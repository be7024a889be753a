// Flash attention (online softmax) for Hopper (sm_90a): three kernels.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention together with its layout
// adapter repro/kernels/ops.py::flash_attention.
//
//   out[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, g, :] / sqrt(D))
//                     v[b, j, g, :]
//
// with g = h / (H / Kh) (grouped-query attention: the K/V head is read in
// place, no repeated copy), keys masked to j <= i (causal) and j > i - window
// (sliding window), or none (bidirectional).  q, k, v and out keep the model's
// (B, S, heads, D) layout; float32 or bfloat16 in, the same type out,
// arithmetic in float32 as the TPU kernel: masked scores are -1e30, the
// running max starts at -1e30, the running sum l is clamped at 1e-30, and
// the output is rounded once.  Key tiles wholly above the causal diagonal
// or wholly outside the window are never loaded, as the TPU kernel skips
// them.  The caller (kernels/flash_attention.py::variant) picks the kernel
// by dtype, head dim and the pointers' alignment: bf16 with D a multiple of
// 8 takes the tensor-core kernel (flash_attention_tc_fwd), float32 with D
// a multiple of 4 the TMA-fed float32 kernel (flash_attention_f32_fwd),
// any other input (TMA needs 16-byte strides and bases) the CUDA-core
// kernel (flash_attention_fwd).
//
// What bounds it on this card: at the serving shape (4, 1024, 16, 16, 64),
// bf16, causal, the function moves 4 B S H D 2 bytes (33.6 MB: 10.0 us at
// 3.35 TB/s) and does 4 B H D S(S+1)/2 operations (8.6 GFLOP: 8.7 us on
// the bf16 tensor cores), near balanced.  In float32 (the TPU kernel's
// float32 products: no TF32) the same operations take at least 128 us on
// the 67 TFLOP/s float32 cores, against 67.1 MB (20 us): the FP32 FMA pipe
// is the bound, and the TMA-fed float32 kernel is built to keep it
// issuing.  The tensor-core kernel does both products on wgmma.  Its P.V
// runs twice (P split into two bf16 parts, below), 1.5x the tensor-core
// operations of one pass: 13 us, still about the bytes' 10 us.  So its
// design keeps the tensor cores fed from shared memory with loads in
// flight (TMA, a ring of K/V stages, a producer warpgroup) and keeps the
// softmax cheap beside them (scores stay in registers, masks only on edge
// tiles, row reductions as quad shuffles).
//
// Tensor-core kernel (bf16, D % 8 == 0, D <= 256).  One block per (batch x
// query head, 64 NWG query rows): NWG consumer warpgroups of 64 rows each
// (3 at D <= 64, 2 up to D = 192, 1 above) and one producer warpgroup.
// The q tiles run in reverse order, so the longest causal rows are
// scheduled first.  One producer thread loads the block's Q tile once and
// then the K/V tiles (64 keys) into a ring of two stages, each by TMA with
// 128-byte swizzle on an mbarrier ("full"); the consumers release a stage
// on a second mbarrier ("empty").  q, k and v are described to TMA as 4-D
// tensors (D, heads, S, B) in boxes of 64 head-dim columns, so TMA
// zero-fills past D (a head dim padded up to a multiple of 64) and past S
// (the ragged last tile).  Per key tile a consumer warpgroup
//   - computes S = Q K^T with wgmma m64n64k16, Q and K read from shared
//     memory (both K-major), over D in k16 steps; the product of two bf16
//     values is exact in fp32, so only the order of the sum differs from
//     the TPU kernel;
//   - scales, masks (only on a tile that crosses the diagonal, the window
//     edge or the end of S), and runs the online softmax in fp32 on the
//     accumulator registers: each thread holds two rows, a row's max and
//     sum are shuffles within a quad of lanes;
//   - splits p into P_hi = bf16(p) and P_lo = bf16(p - P_hi) and adds
//     P_hi V and P_lo V into one fp32 accumulator (wgmma with A from
//     registers, whose layout is the accumulator's, and V from shared
//     memory, MN-major), so p is carried to about 2^-16 of itself, where one
//     bf16 P would round it once more than the TPU kernel does; l is summed
//     from the fp32 p.
// The roles split on a warp-uniform warpgroup index and setmaxnreg drops
// the producer to 24 registers.  ptxas sizes the consumers' code within the
// entry count that __launch_bounds__ gives (65536 / threads: 128, 168 or
// 240 a thread), so the number of consumer warpgroups, not setmaxnreg, is
// what makes room for O (128 registers a thread at D = 256).  The
// epilogue divides by l, rounds to bf16 once, stages the tile in the
// warpgroup's own rows of the Q buffer and writes it with 16-byte stores
// (D is a multiple of 8), only d < D and rows < S.  No atomics: the order
// of every sum is fixed, and a call repeats bit for bit.
//
// TMA-fed float32 kernel (float32, D % 4 == 0, D <= 256: every float32
// prefill).  Both products are register-tiled GEMMs of FP32 FMAs on
// shared-memory tiles.  One block per (batch x query head, 128 query rows;
// 64 above D = 128) of eight warps, 16 rows each (8 above D = 128), the q
// tiles in reverse order (longest causal rows first).  Q is loaded once
// and the K/V tiles (64 keys at D <= 64, 32 above) stream through a ring
// of three stages (two above D = 128), all by TMA with 128-byte swizzle in
// boxes of 32 head-dim columns, on "full" / "empty" mbarriers; the 4-D
// (D, heads, S, B) maps zero-fill past D and S (the ragged last tile), and
// GQA reads the K/V head in place.  Thread 0 issues every load: it fills
// the ring, then refills each stage once all 256 threads have released
// it.  (A ninth, producer warp would cap every thread at 168 registers,
// each SM sub-partition holding 16,384, and the kernel needs up to 254.)
// A warp owns its rows alone: lane (rg, kg) = (lane / 8, lane % 8) holds
// rows rg + 4 i and keys kg + 8 j of a tile, so
//   - S = Q K^T: per 4 head-dim columns, 4 Q and 8 K 16-byte loads (the
//     swizzle puts the rows a warp reads at once in distinct banks) feed
//     128 FMAs into 32 scores, each the sum of two chains (even and odd
//     4-column chunks) of D / 2 FMAs;
//   - the online softmax in log2 units (log2 e folded into the scale,
//     ex2.approx): masks only on edge tiles, a row's max over its 8 lanes
//     by three shuffles, l summed per lane and joined once at the end;
//   - P goes through the warp's own shared-memory rows (chunk j of row r
//     at j ^ 2 (r % 4): conflict-free stores and 16-byte reads), with a
//     __syncwarp, no block barrier;
//   - O += P V: per 4 keys, 4 P and 4 NBOX V 16-byte loads feed 16 NBOX
//     FMAs a row into 4 columns of each 32-column box.
// Tiles above the diagonal or outside the window are skipped per warp (a
// warp still releases them); the output is divided by l (clamped at
// 1e-30), rounded once and stored 16 bytes a lane, rows < S.  No atomics:
// a call repeats bit for bit.  No variant spills.
//
// CUDA-core kernel (float32 with D % 4 != 0 or unaligned inputs, and bf16
// with D % 8 != 0: TMA cannot describe them, since the stride between
// heads must be a multiple of 16 bytes).  One block of 256 threads per
// (batch x head, tile of 64 query rows).  Four neighbouring lanes own one
// query row: lane l holds the 16-byte chunks l, l + 4, l + 8, ... of the
// row's q and of its output accumulator in registers, so a score is 4
// partial dot products joined by two shuffles, and the four lanes of a
// row read one 64-byte run of a key row with 16-byte loads (the other rows
// of the warp read the same run: a broadcast, no bank conflict).  The
// block walks the key/value tiles (BK rows, staged in shared memory as
// float32, rows padded to a multiple of 4 with zeros) that the mask can
// reach.  Within a tile a row takes 16 keys at a time: 16 scores into
// registers, their max, one rescale of its accumulator and sum, then 16
// updates p_j v_j.  The ragged edge of the last tile (S not a multiple of
// BK) and query rows past S are masked.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// (or cudaErrorInvalidValue / cudaErrorNotSupported when a tensor map
// cannot be encoded).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerRow = 4;
constexpr int kRows = kThreads / kLanesPerRow;   // query rows per block: 64
constexpr int kSub = 16;                         // keys per softmax update
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// DS4: the most 16-byte chunks of a row one lane owns (D <= 16 * DS4).
// BK: keys per shared-memory tile (a multiple of kSub).
template <typename T, int DS4, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int S, int H, int Kh, int D, float scale, int causal,
                       int window) {
  extern __shared__ float4 smem[];
  const int D4 = (D + 3) / 4;   // 16-byte chunks of a padded row
  const int Dp = 4 * D4;
  float4* ks = smem;            // (BK, D4)
  float4* vs = smem + BK * D4;  // (BK, D4)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / (H / Kh);
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int lane = tid % kLanesPerRow;
  const int i = q0 + row;                 // this row's query position
  const bool row_ok = i < S;

  const int64_t q_stride = static_cast<int64_t>(H) * D;   // one position
  const int64_t kv_stride = static_cast<int64_t>(Kh) * D;

  float4 qr[DS4];
  float4 acc[DS4];
#pragma unroll
  for (int m = 0; m < DS4; ++m) {
    float e[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = 4 * (lane + kLanesPerRow * m) + t;
      e[t] = (row_ok && d < D)
          ? to_float(q[(static_cast<int64_t>(b) * S + i) * q_stride
                       + static_cast<int64_t>(h) * D + d])
          : 0.0f;
    }
    qr[m] = make_float4(e[0], e[1], e[2], e[3]);
    acc[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float m_run = kNegInf;
  float l = 0.0f;

  // the key tiles that the mask can reach from any row of this block
  const int q_last = min(q0 + kRows, S) - 1;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / BK * BK;
  const int k_end = causal ? q_last + 1 : S;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();            // the previous tile is no longer read
    float* kf = reinterpret_cast<float*>(ks);
    float* vf = reinterpret_cast<float*>(vs);
    for (int e = tid; e < BK * Dp; e += kThreads) {
      const int j = e / Dp;
      const int d = e % Dp;
      const int kj = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (kj < S && d < D) {
        const int64_t off = (static_cast<int64_t>(b) * S + kj) * kv_stride
            + static_cast<int64_t>(g) * D + d;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      kf[e] = kv;
      vf[e] = vv;
    }
    __syncthreads();

#pragma unroll 1
    for (int js = 0; js < BK && k0 + js < k_end; js += kSub) {
      float s[kSub];
      float sub_max = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float4* kr = ks + (js + jj) * D4;
        float part = 0.0f;
#pragma unroll
        for (int m = 0; m < DS4; ++m) {
          const int c4 = lane + kLanesPerRow * m;
          if (c4 < D4) {
            const float4 kv = kr[c4];
            part = fmaf(qr[m].x, kv.x, part);
            part = fmaf(qr[m].y, kv.y, part);
            part = fmaf(qr[m].z, kv.z, part);
            part = fmaf(qr[m].w, kv.w, part);
          }
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        const int kj = k0 + js + jj;
        bool ok = kj < S;
        if (causal) ok = ok && kj <= i;
        if (window > 0) ok = ok && kj > i - window;
        s[jj] = ok ? part * scale : kNegInf;
        sub_max = fmaxf(sub_max, s[jj]);
      }
      const float m_new = fmaxf(m_run, sub_max);
      const float alpha = expf(m_run - m_new);
      l *= alpha;
#pragma unroll
      for (int m = 0; m < DS4; ++m) {
        acc[m].x *= alpha;
        acc[m].y *= alpha;
        acc[m].z *= alpha;
        acc[m].w *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float4* vr = vs + (js + jj) * D4;
#pragma unroll
        for (int m = 0; m < DS4; ++m) {
          const int c4 = lane + kLanesPerRow * m;
          if (c4 < D4) {
            const float4 vv = vr[c4];
            acc[m].x = fmaf(p, vv.x, acc[m].x);
            acc[m].y = fmaf(p, vv.y, acc[m].y);
            acc[m].z = fmaf(p, vv.z, acc[m].z);
            acc[m].w = fmaf(p, vv.w, acc[m].w);
          }
        }
      }
      m_run = m_new;
    }
  }

  if (!row_ok) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  T* o = out + (static_cast<int64_t>(b) * S + i) * q_stride
      + static_cast<int64_t>(h) * D;
#pragma unroll
  for (int m = 0; m < DS4; ++m) {
    const float e[4] = {acc[m].x, acc[m].y, acc[m].z, acc[m].w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = 4 * (lane + kLanesPerRow * m) + t;
      if (d < D) store(o + d, e[t] * inv);
    }
  }
}

template <typename T, int DS4, int BK>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Kh, int D, float scale, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = 2u * BK * ((D + 3) / 4) * sizeof(float4);
  auto kernel = flash_attention_kernel<T, DS4, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, Kh, D, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int Kh, int D, float scale, int causal,
             int window, cudaStream_t stream) {
  // registers per lane: q and acc (8 DS4) plus kSub scores; shared
  // memory: 2 BK D floats, at most 64 KB
  if (D <= 32)
    return launch<T, 2, 64>(q, k, v, out, B, S, H, Kh, D, scale, causal,
                            window, stream);
  if (D <= 64)
    return launch<T, 4, 64>(q, k, v, out, B, S, H, Kh, D, scale, causal,
                            window, stream);
  if (D <= 128)
    return launch<T, 8, 64>(q, k, v, out, B, S, H, Kh, D, scale, causal,
                            window, stream);
  if (D <= 256)
    return launch<T, 16, 32>(q, k, v, out, B, S, H, Kh, D, scale, causal,
                             window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

namespace tc {

constexpr int kWG = 64;               // query rows per consumer warpgroup
constexpr int kBK = 64;               // keys per K/V tile
constexpr int kStages = 2;            // K/V tiles in flight
constexpr int kBox = 64;              // head-dim columns per TMA box
constexpr int kRowBytes = 128;        // one box row: 64 bf16
constexpr int kProducerRegs = 24;

// The consumers' registers after setmaxnreg: the block's entry count (at
// most 65536 / threads, in steps of 8) over its NWG + 1 warpgroups covers
// 24 for the producer and NWG times this; 240 at most.  ptxas caps each
// role's code at the entry count all the same, so that bounds the
// consumers: 128, 168 and 240 registers a thread at NWG = 3, 2, 1.
__host__ __device__ constexpr int consumer_regs(int nwg) {
  const int entry = 65536 / (128 * (nwg + 1)) / 8 * 8;
  const int regs = (entry * (nwg + 1) - kProducerRegs) / nwg / 8 * 8;
  return regs < 240 ? regs : 240;
}

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, from a 1024-byte boundary: Q (NBOX boxes of
// 64 NWG rows), then the K stages and the V stages (NBOX boxes of 64 rows
// each), then the mbarriers: Q, full[kStages], empty[kStages].
template <int NBOX, int NWG>
struct Layout {
  static constexpr uint32_t q_box = NWG * kWG * kRowBytes;
  static constexpr uint32_t kv_box = kBK * kRowBytes;
  static constexpr uint32_t q_bytes = NBOX * q_box;
  static constexpr uint32_t kv_bytes = NBOX * kv_box;  // K or V of a stage
  static constexpr uint32_t k_off = q_bytes;
  static constexpr uint32_t v_off = k_off + kStages * kv_bytes;
  static constexpr uint32_t bar_off = v_off + kStages * kv_bytes;
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * kStages)
      + 1024;                                  // slack for the alignment
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the key tiles [first, end) that the mask lets query rows r_lo..r_hi
// reach
__device__ __forceinline__ void tile_range(int r_lo, int r_hi, int S,
                                           int causal, int window,
                                           int& first, int& end) {
  first = window > 0 ? max(0, r_lo - window + 1) / kBK : 0;
  end = causal ? r_hi / kBK + 1 : (S + kBK - 1) / kBK;
}

// NBOX: 64-column boxes of the head dim (D <= 64 NBOX).  NWG: consumer
// warpgroups (64 query rows each).
template <int NBOX, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ out, int S, int H,
                          int Kh, int D, float scale, int causal,
                          int window) {
  using L = Layout<NBOX, NWG>;
  constexpr int kBM = NWG * kWG;       // query rows per block
  constexpr int kConsumers = NWG * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = smem_raw + pad;
  const uint32_t q_s = raw + pad;
  const uint32_t k_s = q_s + L::k_off;
  const uint32_t v_s = q_s + L::v_off;
  const uint32_t q_bar = q_s + L::bar_off;
  const uint32_t full_bar = q_bar + 8;
  const uint32_t empty_bar = q_bar + 8 * (1 + kStages);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / Kh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;   // longest rows first
  int t_first, t_end;
  tile_range(q0, min(q0 + kBM, S) - 1, S, causal, window, t_first, t_end);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full_bar + 8 * st, 1);
      hopper::mbar_init(empty_bar + 8 * st, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, as a value the compiler can see is uniform in a warp
  // (its registers are then set per role by setmaxnreg)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {
    // ---- producer warpgroup: one thread loads Q once, then the K/V tiles
    // through the ring; the warpgroup gives its registers to the consumers
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      hopper::tma_prefetch_map(&tm_q);
      hopper::tma_prefetch_map(&tm_k);
      hopper::tma_prefetch_map(&tm_v);
      hopper::mbar_arrive_expect_tx(q_bar, L::q_bytes);
      for (int c = 0; c < NBOX; ++c)
        hopper::tma_load_4d(q_s + c * L::q_box, &tm_q, q_bar, c * kBox, h,
                            q0, b);
      for (int t = t_first, i = 0; t < t_end; ++t, ++i) {
        const int st = i % kStages;
        const uint32_t full = full_bar + 8 * st;
        hopper::mbar_wait(empty_bar + 8 * st, ((i / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full, 2 * L::kv_bytes);
        for (int c = 0; c < NBOX; ++c) {
          const uint32_t off = st * L::kv_bytes + c * L::kv_box;
          hopper::tma_load_4d(k_s + off, &tm_k, full, c * kBox, g, t * kBK,
                              b);
          hopper::tma_load_4d(v_s + off, &tm_v, full, c * kBox, g, t * kBK,
                              b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    hopper::reg_alloc<consumer_regs(NWG)>();
    const int w = wg;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row_lo = q0 + kWG * w;
    const int row_hi = min(row_lo + kWG, S) - 1;
    const bool wg_ok = row_lo < S;
    int my_first = t_end, my_end = t_end;          // none
    if (wg_ok)
      tile_range(row_lo, row_hi, S, causal, window, my_first, my_end);
    const int r0 = row_lo + 16 * warp + lane / 4;  // rows r0 and r0 + 8
    const int cq = 2 * (lane % 4);
    const uint64_t q_desc = hopper::desc_sw128(q_s + w * kWG * kRowBytes, 16,
                                               1024);

    float o[NBOX][32];
#pragma unroll
    for (int c = 0; c < NBOX; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
    if (wg_ok) hopper::mbar_wait(q_bar, 0);

    for (int t = t_first, i = 0; t < t_end; ++t, ++i) {
      const int st = i % kStages;
      hopper::mbar_wait(full_bar + 8 * st, (i / kStages) & 1);
      if (t >= my_first && t < my_end) {
        const uint32_t k_st = k_s + st * L::kv_bytes;
        const uint32_t v_st = v_s + st * L::kv_bytes;
        // S = Q K^T: 64 rows x 64 keys, fp32.  s[4 j + e]: chunk j of 8
        // keys, rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3), keys 8 j + cq +
        // (e & 1)
        float s[32];
        const uint64_t qd = hopper::opaque(q_desc);
        const uint64_t kd = hopper::opaque(hopper::desc_sw128(k_st, 16, 1024));
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NBOX; ++kk) {   // zeros past D add 0
          const uint32_t off = (kk % 4) * 32;
          hopper::wgmma_m64n64k16_ss(
              s, hopper::desc_add(qd, (kk / 4) * L::q_box + off),
              hopper::desc_add(kd, (kk / 4) * L::kv_box + off), kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 32; ++e) hopper::fence_operand(s[e]);

        // scale; mask only where the tile crosses the diagonal, the
        // window's edge or the end of S
        const int k0 = t * kBK;
        const bool edge = (causal && k0 + kBK - 1 > row_lo)
            || (window > 0 && k0 <= row_hi - window) || k0 + kBK > S;
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e] * scale;
            if (edge) {
              const int row = r0 + (e >= 2 ? 8 : 0);
              const int col = k0 + 8 * j + cq + (e & 1);
              bool ok = col < S;
              if (causal) ok = ok && col <= row;
              if (window > 0) ok = ok && col > row - window;
              x = ok ? x : kNegInf;
            }
            s[4 * j + e] = x;
            if (e < 2) mx0 = fmaxf(mx0, x);
            else mx1 = fmaxf(mx1, x);
          }
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float a0 = ex2((m0 - mx0) * kLog2e);
        const float a1 = ex2((m1 - mx1) * kLog2e);
        m0 = mx0;
        m1 = mx1;

        // p in fp32 -> l; P_hi, P_lo as the A fragments of the k16 steps:
        // step kk holds key chunks 2 kk (regs 0, 1) and 2 kk + 1 (2, 3),
        // rows r0 (regs 0, 2) and r0 + 8 (1, 3)
        uint32_t p_hi[16], p_lo[16];
        float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float m = half ? m1 : m0;
            const float pa = ex2((s[4 * j + 2 * half] - m) * kLog2e);
            const float pb = ex2((s[4 * j + 2 * half + 1] - m) * kLog2e);
            if (half) ls1 += pa + pb;
            else ls0 += pa + pb;
            const __nv_bfloat162 hi = __floats2bfloat162_rn(pa, pb);
            const __nv_bfloat162 lo = __floats2bfloat162_rn(
                pa - __low2float(hi), pb - __high2float(hi));
            const int r = 4 * (j / 2) + 2 * (j % 2) + half;
            p_hi[r] = bits(hi);
            p_lo[r] = bits(lo);
          }
        }
        l0 = l0 * a0 + ls0;
        l1 = l1 * a1 + ls1;
#pragma unroll
        for (int c = 0; c < NBOX; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[c][4 * j] *= a0;
            o[c][4 * j + 1] *= a0;
            o[c][4 * j + 2] *= a1;
            o[c][4 * j + 3] *= a1;
          }

        // O += P_hi V + P_lo V, V (64 keys x 64 columns a box) MN-major
        const uint64_t vd = hopper::opaque(hopper::desc_sw128(v_st, 1024,
                                                              1024));
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < NBOX; ++c) {
            const uint64_t vb = hopper::desc_add(
                vd, c * L::kv_box + kk * 16 * kRowBytes);
            hopper::wgmma_m64n64k16_rs_tb(o[c], p_hi + 4 * kk, vb);
            hopper::wgmma_m64n64k16_rs_tb(o[c], p_lo + 4 * kk, vb);
          }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NBOX; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) hopper::fence_operand(o[c][e]);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          hopper::fence_operand(p_hi[e]);
          hopper::fence_operand(p_lo[e]);
        }
      }
      hopper::mbar_arrive(empty_bar + 8 * st);
    }

    if (wg_ok) {
      // divide by l, round once, stage in this warpgroup's rows of the Q
      // buffer (same swizzle as TMA's: 16-byte chunk j of row r at j ^ (r
      // % 8)), then 16-byte stores of the rows < S and columns < D
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
      uint8_t* q_tile = smem + w * kWG * kRowBytes;
      const int rl = 16 * warp + lane / 4;
#pragma unroll
      for (int c = 0; c < NBOX; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint8_t* chunk = q_tile + c * L::q_box + ((j ^ (rl & 7)) * 16)
              + (lane % 4) * 4;
          *reinterpret_cast<uint32_t*>(chunk + rl * kRowBytes) = bits(
              __floats2bfloat162_rn(o[c][4 * j] * inv0,
                                    o[c][4 * j + 1] * inv0));
          *reinterpret_cast<uint32_t*>(chunk + (rl + 8) * kRowBytes) = bits(
              __floats2bfloat162_rn(o[c][4 * j + 2] * inv1,
                                    o[c][4 * j + 3] * inv1));
        }
      hopper::named_bar_sync(1 + w, 128);
      constexpr int kChunks = NBOX * 8;
      for (int idx = tid; idx < kWG * kChunks; idx += 128) {
        const int r = idx / kChunks;
        const int cc = idx % kChunks;
        const int row = row_lo + r;
        if (row < S && 8 * cc < D) {
          const uint4 val = *reinterpret_cast<const uint4*>(
              q_tile + (cc / 8) * L::q_box + r * kRowBytes
              + (((cc % 8) ^ (r & 7)) * 16));
          *reinterpret_cast<uint4*>(
              out + ((static_cast<int64_t>(b) * S + row) * H + h) * D
              + 8 * cc) = val;
        }
      }
    }
  }
}

template <int NBOX, int NWG>
struct Variant {
  static constexpr int kSmem = static_cast<int>(Layout<NBOX, NWG>::bytes);
  static constexpr int kBM = NWG * kWG;

  static int launch(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int H, int Kh, int D, float scale,
                    int causal, int window, cudaStream_t stream) {
    // q, k, v as 4-D tensors (D, heads, S, B) in boxes of 64 columns
    CUtensorMap tq, tk, tv;
    const uint64_t dq[4] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
    const uint64_t dkv[4] = {static_cast<uint64_t>(D),
                             static_cast<uint64_t>(Kh),
                             static_cast<uint64_t>(S),
                             static_cast<uint64_t>(B)};
    const uint32_t box_q[4] = {kBox, 1, kBM, 1};
    const uint32_t box_kv[4] = {kBox, 1, kBK, 1};
    int rc = hopper::encode_tensor_map_bf16(&tq, q, 4, dq, box_q);
    if (rc == 0) rc = hopper::encode_tensor_map_bf16(&tk, k, 4, dkv, box_kv);
    if (rc == 0) rc = hopper::encode_tensor_map_bf16(&tv, v, 4, dkv, box_kv);
    if (rc != 0) return rc;
    auto kernel = flash_attention_tc_kernel<NBOX, NWG>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(B * H, (S + kBM - 1) / kBM);
    kernel<<<grid, 128 * (NWG + 1), kSmem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, H, Kh, D, scale,
        causal, window);
    return static_cast<int>(cudaGetLastError());
  }

  static int attributes(int* regs, int* local_bytes, int* smem_bytes) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(
        &attr, flash_attention_tc_kernel<NBOX, NWG>);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *smem_bytes = kSmem;
    return 0;
  }
};

// Chosen by timing 64- and 128-key tiles, two to four stages and one to
// three consumer warpgroups at S = 1024, bf16, on an H100: D <= 64 runs
// fastest with three consumer warpgroups (192 query rows a block, 128
// registers a thread: O, S and both parts of P fit); D <= 192 with two
// (168 registers); D <= 256, where O alone takes 128 registers a thread,
// with one.  None spills.
using V1 = Variant<1, 3>;
using V2 = Variant<2, 2>;
using V3 = Variant<3, 2>;
using V4 = Variant<4, 1>;

}  // namespace tc

namespace f32 {

constexpr int kBox = 32;              // head-dim columns per TMA box
constexpr int kRowBytes = 128;        // one box row: 32 float32
constexpr int kWarps = 8;             // warps a block, two on each SMSP
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, from a 1024-byte boundary: Q (NBOX boxes of
// BM rows x 32 values), the K stages and the V stages (NBOX boxes of BK
// rows each), all with 128-byte swizzle; then each warp's P (4 RPT rows x
// BK values, chunk j of row r at chunk j ^ 2 (r % 4)); then the mbarriers
// Q, full[STAGES], empty[STAGES].
template <int NBOX, int RPT, int BK, int STAGES>
struct Layout {
  static constexpr int BM = kWarps * 4 * RPT;          // query rows a block
  static constexpr uint32_t q_box = BM * kRowBytes;
  static constexpr uint32_t kv_box = BK * kRowBytes;
  static constexpr uint32_t q_bytes = NBOX * q_box;
  static constexpr uint32_t kv_bytes = NBOX * kv_box;  // K or V of a stage
  static constexpr uint32_t k_off = q_bytes;
  static constexpr uint32_t v_off = k_off + STAGES * kv_bytes;
  static constexpr uint32_t p_off = v_off + STAGES * kv_bytes;
  static constexpr uint32_t p_warp = 4 * RPT * BK * 4;
  static constexpr uint32_t bar_off = p_off + kWarps * p_warp;
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * STAGES)
      + 1024;                                  // slack for the alignment
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int BK>
__device__ __forceinline__ void tile_range(int r_lo, int r_hi, int S,
                                           int causal, int window,
                                           int& first, int& end) {
  first = window > 0 ? max(0, r_lo - window + 1) / BK : 0;
  end = causal ? r_hi / BK + 1 : (S + BK - 1) / BK;
}

__device__ __forceinline__ float4 lds4(const uint8_t* p) {
  return *reinterpret_cast<const float4*>(p);
}

// NBOX: 32-column boxes of the head dim (D <= 32 NBOX).  RPT: query rows
// a lane owns (a warp owns 4 RPT).  BK: keys a tile.  STAGES: K/V tiles
// in flight.
template <int NBOX, int RPT, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           float* __restrict__ out, int S, int H, int Kh,
                           int D, float scale, int causal, int window) {
  using L = Layout<NBOX, RPT, BK, STAGES>;
  constexpr int BM = L::BM;
  constexpr int WR = 4 * RPT;          // query rows a warp
  constexpr int KPL = BK / 8;          // keys a lane, per tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = smem_raw + pad;
  const uint32_t q_s = raw + pad;
  const uint32_t k_s = q_s + L::k_off;
  const uint32_t v_s = q_s + L::v_off;
  const uint32_t q_bar = q_s + L::bar_off;
  const uint32_t full_bar = q_bar + 8;
  const uint32_t empty_bar = q_bar + 8 * (1 + STAGES);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / Kh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // longest rows first
  int t_first, t_end;
  tile_range<BK>(q0, min(q0 + BM, S) - 1, S, causal, window, t_first, t_end);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(full_bar + 8 * st, 1);
      hopper::mbar_init(empty_bar + 8 * st, kThreads);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // Q once, then K/V tile t into stage st, each completing on its barrier.
  // Thread 0 issues them all: it fills the ring here and refills each
  // stage once every thread has released it (below)
  auto load_q = [&]() {
    hopper::tma_prefetch_map(&tm_q);
    hopper::tma_prefetch_map(&tm_k);
    hopper::tma_prefetch_map(&tm_v);
    hopper::mbar_arrive_expect_tx(q_bar, L::q_bytes);
    for (int c = 0; c < NBOX; ++c)
      hopper::tma_load_4d(q_s + c * L::q_box, &tm_q, q_bar, c * kBox, h, q0,
                          b);
  };
  auto load_tile = [&](int t, int st) {
    const uint32_t full = full_bar + 8 * st;
    hopper::mbar_arrive_expect_tx(full, 2 * L::kv_bytes);
    for (int c = 0; c < NBOX; ++c) {
      const uint32_t off = st * L::kv_bytes + c * L::kv_box;
      hopper::tma_load_4d(k_s + off, &tm_k, full, c * kBox, g, t * BK, b);
      hopper::tma_load_4d(v_s + off, &tm_v, full, c * kBox, g, t * BK, b);
    }
  };
  if (threadIdx.x == 0) {
    load_q();
    for (int i = 0; i < STAGES && t_first + i < t_end; ++i)
      load_tile(t_first + i, i);
  }

  // Each warp owns WR query rows and runs both products and the softmax
  // on them alone.  Lane (rg, kg) = (lane / 8, lane % 8) holds the scores
  // of rows rg + 4 i (i < RPT) of its warp and keys kg + 8 j (j < KPL) of
  // a tile, and the output of the same rows at columns 32 c + 4 kg .. + 3
  // of each box c
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = lane / 8, kg = lane % 8;
  const int w_lo = q0 + WR * warp;
  const int w_hi = min(w_lo + WR, S) - 1;
  const bool w_ok = w_lo < S;
  int my_first = t_end, my_end = t_end;          // none
  if (w_ok)
    tile_range<BK>(w_lo, w_hi, S, causal, window, my_first, my_end);
  const float scale2 = scale * kLog2e;            // exp(x) = 2^(x log2 e)

  // Q row rg + 4 i of this warp (block row WR warp + rg + 4 i, whose
  // swizzle phase is rg + 4 (i % 2): WR warp is a multiple of 8) at
  // chunk cq: row base + ((cq ^ rg ^ 4 (i % 2)) << 4)
  const uint8_t* q_row = smem + (WR * warp + rg) * kRowBytes;
  // K key kg + 8 j (phase kg) at chunk cq: ((cq ^ kg) << 4)
  const uint8_t* k_lane = smem + L::k_off + kg * kRowBytes;
  const uint8_t* v_base = smem + L::v_off;
  // this lane's P rows: rg + 4 i; chunk jq of row r at jq ^ 2 (r % 4)
  uint8_t* p_lane = smem + L::p_off + warp * L::p_warp + rg * BK * 4;
  const int p_sw = (2 * rg) << 4;

  float o[RPT][NBOX][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < NBOX; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.0f;
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  if (w_ok) hopper::mbar_wait(q_bar, 0);

  for (int t = t_first, it = 0; t < t_end; ++t, ++it) {
    const int st = it % STAGES;
    hopper::mbar_wait(full_bar + 8 * st, (it / STAGES) & 1);
    if (t >= my_first && t < my_end) {
      // S = Q K^T over the head dim, 4 columns at a time, into two
      // partial sums a score (the even and the odd 4-column chunks): two
      // chains of D / 2 FMAs, not one of D
      float s[RPT][KPL], s2[RPT][KPL];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          s[i][j] = 0.0f;
          s2[i][j] = 0.0f;
        }
      const uint8_t* k_st = k_lane + st * L::kv_bytes;
#pragma unroll
      for (int c = 0; c < NBOX; ++c) {
#pragma unroll
        for (int cq = 0; cq < 8; ++cq) {
          const int kx = (cq ^ kg) << 4;
          const int qx0 = (cq ^ rg) << 4;
          const int qx1 = (cq ^ rg ^ 4) << 4;
          float4 qv[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            qv[i] = lds4(q_row + c * L::q_box + 4 * i * kRowBytes
                         + ((i & 1) ? qx1 : qx0));
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            const float4 kv = lds4(k_st + c * L::kv_box
                                   + 8 * j * kRowBytes + kx);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              float& acc = (cq & 1) ? s2[i][j] : s[i][j];
              acc = fmaf(qv[i].x, kv.x, acc);
              acc = fmaf(qv[i].y, kv.y, acc);
              acc = fmaf(qv[i].z, kv.z, acc);
              acc = fmaf(qv[i].w, kv.w, acc);
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPL; ++j) s[i][j] += s2[i][j];

      // scale (into log2 units); mask only where the tile crosses the
      // diagonal, the window's edge or the end of S; the online softmax
      // over the 8 lanes of a row group; p into this warp's P rows
      const int k0 = t * BK;
      const bool edge = (causal && k0 + BK - 1 > w_lo)
          || (window > 0 && k0 <= w_hi - window) || k0 + BK > S;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = w_lo + rg + 4 * i;
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          float x = s[i][j] * scale2;
          if (edge) {
            const int col = k0 + kg + 8 * j;
            bool ok = col < S;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && col > row - window;
            x = ok ? x : kNegInf;
          }
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float alpha = ex2(m[i] - mx);
        m[i] = mx;
        float ls = 0.0f;
        float* p_row = reinterpret_cast<float*>(p_lane + 4 * i * BK * 4);
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const float p = ex2(s[i][j] - mx);
          ls += p;
          // key kg + 8 j: chunk 2 j + kg / 4, word kg % 4
          const int chunk = (2 * j + kg / 4) ^ (2 * rg);
          p_row[4 * chunk + kg % 4] = p;
        }
        l[i] = l[i] * alpha + ls;
#pragma unroll
        for (int c = 0; c < NBOX; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][c][e] *= alpha;
      }
      __syncwarp();

      // O += P V, four keys at a time
      const uint8_t* v_st = v_base + st * L::kv_bytes;
#pragma unroll
      for (int jq = 0; jq < BK / 4; ++jq) {
        float4 pv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          pv[i] = lds4(p_lane + 4 * i * BK * 4 + ((jq << 4) ^ p_sw));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int key = 4 * jq + kk;
          const int vx = (kg ^ (key & 7)) << 4;
#pragma unroll
          for (int c = 0; c < NBOX; ++c) {
            const float4 vv = lds4(v_st + c * L::kv_box + key * kRowBytes
                                   + vx);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float p = kk == 0 ? pv[i].x : kk == 1 ? pv[i].y
                  : kk == 2 ? pv[i].z : pv[i].w;
              o[i][c][0] = fmaf(p, vv.x, o[i][c][0]);
              o[i][c][1] = fmaf(p, vv.y, o[i][c][1]);
              o[i][c][2] = fmaf(p, vv.z, o[i][c][2]);
              o[i][c][3] = fmaf(p, vv.w, o[i][c][3]);
            }
          }
        }
      }
      __syncwarp();          // P is rewritten by the next tile
    }
    hopper::mbar_arrive(empty_bar + 8 * st);
    if (threadIdx.x == 0 && t + STAGES < t_end) {
      hopper::mbar_wait(empty_bar + 8 * st, (it / STAGES) & 1);
      load_tile(t + STAGES, st);
    }
  }

  if (w_ok) {
    // l is summed over the row group's lanes; divide, round once, and
    // store the rows < S, 16 bytes a lane (D % 4 == 0)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      li += __shfl_xor_sync(0xffffffffu, li, 4);
      const float inv = 1.0f / fmaxf(li, 1e-30f);
      const int row = w_lo + rg + 4 * i;
      if (row >= S) continue;
      float* o_row = out + ((static_cast<int64_t>(b) * S + row) * H + h)
          * D;
#pragma unroll
      for (int c = 0; c < NBOX; ++c) {
        const int col = c * kBox + 4 * kg;
        if (col < D)
          *reinterpret_cast<float4*>(o_row + col) = make_float4(
              o[i][c][0] * inv, o[i][c][1] * inv, o[i][c][2] * inv,
              o[i][c][3] * inv);
      }
    }
  }
}

template <int NBOX, int RPT, int BK, int STAGES>
struct Variant {
  static constexpr int kSmem =
      static_cast<int>(Layout<NBOX, RPT, BK, STAGES>::bytes);
  static constexpr int kBM = Layout<NBOX, RPT, BK, STAGES>::BM;

  static int launch(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int H, int Kh, int D, float scale,
                    int causal, int window, cudaStream_t stream) {
    // q, k, v as 4-D tensors (D, heads, S, B) in boxes of 32 columns
    CUtensorMap tq, tk, tv;
    const uint64_t dq[4] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
    const uint64_t dkv[4] = {static_cast<uint64_t>(D),
                             static_cast<uint64_t>(Kh),
                             static_cast<uint64_t>(S),
                             static_cast<uint64_t>(B)};
    const uint32_t box_q[4] = {kBox, 1, kBM, 1};
    const uint32_t box_kv[4] = {kBox, 1, BK, 1};
    int rc = hopper::encode_tensor_map_f32(&tq, q, 4, dq, box_q, true);
    if (rc == 0)
      rc = hopper::encode_tensor_map_f32(&tk, k, 4, dkv, box_kv, true);
    if (rc == 0)
      rc = hopper::encode_tensor_map_f32(&tv, v, 4, dkv, box_kv, true);
    if (rc != 0) return rc;
    auto kernel = flash_attention_f32_kernel<NBOX, RPT, BK, STAGES>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(B * H, (S + kBM - 1) / kBM);
    kernel<<<grid, kThreads, kSmem, stream>>>(
        tq, tk, tv, static_cast<float*>(out), S, H, Kh, D, scale, causal,
        window);
    return static_cast<int>(cudaGetLastError());
  }

  static int attributes(int* regs, int* local_bytes, int* smem_bytes) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(
        &attr, flash_attention_f32_kernel<NBOX, RPT, BK, STAGES>);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *smem_bytes = kSmem;
    return 0;
  }
};

// By head dim: 128 query rows a block (16 a warp, 4 a lane), but 64 (8,
// 2) above D = 128, so that O stays at 64 registers a lane; 64-key tiles
// in three stages at D <= 64, 32-key tiles above (64-key tiles ran at
// half the speed at D = 128).
using V2 = Variant<2, 4, 64, 3>;
using V3 = Variant<3, 4, 32, 3>;
using V4 = Variant<4, 4, 32, 3>;
using V8 = Variant<8, 2, 32, 2>;

}  // namespace f32

// dtype: 0 = float32, 1 = bfloat16.  q, out: (B, S, H, D); k, v: (B, S, Kh,
// D); contiguous.  scale = 1 / sqrt(D).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int dtype,
                                   int B, int S, int H, int Kh, int D,
                                   float scale, int causal, int window,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, S, H, Kh, D, scale, causal,
                           window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, Kh, D, scale,
                                   causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bf16 only, D % 8 == 0 and 8 <= D <= 256; q, k, v 16-byte aligned.  q,
// out: (B, S, H, D); k, v: (B, S, Kh, D); contiguous.  scale = 1 / sqrt(D).
extern "C" int flash_attention_tc_fwd(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int Kh, int D, float scale,
                                      int causal, int window, void* stream) {
  if (D % 8 != 0 || D < 8 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + tc::kBox - 1) / tc::kBox) {
    case 1:
      return tc::V1::launch(q, k, v, out, B, S, H, Kh, D, scale, causal,
                            window, st);
    case 2:
      return tc::V2::launch(q, k, v, out, B, S, H, Kh, D, scale, causal,
                            window, st);
    case 3:
      return tc::V3::launch(q, k, v, out, B, S, H, Kh, D, scale, causal,
                            window, st);
    default:
      return tc::V4::launch(q, k, v, out, B, S, H, Kh, D, scale, causal,
                            window, st);
  }
}

// registers a thread at launch, local memory (spills) and dynamic shared
// memory of the tensor-core kernel that head dim D runs
extern "C" int flash_attention_tc_attributes(int D, int* regs,
                                             int* local_bytes,
                                             int* smem_bytes) {
  switch ((D + tc::kBox - 1) / tc::kBox) {
    case 1: return tc::V1::attributes(regs, local_bytes, smem_bytes);
    case 2: return tc::V2::attributes(regs, local_bytes, smem_bytes);
    case 3: return tc::V3::attributes(regs, local_bytes, smem_bytes);
    default: return tc::V4::attributes(regs, local_bytes, smem_bytes);
  }
}

// float32 only, D % 4 == 0 and 4 <= D <= 256; q, k, v 16-byte aligned.
// q, out: (B, S, H, D); k, v: (B, S, Kh, D); contiguous.  scale = 1 /
// sqrt(D).
extern "C" int flash_attention_f32_fwd(const void* q, const void* k,
                                       const void* v, void* out, int B,
                                       int S, int H, int Kh, int D,
                                       float scale, int causal, int window,
                                       void* stream) {
  if (D % 4 != 0 || D < 4 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return f32::V2::launch(q, k, v, out, B, S, H, Kh, D, scale, causal,
                           window, st);
  if (D <= 96)
    return f32::V3::launch(q, k, v, out, B, S, H, Kh, D, scale, causal,
                           window, st);
  if (D <= 128)
    return f32::V4::launch(q, k, v, out, B, S, H, Kh, D, scale, causal,
                           window, st);
  return f32::V8::launch(q, k, v, out, B, S, H, Kh, D, scale, causal,
                         window, st);
}

// registers a thread at launch, local memory (spills) and dynamic shared
// memory of the float32 TMA kernel that head dim D runs
extern "C" int flash_attention_f32_attributes(int D, int* regs,
                                              int* local_bytes,
                                              int* smem_bytes) {
  if (D <= 64) return f32::V2::attributes(regs, local_bytes, smem_bytes);
  if (D <= 96) return f32::V3::attributes(regs, local_bytes, smem_bytes);
  if (D <= 128) return f32::V4::attributes(regs, local_bytes, smem_bytes);
  return f32::V8::attributes(regs, local_bytes, smem_bytes);
}
