// Grouped (per-expert) GEMM for Hopper (sm_90a): four kernels.
//
// Replaces the Pallas TPU kernel repro/kernels/expert_gemm.py::expert_gemm:
//
//   out[e] = x[e] @ w[e],   x (E, C, D), w (E, D, F) -> out (E, C, F)
//
// the compute core of the MoE layer after dispatch (three calls per layer:
// wi, wg, then wo on silu(g) * h).  float32 or bfloat16 in, both of one
// type; sums in float32, the output written in x's type, rounded once.  Any
// C, D and F >= 1: ragged tiles are masked or zero-filled (the TPU kernel
// asserts that its blocks divide the shape), and every offset is 64-bit.
// The caller (kernels/expert_gemm.py::variant) picks the kernel from the
// dtype, D, F and the pointers' alignment:
//
//   - bf16, D and F multiples of 8, x, w and out 16-byte aligned (every
//     config's expert shapes): the tensor-core kernel (expert_gemm_tc_fwd);
//   - bf16 otherwise (TMA needs 16-byte strides and bases): the mma.sync
//     kernel (expert_gemm_fwd, dtype 1);
//   - float32, D and F multiples of 4, x, w and out 16-byte aligned
//     (every config's): the TMA-fed float32 kernel (expert_gemm_f32_fwd);
//   - float32 otherwise: the CUDA-core kernel (expert_gemm_fwd, dtype 0).
//
// What bounds it on this card: at granite-moe-1b-a400m's prefill shape (E
// 32, C 1280 slots, D 1024, F 512, bf16) one call moves 159.4 MB (47.6 us
// at 3.35 TB/s) and does 42.9 GFLOP (43.4 us on the bf16 tensor cores), so
// a kernel near the roofline is balanced between the two.  In float32 the
// same work takes at least 641 us on the CUDA cores at 67 TFLOP/s (the TPU
// kernel's contract is float32 products, so no TF32 and no split TF32):
// there the FP32 FMA pipe is the bound, and the design keeps it issuing
// (operands from shared memory that TMA filled ahead, no barrier of the
// whole block in the main loop, few loads per FMA).
//
// Design.  On the TPU the contraction axis is a sequential grid axis with a
// (bc, bf) float32 accumulator in VMEM scratch.  Here a block owns output
// tiles and walks D itself, the accumulator in registers.
//
// Tensor-core kernel (bf16).  A persistent grid, one block of three
// warpgroups per SM, walks the (expert, 128-row, 128-column) output tiles
// with the expert as the slowest axis, so the blocks in flight share the
// x rows and w columns of one or two experts in L2 (one block per tile
// took 24 % longer at granite's wi shape: a tail, and a prologue per
// tile).  One thread of the producer warpgroup (which gives its registers
// away with setmaxnreg) loads each 64-deep contraction step of a tile by
// TMA with 128-byte swizzle into a ring of five stages, each with a
// "full" and an "empty" mbarrier: x as the K-major A operand (a map over
// (D, C, E) in boxes of 64 x 128 rows), w as the MN-major B operand, read
// in place (a map over (F, D, E) in boxes of 64 columns x 64 rows, two
// boxes a step).  TMA fills whatever lies outside the tensor with zeros,
// so ragged C, F and D need no masking in the main loop.  Two consumer
// warpgroups own 64 rows each; per stage each issues four wgmma
// m64n128k16 (A and B from shared memory; the product of two bf16 values
// is exact in fp32, so the TPU kernel's contract holds), waits until at
// most this step's group is in flight and releases the previous stage.
// The 64 x 128 fp32 accumulator is 64 registers a consumer thread (tiles
// of 256 columns timed the same at granite's shapes and pad a ragged F
// twice as far).  The epilogue rounds the accumulator to bf16 once,
// stages it in the warpgroup's own buffer (in TMA's swizzle) and writes
// it with TMA stores, which clip rows >= C and columns >= F; the next
// tile's loads are already in flight meanwhile.  No atomics: the order of
// every sum is fixed, and a call repeats bit for bit.
//
// TMA-fed float32 kernel.  The tensor-core kernel's frame around FP32
// FMAs: a persistent grid walks the (expert, 128-row, 128-column) tiles
// expert-major; one thread of a producer warpgroup (24 registers after
// setmaxnreg) keeps a ring of four 32 KB stages full, each one
// contraction step of 32: the x box (128 rows x 32 values, 128-byte
// swizzle, as TMA leaves x's k-contiguous rows) and the w box (32 rows x
// 128 columns as they lie), on a "full" and an "empty" mbarrier; ragged
// C, D and F come from TMA's zero fill and a clipped store.  Two consumer
// warpgroups, 16 x 16 threads, each own 8 rows x 8 columns of the tile
// (64 accumulators): per 4 k values a thread reads its 8 rows' 16-byte
// chunks of x along k (the swizzle puts the two rows a warp reads at once
// in distinct banks, and its phase folds into one base a half step) and
// per k two 16-byte chunks of w, then 64 FMAs: 16 shared-memory loads per
// 256 FMAs, every offset an immediate.  Each consumer thread releases the
// stage after its last read; the epilogue stores the registers straight
// to global memory (F % 4 == 0: 16 bytes a store) while the next tile's
// stages are already loading.  No atomics: a call repeats bit for bit.
// 168 registers a thread (the entry count of a 384-thread block, which
// ptxas sizes the consumers' code within) and no spill; an 8 x 16 tile
// does not fit that, and without the producer warpgroup (thread 0 filling
// the ring, 255 registers) the kernel ran slower, on NVIDIA H100 80GB
// HBM3.
//
// CUDA-core and mma.sync kernels (float32 and bf16 that TMA cannot
// describe).  One block of 256 threads owns one (expert, 128 x 128 output
// tile) and walks D in steps of 32.  The x and w tiles of a step are
// fetched with 16-byte global loads into registers while the block
// computes on the previous step's tiles in shared memory, then stored
// (software prefetch).  A chunk that runs past D or F, or rows whose
// length is not a multiple of 16 bytes, are read one element at a time
// and padded with zeros.
//
// - float32: the x tile is stored transposed (k-major), so each thread
//   reads 4 + 4 rows and 4 + 4 columns with four 16-byte shared-memory
//   loads per k and keeps an 8 x 8 register tile (64 FMAs per k).
// - bfloat16: mma.sync m16n8k16 (bf16 x bf16 -> fp32) on the tensor cores.
//   Eight warps as 2 x 4, each a 64 x 32 warp tile of 4 x 4 fragments;
//   fragments are read with ldmatrix (the w tile with .trans), rows padded
//   by 16 bytes so that the eight row addresses of each 8 x 8 matrix fall
//   in distinct banks.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;   // output rows (slots) per block
constexpr int kBN = 128;   // output columns per block
constexpr int kBK = 32;    // contraction step
constexpr int kPad = 8;    // bf16 row padding: 16 bytes

// 16 bytes of row ``row`` from column ``col``: one vector load where the
// chunk lies inside the row and ``vec`` says rows are 16-byte aligned,
// else element by element, zero past ``ncols`` (and all zero when
// ``row_ok`` is false).  R is the element's raw type (uint32_t for
// float32, uint16_t for bfloat16): zero bits are 0.0 in both.
template <typename R>
__device__ __forceinline__ uint4 load_chunk(const R* __restrict__ base,
                                            int64_t row, int ld, int col,
                                            int ncols, bool row_ok,
                                            bool vec) {
  constexpr int V = 16 / sizeof(R);
  if (!row_ok) return make_uint4(0u, 0u, 0u, 0u);
  const R* p = base + row * ld;
  if (vec && col + V <= ncols)
    return __ldg(reinterpret_cast<const uint4*>(p + col));
  union {
    uint4 u;
    R r[V];
  } c;
  c.u = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (col + i < ncols) c.r[i] = p[col + i];
  return c.u;
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs, an 8 x 8 register tile per thread
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
gemm_f32(const uint32_t* __restrict__ x, const uint32_t* __restrict__ w,
         float* __restrict__ out, int C, int D, int F, int vec_x, int vec_w,
         int vec_out) {
  __shared__ __align__(16) float As[kBK][kBM];   // x tile, k-major
  __shared__ __align__(16) float Bs[kBK][kBN];   // w tile
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const uint32_t* xe = x + static_cast<int64_t>(e) * C * D;
  const uint32_t* we = w + static_cast<int64_t>(e) * D * F;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // per step: x tile 128 rows x 8 chunks, w tile 32 rows x 32 chunks;
  // four chunks of each per thread.  Neighbouring threads take
  // neighbouring x rows, so the transposed shared stores do not conflict.
  uint4 ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * kThreads;
      const int m = id % kBM, kc = id / kBM;
      ra[i] = load_chunk(xe, m0 + m, D, k0 + kc * 4, D, m0 + m < C, vec_x);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * kThreads;
      const int k = id / 32, nc = id % 32;
      rb[i] = load_chunk(we, k0 + k, F, n0 + nc * 4, F, k0 + k < D, vec_w);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * kThreads;
      const int m = id % kBM, kc = id / kBM;
      As[kc * 4 + 0][m] = __uint_as_float(ra[i].x);
      As[kc * 4 + 1][m] = __uint_as_float(ra[i].y);
      As[kc * 4 + 2][m] = __uint_as_float(ra[i].z);
      As[kc * 4 + 3][m] = __uint_as_float(ra[i].w);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * kThreads;
      const int k = id / 32, nc = id % 32;
      *reinterpret_cast<uint4*>(&Bs[k][nc * 4]) = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nk = (D + kBK - 1) / kBK;
  load(0);
  store();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * kBK);
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (kt + 1 < nk) {
      store();
      __syncthreads();
    }
  }

  float* oe = out + static_cast<int64_t>(e) * C * F;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= C) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      float* o = oe + static_cast<int64_t>(m) * F + n;
      if (vec_out && n + 4 <= F) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][h * 4 + 0], acc[i][h * 4 + 1],
                        acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < F) o[j] = acc[i][h * 4 + j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16 on the tensor cores, float32 accumulators
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
gemm_bf16(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
          __nv_bfloat16* __restrict__ out, int C, int D, int F, int vec_x,
          int vec_w, int pair_out) {
  __shared__ __align__(16) uint16_t As[kBM][kBK + kPad];   // x tile, m-major
  __shared__ __align__(16) uint16_t Bs[kBK][kBN + kPad];   // w tile, k-major
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const uint16_t* xe = x + static_cast<int64_t>(e) * C * D;
  const uint16_t* we = w + static_cast<int64_t>(e) * D * F;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;   // 2 x 4 warps of 64 x 32

  // per step: x tile 128 rows x 4 chunks, w tile 32 rows x 16 chunks;
  // two chunks of each per thread, neighbouring threads on neighbouring
  // addresses
  uint4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads;
      const int m = id / 4, kc = id % 4;
      ra[i] = load_chunk(xe, m0 + m, D, k0 + kc * 8, D, m0 + m < C, vec_x);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads;
      const int k = id / 16, nc = id % 16;
      rb[i] = load_chunk(we, k0 + k, F, n0 + nc * 8, F, k0 + k < D, vec_w);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&As[id / 4][(id % 4) * 8]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&Bs[id / 16][(id % 16) * 8]) = rb[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  // the row (of x) or k (of w) and the 8-column offset this lane
  // addresses in an x4 ldmatrix: matrices 0-3 are (rows 0-7, cols 0-7),
  // (rows 8-15, cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols 8-15)
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;

  const int nk = (D + kBK - 1) / kBK;
  load(0);
  store();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], &As[wm * 64 + mi * 16 + lrow][kk + lcol]);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Bs[kk + lrow][wn * 32 + p * 16 + lcol]);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
    if (kt + 1 < nk) {
      store();
      __syncthreads();
    }
  }

  // accumulator fragment: c0, c1 at (row g, cols 2t, 2t + 1), c2, c3 at
  // (row g + 8, the same cols)
  __nv_bfloat16* oe = out + static_cast<int64_t>(e) * C * F;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (m >= C) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * t;
        if (n >= F) continue;
        const float v0 = acc[mi][ni][2 * half];
        const float v1 = acc[mi][ni][2 * half + 1];
        __nv_bfloat16* o = oe + static_cast<int64_t>(m) * F + n;
        if (pair_out) {            // F even: n + 1 < F, 4-byte aligned
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0,
                                                                        v1);
        } else {
          o[0] = __float2bfloat16_rn(v0);
          if (n + 1 < F) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// bfloat16 on wgmma: TMA ring, producer warpgroup, persistent grid
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 128;          // output rows per tile: two warpgroups of 64
constexpr int kWG = 64;           // rows per consumer warpgroup
constexpr int kBN = 128;          // output columns per tile
constexpr int kBK = 64;           // contraction step: one 128-byte row of bf16
constexpr int kBox = 64;          // columns per TMA box
constexpr int kNB = kBN / kBox;   // w boxes a step, output boxes a tile
constexpr int kStages = 5;
constexpr int kRowBytes = 128;    // one box row
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
// ptxas sizes every role's code within 65536 / 384 = 168 registers a
// thread (the entry count); setmaxnreg moves the producer's to the
// consumers: 24 + 2 x 240 = 3 x 168
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory of one block, from a 1024-byte boundary: five 32 KB
// stages of [x box (128 rows x 128 B) | two w boxes (64 rows x 128 B)],
// then the two warpgroups' output buffers (two boxes of 64 rows x 128 B
// each), then the mbarriers full[kStages], empty[kStages]: 197,712 bytes
// with the alignment slack.  Every box starts on a 1024-byte boundary, as
// the 128-byte swizzle needs.
struct Layout {
  static constexpr uint32_t a_bytes = kBM * kRowBytes;
  static constexpr uint32_t b_box = kBK * kRowBytes;
  static constexpr uint32_t stage = a_bytes + kNB * b_box;
  static constexpr uint32_t out_box = kWG * kRowBytes;
  static constexpr uint32_t out_wg = kNB * out_box;
  static constexpr uint32_t out_off = kStages * stage;
  static constexpr uint32_t bar_off = out_off + 2 * out_wg;
  static constexpr uint32_t bytes = bar_off + 16 * kStages
      + 1024;                                  // slack for the alignment
};
constexpr int kSmem = static_cast<int>(Layout::bytes);

// tile t -> expert, first row, first column; the column tile is the
// fastest axis and the expert the slowest
__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n,
                                            int& e, int& m0, int& n0) {
  const int per_e = tiles_m * tiles_n;
  e = t / per_e;
  const int r = t - e * per_e;
  m0 = (r / tiles_n) * kBM;
  n0 = (r % tiles_n) * kBN;
}

__global__ void __launch_bounds__(kThreads, 1)
gemm_tc(const __grid_constant__ CUtensorMap tm_x,
        const __grid_constant__ CUtensorMap tm_w,
        const __grid_constant__ CUtensorMap tm_out, int E, int C, int D,
        int F) {
  using L = Layout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  const uint32_t full_bar = base + L::bar_off;
  const uint32_t empty_bar = full_bar + 8 * kStages;

  const int tiles_m = (C + kBM - 1) / kBM;
  const int tiles_n = (F + kBN - 1) / kBN;
  const int tiles = E * tiles_m * tiles_n;
  const int nk = (D + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full_bar + 8 * st, 1);
      hopper::mbar_init(empty_bar + 8 * st, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, as a value the compiler can see is uniform in a warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---- producer warpgroup: one thread keeps the ring full
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      hopper::tma_prefetch_map(&tm_x);
      hopper::tma_prefetch_map(&tm_w);
      int st = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int e, m0, n0;
        tile_coords(t, tiles_m, tiles_n, e, m0, n0);
        for (int i = 0; i < nk; ++i) {
          const uint32_t full = full_bar + 8 * st;
          const uint32_t dst = base + st * L::stage;
          hopper::mbar_wait(empty_bar + 8 * st, phase ^ 1);
          hopper::mbar_arrive_expect_tx(full, L::stage);
          hopper::tma_load_4d(dst, &tm_x, full, i * kBK, m0, e, 0);
#pragma unroll
          for (int c = 0; c < kNB; ++c)
            hopper::tma_load_4d(dst + L::a_bytes + c * L::b_box, &tm_w, full,
                                n0 + c * kBox, i * kBK, e, 0);
          if (++st == kStages) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows 64 wg .. 64 wg + 63 of each tile
    hopper::reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const uint32_t out_s = base + L::out_off + wg * L::out_wg;
    uint8_t* out_tile = smem + L::out_off + wg * L::out_wg;
    // this thread's accumulator rows rl and rl + 8 of the warpgroup's 64;
    // both have the swizzle phase rl % 8
    const int rl = 16 * warp + lane / 4;
    const int sw = rl & 7;
    int st = 0;
    uint32_t phase = 0;
    float acc[kBN / 2];         // each tile's first product overwrites it
#pragma unroll
    for (int e2 = 0; e2 < kBN / 2; ++e2) acc[e2] = 0.0f;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int e, m0, n0;
      tile_coords(t, tiles_m, tiles_n, e, m0, n0);
      int prev = 0;
      for (int i = 0; i < nk; ++i) {
        hopper::mbar_wait(full_bar + 8 * st, phase);
        const uint32_t a_s = base + st * L::stage + wg * kWG * kRowBytes;
        const uint32_t b_s = base + st * L::stage + L::a_bytes;
        const uint64_t ad = hopper::opaque(hopper::desc_sw128(a_s, 16, 1024));
        const uint64_t bd = hopper::opaque(
            hopper::desc_sw128(b_s, L::b_box, 1024));
#pragma unroll
        for (int e2 = 0; e2 < kBN / 2; ++e2) hopper::fence_operand(acc[e2]);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          hopper::wgmma_m64n128k16_ss_tb(
              acc, hopper::desc_add(ad, kk * 32),
              hopper::desc_add(bd, kk * 16 * kRowBytes), i > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();          // the previous step's products
#pragma unroll
        for (int e2 = 0; e2 < kBN / 2; ++e2) hopper::fence_operand(acc[e2]);
        if (i > 0) hopper::mbar_arrive(empty_bar + 8 * prev);
        prev = st;
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int e2 = 0; e2 < kBN / 2; ++e2) hopper::fence_operand(acc[e2]);
      hopper::mbar_arrive(empty_bar + 8 * prev);

      // epilogue: once the previous tile's stores have read the buffer,
      // round once to bf16 into it (chunk j of row r at j ^ (r % 8), as
      // the output map's swizzle reads it), then one TMA store a box of
      // 64 columns, clipped to C and F by the map
      const int row0 = m0 + wg * kWG;
      if (tid == 0) hopper::tma_store_wait_read<0>();
      hopper::named_bar_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        uint8_t* chunk = out_tile + (j / 8) * L::out_box
            + (((j % 8) ^ sw) * 16) + (lane % 4) * 4;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * j],
                                                        acc[4 * j + 1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[4 * j + 2],
                                                        acc[4 * j + 3]);
        *reinterpret_cast<__nv_bfloat162*>(chunk + rl * kRowBytes) = lo;
        *reinterpret_cast<__nv_bfloat162*>(chunk + (rl + 8) * kRowBytes) =
            hi;
      }
      hopper::fence_proxy_async_smem();
      hopper::named_bar_sync(1 + wg, 128);
      if (tid == 0 && row0 < C) {
#pragma unroll
        for (int c = 0; c < kNB; ++c)
          if (n0 + c * kBox < F)
            hopper::tma_store_4d(&tm_out, out_s + c * L::out_box,
                                 n0 + c * kBox, row0, e, 0);
        hopper::tma_store_commit();
      }
    }
    if (tid == 0) hopper::tma_store_wait<0>();
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// one block per SM (at most one per tile) walks the tiles
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, cudaStream_t stream) {
  // x, w and out as 4-D tensors (innermost first, a unit axis last)
  CUtensorMap tx, tw, to;
  const uint64_t dx[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(C),
                          static_cast<uint64_t>(E), 1};
  const uint64_t dw[4] = {static_cast<uint64_t>(F), static_cast<uint64_t>(D),
                          static_cast<uint64_t>(E), 1};
  const uint64_t dout[4] = {static_cast<uint64_t>(F),
                            static_cast<uint64_t>(C),
                            static_cast<uint64_t>(E), 1};
  const uint32_t box_x[4] = {kBK, kBM, 1, 1};
  const uint32_t box_w[4] = {kBox, kBK, 1, 1};
  const uint32_t box_out[4] = {kBox, kWG, 1, 1};
  int rc = hopper::encode_tensor_map_bf16(&tx, x, 4, dx, box_x);
  if (rc == 0) rc = hopper::encode_tensor_map_bf16(&tw, w, 4, dw, box_w);
  if (rc == 0) rc = hopper::encode_tensor_map_bf16(&to, out, 4, dout, box_out);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = static_cast<int64_t>(E) * ((C + kBM - 1) / kBM)
      * ((F + kBN - 1) / kBN);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int blocks = tiles < sms ? static_cast<int>(tiles) : sms;
  gemm_tc<<<blocks, kThreads, kSmem, stream>>>(tx, tw, to, E, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 on the CUDA cores: TMA ring, producer warpgroup, persistent grid
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBM = 128;          // output rows per tile
constexpr int kBN = 128;          // output columns per tile
constexpr int kBK = 32;           // contraction step: one 128-byte x row
constexpr int kStages = 4;
constexpr int kConsumers = 256;   // 16 x 16 threads of 8 x 8 outputs
constexpr int kThreads = kConsumers + 128;
// as the tensor-core kernel's: 24 + 2 x 240 = 3 x 168
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory of one block, from a 1024-byte boundary: four 32 KB
// stages of [x box (128 rows x 32 values, 128-byte swizzle) | w box (32
// rows x 128 values, as they lie)], then the mbarriers full[kStages],
// empty[kStages]: 132,160 bytes with the alignment slack.
struct Layout {
  static constexpr uint32_t a_bytes = kBM * kBK * 4;
  static constexpr uint32_t b_bytes = kBK * kBN * 4;
  static constexpr uint32_t stage = a_bytes + b_bytes;
  static constexpr uint32_t bar_off = kStages * stage;
  static constexpr uint32_t bytes = bar_off + 16 * kStages
      + 1024;                                  // slack for the alignment
};
constexpr int kSmem = static_cast<int>(Layout::bytes);
static_assert(kBM == tc::kBM && kBN == tc::kBN,
              "the tiles are walked as the tensor-core kernel's");

__global__ void __launch_bounds__(kThreads, 1)
gemm_f32_tma(const __grid_constant__ CUtensorMap tm_x,
             const __grid_constant__ CUtensorMap tm_w,
             float* __restrict__ out, int E, int C, int D, int F) {
  using L = Layout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  const uint32_t full_bar = base + L::bar_off;
  const uint32_t empty_bar = full_bar + 8 * kStages;

  const int tiles_m = (C + kBM - 1) / kBM;
  const int tiles_n = (F + kBN - 1) / kBN;
  const int tiles = E * tiles_m * tiles_n;
  const int nk = (D + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full_bar + 8 * st, 1);
      hopper::mbar_init(empty_bar + 8 * st, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---- producer warpgroup: one thread keeps the ring full
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      hopper::tma_prefetch_map(&tm_x);
      hopper::tma_prefetch_map(&tm_w);
      int st = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int e, m0, n0;
        tc::tile_coords(t, tiles_m, tiles_n, e, m0, n0);
        for (int i = 0; i < nk; ++i) {
          const uint32_t full = full_bar + 8 * st;
          const uint32_t dst = base + st * L::stage;
          hopper::mbar_wait(empty_bar + 8 * st, phase ^ 1);
          hopper::mbar_arrive_expect_tx(full, L::stage);
          hopper::tma_load_4d(dst, &tm_x, full, i * kBK, m0, e, 0);
          hopper::tma_load_4d(dst + L::a_bytes, &tm_w, full, n0, i * kBK, e,
                              0);
          if (++st == kStages) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: thread (tx, ty) owns rows 4 ty + r and 64 + 4 ty + r
    // (r < 4) and columns 4 tx + c and 64 + 4 tx + c (c < 4) of each tile
    hopper::reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    int st = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int e, m0, n0;
      tc::tile_coords(t, tiles_m, tiles_n, e, m0, n0);
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      for (int i = 0; i < nk; ++i) {
        hopper::mbar_wait(full_bar + 8 * st, phase);
        // the x tile arrives swizzled: k values 4 q .. 4 q + 3 of row 4 ty +
        // r (or 64 + 4 ty + r) lie in chunk q ^ (r + 4 (ty % 2)) of the row.
        // For q = 4 kb + kl that is chunk (kl ^ r) + 4 (kb ^ (ty % 2)): one
        // base a half step, the rest immediate offsets
        const uint8_t* As = smem + st * L::stage + ty * 4 * 128;
        const float* Bs = reinterpret_cast<const float*>(
            smem + st * L::stage + L::a_bytes) + tx * 4;
#pragma unroll
        for (int kb = 0; kb < 2; ++kb) {
          const uint8_t* Ab = As + 64 * (kb ^ (ty & 1));
          const float* Bb = Bs + kb * 16 * kBN;
#pragma unroll
          for (int kl = 0; kl < 4; ++kl) {
            float a[8][4];
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const int row = r < 4 ? r : 64 + (r - 4);
              const float4 v = *reinterpret_cast<const float4*>(
                  Ab + row * 128 + ((kl ^ (r & 3)) << 4));
              a[r][0] = v.x;
              a[r][1] = v.y;
              a[r][2] = v.z;
              a[r][3] = v.w;
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float* brow = Bb + (kl * 4 + kk) * kBN;
              const float4 b0 = *reinterpret_cast<const float4*>(brow);
              const float4 b1 = *reinterpret_cast<const float4*>(brow + 64);
              const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                  b1.x, b1.y, b1.z, b1.w};
#pragma unroll
              for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int c = 0; c < 8; ++c)
                  acc[r][c] = fmaf(a[r][kk], b[c], acc[r][c]);
            }
          }
        }
        hopper::mbar_arrive(empty_bar + 8 * st);
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
      }
      // epilogue: straight from the registers, rows < C and columns < F
      // (F % 4 == 0: a 16-byte store is all in or all out); the next
      // tile's loads are in flight meanwhile
      float* oe = out + static_cast<int64_t>(e) * C * F;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int m = m0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + (r - 4));
        if (m >= C) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n = n0 + hh * 64 + tx * 4;
          if (n < F)
            *reinterpret_cast<float4*>(oe + static_cast<int64_t>(m) * F + n)
                = make_float4(acc[r][4 * hh], acc[r][4 * hh + 1],
                              acc[r][4 * hh + 2], acc[r][4 * hh + 3]);
        }
      }
    }
  }
}

int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, cudaStream_t stream) {
  // x and w as 4-D tensors (innermost first, a unit axis last): x in boxes
  // of 32 k values x 128 rows (swizzled), w in boxes of 128 columns x 32
  // k rows (as they lie)
  CUtensorMap tx, tw;
  const uint64_t dx[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(C),
                          static_cast<uint64_t>(E), 1};
  const uint64_t dw[4] = {static_cast<uint64_t>(F), static_cast<uint64_t>(D),
                          static_cast<uint64_t>(E), 1};
  const uint32_t box_x[4] = {kBK, kBM, 1, 1};
  const uint32_t box_w[4] = {kBN, kBK, 1, 1};
  int rc = hopper::encode_tensor_map_f32(&tx, x, 4, dx, box_x, true);
  if (rc == 0) rc = hopper::encode_tensor_map_f32(&tw, w, 4, dw, box_w, false);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_f32_tma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = static_cast<int64_t>(E) * ((C + kBM - 1) / kBM)
      * ((F + kBN - 1) / kBN);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = tc::sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int blocks = tiles < sms ? static_cast<int>(tiles) : sms;
  gemm_f32_tma<<<blocks, kThreads, kSmem, stream>>>(
      tx, tw, static_cast<float*>(out), E, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// dtype: 0 = float32, 1 = bfloat16.  x: (E, C, D); w: (E, D, F); out:
// (E, C, F); contiguous, all of one dtype.
extern "C" int expert_gemm_fwd(const void* x, const void* w, void* out,
                               int dtype, int E, int C, int D, int F,
                               void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gemm_f32<<<grid, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
        static_cast<float*>(out), C, D, F,
        int(D % 4 == 0 && aligned16(x)), int(F % 4 == 0 && aligned16(w)),
        int(F % 4 == 0 && aligned16(out)));
  } else if (dtype == 1) {
    gemm_bf16<<<grid, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
        static_cast<__nv_bfloat16*>(out), C, D, F,
        int(D % 8 == 0 && aligned16(x)), int(F % 8 == 0 && aligned16(w)),
        int(F % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* expert_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bf16 only; D % 8 == 0, F % 8 == 0; x, w and out 16-byte aligned.  x: (E,
// C, D); w: (E, D, F); out: (E, C, F); contiguous.
extern "C" int expert_gemm_tc_fwd(const void* x, const void* w, void* out,
                                  int E, int C, int D, int F, void* stream) {
  if (E < 1 || C < 1 || D < 8 || F < 8 || D % 8 != 0 || F % 8 != 0
      || !aligned16(x) || !aligned16(w) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch(x, w, out, E, C, D, F,
                    static_cast<cudaStream_t>(stream));
}

// registers a thread at launch, local memory (spills) and dynamic shared
// memory of the tensor-core kernel: 168 registers (the entry count of a
// 384-thread block) and no local memory on an NVIDIA H100 80GB HBM3
extern "C" int expert_gemm_tc_attributes(int* regs, int* local_bytes,
                                         int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, tc::gemm_tc);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = tc::kSmem;
  return 0;
}

// float32 only; D % 4 == 0, F % 4 == 0; x, w and out 16-byte aligned.  x:
// (E, C, D); w: (E, D, F); out: (E, C, F); contiguous.
extern "C" int expert_gemm_f32_fwd(const void* x, const void* w, void* out,
                                   int E, int C, int D, int F,
                                   void* stream) {
  if (E < 1 || C < 1 || D < 4 || F < 4 || D % 4 != 0 || F % 4 != 0
      || !aligned16(x) || !aligned16(w) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  return f32::launch(x, w, out, E, C, D, F,
                     static_cast<cudaStream_t>(stream));
}

// registers a thread at launch, local memory (spills) and dynamic shared
// memory of the TMA-fed float32 kernel
extern "C" int expert_gemm_f32_attributes(int* regs, int* local_bytes,
                                          int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f32::gemm_f32_tma);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = f32::kSmem;
  return 0;
}
