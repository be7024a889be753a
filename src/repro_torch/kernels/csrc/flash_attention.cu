// Flash attention (online softmax) for Hopper (sm_90a).
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
// running max starts at -1e30, the running sum l is clamped at 1e-30.
//
// What bounds it on this card: at the serving shapes (S = 1024, D = 64,
// bf16) the function moves 4 B S H D 2 bytes (10 us at 3.35 TB/s) and does
// 4 B H D S(S+1)/2 flops (8.7 us on bf16 tensor cores), so a kernel on the
// tensor cores would be near balanced.  This first kernel computes on the
// float32 CUDA cores (67 TFLOP/s: >= 128 us at that shape); its inner
// loops issue one 16-byte shared-memory load per four multiply-adds, and
// the four lanes of a row each compute the row's exps.  wgmma tiles, TMA
// loads and warp specialisation are later work.
//
// Design.  One block of 256 threads per (batch x head, tile of 64 query
// rows).  Four neighbouring lanes own one query row: lane l holds the
// 16-byte chunks l, l + 4, l + 8, ... of the row's q and of its output
// accumulator in registers, so a score is 4 partial dot products joined by
// two shuffles, and the four lanes of a row read one 64-byte run of a key
// row with 16-byte loads (the other rows of the warp read the same run:
// a broadcast, no bank conflict).  The block walks the key/value tiles (BK
// rows, staged in shared memory as float32, rows padded to a multiple of
// 4 with zeros) that the mask can reach: from the first tile inside the
// window to the last tile on or below the causal diagonal; tiles wholly
// above the diagonal or wholly outside the window are never loaded, as the
// TPU kernel skips them.  Within a tile a row takes 16 keys at a time: 16
// scores into registers, their max, one rescale of its accumulator and
// sum, then 16 updates p_j v_j.  The ragged edge of the last tile (S not a
// multiple of BK) and query rows past S are masked.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
