// Grouped (per-expert) GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/expert_gemm.py::expert_gemm:
//
//   out[e] = x[e] @ w[e],   x (E, C, D), w (E, D, F) -> out (E, C, F)
//
// the compute core of the MoE layer after dispatch (three calls per layer:
// wi, wg, then wo on silu(g) * h).  float32 or bfloat16 in, both of one
// type; sums in float32, the output written in x's type, rounded once.  Any
// C, D and F >= 1: ragged tiles are masked (the TPU kernel asserts that
// its blocks divide the shape), and every offset is 64-bit.
//
// What bounds it on this card: at granite-moe-1b-a400m's prefill shape (E
// 32, C 1280 slots, D 1024, F 512, bf16) one call moves 159.4 MB (47.6 us
// at 3.35 TB/s) and does 42.9 GFLOP (43.4 us on the bf16 tensor cores), so
// a kernel near the roofline is balanced between the two.  In float32 the
// same work takes at least 641 us on the CUDA cores at 67 TFLOP/s (the TPU
// kernel's contract is float32 products, so no TF32).
//
// Design.  On the TPU the contraction axis is a sequential grid axis with a
// (bc, bf) float32 accumulator in VMEM scratch.  Here one block of 256
// threads owns one (expert, 128 x 128 output tile) and walks D itself in
// steps of 32, the accumulator in registers.  The x and w tiles of a step
// are fetched with 16-byte global loads into registers while the block
// computes on the previous step's tiles in shared memory, then stored
// (software prefetch; no cp.async or TMA yet).  A chunk that runs past D or
// F, or rows whose length is not a multiple of 16 bytes, are read one
// element at a time and padded with zeros.
//
// - float32: the x tile is stored transposed (k-major), so each thread
//   reads 4 + 4 rows and 4 + 4 columns with four 16-byte shared-memory
//   loads per k and keeps an 8 x 8 register tile (64 FMAs per k).
// - bfloat16: mma.sync m16n8k16 (bf16 x bf16 -> fp32) on the tensor cores.
//   A product of two bf16 values is exact in fp32, so this keeps the TPU
//   kernel's contract.  Eight warps as 2 x 4, each a 64 x 32 warp tile of
//   4 x 4 fragments; fragments are read with ldmatrix (the w tile with
//   .trans), rows padded by 16 bytes so that the eight row addresses of
//   each 8 x 8 matrix fall in distinct banks.  wgmma, TMA and a multi-stage
//   pipeline are later work.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
