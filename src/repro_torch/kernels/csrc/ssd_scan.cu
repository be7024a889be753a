// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// together with its layout adapter repro/kernels/ops.py::ssd_scan: it reads
// the chunked oracle layout directly, xs (B, NC, Q, H, P), a (B, NC, Q, H),
// bm and cm (B, NC, Q, N), and writes y (B, NC, Q, H, P) and the final state
// (B, H, P, N), all float32.  Per (b, h) the chunks run in order from a zero
// state S (P x N); per chunk, with acum the cumulative sum of a over the
// chunk and L[i, j] = exp(acum_i - acum_j) for j <= i (else 0):
//
//   y     = ((C Bᵀ) ∘ L) X + exp(acum) ∘ (C Sᵀ)
//   S_out = S exp(acum_last) + Xᵀ (B ∘ exp(acum_last - acum))
//
// all in float32 (no TF32), as the TPU kernel.
//
// What bounds it on this card: at mamba2-780m's prefill shape (B 4, 1024
// tokens = 8 chunks of Q 128, H 48, P 64, N 128) the function moves about
// 112 MB (34 us at 3.35 TB/s) and needs about 8 GFLOP of float32 work (120
// us on the CUDA cores at 67 TFLOP/s), so it is bound by operations.  C Bᵀ
// does not depend on the head; this kernel recomputes it per head (over 40 %
// of its multiply-adds), which a later design sharing it across heads
// removes.
//
// Design.  On the TPU the chunk axis is a sequential grid axis with the
// state in VMEM scratch.  Here blocks run in no order, so one block of 256
// threads owns a (b, h, 64-column tile of P) slice — state columns p are
// independent — and loops over the chunks itself, the (P-tile x N) state in
// shared memory the whole time.  A chunk's X, B and C (32 + 64 + 64 KB at
// mamba2's shape) are staged in shared memory; the Q x Q matrix (C Bᵀ) ∘ L
// (64 KB) would not fit beside them in the 227 KB a block may have, so it is
// built and used in blocks of 32 rows.  Each of the four products is a
// register-tiled loop over shared memory: the 16 x 16 threads each own a
// strided (rows ty + 16 r, columns tx + 16 c) micro-tile, and every row is
// padded by one float so that both row and column walks are free of bank
// conflicts.  Entries j > i of (C Bᵀ) ∘ L are set to 0 by selection, never
// exp() of a positive argument times 0.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kMaxQ = 128;      // chunk length
constexpr int kMaxN = 128;      // state size
constexpr int kPT = 64;         // columns of P per block
constexpr int kGR = 32;         // rows of (C Bᵀ) ∘ L built at once

// acc[r][c] += sum_k A(k, m_r) B(k, n_c) (times fac[k] if kScaleA), with
// A(k, m) = A[m * sam + k * sak], B(k, n) = B[n * sbn + k * sbk],
// m_r = ty + 16 r, n_c = tx + 16 c.  Rows and columns past m_lim / n_lim
// read the last valid one; the caller discards those sums.
template <int RM, int RN, bool kScaleA>
__device__ __forceinline__ void tile_product(
    float (&acc)[RM][RN], const float* A, int sak, int sam, int m_lim,
    const float* B, int sbk, int sbn, int n_lim, int K, int ty, int tx,
    const float* fac) {
  int ao[RM], bo[RN];
#pragma unroll
  for (int r = 0; r < RM; ++r) ao[r] = min(ty + 16 * r, m_lim - 1) * sam;
#pragma unroll
  for (int c = 0; c < RN; ++c) bo[c] = min(tx + 16 * c, n_lim - 1) * sbn;
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[RN];
    const float f = kScaleA ? fac[k] : 1.0f;
#pragma unroll
    for (int r = 0; r < RM; ++r) av[r] = A[ao[r] + k * sak] * f;
#pragma unroll
    for (int c = 0; c < RN; ++c) bv[c] = B[bo[c] + k * sbk];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xs, const float* __restrict__ a,
                const float* __restrict__ bm, const float* __restrict__ cm,
                float* __restrict__ y, float* __restrict__ state, int NC,
                int Q, int H, int P, int N) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int p0 = blockIdx.y * kPT;
  const int pt = min(kPT, P - p0);
  const int ldx = pt + 1, ldn = N + 1, ldq = Q + 1;
  float* xsm = smem;               // (Q, pt)  X of the chunk, this tile's p
  float* bsm = xsm + Q * ldx;      // (Q, N)   B of the chunk
  float* csm = bsm + Q * ldn;      // (Q, N)   C of the chunk
  float* ssm = csm + Q * ldn;      // (pt, N)  the carried state S
  float* gsm = ssm + pt * ldn;     // (kGR, Q) rows of (C Bᵀ) ∘ L
  float* acum = gsm + kGR * ldq;   // (Q)      cumulative log-decay
  float* dec = acum + Q;           // (Q)      exp(acum_last - acum)

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  for (int e = tid; e < pt * ldn; e += kThreads) ssm[e] = 0.0f;

  for (int c = 0; c < NC; ++c) {
    __syncthreads();               // the previous chunk is done with smem
    const int64_t row0 = (static_cast<int64_t>(b) * NC + c) * Q;
    for (int e = tid; e < Q * pt; e += kThreads) {
      const int i = e / pt, p = e % pt;
      xsm[i * ldx + p] = xs[((row0 + i) * H + h) * P + p0 + p];
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N, n = e % N;
      bsm[i * ldn + n] = bm[(row0 + i) * N + n];
      csm[i * ldn + n] = cm[(row0 + i) * N + n];
    }
    for (int i = tid; i < Q; i += kThreads) acum[i] = a[(row0 + i) * H + h];
    __syncthreads();
    if (tid == 0) {                // in order, as a cumulative sum
      float run = 0.0f;
      for (int i = 0; i < Q; ++i) {
        run += acum[i];
        acum[i] = run;
      }
    }
    __syncthreads();
    const float a_tot = acum[Q - 1];
    for (int i = tid; i < Q; i += kThreads) dec[i] = expf(a_tot - acum[i]);

    for (int i0 = 0; i0 < Q; i0 += kGR) {
      const int gr = min(kGR, Q - i0);   // rows i0 .. i0 + gr - 1
      const int jn = i0 + gr;            // they see keys j < jn
      {
        float g[kGR / 16][kMaxQ / 16] = {};
        tile_product<kGR / 16, kMaxQ / 16, false>(
            g, csm + i0 * ldn, 1, ldn, gr, bsm, 1, ldn, jn, N, ty, tx,
            nullptr);
#pragma unroll
        for (int r = 0; r < kGR / 16; ++r)
#pragma unroll
          for (int cc = 0; cc < kMaxQ / 16; ++cc) {
            const int ii = ty + 16 * r, j = tx + 16 * cc;
            if (ii < gr && j < jn) {
              const int i = i0 + ii;
              gsm[ii * ldq + j] =
                  j <= i ? g[r][cc] * expf(acum[i] - acum[j]) : 0.0f;
            }
          }
      }
      __syncthreads();
      {
        float yd[kGR / 16][kPT / 16] = {};
        float yo[kGR / 16][kPT / 16] = {};
        tile_product<kGR / 16, kPT / 16, false>(
            yd, gsm, 1, ldq, gr, xsm, ldx, 1, pt, jn, ty, tx, nullptr);
        tile_product<kGR / 16, kPT / 16, false>(
            yo, csm + i0 * ldn, 1, ldn, gr, ssm, 1, ldn, pt, N, ty, tx,
            nullptr);
#pragma unroll
        for (int r = 0; r < kGR / 16; ++r)
#pragma unroll
          for (int cc = 0; cc < kPT / 16; ++cc) {
            const int ii = ty + 16 * r, p = tx + 16 * cc;
            if (ii < gr && p < pt) {
              const int i = i0 + ii;
              y[((row0 + i) * H + h) * P + p0 + p] =
                  yd[r][cc] + yo[r][cc] * expf(acum[i]);
            }
          }
      }
      __syncthreads();             // gsm is rebuilt for the next rows
    }

    float upd[kPT / 16][kMaxN / 16] = {};
    tile_product<kPT / 16, kMaxN / 16, true>(
        upd, xsm, ldx, 1, pt, bsm, ldn, 1, N, Q, ty, tx, dec);
    const float keep = expf(a_tot);
#pragma unroll
    for (int r = 0; r < kPT / 16; ++r)
#pragma unroll
      for (int cc = 0; cc < kMaxN / 16; ++cc) {
        const int p = ty + 16 * r, n = tx + 16 * cc;
        if (p < pt && n < N)
          ssm[p * ldn + n] = ssm[p * ldn + n] * keep + upd[r][cc];
      }
  }
  __syncthreads();
  for (int e = tid; e < pt * N; e += kThreads) {
    const int p = e / N, n = e % N;
    state[((static_cast<int64_t>(b) * H + h) * P + p0 + p) * N + n] =
        ssm[p * ldn + n];
  }
}

// Bytes of dynamic shared memory one block needs (0 if Q or N is too large).
int64_t smem_bytes(int Q, int P, int N) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || P < 1) return 0;
  const int pt = P < kPT ? P : kPT;
  const int64_t floats = static_cast<int64_t>(Q) * (pt + 1)
      + 2LL * Q * (N + 1) + static_cast<int64_t>(pt) * (N + 1)
      + static_cast<int64_t>(kGR) * (Q + 1) + 2LL * Q;
  return floats * static_cast<int64_t>(sizeof(float));
}

}  // namespace

extern "C" int ssd_scan_fwd(const void* xs, const void* a, const void* bm,
                            const void* cm, void* y, void* state, int B,
                            int NC, int Q, int H, int P, int N,
                            void* stream) {
  const int64_t smem = smem_bytes(Q, P, N);
  if (smem == 0 || NC < 1 || B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (P + kPT - 1) / kPT);
  ssd_scan_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(a),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<float*>(y), static_cast<float*>(state), NC, Q, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
