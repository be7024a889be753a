// Mamba2 SSD chunk scan for Hopper (sm_90a), as three stage kernels.
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
// all in float32 on the CUDA cores (no TF32), as the TPU kernel.
//
// What bounds it on this card: at mamba2-780m's prefill shape (B 4, 1024
// tokens = 8 chunks of Q 128, H 48, P 64, N 128) the function moves about
// 112 MB (34 us at 3.35 TB/s) and needs about 8 GFLOP of float32 work (120
// us on the CUDA cores at 67 TFLOP/s), so it is bound by operations.
//
// Design.  On the TPU the chunk axis is a sequential grid axis with the
// state in VMEM scratch.  Here the scan is split as arXiv:2405.21060 §6
// splits it, so that only a cheap elementwise pass is sequential, in
// three launches on the caller's stream:
//
//   1. ssd_chunk_state_kernel, per (b, chunk, h) unit: acum by a warp scan,
//      and the chunk's local final state Xᵀ (B ∘ exp(acum_last - acum)),
//      stored transposed (N x P) into a (B, NC, H, N, P) workspace, and
//      acum_last into a (B, NC, H) one.
//   2. ssd_state_pass_kernel, per (b, h) and 32 x 32 state elements: over
//      the chunks in order, S_c <- S_{c-1} exp(acum_last) + local_c,
//      writing the state entering each chunk over its local state, and the
//      final state through a shared-memory transpose; each thread has
//      eight chunks' loads in flight.  Its first blocks build Gᵀ = B Cᵀ
//      (C Bᵀ transposed) in 32 x 32 tiles on and above the diagonal, and
//      Cᵀ, per (b, chunk) into (B, NC, Q, Q) and (B, NC, N, Q) workspaces
//      (2 MB each at mamba2's shape, resident in L2): neither depends on
//      the head, so each is built once for all H, and these products
//      overlap the pass's memory traffic.
//   3. ssd_chunk_out_kernel, per unit: the whole output in one pass,
//      y = exp(acum) ∘ (C S_inᵀ) + ((C Bᵀ) ∘ L) X.
//
// Building Gᵀ in shared memory instead, in each block of stage 3 for a
// group of heads, ran 1.57-1.67x slower (PERF.md §6).
//
// Stages 1 and 3 are products of 128 x 64 output tiles by 128-thread
// blocks, four consecutive units a block (one wave of 384 blocks at
// mamba2's shape), the units' slabs through one pipeline: each thread owns
// an 8 x 8 micro-tile (two 4-row groups, two 4-column groups) and per step
// of the sum reads its operands as four float4 from shared memory, both
// sides stored k-major (a row of the tile per step of the sum), rows
// padded to keep float4 alignment.  The operands arrive in slabs of 32
// steps by cp.async (16 bytes a copy where the rows allow), zero-filled
// past the edges, into two buffers: the next slab's copies fly while this
// one's products run (57 KB a block, three blocks an SM).  Addresses that
// do not change across the loop are hidden from the compiler (opaque), so
// that it recomputes them rather than keep them in registers the 64
// accumulators need: at 168 registers nothing spills.  Row groups are
// dealt so that each warp holds rows from both ends of the tile: the
// causal triangle then gives every warp the same work over a unit.  No
// float atomics: two calls give the same bits.
//
// Precision and overflow: every exponent is a difference <= 0 (acum_i -
// acum_j for j <= i, acum_last - acum, acum; clamped at 0), never
// exp(-acum) that a product absorbs later: in mamba2 acum reaches -6,400
// over a chunk.  acum is kept as an unevaluated sum hi + lo (each step
// added by TwoSum), so that acum_i - acum_j keeps float32's relative
// precision when both are large and their difference is not: a plain
// float32 acum of -6,400 is off by 5e-4 there, which exp() turns into a
// relative error of 5e-4 on the entries of L that matter.  L factors
// through each 32-row slab's last row for the rows below the slab (two
// exponents <= 0), so exp() runs entry by entry only on the slab's own
// 32 x 32 block, spread over all four warps.  Entries above the diagonal
// are 0 by selection.  Padded rows (a = 0, x = 0) leave the state
// unchanged.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// does not synchronise, allocates nothing (the caller passes the
// workspaces), and returns the first launch error.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps; 8 x 8 accumulators a thread
constexpr int kMinBlocks = 3;   // blocks an SM: at most 168 registers
constexpr int kTX = 8;          // lanes across the columns
constexpr int kGroup = 16;      // rows of a warp's row group
constexpr int kMaxQ = 128;      // chunk length
constexpr int kMaxN = 128;      // state size
constexpr int kTM = 128;        // rows of a block's output tile
constexpr int kTN = 64;         // columns of a block's output tile
constexpr int kTK = 32;         // steps of the sum per staged slab
constexpr int kStages = 2;      // slab buffers: kStages - 1 slabs in flight
                                // (deeper, with 16-step slabs, ran slower)
constexpr int kLdA = kTM + 4;   // padded rows, 16-byte multiples
constexpr int kLdB = kTN + 4;
constexpr int kUnits = 4;       // (b, chunk, h) units a product block
constexpr int kCbTile = 32;     // C Bᵀ in 32 x 32 tiles, B and C
constexpr int kCbSlice = 64;    // staged 64 columns at a time
constexpr int kPassTile = 32;   // state pass: 32 x 32 elements a block
constexpr int kPassThreads = kPassTile * kPassTile / 4;   // a float4 each
static_assert(kPassThreads == 8 * kCbTile, "a C Bᵀ block: 4 outputs a "
              "thread");
constexpr int kPassAhead = 8;   // chunks a state-pass thread loads at once

// Two buffers of operand slabs, then the cumulative sums.
struct Pipe {
  float a[kStages][kTK * kLdA];
  float b[kStages][kTK * kLdB];
};
struct Acum {
  float hi[kMaxQ];
  float lo[kMaxQ];
};
constexpr int kGemmSmem = static_cast<int>(
    sizeof(Pipe) + kUnits * (sizeof(Acum) + kMaxQ * sizeof(float)));

// hopper::opaque for a pointer or an int64_t: what is derived from the
// value is computed where it is used, not hoisted out of a loop into
// registers that the accumulators need.
template <class T>
__device__ __forceinline__ T* opaque(T* p) {
  return reinterpret_cast<T*>(hopper::opaque(reinterpret_cast<uint64_t>(p)));
}
__device__ __forceinline__ int64_t opaque(int64_t x) {
  return static_cast<int64_t>(hopper::opaque(static_cast<uint64_t>(x)));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the kStages - 1 newest groups of this thread's copies have
// landed: the slab to use now has (one group a slab)
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// sm[k][m] <- src[(k0 + k) * lds + m] for k0 + k < kn, m < mn, else 0: a
// slab of a (steps k, columns m) source, W columns; 16 bytes a copy where
// the rows allow.
template <int W, int LD>
__device__ __forceinline__ void load_rows(float* sm, const float* src,
                                          int64_t lds, int k0, int kn,
                                          int mn, int tid) {
  src = opaque(src);         // its offsets are recomputed at each slab
  lds = opaque(lds);
  if ((lds & 3) == 0 && (mn & 3) == 0
      && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll 4
    for (int e = 4 * tid; e < kTK * W; e += 4 * kThreads) {
      const int k = e / W, m = e % W;
      const bool v = k0 + k < kn && m < mn;
      cp_async16(sm + k * LD + m, v ? src + (k0 + k) * lds + m : src, v);
    }
    return;
  }
#pragma unroll 4
  for (int e = tid; e < kTK * W; e += kThreads) {
    const int k = e / W, m = e % W;
    const bool v = k0 + k < kn && m < mn;
    cp_async4(sm + k * LD + m, v ? src + (k0 + k) * lds + m : src, v);
  }
}

// The two row groups of the tile that warp w owns: rows kGroup w .. and
// 128 - kGroup (w + 1) .., so that every warp has rows near both ends.
__device__ __forceinline__ int group_row(int warp, int g) {
  return g == 0 ? kGroup * warp : kTM - kGroup * (warp + 1);
}

// A thread's place in its warp: 4 rows of 4-row blocks, kTX columns of
// 4-column blocks.
struct Lane {
  int warp, ty, tx;
  __device__ explicit Lane(int tid)
      : warp(tid / 32), ty((tid % 32) / kTX), tx(tid % kTX) {}
  // row of accumulator row r (0..7), column of accumulator column c
  __device__ int row(int r) const {
    return group_row(warp, r >> 2) + 4 * ty + (r & 3);
  }
  __device__ int col(int c) const {
    return 4 * tx + (c & 3) + 4 * kTX * (c >> 2);
  }
};

using Acc = float[8][8];

// acc += sa(k, rows)ᵀ sb(k, cols) over one slab: sa is kTK x kLdA, sb is
// kTK x kLdB, both k-major.  G0 / G1: whether the row groups take part.
template <bool G0, bool G1>
__device__ __forceinline__ void mma_slab(Acc& acc, const float* sa,
                                         const float* sb, Lane ln) {
  const float* pa0 = sa + group_row(ln.warp, 0) + 4 * ln.ty;
  const float* pa1 = sa + group_row(ln.warp, 1) + 4 * ln.ty;
  const float* pb = sb + 4 * ln.tx;
#pragma unroll 4
  for (int k = 0; k < kTK; ++k) {
    float bv[8];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(pb + k * kLdB
                                                        + 4 * kTX * g);
      bv[4 * g] = v.x;
      bv[4 * g + 1] = v.y;
      bv[4 * g + 2] = v.z;
      bv[4 * g + 3] = v.w;
    }
    if (G0) {
      const float4 a0 = *reinterpret_cast<const float4*>(pa0 + k * kLdA);
      const float av[4] = {a0.x, a0.y, a0.z, a0.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    if (G1) {
      const float4 a1 = *reinterpret_cast<const float4*>(pa1 + k * kLdA);
      const float av[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[4 + r][c] = fmaf(av[r], bv[c], acc[4 + r][c]);
    }
  }
}

__device__ __forceinline__ void mma_groups(Acc& acc,
                                           const float* sa, const float* sb,
                                           bool g0, bool g1, Lane ln) {
  if (g0 && g1) mma_slab<true, true>(acc, sa, sb, ln);
  else if (g0) mma_slab<true, false>(acc, sa, sb, ln);
  else if (g1) mma_slab<false, true>(acc, sa, sb, ln);
}

// Store acc to dst[row * ld + col] for row < rn, col < cn; 16-byte stores
// where ld and dst allow.
__device__ __forceinline__ void store_tile(float* dst, int64_t ld, int rn,
                                           int cn, const Acc& acc, Lane ln) {
  dst = opaque(dst);         // its 16 offsets are not kept in registers
  ld = opaque(ld);           // across the products
  const bool vec = ((ld & 3) == 0)
      && ((reinterpret_cast<uintptr_t>(dst) & 15) == 0);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = ln.row(r);
    if (row >= rn) continue;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = ln.col(4 * g);
      float* out = dst + row * ld + col;
      if (vec && col + 3 < cn) {
        *reinterpret_cast<float4*>(out) = make_float4(
            acc[r][4 * g], acc[r][4 * g + 1], acc[r][4 * g + 2],
            acc[r][4 * g + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < cn) out[c] = acc[r][4 * g + c];
      }
    }
  }
}

// s + e == a + b exactly (Knuth's TwoSum; no reassociation, no FMA).
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// acum_i = a_0 + ... + a_i over the chunk (a_i at src[i * stride]), i <
// Q <= 128, as hi + lo, by one whole warp: each lane sums 4 consecutive
// entries in order, then the lanes' sums are scanned across the warp.
__device__ __forceinline__ void chunk_cumsum(const float* src, int64_t stride,
                                             int Q, Acum& ac, int lane) {
  float ph[4], pl[4], h = 0.0f, l = 0.0f, s, e;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * lane + k;
    two_sum(h, i < Q ? src[i * stride] : 0.0f, s, e);
    h = s;
    l += e;
    ph[k] = h;
    pl[k] = l;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float th = __shfl_up_sync(0xffffffffu, h, off);
    const float tl = __shfl_up_sync(0xffffffffu, l, off);
    if (lane >= off) {
      two_sum(th, h, s, e);
      h = s;
      l = (l + tl) + e;
    }
  }
  float xh = __shfl_up_sync(0xffffffffu, h, 1);
  float xl = __shfl_up_sync(0xffffffffu, l, 1);
  if (lane == 0) xh = xl = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * lane + k;
    if (i < Q) {
      two_sum(xh, ph[k], s, e);
      ac.hi[i] = s;
      ac.lo[i] = (xl + pl[k]) + e;
    }
  }
}

// exp(acum_i - acum_j), the difference taken on hi and lo apart.
__device__ __forceinline__ float decay_between(const Acum& ac, int i, int j) {
  return expf(fminf((ac.hi[i] - ac.hi[j]) + (ac.lo[i] - ac.lo[j]), 0.0f));
}

// The shared memory of a product block: the operand slabs, then per unit
// its acum and one more row of kMaxQ (exp(acum_last - acum) in stage 1,
// the pivot factors of L in stage 3).
struct Units {
  Acum* ac;
  float* row;
  __device__ explicit Units(float* smem)
      : ac(reinterpret_cast<Acum*>(smem + sizeof(Pipe) / sizeof(float))),
        row(reinterpret_cast<float*>(ac + kUnits)) {}
};

// Warp w scans the chunk of unit u0 + w, for w < nu; then the block
// synchronises.
__device__ __forceinline__ void scan_units(const float* a, int u0, int nu,
                                           int H, int Q, Acum* ac, Lane ln,
                                           int tid) {
  if (ln.warp < nu) {
    const int unit = u0 + ln.warp;
    chunk_cumsum(a + static_cast<int64_t>(unit / H) * Q * H + unit % H, H, Q,
                 ac[ln.warp], tid % 32);
  }
  __syncthreads();
}

// Stage 1: for kUnits consecutive units (b, c, h) a block,
// states[b, c, h] (N x P) = Bᵀ (X ∘ exp(acum_last - acum)), the chunk's
// local final state, transposed; alast[b, c, h] = acum_last.  The units'
// slabs run through one pipeline.  Grid (ceil(units / kUnits), ceil(P /
// 64)).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_chunk_state_kernel(const float* __restrict__ xs,
                       const float* __restrict__ a,
                       const float* __restrict__ bm,
                       float* __restrict__ states, float* __restrict__ alast,
                       int units, int H, int Q, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  Pipe& pp = *reinterpret_cast<Pipe*>(smem);
  const Units us(smem);
  const int tid = threadIdx.x;
  const Lane ln(tid);
  const int u0 = blockIdx.x * kUnits, nu = min(kUnits, units - u0);
  const int p0 = blockIdx.y * kTN, pn = min(kTN, P - p0);
  const int64_t ldx = static_cast<int64_t>(H) * P;
  const int per = (Q + kTK - 1) / kTK;      // slabs a unit
  const int slabs = nu * per;
  auto fetch = [&](int s) {
    const int unit = u0 + s / per;
    const int64_t bc = unit / H;
    const int k0 = (s % per) * kTK;
    load_rows<kTM, kLdA>(pp.a[s % kStages], bm + bc * Q * N, N, k0, Q, N,
                         tid);
    load_rows<kTN, kLdB>(pp.b[s % kStages],
                         xs + (bc * Q * H + unit % H) * P + p0, ldx, k0, Q,
                         pn, tid);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < slabs) fetch(t);
    cp_commit();
  }                              // flies during the scans
  scan_units(a, u0, nu, H, Q, us.ac, ln, tid);
  for (int e = tid; e < nu * kMaxQ; e += kThreads) {
    const int w = e / kMaxQ, i = e % kMaxQ;
    us.row[e] = i < Q ? decay_between(us.ac[w], Q - 1, i) : 0.0f;
  }
  if (blockIdx.y == 0 && tid < nu)
    alast[u0 + tid] = us.ac[tid].hi[Q - 1] + us.ac[tid].lo[Q - 1];
  Acc acc = {};
  for (int s = 0; s < slabs; ++s) {
    if (s + kStages - 1 < slabs) fetch(s + kStages - 1);
    cp_commit();
    cp_wait_prev();
    __syncthreads();                        // slab s and the rows are in
    // X ∘ exp(acum_last - acum): a thread scales one column, every
    // (kThreads / kTN)-th row, at fixed offsets from one address
    float* sb = pp.b[s % kStages];
    {
      const int k1 = tid / kTN, q0 = (s % per) * kTK + k1;
      float* col = sb + k1 * kLdB + tid % kTN;
      const float* dec = us.row + (s / per) * kMaxQ + q0;
      constexpr int kStep = kThreads / kTN;
#pragma unroll
      for (int t = 0; t < kTK / kStep; ++t)
        col[t * kStep * kLdB] *= q0 + t * kStep < Q ? dec[t * kStep] : 0.0f;
    }
    __syncthreads();
    mma_slab<true, true>(acc, pp.a[s % kStages], sb, ln);
    if (s % per == per - 1) {               // the unit's last slab
      store_tile(states + static_cast<int64_t>(u0 + s / per) * N * P + p0, P,
                 N, pn, acc, ln);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
    }
    __syncthreads();                        // the buffer is free
  }
}

// C Bᵀ, in the first blocks of stage 2's launch: for (b, c) = bc and
// the pair-th 32 x 32 tile on or above the diagonal of Gᵀ = B Cᵀ (C Bᵀ
// transposed; rows j <= columns i: the only ones stage 3 reads), cbt[b, c]
// (Q x Q), and with the tiles of row 0, ct[b, c] = Cᵀ (N x Q).  The pairs
// (tj <= ti) of T = ceil(Q / 32) tiles are numbered T (T + 1) / 2.
__device__ __forceinline__ void cb_block(float* buf, const float* bm,
                                         const float* cm, float* cbt,
                                         float* ct, int64_t bc, int pair,
                                         int Q, int N) {
  float (*bs)[kCbSlice + 1] = reinterpret_cast<float (*)[kCbSlice + 1]>(buf);
  float (*cs)[kCbSlice + 1] = bs + kCbTile;
  int tj = pair, ti = 0;
  while (tj > ti) tj -= ++ti;
  const int j0 = tj * kCbTile, i0 = ti * kCbTile;
  const float* bsrc = bm + bc * Q * N;
  const float* csrc = cm + bc * Q * N;
  const int jj = threadIdx.x / 8, ii = 4 * (threadIdx.x % 8);
  float acc[4] = {};
  for (int n0 = 0; n0 < N; n0 += kCbSlice) {    // N in slices of 64
    const int nn = min(kCbSlice, N - n0);
    __syncthreads();                             // the last slice is used
    for (int e = threadIdx.x; e < kCbTile * nn; e += kPassThreads) {
      const int r = e / nn, n = e % nn;
      bs[r][n] = j0 + r < Q ? bsrc[(j0 + r) * N + n0 + n] : 0.0f;
      cs[r][n] = i0 + r < Q ? csrc[(i0 + r) * N + n0 + n] : 0.0f;
    }
    __syncthreads();
    if (tj == 0) {
      for (int e = threadIdx.x; e < kCbTile * nn; e += kPassThreads) {
        const int n = e / kCbTile, r = e % kCbTile;
        if (i0 + r < Q) ct[(bc * N + n0 + n) * Q + i0 + r] = cs[r][n];
      }
    }
    for (int n = 0; n < nn; ++n) {
      const float bv = bs[jj][n];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = fmaf(bv, cs[ii + k][n], acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (j0 + jj < Q && i0 + ii + k < Q)
      cbt[(bc * Q + j0 + jj) * Q + i0 + ii + k] = acc[k];
}

// Stage 2: per (b, h) and a 32 x 32 tile of its (N x P) plane, over the
// chunks in order: states[c] <- S (the state entering chunk c), S <- S
// exp(acum_last[c]) + local_c; then final[b, h][p][n] = S through a
// shared-memory transpose.  A thread owns 4 consecutive p of one n and
// loads kPassAhead chunks before it stores any.  The first cb_blocks
// blocks (B NC tile pairs) build C Bᵀ and Cᵀ instead (cb_block): only
// stage 3 reads them, and their products overlap the pass's memory
// traffic.  Grid (cb_blocks + B H ceil(N / 32) ceil(P / 32)).
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ alast,
                      float* __restrict__ final_state,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm, float* __restrict__ cbt,
                      float* __restrict__ ct, int cb_blocks, int NC, int H,
                      int Q, int P, int N) {
  __shared__ float buf[2 * kCbTile * (kCbSlice + 1)];
  if (static_cast<int>(blockIdx.x) < cb_blocks) {
    const int t = (Q + kCbTile - 1) / kCbTile, pairs = t * (t + 1) / 2;
    cb_block(buf, bm, cm, cbt, ct, blockIdx.x / pairs, blockIdx.x % pairs,
             Q, N);
    return;
  }
  float (*tile)[kPassTile + 1] = reinterpret_cast<float (*)[kPassTile + 1]>(
      buf);
  const int nt = (N + kPassTile - 1) / kPassTile;
  const int pt = (P + kPassTile - 1) / kPassTile;
  const int blk = blockIdx.x - cb_blocks;
  const int bh = blk / (nt * pt), ny = blk / pt % nt, pz = blk % pt;
  const int b = bh / H, h = bh % H;
  const int nn = threadIdx.x / (kPassTile / 4);
  const int pp = 4 * (threadIdx.x % (kPassTile / 4));
  const int n = ny * kPassTile + nn, p = pz * kPassTile + pp;
  const int cnt = n < N ? max(0, min(4, P - p)) : 0;
  const bool vec = cnt == 4 && (P & 3) == 0;
  const int64_t plane = static_cast<int64_t>(N) * P;
  const int64_t off = static_cast<int64_t>(n) * P + p;
  float st[4] = {};
  for (int c0 = 0; c0 < NC; c0 += kPassAhead) {
    float loc[kPassAhead][4], keep[kPassAhead];
#pragma unroll
    for (int k = 0; k < kPassAhead; ++k) {
      if (c0 + k < NC) {
        const int64_t unit = (static_cast<int64_t>(b) * NC + c0 + k) * H + h;
        const float* ws = states + unit * plane + off;
        keep[k] = expf(fminf(alast[unit], 0.0f));
        if (vec) {
          const float4 v = *reinterpret_cast<const float4*>(ws);
          loc[k][0] = v.x;
          loc[k][1] = v.y;
          loc[k][2] = v.z;
          loc[k][3] = v.w;
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) loc[k][t] = t < cnt ? ws[t] : 0.0f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPassAhead; ++k) {
      if (c0 + k < NC) {
        const int64_t unit = (static_cast<int64_t>(b) * NC + c0 + k) * H + h;
        float* ws = states + unit * plane + off;
        if (vec) {
          *reinterpret_cast<float4*>(ws) = make_float4(st[0], st[1], st[2],
                                                       st[3]);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (t < cnt) ws[t] = st[t];
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) st[t] = fmaf(st[t], keep[k], loc[k][t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) tile[nn][pp + t] = st[t];
  __syncthreads();
  float* dst = final_state + static_cast<int64_t>(bh) * plane;
  const int tn = threadIdx.x % kPassTile;        // lanes along n
#pragma unroll
  for (int r = 0; r < kPassTile / 8; ++r) {
    const int tp = threadIdx.x / kPassTile + 8 * r;
    const int n2 = ny * kPassTile + tn;
    const int p2 = pz * kPassTile + tp;
    if (n2 < N && p2 < P)
      dst[static_cast<int64_t>(p2) * N + n2] = tile[tn][tp];
  }
}

// The slabs of up to four units in one pipeline: unit u's are [first(u),
// first(u + 1)); f1, f2, f3 are the first of units 1-3, end the count.
static_assert(kUnits == 4, "Plan holds four units");
struct Plan {
  int f1, f2, f3, end;
  __device__ void locate(int s, int& u, int& base, int& next) const {
    if (s < f1) {
      u = 0, base = 0, next = f1;
    } else if (s < f2) {
      u = 1, base = f1, next = f2;
    } else if (s < f3) {
      u = 2, base = f2, next = f3;
    } else {
      u = 3, base = f3, next = end;
    }
  }
};

// Stage 3, per block: for nu <= kUnits consecutive units from u0 and one
// 64-column tile of P, y = exp(acum) ∘ (C S_inᵀ) + ((Gᵀ)ᵀ ∘ L) X, each
// unit's state slabs, then its diagonal ones, all through one pipeline.
// Gᵀ (at cbt[b, c][j][i]) and Cᵀ (at ct[b, c][n][i]) come from stage 2's
// workspaces, copied into the slabs by cp.async.  L of a diagonal slab j0
// .. j0 + 31 factors for the rows i below it through the slab's last row
// jp: exp(acum_i - acum_jp) exp(acum_jp - acum_j), both exponents <= 0;
// the slab's own 32 x 32 block takes exp() entry by entry.  The state's
// share is fused here rather than added by a fourth launch: that saves
// y's write and reread (25 MB at mamba2's shape) and a launch.
// Grid (ceil(units / kUnits), ceil(P / 64)).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_chunk_out_kernel(const float* __restrict__ xs,
                     const float* __restrict__ a,
                     const float* __restrict__ ct,
                     const float* __restrict__ cbt,
                     const float* __restrict__ states, float* __restrict__ y,
                     int units, int NC, int H, int Q, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * kUnits, nu = min(kUnits, units - u0);
  const int p0 = blockIdx.y * kTN, pn = min(kTN, P - p0);
  Pipe& pp = *reinterpret_cast<Pipe*>(smem);
  const Units us(smem);
  const Lane ln(tid);
  const int64_t ldx = static_cast<int64_t>(H) * P;
  const int sd = (Q + kTK - 1) / kTK, sf = (N + kTK - 1) / kTK;
  // first slab of each unit: the first chunk enters from 0, no state slabs
  auto state_slabs = [&](int u) {
    return u < nu && (u0 + u) / H % NC != 0 ? sf : 0;
  };
  Plan plan;
  plan.f1 = nu > 0 ? sd + state_slabs(0) : 0;
  plan.f2 = plan.f1 + (nu > 1 ? sd + state_slabs(1) : 0);
  plan.f3 = plan.f2 + (nu > 2 ? sd + state_slabs(2) : 0);
  plan.end = plan.f3 + (nu > 3 ? sd + state_slabs(3) : 0);
  const int slabs = plan.end;
  // the unit of slab s, its first slab, the next unit's, its state slabs
  auto locate = [&](int s, int& u, int& base, int& end, int& sn) {
    plan.locate(s, u, base, end);
    sn = state_slabs(u);
  };
  auto fetch = [&](int s) {
    int u, base, end, sn;
    locate(s, u, base, end, sn);
    const int unit = u0 + u;
    const int64_t bc = unit / H;
    const int sl = s - base;
    float* sa = pp.a[s % kStages];
    float* sb = pp.b[s % kStages];
    if (sl < sn) {
      load_rows<kTM, kLdA>(sa, ct + bc * N * Q, Q, sl * kTK, N, Q, tid);
      load_rows<kTN, kLdB>(sb, states + static_cast<int64_t>(unit) * N * P
                           + p0, P, sl * kTK, N, pn, tid);        // S_in
      return;
    }
    const int j0 = (sl - sn) * kTK;
    load_rows<kTM, kLdA>(sa, cbt + bc * Q * Q, Q, j0, Q, Q, tid);    // Gᵀ
    load_rows<kTN, kLdB>(sb, xs + (bc * Q * H + unit % H) * P + p0, ldx,
                         j0, Q, pn, tid);                        // X
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < slabs) fetch(t);
    cp_commit();
  }
  scan_units(a, u0, nu, H, Q, us.ac, ln, tid);
  // row[u][j] = exp(acum_jp - acum_j), jp the last row of j's slab
  for (int e = tid; e < nu * kMaxQ; e += kThreads) {
    const int w = e / kMaxQ, j = e % kMaxQ;
    us.row[e] = j < Q
        ? decay_between(us.ac[w], min(j | (kTK - 1), Q - 1), j) : 0.0f;
  }
  Acc acc = {};
  for (int s = 0; s < slabs; ++s) {
    if (s + kStages - 1 < slabs) fetch(s + kStages - 1);
    cp_commit();
    cp_wait_prev();
    __syncthreads();
    int u, base, end, sn;
    locate(s, u, base, end, sn);
    const int sl = s - base;
    const Acum& ac = us.ac[u];
    float* sa = pp.a[s % kStages];
    if (sl < sn) {
      mma_slab<true, true>(acc, sa, pp.b[s % kStages], ln);
    } else {
      const int j0 = (sl - sn) * kTK, jp = min(j0 + kTK - 1, Q - 1);
      if (sl == sn && sn) {            // the state's share, scaled once
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = ln.row(r);
          const float e = i < Q
              ? expf(fminf(ac.hi[i] + ac.lo[i], 0.0f)) : 0.0f;
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] *= e;
        }
      }
      // ∘ L.  Columns i below the slab (i > jp): a thread a column, L =
      // exp(acum_i - acum_jp) row[j], no exp() per entry.  The slab's own
      // 32 x 32 block: exp() entry by entry, 8 entries a thread, spread
      // over every warp.  Columns left of the slab: their row groups skip
      // it (below), so they are left as they are.
      static_assert(kThreads == kTM && kThreads % kTK == 0,
                    "a column a thread");
      const float* wrow = us.row + u * kMaxQ + j0;
      {
        const int i = tid;
        float* col = sa + i;
        if (i > jp && i < Q) {
          const float f = decay_between(ac, i, jp);
#pragma unroll
          for (int jj = 0; jj < kTK; ++jj) col[jj * kLdA] *= f * wrow[jj];
        }
        const int ib = j0 + tid % kTK;          // the block's column
        float* bcol = sa + ib;
#pragma unroll
        for (int t = 0; t < kTK / (kThreads / kTK); ++t) {
          const int jj = tid / kTK + t * (kThreads / kTK), j = j0 + jj;
          bcol[jj * kLdA] = j <= ib && ib < Q
              ? bcol[jj * kLdA] * decay_between(ac, ib, j) : 0.0f;
        }
      }
      __syncthreads();
      // a row group takes part once its last row reaches the slab
      mma_groups(acc, sa, pp.b[s % kStages],
                 j0 <= group_row(ln.warp, 0) + kGroup - 1,
                 j0 <= group_row(ln.warp, 1) + kGroup - 1, ln);
      if (s == end - 1) {                // the unit's last slab
        const int unit = u0 + u;
        store_tile(y + (static_cast<int64_t>(unit / H) * Q * H + unit % H) * P
                   + p0, ldx, Q, pn, acc, ln);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
      }
    }
    __syncthreads();                   // the buffer is free
  }
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Three launches: chunk_state, state_pass (whose first blocks build C Bᵀ
// and Cᵀ into `cbt` (B, NC, Q, Q) and `ct` (B, NC, N, Q)) and chunk_out.
// `states` (B, NC, H, N, P), `alast` (B, NC, H), `cbt` and `ct` are
// workspaces; every buffer is float32.
extern "C" int ssd_scan_fwd(const void* xs, const void* a, const void* bm,
                            const void* cm, void* y, void* state,
                            void* states, void* alast, void* cbt, void* ct,
                            int B, int NC, int Q, int H, int P, int N,
                            void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || P < 1 || NC < 1 || B < 1
      || H < 1 || !cbt || !ct)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fx = static_cast<const float*>(xs);
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(bm);
  const auto* fc = static_cast<const float*>(cm);
  auto* fy = static_cast<float*>(y);
  auto* fws = static_cast<float*>(states);
  auto* flast = static_cast<float*>(alast);
  auto* fcb = static_cast<float*>(cbt);
  auto* fct = static_cast<float*>(ct);
  const int ptiles = (P + kTN - 1) / kTN;
  const int units = B * NC * H;
  const int ublocks = (units + kUnits - 1) / kUnits;
  cudaError_t err;
#define SSD_TRY(expr) \
  if ((err = (expr)) != cudaSuccess) return static_cast<int>(err)
  SSD_TRY(allow_smem(ssd_chunk_state_kernel, kGemmSmem));
  ssd_chunk_state_kernel<<<dim3(ublocks, ptiles), kThreads, kGemmSmem,
                           st>>>(fx, fa, fb, fws, flast, units, H, Q, P, N);
  SSD_TRY(cudaGetLastError());
  const int t = (Q + kCbTile - 1) / kCbTile;
  const int cb_blocks = B * NC * t * (t + 1) / 2;
  const int pass_blocks = B * H * ((N + kPassTile - 1) / kPassTile)
      * ((P + kPassTile - 1) / kPassTile);
  ssd_state_pass_kernel<<<cb_blocks + pass_blocks, kPassThreads, 0, st>>>(
      fws, flast, static_cast<float*>(state), fb, fc, fcb, fct, cb_blocks,
      NC, H, Q, P, N);
  SSD_TRY(cudaGetLastError());
  SSD_TRY(allow_smem(ssd_chunk_out_kernel, kGemmSmem));
  ssd_chunk_out_kernel<<<dim3(ublocks, ptiles), kThreads, kGemmSmem, st>>>(
      fx, fa, fct, fcb, fws, fy, units, NC, H, Q, P, N);
#undef SSD_TRY
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local memory (spills) and shared memory (static and
// dynamic) of stage kernel `stage`: 0 chunk_state, 1 state_pass, 2
// chunk_out.
extern "C" int ssd_scan_attributes(int stage, int* regs, int* local_bytes,
                                   int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  int dynamic = 0;
  switch (stage) {
    case 0:
      err = cudaFuncGetAttributes(&attr, ssd_chunk_state_kernel);
      dynamic = kGemmSmem;
      break;
    case 1: err = cudaFuncGetAttributes(&attr, ssd_state_pass_kernel); break;
    case 2:
      err = cudaFuncGetAttributes(&attr, ssd_chunk_out_kernel);
      dynamic = kGemmSmem;
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes) + dynamic;
  return 0;
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
