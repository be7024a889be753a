// Per-tensor symmetric int8 quantize / dequantize for Hopper (sm_90a),
// over every leaf of a parameter tree in one launch.
//
// Replaces the Pallas TPU kernels repro/kernels/quantize.py::quantize_int8
// (K2a) and ::dequantize_int8 (K2b), the int8 payload codec's hot loop:
//
//   quantize:   q[i]   = clamp(round_half_even(x[i] / scale), -127, 127)
//   dequantize: out[i] = float(q[i]) * scale
//
// per leaf, with one float32 scale per leaf, plus a third kernel the JAX
// package leaves to XLA: the scale itself, max|x| / 127 (computed as
// max(max|x|, 1e-12) times the float32 reciprocal of 127, as XLA compiles
// the division by a constant), one per leaf.
//
// Bound by memory: one division or multiply per element, while the scale
// pass reads 4 B, quantize reads 4 B and writes 1 B, and dequantize reads
// 1 B and writes 4 B per element.  For the CIFAR supernet's 126-leaf
// master (P = 26,119,059) a roundtrip moves 14 P bytes, 0.109 ms at
// 3.35 TB/s; its largest leaf (P = 2,359,296) takes 3.5 us a kernel, and
// most leaves under 1 us, less than the host takes to issue a launch.
// So this design:
//
// * One launch covers up to kCapacity leaves.  The caller passes a leaf
//   table by value as a __grid_constant__ parameter (8 KB of the 32 KB
//   a launch may carry since CUDA 12.1): each entry holds the source and
//   destination pointers, the element count, the leaf's first tile and
//   its head (see below).  A tile is kTile elements of one leaf and never crosses into
//   the next; block b finds its leaf by a binary search over the
//   first-tile column (uniform across the block, so every read is a
//   broadcast from the constant bank).  A leaf of 1 element takes one
//   block, one of 2.36 M elements 576, so a tree of any shape fills the
//   132 SMs as far as its bytes allow.  Larger trees go in chunks of
//   kCapacity leaves, one launch per chunk and kernel.
// * 16-byte accesses on the float32 side (4 of the 5 bytes an element
//   moves), 4-byte ones on the int8 side, and every warp instruction on
//   neighbouring addresses.  A thread takes four words of 4 elements,
//   kThreads words apart: a word is one float4 and one 32-bit int8 word,
//   so each load or store instruction of a warp covers 512 contiguous
//   bytes of float32 or 128 of int8, whole cache lines.  (Sixteen
//   contiguous elements per thread, with one 16-byte int8 access, put
//   each float4 store of a warp on 32 half sectors 64 bytes apart, and
//   the dequantize kernel ran far below the library's rate.)  The
//   sources may start at any 4-byte boundary (K1 hands the master back
//   as views of one flat vector), so the caller places each leaf's
//   segment of the flat int8 and float32 buffers at an element offset
//   congruent, mod 4, to the source's misalignment: then source, int8
//   word and float4 reach their boundary at the same element, `head`
//   (< 4).  It also puts that element on a 128-byte line of both flat
//   buffers, so that no warp's stores share a line with another's.  The
//   head and a ragged last word (at most 3 elements each) are done one
//   element at a time.  Nothing is padded into the data or sliced, as
//   the TPU kernel's 8192-element blocks are.
// * The scale pass (int8_scale_kernel) walks the same tiles: each block
//   reduces max|x| of its tile, as the unsigned bit pattern of |x| (its
//   order is the order of the values, and a NaN stays the largest, as in
//   torch.amax), then atomicMax-es it into a per-leaf word and counts
//   itself done; the last block of a leaf turns the word into the scale
//   and sets both words back to 0.  So the workspace (two words per table
//   entry, zeroed once when the caller allocates it) needs no fill before
//   each launch, and a roundtrip takes 3 launches per chunk: scale pass,
//   quantize, dequantize.  Partial maxima read back by the quantize kernel
//   were the alternative; they would leave the scales to the next kernel,
//   and every block of a large leaf would reread all of its partials.
//
// Rounding must match the JAX package bit for bit, whatever the vector
// width: an IEEE division (__fdiv_rn; never __fdividef, x * (1 / s) or
// --use_fast_math), then rintf, which rounds half to even like jnp.round
// and torch.round, then the clamp; dequantize is one __fmul_rn.  The
// scales are read through a device pointer and never reach the host.
//
// Plain C interface, loaded with ctypes: each function launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().  A table of capacity 1 serves the per-vector entry
// points (a 40-byte parameter), one of kCapacity the tree functions.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;                   // 4-element words per thread
constexpr int kTile = kThreads * kWords * 4;  // elements per block
constexpr int kCapacity = 256;              // leaves per tree launch
constexpr float kScaleFloor = 1e-12f;
constexpr float kInvQmax = 1.0f / 127.0f;   // float32, rounded once

template <int Cap>
struct LeafTable {
  const void* src[Cap];
  void* dst[Cap];
  int64_t n[Cap];
  int32_t first_tile[Cap];
  int32_t head[Cap];      // first element of the leaf's aligned words
  int32_t count;
};

// This block's leaf and tile.  Word k of thread i covers elements
// e0 + 4 (k kThreads + i) .. + 3: each load and store instruction of a
// warp covers 32 neighbouring words.
struct Tile {
  int leaf;
  int64_t e0;         // first element of the tile's words
  int64_t n;
  int head;
  bool first;         // the leaf's first tile (it also does the head)
};

template <int Cap>
__device__ __forceinline__ Tile find_tile(const LeafTable<Cap>& t) {
  const int tile = static_cast<int>(blockIdx.x);
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_tile[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  const int local = tile - t.first_tile[lo];
  return {lo, t.head[lo] + static_cast<int64_t>(local) * kTile, t.n[lo],
          t.head[lo], local == 0};
}

__device__ __forceinline__ int64_t word_start(const Tile& w, int k) {
  return w.e0 + 4 * (static_cast<int64_t>(k) * kThreads + threadIdx.x);
}

__device__ __forceinline__ int32_t quant1(float x, float s) {
  float r = rintf(__fdiv_rn(x, s));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int32_t>(r);
}

__device__ __forceinline__ uint32_t pack4(float4 v, float s) {
  return (static_cast<uint32_t>(quant1(v.x, s)) & 0xffu)
      | ((static_cast<uint32_t>(quant1(v.y, s)) & 0xffu) << 8)
      | ((static_cast<uint32_t>(quant1(v.z, s)) & 0xffu) << 16)
      | (static_cast<uint32_t>(quant1(v.w, s)) << 24);
}

__device__ __forceinline__ float dequant1(int8_t q, float s) {
  return __fmul_rn(static_cast<float>(q), s);
}

// byte k of w as a signed value
__device__ __forceinline__ float dequant_byte(uint32_t w, int k, float s) {
  return dequant1(static_cast<int8_t>((w >> (8 * k)) & 0xffu), s);
}

__device__ __forceinline__ float4 unpack4(uint32_t w, float s) {
  return make_float4(dequant_byte(w, 0, s), dequant_byte(w, 1, s),
                     dequant_byte(w, 2, s), dequant_byte(w, 3, s));
}

__device__ __forceinline__ uint32_t abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

__device__ __forceinline__ uint32_t max_abs_bits(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)),
             max(abs_bits(v.z), abs_bits(v.w)));
}

// torch.clamp_min(amax, 1e-12) * float32(1 / 127); clamp_min keeps a NaN
__device__ __forceinline__ float finish_scale(uint32_t amax_bits) {
  const float amax = __uint_as_float(amax_bits);
  const float floored = amax != amax ? amax : fmaxf(amax, kScaleFloor);
  return __fmul_rn(floored, kInvQmax);
}

// Calls whole(v, e) for each of this thread's words that lies inside the
// leaf, after issuing all of their loads through load(e), and part(i)
// for each element of a ragged last word and of the head.
template <typename Load, typename Whole, typename Part>
__device__ __forceinline__ void for_each_word(const Tile& w, Load load,
                                              Whole whole, Part part) {
  decltype(load(int64_t{0})) v[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int64_t e = word_start(w, k);
    if (e + 4 <= w.n) v[k] = load(e);
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int64_t e = word_start(w, k);
    if (e + 4 <= w.n) {
      whole(v[k], e);
    } else {
      for (int64_t i = e; i < w.n; ++i) part(i);
    }
  }
  if (w.first && static_cast<int>(threadIdx.x) < w.head && threadIdx.x < w.n)
    part(static_cast<int64_t>(threadIdx.x));
}

template <int Cap>
__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const __grid_constant__ LeafTable<Cap> t,
                     const float* __restrict__ scales) {
  const Tile w = find_tile(t);
  const float* __restrict__ x = static_cast<const float*>(t.src[w.leaf]);
  int8_t* __restrict__ q = static_cast<int8_t*>(t.dst[w.leaf]);
  const float s = __ldg(scales + w.leaf);
  for_each_word(
      w, [&](int64_t e) { return *reinterpret_cast<const float4*>(x + e); },
      [&](float4 v, int64_t e) {
        *reinterpret_cast<uint32_t*>(q + e) = pack4(v, s);
      },
      [&](int64_t i) { q[i] = static_cast<int8_t>(quant1(x[i], s)); });
}

// 8 blocks of 256 threads an SM (32 registers a thread), and stores that
// stream past L2 (st.global.cs): the output is not read again soon.  On
// the card each made this kernel faster; the quantize kernel, which
// divides, ran slower at 32 registers.  A persistent grid (a block per
// SM slot, walking the tiles) ran all three kernels slower than one
// block per tile.
template <int Cap>
__global__ void __launch_bounds__(kThreads, 8)
dequantize_int8_kernel(const __grid_constant__ LeafTable<Cap> t,
                       const float* __restrict__ scales) {
  const Tile w = find_tile(t);
  const int8_t* __restrict__ q = static_cast<const int8_t*>(t.src[w.leaf]);
  float* __restrict__ out = static_cast<float*>(t.dst[w.leaf]);
  const float s = __ldg(scales + w.leaf);
  for_each_word(
      w, [&](int64_t e) { return *reinterpret_cast<const uint32_t*>(q + e); },
      [&](uint32_t v, int64_t e) {
        __stcs(reinterpret_cast<float4*>(out + e), unpack4(v, s));
      },
      [&](int64_t i) { out[i] = dequant1(q[i], s); });
}

// workspace: amax bits of leaf i at ws[i], blocks done at ws[kCapacity + i];
// all zero before and after every launch
__global__ void __launch_bounds__(kThreads)
int8_scale_kernel(const __grid_constant__ LeafTable<kCapacity> t,
                  float* __restrict__ scales, uint32_t* __restrict__ ws) {
  const Tile w = find_tile(t);
  const float* __restrict__ x = static_cast<const float*>(t.src[w.leaf]);
  uint32_t m = 0;
  for_each_word(
      w, [&](int64_t e) { return *reinterpret_cast<const float4*>(x + e); },
      [&](float4 v, int64_t) { m = max(m, max_abs_bits(v)); },
      [&](int64_t i) { m = max(m, abs_bits(x[i])); });

  __shared__ uint32_t warp_max[kThreads / 32];
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int i = 1; i < kThreads / 32; ++i) m = max(m, warp_max[i]);
  const int tiles = (w.leaf + 1 < t.count ? t.first_tile[w.leaf + 1]
                                          : static_cast<int>(gridDim.x))
                    - t.first_tile[w.leaf];
  atomicMax(ws + w.leaf, m);
  __threadfence();                    // the max lands before the count
  if (atomicAdd(ws + kCapacity + w.leaf, 1u)
      == static_cast<uint32_t>(tiles - 1)) {
    __threadfence();
    scales[w.leaf] = finish_scale(atomicExch(ws + w.leaf, 0u));
    atomicExch(ws + kCapacity + w.leaf, 0u);
  }
}

template <int Cap>
int launch_quantize(const void* table, const void* scales, int tiles,
                    cudaStream_t stream) {
  quantize_int8_kernel<Cap><<<tiles, kThreads, 0, stream>>>(
      *static_cast<const LeafTable<Cap>*>(table),
      static_cast<const float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

template <int Cap>
int launch_dequantize(const void* table, const void* scales, int tiles,
                      cudaStream_t stream) {
  dequantize_int8_kernel<Cap><<<tiles, kThreads, 0, stream>>>(
      *static_cast<const LeafTable<Cap>*>(table),
      static_cast<const float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The layout the Python side must build: sizes of the two table shapes,
// the tile and the tree capacity.
extern "C" int64_t int8_table_bytes(int capacity) {
  if (capacity == 1) return sizeof(LeafTable<1>);
  if (capacity == kCapacity) return sizeof(LeafTable<kCapacity>);
  return -1;
}

extern "C" int int8_tile() { return kTile; }

extern "C" int int8_capacity() { return kCapacity; }

extern "C" int int8_scale_f32(const void* table, void* workspace,
                              void* scales, int tiles, void* stream) {
  int8_scale_kernel<<<tiles, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const LeafTable<kCapacity>*>(table),
      static_cast<float*>(scales), static_cast<uint32_t*>(workspace));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quantize_int8_f32(const void* table, int capacity,
                                 const void* scales, int tiles,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (capacity == 1) return launch_quantize<1>(table, scales, tiles, s);
  if (capacity == kCapacity)
    return launch_quantize<kCapacity>(table, scales, tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dequantize_int8_f32(const void* table, int capacity,
                                   const void* scales, int tiles,
                                   void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (capacity == 1) return launch_dequantize<1>(table, scales, tiles, s);
  if (capacity == kCapacity)
    return launch_dequantize<kCapacity>(table, scales, tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* quantize_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
