// Hopper (sm_90a) building blocks shared by the port's kernels: shared
// memory addresses, mbarriers, TMA tensor maps, loads and stores, wgmma
// descriptors and products, setmaxnreg and named barriers.
//
// Conventions.  Every shared-memory operand is a 32-bit address in the
// shared window (``smem_u32``).  TMA tiles are loaded with 128-byte
// swizzle, so each row of a box is 128 bytes (64 bf16 or 32 float32
// values), the 16-byte chunk j of row r lies at chunk j ^ (r % 8), and
// the pattern repeats every 8 rows (1024 bytes): a swizzled tile must
// start on a 1024-byte boundary.  (The float32 kernels also load boxes
// without swizzle, rows as they lie.)  The wgmma wrappers are the
// bf16 x bf16 -> fp32 shapes the kernels use; a product of two bf16
// values is exact in fp32.
//
// Host side: ``encode_tensor_map`` (bf16 and float32 maps) reaches the
// driver's cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so a
// library built from a source that includes this header needs no -lcuda.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace hopper {

// --------------------------------------------------------------------------
// shared memory, barriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an mbarrier that completes a phase after ``count`` arrivals (and the
// transaction bytes announced by arrive_expect_tx); one thread inits
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// makes the inits visible to the other threads and to the async proxy
// (TMA); call after the last mbar_init, before a __syncthreads
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// one arrival that also announces ``bytes`` of TMA transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity ``parity`` has completed.  A fresh
// barrier is in phase 0: waiting on parity 1 passes at once (a producer's
// first wait on an empty stage), on parity 0 it blocks until the first
// phase completes.  A wait still open after about 2^35 clocks (some 20 s)
// traps: a fault in a pipeline then ends the launch with an error instead
// of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

// a barrier over ``count`` threads (a multiple of 32) with its own id
// (1..15; 0 is __syncthreads)
__device__ __forceinline__ void named_bar_sync(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// --------------------------------------------------------------------------
// register rebalancing between warpgroups (every warp of the warpgroup
// executes it; keep each role in one branch that never rejoins the other)

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// --------------------------------------------------------------------------
// TMA

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// one box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at ``dst``; completes on ``bar``.  Elements
// outside the tensor are filled with zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// one box of shared memory at ``src`` into a 4-D tensor map at coordinates
// (c0, c1, c2, c3); elements outside the tensor are not written.  The
// store joins the thread's current bulk group (tma_store_commit)
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3, %4}], [%5];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(src)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups still read shared
// memory (their source may then be written again)
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// wait until at most N of this thread's bulk groups are incomplete
template <int N>
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// makes this thread's ordinary shared-memory writes visible to the async
// proxy (a TMA store that reads them); then a barrier, then the store
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------------------------
// wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator (or a
// register operand) across the asynchronous product
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile (layout
// type 1): start address, leading and stride byte offsets, all in units of
// 16 bytes.  Both operand kinds are stored as TMA writes a box with
// 128-byte swizzle: rows of 128 bytes (64 bf16), the 16-byte chunk j of
// row r at chunk j ^ (r % 8), each 8 rows (1024 bytes) one swizzle atom.
//   - K-major operand (each row runs along the contraction, rows along M
//     or N): SBO = 1024, from 8 rows to the next 8; LBO is not read (the
//     contraction of one k16 step, 32 bytes, lies inside a row); one k16
//     step further is +32 bytes of start address.
//   - MN-major operand (each row runs along M or N, rows along the
//     contraction): SBO = 1024, from 8 contraction rows to the next 8;
//     LBO = the stride between 64-column chunks (boxes) along M or N,
//     read only when the operand is wider than 64 (N = 128: 2 chunks).
//     Boxes of 64 contraction rows stored one after another
//     give LBO = 64 x 128 = 8192 bytes; one k16 step further is +16 rows,
//     +2048 bytes of start address.  (This is CUTLASS's canonical
//     MN-major SW128 layout ((8 x 16 B, m), (8, k)) : ((16 B, LBO), (128
//     B, SBO)); K3's V operand is 64 wide and never reads LBO.)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// the descriptor of the tile ``bytes`` further on in shared memory (the
// start address field counts 16 bytes; shared addresses lie below 256 KB,
// so the sum never carries out of the field)
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

// hides ``x`` from the compiler: descriptors derived from it inside a loop
// are then recomputed there (one add each) instead of being hoisted out of
// the loop into registers the accumulators need
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

#define HOPPER_ACC32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),              \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
  "+f"(d[31])

#define HOPPER_ACC32_LIST                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, fp32) = A (64 x 16) B (16 x 64) + (accumulate ? d : 0), A
// and B bf16 in shared memory, both K-major.  Accumulator layout: thread
// t of warp w holds rows 16 w + t / 4 (d[4 j], d[4 j + 1]) and 16 w + t /
// 4 + 8 (d[4 j + 2], d[4 j + 3]), columns 8 j + 2 (t % 4) and + 1
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      HOPPER_ACC32_LIST ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16) B (16 x 64), A bf16 in registers (per
// warp the mma.m16n8k16 A fragment: a[0] rows t / 4, columns 2 (t % 4)
// and + 1; a[1] the rows + 8; a[2], a[3] the columns + 8; the lower
// column in the low half), B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                      const uint32_t* a,
                                                      uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      HOPPER_ACC32_LIST ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#define HOPPER_ACC8(d, i)                                                   \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),       \
  "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

#define HOPPER_ACC64(d)                                                     \
  HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16),                 \
  HOPPER_ACC8(d, 24), HOPPER_ACC8(d, 32), HOPPER_ACC8(d, 40),               \
  HOPPER_ACC8(d, 48), HOPPER_ACC8(d, 56)

// d (64 x 128, fp32) = A (64 x 16) B (16 x 128) + (accumulate ? d : 0), A
// and B bf16 in shared memory, A K-major, B MN-major (two 64-column
// chunks LBO apart).  Accumulator layout as m64n64k16's, for 16 chunks j
// of 8 columns: d[4 j .. 4 j + 3] at columns 8 j + 2 (t % 4) and + 1
__device__ __forceinline__ void wgmma_m64n128k16_ss_tb(float (&d)[64],
                                                       uint64_t a,
                                                       uint64_t b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : HOPPER_ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef HOPPER_ACC64
#undef HOPPER_ACC8
#undef HOPPER_ACC32_LIST
#undef HOPPER_ACC32

// --------------------------------------------------------------------------
// host: tensor maps

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of a contiguous array of ``rank`` dims (``dims``
// innermost first, the innermost dense) of ``elem_bytes``-byte elements
// of ``type``, read in boxes of ``box`` elements with ``swizzle``;
// out-of-bounds elements read as zero.  Every stride must be a multiple
// of 16 bytes and ``ptr`` 16-byte aligned.  Returns 0 or a cudaError_t.
inline int encode_tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                             uint64_t elem_bytes, const void* ptr, int rank,
                             const uint64_t* dims, const uint32_t* box,
                             CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t gdim[5];
  cuuint64_t gstride[4];
  cuuint32_t boxdim[5];
  cuuint32_t estride[5];
  uint64_t stride = elem_bytes;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    boxdim[i] = box[i];
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = stride;
    stride *= dims[i];
  }
  CUresult r = fn(map, type, static_cast<cuuint32_t>(rank),
                  const_cast<void*>(ptr), gdim, gstride, boxdim, estride,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// bf16 with 128-byte swizzle: each box row is 128 bytes (64 values)
inline int encode_tensor_map_bf16(CUtensorMap* map, const void* ptr,
                                  int rank, const uint64_t* dims,
                                  const uint32_t* box) {
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr,
                           rank, dims, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// float32, with 128-byte swizzle (a box row of 32 values) or none (a box
// row of up to 256 values, stored as it lies)
inline int encode_tensor_map_f32(CUtensorMap* map, const void* ptr,
                                 int rank, const uint64_t* dims,
                                 const uint32_t* box, bool swizzle128) {
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr,
                           rank, dims, box,
                           swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace hopper
