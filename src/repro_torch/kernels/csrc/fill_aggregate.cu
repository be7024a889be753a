// Fill-aggregation (paper Algorithm 3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fill_aggregate.py::fill_aggregate.
//
//   out[p] = sum_k w_k * (mask_k[p] * c_k[p] + (1 - mask_k[p]) * prev[p])
//
// over m uploads of a flat float32 parameter vector of length P.
//
// Bound by memory: each element is a few flops, and the kernel must read
// clients and masks (2 m P floats) and prev (P floats) and write out
// (P floats), (2m+1) P 4 bytes read and P 4 bytes written.  The design
// streams every element exactly once: a 1-D grid over P, one thread per
// element of prev/out, looping over the m uploads with the sum in an fp32
// register.  Neighbouring threads read neighbouring addresses of each row
// k, so every load and the store are coalesced across the warp.  The TPU
// kernel pads P up to 8192-element blocks; here the ragged tail is masked
// instead.  Row offsets k * P are 64-bit: m * P passes 2^31 at m >= 83 on
// the full CIFAR supernet.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void fill_aggregate_kernel(const float* __restrict__ clients,
                                      const float* __restrict__ masks,
                                      const float* __restrict__ weights,
                                      const float* __restrict__ prev,
                                      float* __restrict__ out,
                                      int m, int64_t p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p) return;
  const float pv = prev[i];
  float acc = 0.0f;
  for (int k = 0; k < m; ++k) {
    const int64_t off = static_cast<int64_t>(k) * p + i;
    const float mk = masks[off];
    const float filled = mk * clients[off] + (1.0f - mk) * pv;
    acc = fmaf(weights[k], filled, acc);
  }
  out[i] = acc;
}

}  // namespace

extern "C" int fill_aggregate_f32(const void* clients, const void* masks,
                                  const void* weights, const void* prev,
                                  void* out, int m, int64_t p,
                                  void* stream) {
  const int64_t blocks = (p + kThreads - 1) / kThreads;
  fill_aggregate_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(clients), static_cast<const float*>(masks),
      static_cast<const float*>(weights), static_cast<const float*>(prev),
      static_cast<float*>(out), m, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fill_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
