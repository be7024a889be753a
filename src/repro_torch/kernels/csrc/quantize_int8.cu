// Per-tensor symmetric int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/quantize.py::quantize_int8
// (K2a) and ::dequantize_int8 (K2b), the int8 payload codec's hot loop:
//
//   quantize:   q[i]   = clamp(round_half_even(x[i] / scale), -127, 127)
//   dequantize: out[i] = float(q[i]) * scale
//
// over one flat tensor (one leaf of a parameter tree) of length P, with
// the scale (max|x| / 127, computed beside the call) as a float32 on the
// device.
//
// Bound by memory: one division or multiply per element, while quantize
// reads 4 B and writes 1 B per element, and dequantize reads 1 B and
// writes 4 B: 5 P bytes either way, 11.8 MB and 3.5 us at 3.35 TB/s for the
// CIFAR supernet's largest leaf (P = 2,359,296).  At that size one launch
// costs about as much as the bytes, so the design stays simple: a 1-D grid,
// one thread per element, neighbouring threads on neighbouring addresses
// (coalesced), 64-bit indices and the ragged tail masked (the TPU kernel
// pads P up to 8192-element blocks and slices the result; nothing is padded
// or copied here).  The leaves arrive as views at any element offset, so
// there are no 16-byte vector loads yet.
//
// The scale is read through a device pointer, so the caller never brings
// it to the host (that would be one synchronisation per leaf).
//
// Rounding must match the JAX package bit for bit: an IEEE division
// (__fdiv_rn; never __fdividef, x * (1 / s) or --use_fast_math), then
// rintf, which rounds half to even like jnp.round and torch.round (roundf
// and floorf(x + 0.5f) round ties away from zero), then the clamp.  Inputs
// are finite, as a scale taken from max|x| requires.
//
// Plain C interface, loaded with ctypes: each function launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void quantize_int8_kernel(const float* __restrict__ x,
                                     const float* __restrict__ scale,
                                     int8_t* __restrict__ q, int64_t p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p) return;
  const float s = __ldg(scale);
  float r = rintf(__fdiv_rn(x[i], s));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  q[i] = static_cast<int8_t>(static_cast<int>(r));
}

__global__ void dequantize_int8_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scale,
                                       float* __restrict__ out, int64_t p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p) return;
  out[i] = __fmul_rn(static_cast<float>(q[i]), __ldg(scale));
}

unsigned int blocks_for(int64_t p) {
  return static_cast<unsigned int>((p + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int quantize_int8_f32(const void* x, const void* scale, void* q,
                                 int64_t p, void* stream) {
  quantize_int8_kernel<<<blocks_for(p), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<int8_t*>(q), p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_int8_f32(const void* q, const void* scale,
                                   void* out, int64_t p, void* stream) {
  dequantize_int8_kernel<<<blocks_for(p), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quantize_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
