// What every kernel of the library shares (counterpart of
// vit_tpu/ops/pallas/common.py and vit_tpu/ops/pallas/activations.py).
//
// Data types: fp32 and bf16 tensors, fp32 arithmetic throughout; a value is
// rounded to the tensor's type only where the Pallas kernel rounds it.
//
// GELU: the Pallas kernels evaluate erf with the Abramowitz & Stegun 7.1.26
// polynomial (|err| <= 1.5e-7) because Mosaic has no erf. CUDA has an
// accurate erff, so the kernels use it; the plain PyTorch versions use
// torch.erf.
//
// C interface: every entry point (extern "C", loaded with ctypes) takes its
// pointers and sizes, then (dtype, device, stream), and returns
// cudaGetLastError() after its launch, so that a refused launch is reported
// to the caller instead of being lost.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vit {

enum DType : int { kF32 = 0, kBF16 = 1 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Exact erf-form GELU: 0.5 * x * (1 + erf(x / sqrt(2))).
__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One row of layernorm, computed by one warp: fp32 mean, biased variance
// from the centred values, rsqrt(var + eps), then scale and bias in fp32
// (vit_tpu/ops/pallas/layernorm.py:_layernorm_kernel). Writes
// out[i] = from_f32<O>(...) for i < d.
template <typename T, typename O>
__device__ __forceinline__ void layernorm_row(const T* __restrict__ x,
                                              const T* __restrict__ g,
                                              const T* __restrict__ b,
                                              O* __restrict__ out, int d,
                                              float eps, int lane) {
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += to_f32(x[i]);
  const float mean = warp_sum(s) / d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float c = to_f32(x[i]) - mean;
    ss += c * c;
  }
  const float rstd = rsqrtf(warp_sum(ss) / d + eps);
  for (int i = lane; i < d; i += 32) {
    const float c = (to_f32(x[i]) - mean) * rstd;
    out[i] = from_f32<O>(c * to_f32(g[i]) + to_f32(b[i]));
  }
}

// Make `device` current for this library's runtime; its launches then go to
// the same context as the caller's tensors.
inline cudaError_t use_device(int device) { return cudaSetDevice(device); }

}  // namespace vit
