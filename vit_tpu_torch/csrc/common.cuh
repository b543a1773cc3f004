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

// kI8: int8 inputs, where a kernel takes them as its type (K22).
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(signed char v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ signed char from_f32<signed char>(float v) {
  return static_cast<signed char>(__float2int_rn(v));
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

// The fp32 mean and rsqrt(var + eps) of one row of d values, computed by
// one warp: the variance is the centred, biased sum((x - mean)^2) / d of a
// second pass (vit_tpu/ops/pallas/layernorm.py:_stats_kernel). Every lane
// returns the same pair.
template <typename T>
__device__ __forceinline__ float2 row_stats(const T* __restrict__ x, int d,
                                            float eps, int lane) {
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += to_f32(x[i]);
  const float mean = warp_sum(s) / d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float c = to_f32(x[i]) - mean;
    ss += c * c;
  }
  return make_float2(mean, rsqrtf(warp_sum(ss) / d + eps));
}

// One row of layernorm, computed by one warp: row_stats, then scale and
// bias in fp32 (vit_tpu/ops/pallas/layernorm.py:_layernorm_kernel). Writes
// out[i] = from_f32<O>(...) for i < d. The scale and bias may have another
// type than x (K9's final LN reads an fp32 row with bf16 parameters).
template <typename T, typename O, typename G = T>
__device__ __forceinline__ void layernorm_row(const T* __restrict__ x,
                                              const G* __restrict__ g,
                                              const G* __restrict__ b,
                                              O* __restrict__ out, int d,
                                              float eps, int lane) {
  const float2 st = row_stats(x, d, eps, lane);
  for (int i = lane; i < d; i += 32) {
    const float c = (to_f32(x[i]) - st.x) * st.y;
    out[i] = from_f32<O>(c * to_f32(g[i]) + to_f32(b[i]));
  }
}

// ---------------------------------------------------------------- int8 --
// The int8 tier's rounding, written so that a kernel agrees with its plain
// PyTorch version bit for bit where their fp32 inputs do: round half to
// even (rintf; CUDA's roundf rounds half away from zero, jnp.round does
// not), a true division (multiplying by 127 / max flips codes), and every
// dequantization as __fmul_rn / __fadd_rn in JAX's order, which nvcc may
// not contract into an FMA.

// The scale of a row whose largest magnitude is amax: max(amax, 1e-12) /
// 127 (vit_tpu/ops/pallas/block.py:533-534).
__device__ __forceinline__ float quant_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
}

// round(v / a), saturated at +-127 (a guard that never binds).
__device__ __forceinline__ signed char quant_code(float v, float a) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, a)), -127.f), 127.f);
  return static_cast<signed char>(__float2int_rn(r));
}

// (acc * a) * s, the dequantization of an int32 sum.
__device__ __forceinline__ float dequant(int acc, float a, float s) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), a), s);
}

// One row of d values quantized by one warp, optionally after an fp32 LN
// that is not rounded to the tensor's type (vit_tpu/ops/pallas/block.py:
// _ln32): the absmax over the row, the scale, then store(i, code) for each
// element. The row is read again for each pass rather than held, so any d
// is legal. Every lane returns the scale. Without LN, g and b are null.
template <typename T, typename G, typename Store>
__device__ __forceinline__ float quantize_row(const T* __restrict__ x,
                                              const G* g, const G* b, int d,
                                              float eps, int lane,
                                              const Store& store) {
  float2 st = make_float2(0.f, 1.f);
  if (g) st = row_stats(x, d, eps, lane);
  auto value = [&](int i) {
    const float v = to_f32(x[i]);
    if (!g) return v;
    const float c = __fmul_rn(__fsub_rn(v, st.x), st.y);
    return __fadd_rn(__fmul_rn(c, to_f32(g[i])), to_f32(b[i]));
  };
  float m = 0.f;
  for (int i = lane; i < d; i += 32) m = fmaxf(m, fabsf(value(i)));
  const float a = quant_scale(warp_max(m));
  for (int i = lane; i < d; i += 32) store(i, quant_code(value(i), a));
  return a;
}

// Make `device` current for this library's runtime; its launches then go to
// the same context as the caller's tensors.
inline cudaError_t use_device(int device) { return cudaSetDevice(device); }

}  // namespace vit
