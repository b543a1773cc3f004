// K1: row layernorm.
//
// Replaces vit_tpu/ops/pallas/layernorm.py:layernorm (_layernorm_kernel):
// per row of D values, fp32 mean and biased variance, rsqrt(var + eps) with
// eps inside, scale and bias in fp32, one cast to the tensor's type.
//
// Bound on the card: device memory, 2*M*D*bytes (read x, write out). One
// warp owns one row and reduces it with shuffles, so no shared memory and no
// block-wide barrier are needed; the row is re-read from L1 for the second
// and third pass rather than held in registers, which keeps any D legal.

#include "common.cuh"

namespace vit {

constexpr int kLnThreads = 256;
constexpr int kLnRowsPerBlock = kLnThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    layernorm_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const T* __restrict__ b, T* __restrict__ out, int rows,
                     int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const size_t off = static_cast<size_t>(row) * d;
  layernorm_row<T, T>(x + off, g, b, out + off, d, eps, lane);
}

}  // namespace vit

extern "C" const char* vit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int vit_layernorm(const void* x, const void* g, const void* b,
                             void* out, int rows, int d, float eps, int dtype,
                             int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  const dim3 grid((rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    layernorm_kernel<float><<<grid, kLnThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<float*>(out), rows, d, eps);
  } else if (dtype == kBF16) {
    layernorm_kernel<bf16><<<grid, kLnThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g),
        static_cast<const bf16*>(b), static_cast<bf16*>(out), rows, d, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
