// K1: row layernorm, and K5: its row statistics alone.
//
// Replaces vit_tpu/ops/pallas/layernorm.py:layernorm (_layernorm_kernel):
// per row of D values, fp32 mean and biased variance, rsqrt(var + eps) with
// eps inside, scale and bias in fp32, one cast to the tensor's type.
//
// Bound on the card: device memory, 2*M*D*bytes (read x, write out). One
// warp owns one row and reduces it with shuffles, so no shared memory and no
// block-wide barrier are needed; the row is re-read from L1 for the second
// and third pass rather than held in registers, which keeps any D legal.
//
// K5 replaces vit_tpu/ops/pallas/layernorm.py:layernorm_stats
// (_stats_kernel): the fp32 mean and rsqrt(var + eps) of each row, written
// as two (M, 1) fp32 vectors for the LN prologue of fused_linear (K6,
// csrc/matmul.cu). Bound by reading M*D*bytes once (the writes are 8 bytes
// a row); the same one-warp-a-row layout as K1. The variance is the
// centred, biased sum((x - mean)^2) / D of a second pass over the row, not
// E[x^2] - mean^2, which loses digits on rows whose mean is large.
//
// K10: quantize_rows, the per-row symmetric int8 of the int8 tier. It is
// not a TPU kernel of its own: it is the first and the fourth of the five
// launches that attn_block_q (vit_tpu/ops/pallas/block.py:attn_block_q,
// _attn_q_core :1218-1221 and :1252-1254) takes on Hopper, and K12's
// prologue (csrc/mlp_block_i8.cu) runs its device routine, quantize_row
// (common.cuh). One warp a row: with LN, the fp32 normalisation of _ln32,
// not rounded to the tensor's type; then ax = max(max|xn|, 1e-12) / 127
// (fp32, M) and xq = round(xn / ax) (int8, M x D). Bound by device memory:
// M*D*(bytes + 1) + 4*M (4.6 us with LN at B/16 bs=32, 6656 x 768 bf16, at
// 3.35 TB/s); the row is read three or four times, from L1 after the
// first.

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

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    layernorm_stats_kernel(const T* __restrict__ x, float* __restrict__ mu,
                           float* __restrict__ rstd, int rows, int d,
                           float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const float2 st = row_stats(x + static_cast<size_t>(row) * d, d, eps, lane);
  if (lane == 0) {
    mu[row] = st.x;
    rstd[row] = st.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    quantize_rows_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const T* __restrict__ b, signed char* __restrict__ q,
                         float* __restrict__ ax, int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const size_t off = static_cast<size_t>(row) * d;
  signed char* qr = q + off;
  const float a = quantize_row(x + off, g, b, d, eps, lane,
                               [&](int i, signed char c) { qr[i] = c; });
  if (lane == 0) ax[row] = a;
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

extern "C" int vit_layernorm_stats(const void* x, void* mu, void* rstd,
                                   int rows, int d, float eps, int dtype,
                                   int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  const dim3 grid((rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    layernorm_stats_kernel<float><<<grid, kLnThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(mu),
        static_cast<float*>(rstd), rows, d, eps);
  } else if (dtype == kBF16) {
    layernorm_stats_kernel<bf16><<<grid, kLnThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<float*>(mu),
        static_cast<float*>(rstd), rows, d, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// K10: x (rows, d) in the dtype; g and b (d,) in the dtype, or both null
// for no LN; q (rows, d) int8 and ax (rows,) fp32 out.
extern "C" int vit_quantize_rows(const void* x, const void* g, const void* b,
                                 void* q, void* ax, int rows, int d,
                                 float eps, int dtype, int device,
                                 void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (rows <= 0 || d <= 0 || (g == nullptr) != (b == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock);
  auto st = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<signed char*>(q);
  auto* aa = static_cast<float*>(ax);
  if (dtype == kF32) {
    quantize_rows_kernel<float><<<grid, kLnThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), qq, aa, rows, d, eps);
  } else if (dtype == kBF16) {
    quantize_rows_kernel<bf16><<<grid, kLnThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g),
        static_cast<const bf16*>(b), qq, aa, rows, d, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
