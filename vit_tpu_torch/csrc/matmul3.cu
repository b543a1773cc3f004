// K16 matmul3: out[b] = (x[b] @ y[b]) * scale for x (B, M, K) and y (B, K,
// N), row-major, summed in fp32 and cast once to the tensor's type.
//
// Replaces vit_tpu/ops/pallas/matmul3.py:matmul3, both of its pallas_calls:
// the group kernel (_matmul3_group_kernel, matmul3.py:52, launched at :105),
// which takes several whole per-batch products a grid step, and the general
// tiled kernel (_matmul3_kernel, :32, launched at :130). The two compute the
// same function; the split is the TPU's per-grid-step cost, which a Hopper
// grid does not have, so one kernel serves both. It carries the unfused
// attention's scores (q @ k^T * d^-0.5) and context (p @ v) and, in the
// backward, both products of its VJP (vit_tpu/ops/pallas/vjp.py:215-220).
// The operands are row-major, so the model copies k^T contiguous before the
// call, as XLA materialises it before the opaque pallas_call.
//
// Each block runs gemm_tile.cuh's tile routine -- K2's loop: bf16 wmma with
// fp32 sums, or true-fp32 FFMA (no TF32; the JAX kernel runs fp32 at
// Precision.HIGHEST) -- on one output tile of batch blockIdx.z, with an
// epilogue of acc * scale and one cast. The routine masks ragged M, N and K
// (197 tokens; K = 64 or 197), so nothing is padded in device memory.
//
// Bound on the card: bytes at the unfused B/16 bs=32 shapes (scores: 9.7 +
// 9.7 MB in, 29.8 MB out in bf16, 14.7 us at 3.35 TB/s, against 1.9 GFLOP,
// 1.9 us at 989 TFLOP/s). The tile loop is not pipelined and a 64-deep K
// (the scores) gives it two steps a tile; scale == 1 (no scale) is exact.

#include "gemm_tile.cuh"

namespace vit {

template <typename T>
struct ScaleEpilogue {
  T* out;  // this batch's (M, N)
  int n;
  float scale;

  __device__ __forceinline__ void store(int row, int col, float acc) const {
    out[static_cast<size_t>(row) * n + col] = from_f32<T>(__fmul_rn(acc, scale));
  }
};

template <typename T>
__global__ void __launch_bounds__(kMmThreads)
    matmul3_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   T* __restrict__ out, int m, int n, int k, float scale) {
  __shared__ typename Gemm<T>::Smem sm;
  const size_t z = blockIdx.z;
  const T* xz = x + z * m * k;
  const T* yz = y + z * k * n;
  const ScaleEpilogue<T> ep{out + z * m * n, n, scale};
  gemm_tile<false>(xz, yz, m, n, k, blockIdx.y * Gemm<T>::BM,
                   blockIdx.x * Gemm<T>::BN, vec_ok<T, T>(xz, k),
                   vec_ok<T, T>(yz, n), LnPrologue<T>{}, ep, sm);
}

template <typename T>
cudaError_t launch_matmul3(const void* x, const void* y, void* out, int b,
                           int m, int n, int k, float scale,
                           cudaStream_t st) {
  const dim3 grid((n + Gemm<T>::BN - 1) / Gemm<T>::BN,
                  (m + Gemm<T>::BM - 1) / Gemm<T>::BM, b);
  matmul3_kernel<T><<<grid, kMmThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      m, n, k, scale);
  return cudaGetLastError();
}

}  // namespace vit

// x (b, m, k), y (b, k, n) and out (b, m, n) in the dtype, row-major; scale
// 1 where the caller gives none.
extern "C" int vit_matmul3(const void* x, const void* y, void* out, int b,
                           int m, int n, int k, float scale, int dtype,
                           int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || b > 65535 || m <= 0 || n <= 0 || k <= 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_matmul3<float>(x, y, out, b, m, n, k, scale, st);
  if (dtype == kBF16)
    return launch_matmul3<bf16>(x, y, out, b, m, n, k, scale, st);
  return cudaErrorInvalidValue;
}
