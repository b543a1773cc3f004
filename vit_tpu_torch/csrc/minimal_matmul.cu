// K21: the minimal matmul, the teaching companion of the library's kernels
// (counterpart of examples/minimal_pallas_matmul.py, whose pallas_call is at
// :50). It shows the bare essentials of a kernel of this library, with none
// of K2's machinery (no tensor cores, no epilogue, no ragged edges):
//
// - The C interface. A kernel is launched by a plain `extern "C"` function
//   that takes raw device pointers and sizes, then the dtype code, the
//   device index and the stream, and returns cudaGetLastError() after the
//   launch, so that a refused launch reaches the caller. The Python side
//   (vit_tpu_torch/examples/minimal_matmul.py) declares the argument types
//   for ctypes (_build.py:_SIGNATURES: a pointer is c_void_p, an int c_int),
//   passes tensor.data_ptr() and torch.cuda.current_stream().cuda_stream,
//   and allocates the output itself: the kernel allocates nothing and
//   never synchronises.
// - The grid tiles the output, as the Pallas grid does. Where a BlockSpec
//   maps a grid position to a tile, here the block computes its tile's
//   offsets from blockIdx; where the Pallas K axis streams K tiles through
//   a sequential grid dimension with an fp32 scratch accumulator, here a
//   loop inside the block walks K, because blocks run in parallel in no
//   order and nothing carries over between them.
// - Shared memory stages one TILE x TILE slice of x and of w per step; each
//   of the TILE x TILE threads keeps its output element's fp32 sum in a
//   register and writes it once, in x's type.
//
// TILE is 32 (one thread an output element, 1024 threads a block), not the
// Pallas example's 128 (one MXU tile); every dimension must be a multiple of
// 128 all the same, the example's assert. Bound on the card: operations,
// 2*M*N*K on the FFMA units (fp32; a bf16 input is widened as it is staged).

#include "common.cuh"

namespace vit {

constexpr int kTile = 32;

template <typename T>
__global__ void __launch_bounds__(kTile * kTile)
    minimal_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          T* __restrict__ out, int n, int k) {
  __shared__ float xs[kTile][kTile + 1];  // +1: no bank conflicts on reads
  __shared__ float ws[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * kTile + ty, col = blockIdx.x * kTile + tx;
  float acc = 0.f;
  for (int k0 = 0; k0 < k; k0 += kTile) {
    xs[ty][tx] = to_f32(x[static_cast<size_t>(row) * k + k0 + tx]);
    ws[ty][tx] = to_f32(w[static_cast<size_t>(k0 + ty) * n + col]);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) acc = fmaf(xs[ty][kk], ws[kk][tx], acc);
    __syncthreads();
  }
  out[static_cast<size_t>(row) * n + col] = from_f32<T>(acc);
}

}  // namespace vit

extern "C" int vit_minimal_matmul(const void* x, const void* w, void* out,
                                  int m, int n, int k, int dtype, int device,
                                  void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || n <= 0 || k <= 0 || m % 128 || n % 128 || k % 128)
    return cudaErrorInvalidValue;
  const dim3 grid(n / kTile, m / kTile), block(kTile, kTile);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    minimal_matmul_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), n, k);
  else if (dtype == kBF16)
    minimal_matmul_kernel<bf16><<<grid, block, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), n, k);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
