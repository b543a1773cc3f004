// K14 add and K15 softmax: the two elementwise ops of the reference op chain
// (attention="unfused", fused=False in vit_tpu/models/vit.py:encoder_block).
//
// K14 replaces vit_tpu/ops/pallas/add.py:add (_add_kernel, add.py:22):
// out = x + y for two tensors of one shape and type, each sum computed in
// fp32 and rounded once, as PyTorch and XLA round a bf16 add, so the kernel
// agrees with its plain version bit for bit. Bound on the card: bytes (two
// reads and a write; 29 MB for the B/16 bs=32 residual, 8.7 us at 3.35
// TB/s). Every thread moves 16 bytes a step where the three pointers allow
// it, with a scalar tail; the grid strides over the tensor.
//
// K15 replaces vit_tpu/ops/pallas/softmax.py:softmax (_softmax_kernel,
// softmax.py:26): a row softmax with the row max, exp and the row sum in
// fp32, then one cast. Bound on the card: bytes (one read, one write: 59.6
// MB for the unfused scores of B/16 bs=32, 17.8 us). A row of up to 1024
// values is one warp's, held in registers (up to 32 a lane), so the row is
// read once; a longer row is one block's, read three times (max, sum,
// write). Ragged widths are masked: lanes past the row hold -inf, whose exp
// is 0. exp is the accurate expf and the division a true division, so only
// the order of the row sum differs from the plain version's.

#include <math_constants.h>

#include "common.cuh"

namespace vit {

// ----------------------------------------------------------------- add --

constexpr int kAddThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kAddThreads)
    add_kernel(const T* __restrict__ x, const T* __restrict__ y,
               T* __restrict__ out, long long n, bool vec) {
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long i = t; i < nv; i += stride) {
      uint4 a = reinterpret_cast<const uint4*>(x)[i];
      const uint4 b = reinterpret_cast<const uint4*>(y)[i];
      T* ae = reinterpret_cast<T*>(&a);
      const T* be = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int e = 0; e < V; ++e)
        ae[e] = from_f32<T>(to_f32(ae[e]) + to_f32(be[e]));
      reinterpret_cast<uint4*>(out)[i] = a;
    }
    done = nv * V;
  }
  for (long long i = done + t; i < n; i += stride)
    out[i] = from_f32<T>(to_f32(x[i]) + to_f32(y[i]));
}

template <typename T>
cudaError_t launch_add(const void* x, const void* y, void* out, long long n,
                       cudaStream_t st) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(y) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const long long work = vec ? n / (16 / sizeof(T)) + 1 : n;
  const long long blocks = (work + kAddThreads - 1) / kAddThreads;
  // 132 SMs at eight blocks each keep every SM's loads in flight; the grid
  // strides over the rest.
  const int grid = static_cast<int>(blocks < 1056 ? blocks : 1056);
  add_kernel<T><<<grid, kAddThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      n, vec);
  return cudaGetLastError();
}

// ------------------------------------------------------------- softmax --

constexpr int kSmThreads = 256;
constexpr int kSmWarpMaxD = 1024;  // the widest row one warp takes

// One row a warp, VPL values a lane in registers: d <= 32 * VPL.
template <typename T, int VPL>
__global__ void __launch_bounds__(kSmThreads)
    softmax_warp_kernel(const T* __restrict__ x, T* __restrict__ out, int rows,
                        int d) {
  const int row = blockIdx.x * (kSmThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* orow = out + static_cast<size_t>(row) * d;
  float v[VPL];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < d ? to_f32(xr[i]) : -CUDART_INF_F;
    m = fmaxf(m, v[j]);
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    v[j] = expf(v[j] - m);
    s += v[j];
  }
  s = warp_sum(s);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = lane + 32 * j;
    if (i < d) orow[i] = from_f32<T>(__fdiv_rn(v[j], s));
  }
}

// The block-wide reduction of one value a thread by op (max or sum).
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* red, Op op) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // the previous reduction's readers of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kSmThreads / 32; ++w) v = op(v, red[w]);
  return v;
}

// One row a block, for rows longer than kSmWarpMaxD.
template <typename T>
__global__ void __launch_bounds__(kSmThreads)
    softmax_block_kernel(const T* __restrict__ x, T* __restrict__ out, int d) {
  __shared__ float red[kSmThreads / 32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
  float m = -CUDART_INF_F;
  for (int i = threadIdx.x; i < d; i += kSmThreads) m = fmaxf(m, to_f32(xr[i]));
  m = block_reduce(m, red, [](float a, float b) { return fmaxf(a, b); });
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kSmThreads)
    s += expf(to_f32(xr[i]) - m);
  s = block_reduce(s, red, [](float a, float b) { return a + b; });
  for (int i = threadIdx.x; i < d; i += kSmThreads)
    orow[i] = from_f32<T>(__fdiv_rn(expf(to_f32(xr[i]) - m), s));
}

template <typename T>
cudaError_t launch_softmax(const void* x, void* out, int rows, int d,
                           cudaStream_t st) {
  auto* xi = static_cast<const T*>(x);
  auto* o = static_cast<T*>(out);
  if (d > kSmWarpMaxD) {
    softmax_block_kernel<T><<<rows, kSmThreads, 0, st>>>(xi, o, d);
    return cudaGetLastError();
  }
  const int grid = (rows + kSmThreads / 32 - 1) / (kSmThreads / 32);
  if (d <= 32 * 8)
    softmax_warp_kernel<T, 8><<<grid, kSmThreads, 0, st>>>(xi, o, rows, d);
  else
    softmax_warp_kernel<T, 32><<<grid, kSmThreads, 0, st>>>(xi, o, rows, d);
  return cudaGetLastError();
}

}  // namespace vit

// x, y and out: n elements of the dtype.
extern "C" int vit_add(const void* x, const void* y, void* out, long long n,
                       int dtype, int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_add<float>(x, y, out, n, st);
  if (dtype == kBF16) return launch_add<bf16>(x, y, out, n, st);
  return cudaErrorInvalidValue;
}

// x and out: (rows, d) in the dtype, row-major.
extern "C" int vit_softmax(const void* x, void* out, int rows, int d,
                           int dtype, int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_softmax<float>(x, out, rows, d, st);
  if (dtype == kBF16) return launch_softmax<bf16>(x, out, rows, d, st);
  return cudaErrorInvalidValue;
}
