// K20: the smoke kernel of the block-gated print (debug.cuh), the
// counterpart of the Pallas kernel in tests/test_ops_pallas.py:235-256
// (test_debug_print_if_smoke, pallas_call :248), which calls
// vit_tpu/ops/pallas/debug.py:print_if inside a copy:
//
//   print_if("pid0 block sum = {}", jnp.sum(x_ref[:]), conds="=0")
//   o_ref[:] = x_ref[:]
//
// The (R, C) input is cut into a (gx, gy) grid of (R/gx, C/gy) tiles, as the
// Pallas BlockSpec cuts it; block (i, j) copies tile (i, j) to the output,
// bit for bit, sums it in fp32 and, where the conditions hold, prints one
// line, "block (i, j, 0) sum = <sum, %.9g>".
//
// Bound on the card: bytes, the input read once and the copy written once.
// The printf is what the kernel exists for; nothing here is tuned.

#include "common.cuh"
#include "debug.cuh"

namespace vit {

constexpr int kDebugThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDebugThreads)
    print_if_smoke_kernel(const T* __restrict__ x, T* __restrict__ out,
                          int cols, int tr, int tc, PidConds conds) {
  __shared__ float part[kDebugThreads / 32];
  const int r0 = blockIdx.x * tr, c0 = blockIdx.y * tc;
  float s = 0.f;
  for (int e = threadIdx.x; e < tr * tc; e += kDebugThreads) {
    const size_t i = static_cast<size_t>(r0 + e / tc) * cols + c0 + e % tc;
    out[i] = x[i];
    s += to_f32(x[i]);
  }
  s = warp_sum(s);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kDebugThreads / 32; ++w) total += part[w];
    print_if(conds, "block (%d, %d, %d) sum = %.9g\n",
             static_cast<int>(blockIdx.x), static_cast<int>(blockIdx.y),
             static_cast<int>(blockIdx.z), static_cast<double>(total));
  }
}

}  // namespace vit

extern "C" int vit_print_if_smoke(const void* x, void* out, int rows,
                                  int cols, int gx, int gy, int op0, int rhs0,
                                  int op1, int rhs1, int op2, int rhs2,
                                  int dtype, int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (rows <= 0 || cols <= 0 || gx <= 0 || gy <= 0 || rows % gx || cols % gy)
    return cudaErrorInvalidValue;
  const PidConds conds = {{op0, op1, op2}, {rhs0, rhs1, rhs2}};
  const dim3 grid(gx, gy);
  const int tr = rows / gx, tc = cols / gy;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    print_if_smoke_kernel<float><<<grid, kDebugThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), cols, tr, tc,
        conds);
  else if (dtype == kBF16)
    print_if_smoke_kernel<bf16><<<grid, kDebugThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(out), cols, tr, tc,
        conds);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
