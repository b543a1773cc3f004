// K22: the int8 probe's dot, x (m, k) @ w (k, n), written out as the
// accumulator stands: int8 x int8 -> int32, exact; bf16 x bf16 or fp32 x
// fp32 -> fp32. No scale, no bias, no cast.
//
// Replaces tools/int8_probe.py:pallas_dot (_dot_kernel, pallas_call :43),
// which asks whether the TPU's matrix unit takes an s8 x s8 -> s32 dot and
// how fast it runs against bf16 at the MLP's shape (1664 x 768 @ 768 x
// 3072). The Pallas kernel holds the whole arrays in VMEM in one grid step;
// here each block computes one tile with K2's tile loop (gemm_tile.cuh):
// its TcTile traits run int8 on s8 wmma fragments with int32 sums, K
// staged 64 deep, and bf16 on bf16 fragments with fp32 sums, K staged 32
// deep; fp32 runs the true-fp32 FFMA tile. The epilogue stores each sum
// unchanged, so the int8 result is the exact integer product, bit for bit.
// Ragged edges are masked by the tile loop.
//
// Bound on the card: operations. At the probe's shape, 2*m*k*n = 7.84
// GOP, 3.96 us at int8's 1,979 TOP/s and 7.93 us at bf16's 989 TFLOP/s;
// the bytes (int8 4.9 MB, bf16 9.5 MB with fp32 outputs) take 1.5-2.8 us.
// The tile loop is not pipelined (no cp.async, TMA or wgmma), so this
// kernel measures that loop, as K11 and K12 run it, not the card's int8
// rate: the answer the probe gives is whether int8 pays through the
// port's own tiles.

#include "gemm_tile.cuh"

namespace vit {

template <typename Acc>
struct StoreAcc {
  Acc* out;
  int n;

  __device__ __forceinline__ void store(int row, int col, Acc acc) const {
    out[static_cast<size_t>(row) * n + col] = acc;
  }
};

template <typename In, typename Acc>
__global__ void __launch_bounds__(kMmThreads)
    dot_probe_kernel(const In* __restrict__ x, const In* __restrict__ w,
                     Acc* __restrict__ out, int m, int n, int k, bool vec_x,
                     bool vec_w) {
  __shared__ typename Gemm<In>::Smem sm;
  gemm_tile<false>(x, w, m, n, k, blockIdx.y * Gemm<In>::BM,
                   blockIdx.x * Gemm<In>::BN, vec_x, vec_w, LnPrologue<In>{},
                   StoreAcc<Acc>{out, n}, sm);
}

template <typename In, typename Acc>
cudaError_t launch_dot_probe(const void* x, const void* w, void* out, int m,
                             int n, int k, cudaStream_t st) {
  auto* xi = static_cast<const In*>(x);
  auto* wi = static_cast<const In*>(w);
  const dim3 grid((n + Gemm<In>::BN - 1) / Gemm<In>::BN,
                  (m + Gemm<In>::BM - 1) / Gemm<In>::BM);
  dot_probe_kernel<In, Acc><<<grid, kMmThreads, 0, st>>>(
      xi, wi, static_cast<Acc*>(out), m, n, k, vec_ok<In, In>(xi, k),
      vec_ok<In, In>(wi, n));
  return cudaGetLastError();
}

}  // namespace vit

// x (m, k) and w (k, n) in the input type (dtype: kF32, kBF16 or kI8);
// out (m, n) fp32, or int32 for int8.
extern "C" int vit_dot_probe(const void* x, const void* w, void* out, int m,
                             int n, int k, int dtype, int device,
                             void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kI8) return launch_dot_probe<signed char, int>(x, w, out, m, n,
                                                              k, st);
  if (dtype == kBF16)
    return launch_dot_probe<bf16, float>(x, w, out, m, n, k, st);
  if (dtype == kF32)
    return launch_dot_probe<float, float>(x, w, out, m, n, k, st);
  return cudaErrorInvalidValue;
}
