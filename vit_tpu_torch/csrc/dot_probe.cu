// K22: the int8 probe's dot, x (m, k) @ w (k, n), written out as the
// accumulator stands: int8 x int8 -> int32, exact; bf16 x bf16 or fp32 x
// fp32 -> fp32. No scale, no bias, no cast.
//
// Replaces tools/int8_probe.py:pallas_dot (_dot_kernel, pallas_call :43),
// which asks whether the TPU's matrix unit takes an s8 x s8 -> s32 dot and
// how fast it runs against bf16 at the MLP's shape (1664 x 768 @ 768 x
// 3072). The Pallas kernel holds the whole arrays in VMEM in one grid step;
// here each dot runs on the tile the port's own path runs it on:
// - int8 on K11's s8 wgmma tile (matmul_i8_wgmma.cu: TMA, the raw weight
//   boxes turned K-major on chip, persistent 128 x 128 tiles) with Ep<int>,
//   its raw epilogue, where TMA reads both operands (16-byte aligned bases,
//   K and N multiples of 16: ops/cuda/quant.py:i8_path's rule);
// - bf16 on K2's wgmma tile (gemm_wgmma.cuh, kXepRawF32: the fp32 sums
//   stored unrounded) where TMA reads both (16-byte aligned bases, K and N
//   multiples of 8: ops/cuda/matmul.py:gemm_path's rule);
// - fp32 on K2's tf32 wgmma tile (matmul_tf32.cu, gemm_tf32.cuh: the
//   three-pass TF32 split, its epilogue without bias or residual storing
//   the sums raw) where TMA reads both (16-byte aligned bases, K and N
//   multiples of 4: gemm_path's fp32 rule, tf32_takes);
// - every other shape on K2's tile loop (gemm_tile.cuh): s8 or bf16 wmma
//   fragments, or the true-fp32 FFMA tile;
// decided by shape and alignment alone. The int8 result is the exact
// integer product on every tile, bit for bit.
//
// Bound on the card: bytes. At the probe's shape, 2*m*k*n = 7.84 GOP,
// 3.96 us at int8's 1,979 TOP/s and 7.93 us at bf16's 989 TFLOP/s; the
// bytes (int8 3.6 MB in and a 20.4 MB int32 product out, 7.2 us at 3.35
// TB/s; bf16 7.3 MB in, 20.4 MB out, 8.3 us) set the bound: 0.0072 and
// 0.0083 ms. So the probe's question, whether int8 pays, is answered on
// the tiles the int8 tier (K11) and K2 run. In fp32 the operations bound
// it: 7.84 GFLOP in three TF32 passes at 495/3 TFLOP/s, 0.0476 ms.

#include "gemm_tile.cuh"

namespace vit {

// The wgmma launchers (matmul_i8_wgmma.cu, matmul_wgmma.cu).
cudaError_t launch_i8_raw(const void* xq, const void* wq, int* out, int m,
                          int n, int k, int device, cudaStream_t st);
cudaError_t launch_wgmma_raw(const void* x, const void* w, float* out, int m,
                             int n, int k, int device, cudaStream_t st);
bool wgmma_takes(const void* x, const void* w, int n, int k);
// matmul_tf32.cu: K2's fp32 launch on the tf32 tile, and its rule.
cudaError_t launch_tf32(const void* x, const void* w, const void* bias,
                        const void* residual, void* out, int m, int n, int k,
                        int gelu_act, int trans_a, int trans_b, int device,
                        cudaStream_t st);
bool tf32_takes(const void* x, const void* w, int n, int k);

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

// Whether K22's int8 dot runs on K11's s8 wgmma tile (ops/cuda/quant.py:
// i8_path's rule).
inline bool i8_wgmma_takes(const void* x, const void* w, int n, int k) {
  return aligned16(x) && aligned16(w) && k % 16 == 0 && n % 16 == 0;
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
  if (dtype == kI8)
    return i8_wgmma_takes(x, w, n, k)
               ? launch_i8_raw(x, w, static_cast<int*>(out), m, n, k, device,
                               st)
               : launch_dot_probe<signed char, int>(x, w, out, m, n, k, st);
  if (dtype == kBF16)
    return wgmma_takes(x, w, n, k)
               ? launch_wgmma_raw(x, w, static_cast<float*>(out), m, n, k,
                                  device, st)
               : launch_dot_probe<bf16, float>(x, w, out, m, n, k, st);
  if (dtype == kF32)
    return tf32_takes(x, w, n, k)
               ? launch_tf32(x, w, nullptr, nullptr, out, m, n, k, 0, 0, 0,
                             device, st)
               : launch_dot_probe<float, float>(x, w, out, m, n, k, st);
  return cudaErrorInvalidValue;
}

// The tile vit_dot_probe runs x (m, k) @ w (k, n) on, without launching:
// 1 the wgmma tile (K11's in int8, K2's in bf16, K2's tf32 tile in fp32),
// 0 gemm_tile.cuh's (vit_tpu_torch/tools/int8_probe.py:dot_tile asks it).
extern "C" int vit_dot_probe_tile(const void* x, const void* w, int n, int k,
                                  int dtype) {
  using namespace vit;
  if (dtype == kI8) return i8_wgmma_takes(x, w, n, k) ? 1 : 0;
  if (dtype == kBF16) return wgmma_takes(x, w, n, k) ? 1 : 0;
  if (dtype == kF32) return tf32_takes(x, w, n, k) ? 1 : 0;
  return 0;
}
