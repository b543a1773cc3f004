// K2: tiled GEMM, (M,K) @ (K,N) with W in the params' (in, out) row-major
// layout, an fp32 accumulator, and the epilogue bias -> erf-GELU ->
// residual, all in fp32, then one cast.
//
// Replaces vit_tpu/ops/pallas/matmul.py:matmul (_matmul_kernel,
// _matmul_kernel_nk1). The residual is this port's one extension: the split
// attn_block ends with ctx @ Wout + bout + x, rounded once, exactly as
// _attn_core does (vit_tpu/ops/pallas/block.py:694-699).
//
// Bound on the card: at the slice's shapes (M = 6656, K and N of 768 to
// 3072) the products are compute-bound. Two tiles, chosen by the wrapper
// (ops/cuda/matmul.py:gemm_path) from shape and alignment alone:
// - where TMA can read both operands (16-byte-aligned bases, row strides
//   a multiple of 16 bytes) a persistent 128 x 128 wgmma tile fed by TMA,
//   which also reads an operand given as the transpose of a contiguous
//   matrix (trans_a: x is the view of a (k, m) matrix; trans_b: w is the
//   view of an (n, k) one): in bf16 gemm_wgmma.cuh's, launched by
//   matmul_wgmma.cu; in fp32 gemm_tf32.cuh's, launched by matmul_tf32.cu,
//   each product three TF32 passes on the tensor cores (tf32_split.cuh),
//   the counterpart of JAX's Precision.HIGHEST (0.143 ms of them at the
//   QKV at 495 TFLOP/s);
// - otherwise the device routine of gemm_tile.cuh, which K6, K8, K9 and
//   K11 share: wmma bf16 64x128 tiles or true-fp32 FFMA 64x64 tiles,
//   ragged edges masked, not pipelined, one block a tile; its operands
//   are contiguous.
//
// K6, fused_linear, is the same two tiles with an LN prologue. Replaces
// vit_tpu/ops/pallas/matmul.py:fused_linear (_fused_linear_kernel,
// _fused_linear_kernel_nk1, its pallas_call at :388): act(LN(x) @ W + b) +
// residual, with the row stats mu and rstd computed beforehand by K5
// (csrc/layernorm.cu), as JAX computes them with layernorm_stats; LN in
// fp32, ((x - mu) * rstd) * gamma + beta, rounded to the dtype before the
// product (bf16; fp32 is not rounded). LN(x) never reaches device memory.
// Where TMA can read x and w (gemm_path's rule on the contiguous operands:
// wgmma_takes in bf16, tf32_takes in fp32) K6 runs on the dtype's wgmma
// tile: in bf16 x's raw box arrives by TMA and the producer warpgroup's
// idle warps normalise it in shared memory (K5's row stats, each step's
// gamma and beta loaded before its box arrives, columns past K exact
// zeros) before the consumers' wgmma reads it (gemm_wgmma.cuh); in fp32
// each consumer thread normalises its A fragments as it loads them from
// the raw box, before the three-pass split (gemm_tf32.cuh, launched by
// matmul_tf32.cu; columns past K exact zeros). Elsewhere each element of
// an A tile of gemm_tile.cuh is normalised as it is staged (template flag
// LN). Without LN, the fused_linear wrapper launches K2, which has the
// same residual epilogue.
//
// K11, matmul_i8: xq (M, K) int8 @ wq (K, N) int8 with exact int32 sums,
// then in fp32 (acc * ax[row]) * wscale[col], + bias, GELU, + residual, one
// cast to bf16 or fp32. It is the int8 projection of the int8 tier: the
// second and fifth launches of attn_block_q on Hopper (the QKV and
// out-projection dots of vit_tpu/ops/pallas/block.py:_attn_q_core,
// :1226-1231 and :1255-1258, with the + bout + x of _attn_q_kernel :1275-
// 1276), and the product of vit_tpu/quant.py:int8_matmul. The same tile
// loop as K2 (gemm_tile.cuh) on s8 wmma fragments, K staged 64 deep, one
// block a 64x128 tile. Bound on the card: compute at B/16 bs=32's QKV
// (2*6656*768*2304 = 23.6 GOP, 11.9 us at 1,979 TOP/s), device memory at
// its out-projection (26 MB in all, 7.8 us at 3.35 TB/s). The epilogue
// follows the plain version's order with __fmul_rn / __fadd_rn, so the two
// agree bit for bit without GELU.

#include "gemm_tile.cuh"

namespace vit {

template <typename T>
struct Epilogue {
  const T* bias;      // (N,) or null
  const T* residual;  // (M, N) or null
  T* out;             // (M, N)
  int m, n, gelu_act;

  __device__ __forceinline__ void store(int row, int col, float acc) const {
    float v = acc;
    if (bias) v += to_f32(bias[col]);
    if (gelu_act) v = gelu(v);
    const size_t idx = static_cast<size_t>(row) * n + col;
    if (residual) v += to_f32(residual[idx]);
    out[idx] = from_f32<T>(v);
  }
};

// K11's epilogue: bias, residual and out in O (bf16 or fp32); ax (M,) and
// wscale (N,) fp32.
template <typename O>
struct I8Epilogue {
  const float* ax;
  const float* wscale;
  const O* bias;      // (N,) or null
  const O* residual;  // (M, N) or null
  O* out;             // (M, N)
  int m, n, gelu_act;

  __device__ __forceinline__ void store(int row, int col, int acc) const {
    float v = dequant(acc, ax[row], wscale[col]);
    if (bias) v = __fadd_rn(v, to_f32(bias[col]));
    if (gelu_act) v = gelu(v);
    const size_t idx = static_cast<size_t>(row) * n + col;
    if (residual) v = __fadd_rn(v, to_f32(residual[idx]));
    out[idx] = from_f32<O>(v);
  }
};

template <typename O>
__global__ void __launch_bounds__(kMmThreads)
    matmul_i8_kernel(const signed char* __restrict__ xq,
                     const signed char* __restrict__ wq, I8Epilogue<O> ep,
                     int k, bool vec_x, bool vec_w) {
  __shared__ GemmSmemI8 sm;
  gemm_tile<false>(xq, wq, ep.m, ep.n, k, blockIdx.y * kBM,
                   blockIdx.x * kBN, vec_x, vec_w, LnPrologue<signed char>{},
                   ep, sm);
}

template <bool LN>
__global__ void __launch_bounds__(kMmThreads)
    matmul_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       Epilogue<bf16> ep, LnPrologue<bf16> ln, int k,
                       bool vec_x, bool vec_w) {
  __shared__ GemmSmemBf16 sm;
  gemm_tile<LN>(x, w, ep.m, ep.n, k, blockIdx.y * kBM, blockIdx.x * kBN,
                vec_x, vec_w, ln, ep, sm);
}

template <bool LN>
__global__ void __launch_bounds__(kMmThreads)
    matmul_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ w, Epilogue<float> ep,
                      LnPrologue<float> ln, int k) {
  __shared__ GemmSmemF32 sm;
  gemm_tile<LN>(x, w, ep.m, ep.n, k, blockIdx.y * kFBM, blockIdx.x * kFBN,
                false, false, ln, ep, sm);
}

// K2 (LN false) or K6 (LN true) on the current stream.
template <typename O>
int launch_matmul_i8(const signed char* xq, const float* ax,
                     const signed char* wq, const float* wscale,
                     const void* bias, const void* residual, void* out, int m,
                     int n, int k, int gelu_act, cudaStream_t st) {
  I8Epilogue<O> ep{ax, wscale, static_cast<const O*>(bias),
                   static_cast<const O*>(residual), static_cast<O*>(out), m,
                   n, gelu_act};
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_i8_kernel<O><<<grid, kMmThreads, 0, st>>>(
      xq, wq, ep, k, vec_ok<signed char, signed char>(xq, k),
      vec_ok<signed char, signed char>(wq, n));
  return cudaGetLastError();
}

template <bool LN>
int launch_gemm(const void* x, const void* w, const void* bias,
                const void* residual, const float* mu, const float* rstd,
                const void* gamma, const void* beta, void* out, int m, int n,
                int k, int gelu_act, int dtype, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  if (LN && !(mu && rstd && gamma && beta)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    Epilogue<float> ep{static_cast<const float*>(bias),
                       static_cast<const float*>(residual),
                       static_cast<float*>(out), m, n, gelu_act};
    LnPrologue<float> ln{mu, rstd, static_cast<const float*>(gamma),
                         static_cast<const float*>(beta), 0};
    const dim3 grid((n + kFBN - 1) / kFBN, (m + kFBM - 1) / kFBM);
    matmul_f32_kernel<LN><<<grid, kMmThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), ep, ln,
        k);
  } else if (dtype == kBF16) {
    Epilogue<bf16> ep{static_cast<const bf16*>(bias),
                      static_cast<const bf16*>(residual),
                      static_cast<bf16*>(out), m, n, gelu_act};
    LnPrologue<bf16> ln{mu, rstd, static_cast<const bf16*>(gamma),
                        static_cast<const bf16*>(beta), 0};
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    const bool vec_x = aligned16(x) && k % 8 == 0;
    const bool vec_w = aligned16(w) && n % 8 == 0;
    matmul_bf16_kernel<LN><<<grid, kMmThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), ep, ln, k,
        vec_x, vec_w);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// K2 and K6 on the wgmma tile (csrc/matmul_wgmma.cu, its own unit, so
// that the kernels here compile as they did before it).
cudaError_t launch_wgmma(const void* x, const void* w, const void* bias,
                         const void* residual, void* out, int m, int n, int k,
                         int gelu_act, int trans_a, int trans_b, int device,
                         cudaStream_t st);
cudaError_t launch_wgmma_ln(const void* x, const void* w, const void* bias,
                            const void* residual, const float* mu,
                            const float* rstd, const void* gamma,
                            const void* beta, void* out, int m, int n, int k,
                            int gelu_act, int device, cudaStream_t st);
bool wgmma_takes(const void* x, const void* w, int n, int k);
// K2 and K6 in fp32 on the tf32 wgmma tile (csrc/matmul_tf32.cu).
cudaError_t launch_tf32(const void* x, const void* w, const void* bias,
                        const void* residual, void* out, int m, int n, int k,
                        int gelu_act, int trans_a, int trans_b, int device,
                        cudaStream_t st);
cudaError_t launch_tf32_ln(const void* x, const void* w, const void* bias,
                           const void* residual, const float* mu,
                           const float* rstd, const void* gamma,
                           const void* beta, void* out, int m, int n, int k,
                           int gelu_act, int device, cudaStream_t st);
bool tf32_takes(const void* x, const void* w, int n, int k);

}  // namespace vit

// K2. tile 0: gemm_tile.cuh's tile (bf16 wmma or fp32 FFMA; no transposed
// operand); tile 1: the wgmma tile of the dtype (bf16: gemm_wgmma.cuh; fp32:
// gemm_tf32.cuh's three-pass TF32 split), with trans_a (x is the view of a
// contiguous (k, m) matrix) and trans_b (w is the view of a contiguous
// (n, k) matrix).
extern "C" int vit_matmul(const void* x, const void* w, const void* bias,
                          const void* residual, void* out, int m, int n, int k,
                          int gelu_act, int trans_a, int trans_b, int tile,
                          int dtype, int device, void* stream) {
  using namespace vit;
  if (tile == 0) {
    if (trans_a || trans_b) return cudaErrorInvalidValue;
    return launch_gemm<false>(x, w, bias, residual, nullptr, nullptr, nullptr,
                              nullptr, out, m, n, k, gelu_act, dtype, device,
                              stream);
  }
  if (tile != 1 || (dtype != kBF16 && dtype != kF32))
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_tf32(x, w, bias, residual, out, m, n, k, gelu_act, trans_a,
                       trans_b, device, static_cast<cudaStream_t>(stream));
  return launch_wgmma(x, w, bias, residual, out, m, n, k, gelu_act, trans_a,
                      trans_b, device, static_cast<cudaStream_t>(stream));
}

// The tile K6 runs (x, w) on: 1 the dtype's wgmma tile (bf16
// gemm_wgmma.cuh's, fp32 gemm_tf32.cuh's), 0 gemm_tile.cuh's (bf16 wmma,
// fp32 FFMA). The tile is chosen from these alone, before the launch;
// vit_fused_linear runs the one this returns.
extern "C" int vit_fused_linear_tile(const void* x, const void* w, int n,
                                     int k, int dtype) {
  if (dtype == vit::kBF16) return vit::wgmma_takes(x, w, n, k) ? 1 : 0;
  if (dtype == vit::kF32) return vit::tf32_takes(x, w, n, k) ? 1 : 0;
  return 0;
}

// K6: K2 with the LN prologue, x (m, k) and w (k, n) contiguous; mu, rstd,
// gamma and beta must all be set.
extern "C" int vit_fused_linear(const void* x, const void* w,
                                const void* bias, const void* residual,
                                const void* mu, const void* rstd,
                                const void* gamma, const void* beta,
                                void* out, int m, int n, int k, int gelu_act,
                                int dtype, int device, void* stream) {
  using namespace vit;
  auto* mu32 = static_cast<const float*>(mu);
  auto* rs32 = static_cast<const float*>(rstd);
  if (vit_fused_linear_tile(x, w, n, k, dtype) == 0)
    return launch_gemm<true>(x, w, bias, residual, mu32, rs32, gamma, beta,
                             out, m, n, k, gelu_act, dtype, device, stream);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || n <= 0 || k <= 0 || !(mu && rstd && gamma && beta))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_tf32_ln(x, w, bias, residual, mu32, rs32, gamma, beta, out,
                          m, n, k, gelu_act, device, st);
  return launch_wgmma_ln(x, w, bias, residual, mu32, rs32, gamma, beta, out,
                         m, n, k, gelu_act, device, st);
}

// K11: xq (m, k) int8, ax (m,) fp32, wq (k, n) int8, wscale (n,) fp32; bias
// (n,), residual (m, n) and out (m, n) in the dtype (bias and residual may
// be null).
extern "C" int vit_matmul_i8(const void* xq, const void* ax, const void* wq,
                             const void* wscale, const void* bias,
                             const void* residual, void* out, int m, int n,
                             int k, int gelu_act, int dtype, int device,
                             void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* x8 = static_cast<const signed char*>(xq);
  auto* w8 = static_cast<const signed char*>(wq);
  auto* a = static_cast<const float*>(ax);
  auto* s = static_cast<const float*>(wscale);
  if (dtype == kF32)
    return launch_matmul_i8<float>(x8, a, w8, s, bias, residual, out, m, n,
                                   k, gelu_act, st);
  if (dtype == kBF16)
    return launch_matmul_i8<bf16>(x8, a, w8, s, bias, residual, out, m, n, k,
                                  gelu_act, st);
  return cudaErrorInvalidValue;
}
