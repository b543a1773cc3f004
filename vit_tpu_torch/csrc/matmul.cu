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
// 3072) the products are compute-bound. The tile loop -- wmma bf16 64x128
// tiles, true-fp32 FFMA 64x64 tiles, ragged edges masked, not pipelined --
// is the device routine of gemm_tile.cuh, which K8 and K9 share; the two
// kernels here launch one block a tile. Pipelining the loads (cp.async or
// TMA) and moving to wgmma is the first thing a later PR should change.
//
// K6, fused_linear, is the same two kernels with an LN prologue
// (template flag LN). Replaces vit_tpu/ops/pallas/matmul.py:fused_linear
// (_fused_linear_kernel, _fused_linear_kernel_nk1): act(LN(x) @ W + b) +
// residual, with the row stats mu and rstd computed beforehand by K5
// (csrc/layernorm.cu), as JAX computes them with layernorm_stats. Each
// element of an A tile is normalised as it is staged into shared memory
// (gemm_tile.cuh), so LN(x) never reaches device memory and costs no extra
// pass over it. Without LN, the fused_linear wrapper launches K2, which has
// the same residual epilogue.

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

}  // namespace vit

extern "C" int vit_matmul(const void* x, const void* w, const void* bias,
                          const void* residual, void* out, int m, int n, int k,
                          int gelu_act, int dtype, int device, void* stream) {
  return vit::launch_gemm<false>(x, w, bias, residual, nullptr, nullptr,
                                 nullptr, nullptr, out, m, n, k, gelu_act,
                                 dtype, device, stream);
}

// K6: K2 with the LN prologue; mu, rstd, gamma and beta must all be set.
extern "C" int vit_fused_linear(const void* x, const void* w,
                                const void* bias, const void* residual,
                                const void* mu, const void* rstd,
                                const void* gamma, const void* beta,
                                void* out, int m, int n, int k, int gelu_act,
                                int dtype, int device, void* stream) {
  return vit::launch_gemm<true>(x, w, bias, residual,
                                static_cast<const float*>(mu),
                                static_cast<const float*>(rstd), gamma, beta,
                                out, m, n, k, gelu_act, dtype, device, stream);
}
