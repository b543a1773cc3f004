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
// 3072) the products are compute-bound. bf16 runs on the tensor cores
// through nvcuda::wmma 16x16x16 tiles (fp32 accumulate): a 64x128 block
// tile, K staged through shared memory 32 deep, eight warps of 32x32. fp32
// must multiply in true fp32 -- the JAX kernel runs fp32 at
// Precision.HIGHEST (matmul.py:37-45), and TF32 would break the golden bar
// -- so fp32 is a register-blocked FFMA kernel (64x64 tile, 4x4 outputs a
// thread). Neither is pipelined (no cp.async, TMA or wgmma yet): loads and
// math alternate, which is the first thing a later PR should change.
//
// Ragged M, N and K are masked: tiles are zero-filled past the edges in
// shared memory and the epilogue stores only inside (M, N). K is not padded
// in device memory.
//
// K6, fused_linear, is the same two kernels with an LN prologue
// (template flag LN). Replaces vit_tpu/ops/pallas/matmul.py:fused_linear
// (_fused_linear_kernel, _fused_linear_kernel_nk1): act(LN(x) @ W + b) +
// residual, with the row stats mu and rstd computed beforehand by K5
// (csrc/layernorm.cu), as JAX computes them with layernorm_stats. Each
// element of an A tile is normalised as it is staged into shared memory,
// ((x - mu) * rstd) * gamma + beta in fp32, rounded to the tensor's type --
// so LN(x) never reaches device memory and costs no extra pass over it.
// The zero-fill of a ragged K edge comes after the normalisation, not
// before: a zero x would normalise to beta - mu*rstd*gamma, not to zero
// (JAX gets its zeros by zero-padding gamma and beta, matmul.py:363-365).
// Without LN, the fused_linear wrapper launches K2, which has the same
// residual epilogue.

#include <mma.h>

#include "common.cuh"

namespace vit {

using namespace nvcuda;

constexpr int kMmThreads = 256;

template <typename T>
struct Epilogue {
  const T* bias;      // (N,) or null
  const T* residual;  // (M, N) or null
  T* out;             // (M, N)
  int m, n, gelu_act;

  __device__ __forceinline__ void store(int row, int col, float acc) const {
    if (row >= m || col >= n) return;
    float v = acc;
    if (bias) v += to_f32(bias[col]);
    if (gelu_act) v = gelu(v);
    const size_t idx = static_cast<size_t>(row) * n + col;
    if (residual) v += to_f32(residual[idx]);
    out[idx] = from_f32<T>(v);
  }
};

// The LN prologue of K6 on element (row, col) of x, in fp32.
template <typename T>
struct LnPrologue {
  const float* mu;    // (M,) row means
  const float* rstd;  // (M,) rsqrt(var + eps)
  const T* gamma;     // (K,)
  const T* beta;      // (K,)

  __device__ __forceinline__ float apply(float x, float m, float rs,
                                         int col) const {
    return (x - m) * rs * to_f32(gamma[col]) + to_f32(beta[col]);
  }
};

// ---------------------------------------------------------------- bf16 --

constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kLdA = kBK + 8;  // padded smem rows: 80 B, 16-byte aligned
constexpr int kLdB = kBN + 8;  // 272 B

// Stage the ROWS x COLS tile at (r0, c0) of a row-major R x C matrix with
// leading dimension ld into shared memory (leading dimension lds), zeros
// outside the matrix. A chunk of 8 values moves as one 16-byte load when it
// lies wholly inside and `vec` says the rows are 16-byte aligned. With LN,
// every value inside the matrix is normalised by `ln` (rows are rows of x,
// columns are K) before it is stored; values outside stay exact zeros.
template <int ROWS, int COLS, bool LN>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst, int lds,
                                          const bf16* __restrict__ src,
                                          int ld, int r0, int c0, int R,
                                          int C, bool vec,
                                          const LnPrologue<bf16>& ln) {
  constexpr int kChunks = ROWS * COLS / 8;
  for (int ch = threadIdx.x; ch < kChunks; ch += kMmThreads) {
    const int r = ch / (COLS / 8), c = (ch % (COLS / 8)) * 8;
    const int gr = r0 + r, gc = c0 + c;
    bf16* d = dst + r * lds + c;
    const bf16* s = src + static_cast<size_t>(gr) * ld + gc;
    float m = 0.f, rs = 0.f;
    if (LN && gr < R) {
      m = ln.mu[gr];
      rs = ln.rstd[gr];
    }
    if (vec && gr < R && gc + 8 <= C) {
      uint4 u = *reinterpret_cast<const uint4*>(s);
      if (LN) {
        bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          e[i] = from_f32<bf16>(ln.apply(to_f32(e[i]), m, rs, gc + i));
      }
      *reinterpret_cast<uint4*>(d) = u;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        bf16 v = __float2bfloat16_rn(0.f);
        if (gr < R && gc + e < C) {
          v = s[e];
          if (LN) v = from_f32<bf16>(ln.apply(to_f32(v), m, rs, gc + e));
        }
        d[e] = v;
      }
    }
  }
}

template <bool LN>
__global__ void __launch_bounds__(kMmThreads)
    matmul_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       Epilogue<bf16> ep, LnPrologue<bf16> ln, int k,
                       bool vec_x, bool vec_w) {
  __shared__ __align__(128) bf16 As[kBM * kLdA];
  __shared__ __align__(128) bf16 Bs[kBK * kLdB];
  __shared__ __align__(128) float Cs[kMmThreads / 32][16 * 16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / 4, wc = warp % 4;  // 2 x 4 warps, 32 x 32 each
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    load_tile<kBM, kBK, LN>(As, kLdA, x, k, m0, k0, ep.m, k, vec_x, ln);
    load_tile<kBK, kBN, false>(Bs, kLdB, w, ep.n, k0, n0, k, ep.n, vec_w, ln);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * kLdA + kk,
                               kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kLdB + wc * 32 + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue through a per-warp 16x16 fp32 tile in shared memory.
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        ep.store(m0 + wr * 32 + i * 16 + e / 16,
                 n0 + wc * 32 + j * 16 + e % 16, cs[e]);
      __syncwarp();
    }
}

// ---------------------------------------------------------------- fp32 --

constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

template <bool LN>
__global__ void __launch_bounds__(kMmThreads)
    matmul_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ w, Epilogue<float> ep,
                      LnPrologue<float> ln, int k) {
  __shared__ float As[kFBK][kFBM + 4];  // transposed: As[kk][row]
  __shared__ float Bs[kFBK][kFBN];

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < k; k0 += kFBK) {
    for (int e = threadIdx.x; e < kFBM * kFBK; e += kMmThreads) {
      const int r = e / kFBK, c = e % kFBK;
      const int gr = m0 + r, gc = k0 + c;
      float v = 0.f;
      if (gr < ep.m && gc < k) {
        v = x[static_cast<size_t>(gr) * k + gc];
        if (LN) v = ln.apply(v, ln.mu[gr], ln.rstd[gr], gc);
      }
      As[c][r] = v;
    }
    for (int e = threadIdx.x; e < kFBK * kFBN; e += kMmThreads) {
      const int r = e / kFBN, c = e % kFBN;
      const int gr = k0 + r, gc = n0 + c;
      Bs[r][c] = (gr < k && gc < ep.n)
                     ? w[static_cast<size_t>(gr) * ep.n + gc]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ep.store(m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
                         static_cast<const float*>(beta)};
    const dim3 grid((n + kFBN - 1) / kFBN, (m + kFBM - 1) / kFBM);
    matmul_f32_kernel<LN><<<grid, kMmThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), ep, ln,
        k);
  } else if (dtype == kBF16) {
    Epilogue<bf16> ep{static_cast<const bf16*>(bias),
                      static_cast<const bf16*>(residual),
                      static_cast<bf16*>(out), m, n, gelu_act};
    LnPrologue<bf16> ln{mu, rstd, static_cast<const bf16*>(gamma),
                        static_cast<const bf16*>(beta)};
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
