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

// ---------------------------------------------------------------- bf16 --

constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kLdA = kBK + 8;  // padded smem rows: 80 B, 16-byte aligned
constexpr int kLdB = kBN + 8;  // 272 B

// Stage the ROWS x COLS tile at (r0, c0) of a row-major R x C matrix with
// leading dimension ld into shared memory (leading dimension lds), zeros
// outside the matrix. A chunk of 8 values moves as one 16-byte load when it
// lies wholly inside and `vec` says the rows are 16-byte aligned.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst, int lds,
                                          const bf16* __restrict__ src,
                                          int ld, int r0, int c0, int R,
                                          int C, bool vec) {
  constexpr int kChunks = ROWS * COLS / 8;
  for (int ch = threadIdx.x; ch < kChunks; ch += kMmThreads) {
    const int r = ch / (COLS / 8), c = (ch % (COLS / 8)) * 8;
    const int gr = r0 + r, gc = c0 + c;
    bf16* d = dst + r * lds + c;
    const bf16* s = src + static_cast<size_t>(gr) * ld + gc;
    if (vec && gr < R && gc + 8 <= C) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (gr < R && gc + e < C) ? s[e] : __float2bfloat16_rn(0.f);
    }
  }
}

__global__ void __launch_bounds__(kMmThreads)
    matmul_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       Epilogue<bf16> ep, int k, bool vec_x, bool vec_w) {
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
    load_tile<kBM, kBK>(As, kLdA, x, k, m0, k0, ep.m, k, vec_x);
    load_tile<kBK, kBN>(Bs, kLdB, w, ep.n, k0, n0, k, ep.n, vec_w);
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

__global__ void __launch_bounds__(kMmThreads)
    matmul_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ w, Epilogue<float> ep,
                      int k) {
  __shared__ float As[kFBK][kFBM + 4];  // transposed: As[kk][row]
  __shared__ float Bs[kFBK][kFBN];

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < k; k0 += kFBK) {
    for (int e = threadIdx.x; e < kFBM * kFBK; e += kMmThreads) {
      const int r = e / kFBK, c = e % kFBK;
      const int gr = m0 + r, gc = k0 + c;
      As[c][r] = (gr < ep.m && gc < k) ? x[static_cast<size_t>(gr) * k + gc]
                                       : 0.f;
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

}  // namespace vit

extern "C" int vit_matmul(const void* x, const void* w, const void* bias,
                          const void* residual, void* out, int m, int n, int k,
                          int gelu_act, int dtype, int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    Epilogue<float> ep{static_cast<const float*>(bias),
                       static_cast<const float*>(residual),
                       static_cast<float*>(out), m, n, gelu_act};
    const dim3 grid((n + kFBN - 1) / kFBN, (m + kFBM - 1) / kFBM);
    matmul_f32_kernel<<<grid, kMmThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), ep, k);
  } else if (dtype == kBF16) {
    Epilogue<bf16> ep{static_cast<const bf16*>(bias),
                      static_cast<const bf16*>(residual),
                      static_cast<bf16*>(out), m, n, gelu_act};
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    const bool vec_x = aligned16(x) && k % 8 == 0;
    const bool vec_w = aligned16(w) && n % 8 == 0;
    matmul_bf16_kernel<<<grid, kMmThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), ep, k,
        vec_x, vec_w);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
