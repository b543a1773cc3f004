// K2's tile loop as a device routine: one output tile of act(LN(x) @ w) at
// tile coordinates (m0, n0), handed element by element to an epilogue
// functor. K2 and K6 (matmul.cu), K8 (embed.cu) and the GEMM phases of K9
// (encoder_stack.cu) are its callers; each brings its own epilogue
// (`void store(int row, int col, float acc) const`, called only for
// elements inside (m, n)) and its own shared memory.
//
// bf16 runs on the tensor cores through nvcuda::wmma 16x16x16 tiles (fp32
// accumulate): a 64x128 tile, K staged through shared memory 32 deep, eight
// warps of 32x32. fp32 multiplies in true fp32 -- the JAX kernels run fp32
// at Precision.HIGHEST (vit_tpu/ops/pallas/matmul.py:37-45), and TF32 would
// break the golden bar -- as a register-blocked FFMA loop (64x64 tile, 4x4
// outputs a thread). Neither is pipelined (no cp.async, TMA or wgmma yet):
// loads and math alternate.
//
// Ragged M, N and K are masked: tiles are zero-filled past the edges in
// shared memory. K is not padded in device memory.
//
// With LN (K6's prologue) each element of an x tile is normalised as it is
// staged, ((x - mu) * rstd) * gamma + beta in fp32, rounded to the tensor's
// type. The zero-fill of a ragged K edge comes after the normalisation, not
// before: a zero x would normalise to beta - mu*rstd*gamma, not to zero
// (JAX gets its zeros by zero-padding gamma and beta, matmul.py:363-365).
//
// Every block of 256 threads must call the routine together: it
// synchronises the block. It neither reads nor writes anything but x, w,
// the LN rows and what the epilogue touches, so a persistent kernel may
// call it for one tile after another.

#pragma once

#include <mma.h>

#include "common.cuh"

namespace vit {

constexpr int kMmThreads = 256;

// The LN prologue of K6, in fp32: `stats` reads a row's mean and rstd
// (once per staged chunk), `apply` normalises element (row, col) with
// them. mu and rstd are indexed by row - row0: K6 passes whole-matrix
// stats (row0 = 0), K9 the stats of one tile's rows in shared memory
// (row0 = the tile's m0).
template <typename T>
struct LnPrologue {
  const float* mu;
  const float* rstd;
  const T* gamma;  // (K,)
  const T* beta;   // (K,)
  int row0;

  __device__ __forceinline__ float2 stats(int row) const {
    return make_float2(mu[row - row0], rstd[row - row0]);
  }
  __device__ __forceinline__ float apply(float x, float2 st, int col) const {
    return (x - st.x) * st.y * to_f32(gamma[col]) + to_f32(beta[col]);
  }
};

// ---------------------------------------------------------------- bf16 --

constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kLdA = kBK + 8;  // padded smem rows: 80 B, 16-byte aligned
constexpr int kLdB = kBN + 8;  // 272 B

struct __align__(128) GemmSmemBf16 {
  bf16 a[kBM * kLdA];                  // 5120 B
  bf16 b[kBK * kLdB];                  // 8704 B
  float c[kMmThreads / 32][16 * 16];   // per-warp epilogue tile, 8192 B
};

// Stage the ROWS x COLS tile at (r0, c0) of a row-major R x C matrix with
// leading dimension ld into shared memory (leading dimension lds), zeros
// outside the matrix. A chunk of 8 values moves as one 16-byte load when it
// lies wholly inside and `vec` says the rows are 16-byte aligned. With LN,
// every value inside the matrix is normalised by `ln` (rows are rows of x,
// columns are K) before it is stored; values outside stay exact zeros.
template <int ROWS, int COLS, bool LN>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst, int lds,
                                          const bf16* src, int ld, int r0,
                                          int c0, int R, int C, bool vec,
                                          const LnPrologue<bf16>& ln) {
  constexpr int kChunks = ROWS * COLS / 8;
  for (int ch = threadIdx.x; ch < kChunks; ch += kMmThreads) {
    const int r = ch / (COLS / 8), c = (ch % (COLS / 8)) * 8;
    const int gr = r0 + r, gc = c0 + c;
    bf16* d = dst + r * lds + c;
    const bf16* s = src + static_cast<size_t>(gr) * ld + gc;
    float2 st = make_float2(0.f, 0.f);
    if (LN && gr < R) st = ln.stats(gr);
    if (vec && gr < R && gc + 8 <= C) {
      uint4 u = *reinterpret_cast<const uint4*>(s);
      if (LN) {
        bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          e[i] = from_f32<bf16>(ln.apply(to_f32(e[i]), st, gc + i));
      }
      *reinterpret_cast<uint4*>(d) = u;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        bf16 v = __float2bfloat16_rn(0.f);
        if (gr < R && gc + e < C) {
          v = s[e];
          if (LN) v = from_f32<bf16>(ln.apply(to_f32(v), st, gc + e));
        }
        d[e] = v;
      }
    }
  }
}

// One kBM x kBN tile at (m0, n0) of x (m, k) @ w (k, n), bf16 in, fp32 sums.
template <bool LN, typename Ep>
__device__ __forceinline__ void gemm_tile(const bf16* x, const bf16* w, int m,
                                          int n, int k, int m0, int n0,
                                          bool vec_x, bool vec_w,
                                          const LnPrologue<bf16>& ln,
                                          const Ep& ep, GemmSmemBf16& sm) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / 4, wc = warp % 4;  // 2 x 4 warps, 32 x 32 each

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  __syncthreads();  // the previous tile's readers of sm are done
  for (int k0 = 0; k0 < k; k0 += kBK) {
    load_tile<kBM, kBK, LN>(sm.a, kLdA, x, k, m0, k0, m, k, vec_x, ln);
    load_tile<kBK, kBN, false>(sm.b, kLdB, w, n, k0, n0, k, n, vec_w, ln);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sm.a + (wr * 32 + i * 16) * kLdA + kk,
                               kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sm.b + kk * kLdB + wc * 32 + j * 16,
                               kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue through a per-warp 16x16 fp32 tile in shared memory.
  float* cs = sm.c[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + wr * 32 + i * 16 + e / 16;
        const int col = n0 + wc * 32 + j * 16 + e % 16;
        if (row < m && col < n) ep.store(row, col, cs[e]);
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------- fp32 --

constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

struct __align__(16) GemmSmemF32 {
  float a[kFBK][kFBM + 4];  // transposed: a[kk][row]
  float b[kFBK][kFBN];
};

// One kFBM x kFBN tile at (m0, n0) of x (m, k) @ w (k, n), fp32 FFMA.
template <bool LN, typename Ep>
__device__ __forceinline__ void gemm_tile(const float* x, const float* w,
                                          int m, int n, int k, int m0, int n0,
                                          bool /*vec_x*/, bool /*vec_w*/,
                                          const LnPrologue<float>& ln,
                                          const Ep& ep, GemmSmemF32& sm) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  __syncthreads();  // the previous tile's readers of sm are done
  for (int k0 = 0; k0 < k; k0 += kFBK) {
    for (int e = threadIdx.x; e < kFBM * kFBK; e += kMmThreads) {
      const int r = e / kFBK, c = e % kFBK;
      const int gr = m0 + r, gc = k0 + c;
      float v = 0.f;
      if (gr < m && gc < k) {
        v = x[static_cast<size_t>(gr) * k + gc];
        if (LN) v = ln.apply(v, ln.stats(gr), gc);
      }
      sm.a[c][r] = v;
    }
    for (int e = threadIdx.x; e < kFBK * kFBN; e += kMmThreads) {
      const int r = e / kFBN, c = e % kFBN;
      const int gr = k0 + r, gc = n0 + c;
      sm.b[r][c] =
          (gr < k && gc < n) ? w[static_cast<size_t>(gr) * n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.b[kk][tx + 16 * j];
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
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < m && col < n) ep.store(row, col, acc[i][j]);
    }
}

// Tile shape and shared memory of the routine for each type.
template <typename T>
struct Gemm;
template <>
struct Gemm<bf16> {
  static constexpr int BM = kBM, BN = kBN;
  using Smem = GemmSmemBf16;
};
template <>
struct Gemm<float> {
  static constexpr int BM = kFBM, BN = kFBN;
  using Smem = GemmSmemF32;
};

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace vit
