// The MLP chunk loop of K3 as device routines: for a block's tile of rows,
// already normalised into shared memory, acc += gelu(xn @ W1 + b1) @ W2
// over every MLP column, a chunk at a time, so that the (rows, mlp) hidden
// never reaches device memory. K3 (mlp_block.cu) seeds acc with x + b2 (or
// zero) and K18 (layer_block.cu) with the fp32 y + b2 of its out-projection;
// both then call these loops (vit_tpu/ops/pallas/block.py:_mlp_kernel,
// block.py:79-90, and _layer_kernel, block.py:1711-1719).
//
// bf16: 32 rows a block, eight warps. The fp32 accumulator (32 x D) lives in
// wmma fragments spread over the warps' registers (warp w owns columns
// [w*D/8, (w+1)*D/8): acc[i][j] is rows [16i, 16i+16), columns
// [(w*NT + j)*16, +16)). Each chunk's pre-activation (32 x 128 fp32) and its
// GELU'd copy rounded to bf16 (block.py:86) sit in caller-provided shared
// memory. D and mlp are multiples of 128.
//
// fp32: true fp32 FFMA (no TF32), 16 rows a block. Thread t computes hidden
// column c0+t of each 256-wide chunk and owns output columns t, t+256, ...
// of the accumulator, which stays in registers. Rows, D and mlp are masked.
//
// Every thread of the 256-thread block calls a loop together, after the
// normalised rows are complete in shared memory (the caller synchronises);
// the loop synchronises the block between chunks. The bf16 loop returns
// right after the last chunk's products, with no trailing barrier; the
// fp32 loop ends with one.

#pragma once

#include <mma.h>

#include "common.cuh"

namespace vit {

using namespace nvcuda;

constexpr int kMlpThreads = 256;
constexpr int kMlpWarps = kMlpThreads / 32;

using MlpFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// ---------------------------------------------------------------- bf16 --

constexpr int kMlpBM = 32;   // rows a block
constexpr int kMlpCT = 128;  // MLP columns a chunk

// Shared memory of one chunk: the fp32 pre-activation and its bf16 copy.
constexpr size_t kMlpChunkBytes =
    kMlpBM * kMlpCT * (sizeof(float) + sizeof(bf16));

// xn: kMlpBM x D bf16; hpre: kMlpBM x kMlpCT fp32; hb: kMlpBM x kMlpCT bf16.
template <int NT>  // D = NT * 128
__device__ __forceinline__ void mlp_chunks_bf16(
    const bf16* xn, float* hpre, bf16* hb, const bf16* __restrict__ w1,
    const bf16* __restrict__ b1, const bf16* __restrict__ w2, int mlp,
    MlpFrag (&acc)[2][NT]) {
  constexpr int D = NT * 128;
  const int warp = threadIdx.x / 32;
  for (int c0 = 0; c0 < mlp; c0 += kMlpCT) {
    // fc1: warp w computes chunk columns [16w, 16w+16) for all 32 rows.
    MlpFrag h[2];
    wmma::fill_fragment(h[0], 0.f);
    wmma::fill_fragment(h[1], 0.f);
    const bf16* w1c = w1 + c0 + warp * 16;
    for (int k = 0; k < D; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> wb;
      wmma::load_matrix_sync(wb, w1c + static_cast<size_t>(k) * mlp, mlp);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xn + i * 16 * D + k, D);
        wmma::mma_sync(h[i], a, wb, h[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::store_matrix_sync(hpre + i * 16 * kMlpCT + warp * 16, h[i],
                              kMlpCT, wmma::mem_row_major);
    __syncthreads();  // pre-activation chunk complete; the previous
                      // chunk's fc2 reads of hb are done too
    for (int e = threadIdx.x; e < kMlpBM * kMlpCT; e += kMlpThreads)
      hb[e] = from_f32<bf16>(gelu(hpre[e] + to_f32(b1[c0 + e % kMlpCT])));
    __syncthreads();  // h complete

    // fc2: acc += h (32 x 128) @ W2[c0:c0+128, warp's columns].
#pragma unroll 2
    for (int kk = 0; kk < kMlpCT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], hb + i * 16 * kMlpCT + kk, kMlpCT);
      const bf16* w2r = w2 + static_cast<size_t>(c0 + kk) * D;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> wb;
        wmma::load_matrix_sync(wb, w2r + (warp * NT + j) * 16, D);
        wmma::mma_sync(acc[0][j], a[0], wb, acc[0][j]);
        wmma::mma_sync(acc[1][j], a[1], wb, acc[1][j]);
      }
    }
  }
}

// ---------------------------------------------------------------- fp32 --

constexpr int kMlpFBM = 16;   // rows a block
constexpr int kMlpFCT = 256;  // MLP columns a chunk (one a thread)

// xn: kMlpFBM x d fp32; hs: kMlpFBM x kMlpFCT fp32. acc[r][j] is row r,
// column t + 256*j.
template <int NJ>
__device__ __forceinline__ void mlp_chunks_f32(
    const float* xn, float* hs, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2, int d,
    int mlp, float (&acc)[kMlpFBM][NJ]) {
  const int t = threadIdx.x;
  for (int c0 = 0; c0 < mlp; c0 += kMlpFCT) {
    const int c = c0 + t;
    float a[kMlpFBM];
#pragma unroll
    for (int r = 0; r < kMlpFBM; ++r) a[r] = 0.f;
    if (c < mlp) {
      for (int k = 0; k < d; ++k) {
        const float wv = w1[static_cast<size_t>(k) * mlp + c];
#pragma unroll
        for (int r = 0; r < kMlpFBM; ++r) a[r] = fmaf(xn[r * d + k], wv, a[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kMlpFBM; ++r)
      hs[r * kMlpFCT + t] = c < mlp ? gelu(a[r] + b1[c]) : 0.f;
    __syncthreads();  // chunk complete

    const int cn = min(kMlpFCT, mlp - c0);
    for (int cc = 0; cc < cn; ++cc) {
      const float* w2r = w2 + static_cast<size_t>(c0 + cc) * d;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = t + j * kMlpThreads;
        if (n < d) {
          const float wv = w2r[n];
#pragma unroll
          for (int r = 0; r < kMlpFBM; ++r)
            acc[r][j] = fmaf(hs[r * kMlpFCT + cc], wv, acc[r][j]);
        }
      }
    }
    // The next chunk overwrites hs. With this barrier before the write in
    // place of here, ptxas gave K3's fp32 kernel 80 registers in place of
    // 103 and it ran 1.3 times slower.
    __syncthreads();
  }
}

}  // namespace vit
