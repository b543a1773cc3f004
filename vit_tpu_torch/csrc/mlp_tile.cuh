// The fp32 MLP chunk loop of K3 and K18 as device routines: for a block's
// tile of rows, already normalised into shared memory, acc += gelu(xn @ W1
// + b1) @ W2 over every MLP column, a chunk at a time, so that the (rows,
// mlp) hidden never reaches device memory. K3 (mlp_block.cu) seeds acc
// with x + b2 (or zero) and K18 (layer_block.cu) with the fp32 y + b2 of
// its out-projection; both then call this loop (vit_tpu/ops/pallas/
// block.py:_mlp_kernel, block.py:79-90, and _layer_kernel,
// block.py:1711-1719). Their bf16 forms run on mlp_wgmma.cuh's tile.
//
// True fp32 FFMA (no TF32), 16 rows a block. Thread t computes hidden
// column c0+t of each 256-wide chunk and owns output columns t, t+256, ...
// of the accumulator, which stays in registers. Rows, D and mlp are
// masked. Every thread of the 256-thread block calls the loop together,
// after the normalised rows are complete in shared memory (the caller
// synchronises); the loop synchronises the block between chunks and ends
// with a barrier.

#pragma once

#include "common.cuh"

namespace vit {

constexpr int kMlpThreads = 256;
constexpr int kMlpWarps = kMlpThreads / 32;

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
