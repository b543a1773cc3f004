// K9's phase routines, shared by K9 (encoder_stack.cu) and its probe K24
// (encstack_probe.cu): the shared memory of a persistent block, one GEMM
// phase (every tile of a product strided over the grid, with K6's LN
// prologue), and the cooperative launch of a persistent grid.

#pragma once

#include "attention_core.cuh"
#include "gemm_tile.cuh"

namespace vit {

static_assert(kAttnThreads == kMmThreads, "one block size for all phases");

constexpr size_t kStackMaxSmem = 232448;  // 227 KB a block on Hopper

// Dynamic shared memory: the larger of a GEMM phase's (the tile routine's
// buffers, then a tile's LN mean and rstd) and an attention tile's.
template <typename T>
inline size_t stack_smem(int sp, int dh) {
  const size_t gemm =
      sizeof(typename Gemm<T>::Smem) + 2 * Gemm<T>::BM * sizeof(float);
  const size_t attn = attention_smem<T>(sp, dh);
  return attn > gemm ? attn : gemm;
}

// One GEMM phase: every (BM x BN) tile of x (m, k) @ w (k, n), strided over
// the grid. With LN, a tile first computes its rows' LN stats into shared
// memory, then normalises x with ln_g, ln_b while staging it.
template <bool LN, typename T, typename W, typename Ep>
__device__ __forceinline__ void gemm_phase(const T* x, const W* w, int m,
                                           int n, int k, const T* ln_g,
                                           const T* ln_b, float eps,
                                           const Ep& ep,
                                           unsigned char* smem) {
  auto& sm = *reinterpret_cast<typename Gemm<T>::Smem*>(smem);
  float* mu = reinterpret_cast<float*>(smem + sizeof(typename Gemm<T>::Smem));
  float* rstd = mu + Gemm<T>::BM;
  const bool vec_x = aligned16(x) && k % 8 == 0;
  const bool vec_w = vec_ok<T, W>(w, n);
  const int tn = (n + Gemm<T>::BN - 1) / Gemm<T>::BN;
  const int tiles = (m + Gemm<T>::BM - 1) / Gemm<T>::BM * tn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / tn * Gemm<T>::BM, n0 = t % tn * Gemm<T>::BN;
    if (LN) {
      __syncthreads();  // the previous tile's readers of the stats are done
      for (int r = warp; r < Gemm<T>::BM; r += kMmThreads / 32) {
        if (m0 + r >= m) continue;
        const float2 st =
            row_stats(x + static_cast<size_t>(m0 + r) * k, k, eps, lane);
        if (lane == 0) {
          mu[r] = st.x;
          rstd[r] = st.y;
        }
      }
      // gemm_tile synchronises the block before it stages x.
    }
    gemm_tile<LN>(x, w, m, n, k, m0, n0, vec_x, vec_w,
                  LnPrologue<T>{mu, rstd, ln_g, ln_b, m0}, ep, sm);
  }
}

// The grid of a cooperative persistent kernel: as many blocks of
// kMmThreads as fit on the card at once with `smem` bytes of dynamic shared
// memory each (cudaOccupancyMaxActiveBlocksPerMultiprocessor), after the
// kernel is allowed that much.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int device,
                            int* grid) {
  if (smem > kStackMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kMmThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *grid = per_sm * sms;
  return cudaSuccess;
}

// Launch `kernel(a)` cooperatively on `grid` blocks (every block resident,
// so that grid-wide barriers are legal).
template <typename Kernel, typename Args>
cudaError_t launch_persistent(Kernel kernel, Args& a, size_t smem, int grid,
                              cudaStream_t st) {
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kMmThreads),
      params, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace vit
