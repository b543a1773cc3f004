// K9's phase routines, shared by K9 (encoder_stack.cu) and its probe K24
// (encstack_probe.cu): the shared memory of a persistent block, one GEMM
// phase (every tile of a product strided over the grid, with K6's LN
// prologue) on gemm_tile.cuh's tile for fp32 and FOLD's patch projection,
// stack_phase for either type (bf16 on stack_wgmma.cuh's LN pass and wgmma
// phases), the tensor maps of the bf16 phases, and the cooperative launch
// of a persistent grid.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_core.cuh"
#include "gemm_tile.cuh"
#include "stack_wgmma.cuh"

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

// One GEMM phase of K9 or K24 and the grid barrier after it: act(LN(x) @ w)
// with LN, else x @ w, w the layer's (k, n) slice of a stacked weight,
// whose first row in the stacked (L*k, n) map is w_row0. fp32 runs
// gemm_phase (x and w read directly, K6's LN prologue). bf16 runs the
// wgmma phase on map_a over its A operand: without LN that is x; with LN,
// ln_pass first writes LN(x) into xn (map_a's buffer; it may be x) and a
// grid barrier follows (xn takes nullptr without LN, so it does not take
// part in deducing T). A workspace `ws` splits the phase over K, and
// reduce_phase sums the slices after a second barrier.
template <typename T>
struct NoDeduce {
  using type = T;
};

template <bool LN, typename T, typename W, typename Ep>
__device__ __forceinline__ void stack_phase(
    cooperative_groups::grid_group& grid, unsigned char* smem, const T* x,
    const W* w, const CUtensorMap* map_a, const CUtensorMap* map_w,
    int w_row0, int m, int n, int k, const T* ln_g, const T* ln_b, float eps,
    typename NoDeduce<T>::type* xn, float* ws, const Ep& ep) {
  if constexpr (std::is_same_v<T, bf16>) {
    uint8_t* sm = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
    if (LN) {
      sw::ln_pass(x, xn, m, k, ln_g, ln_b, eps);
      grid.sync();
    }
    sw::wgmma_phase<W>(sm, map_a, map_w, w_row0, m, n, k, ws, ep);
    if (ws) {
      const int splits = sw::phase_splits(m, n, k);
      if (splits > 1) {
        grid.sync();
        sw::reduce_phase(ws, splits, m, n, ep);
      }
    }
  } else {
    gemm_phase<LN>(x, w, m, n, k, ln_g, ln_b, eps, ep, smem);
  }
  grid.sync();
}

// The dynamic shared memory of K9 or K24: stack_smem, and for bf16 the
// wgmma phases' (all 227 KB), 0 where they do not take D (whole 64-column
// steps, the LN pass's 2048 at most).
template <typename T, typename W>
inline size_t stack_smem_all(int sp, int dh, int d) {
  const size_t base = stack_smem<T>(sp, dh);
  if constexpr (!std::is_same_v<T, bf16>) {
    return base;
  } else {
    if (d % 64 || d > sw::kMaxK) return 0;
    const size_t ph = sw::Layout<W>::kSmem;
    return ph > base ? ph : base;
  }
}

// Defined in matmul_wgmma.cu: a bf16 or int8 tensor map with 128-byte
// swizzle over a rows x cols row-major matrix, boxes of box_cols x
// box_rows.
bool tensor_map(CUtensorMap* map, const void* p, int rows, int cols, int ld,
                int box_cols, int box_rows);
bool tensor_map_i8(CUtensorMap* map, const void* p, int rows, int cols,
                   int ld, int box_cols, int box_rows);

// A bf16 phase's map over the (rows, cols) activation at p (64 x 64
// boxes), or over a stacked weight of rows L*K (bf16 64 x 64, int8 128 x
// 64); false if cuTensorMapEncodeTiled refuses it.
inline bool act_map(CUtensorMap* map, const void* p, int rows, int cols) {
  return tensor_map(map, p, rows, cols, cols, 64, 64);
}
template <typename W>
inline bool weight_map(CUtensorMap* map, const void* p, int rows, int cols) {
  if constexpr (sizeof(W) == 1)
    return tensor_map_i8(map, p, rows, cols, cols, 128, 64);
  else
    return tensor_map(map, p, rows, cols, cols, 64, 64);
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
