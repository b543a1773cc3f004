// K12: the int8 MLP half of an encoder layer in one kernel,
//   out = x + fc2(gelu(fc1(LN(x)))) with both products s8 x s8 -> s32,
// and the (M, mlp) hidden never reaches device memory.
//
// Replaces vit_tpu/ops/pallas/block.py:mlp_block_i8dot (_mlp_i8dot_kernel,
// block.py:511-560) and its stacked form (mlp_block_q_stacked with i8dot,
// :1588; layer l's weights are the view w[l]). As there, a block owns a
// tile of rows: LN in fp32, not rounded to the tensor's type, quantized per
// row (ax = max(max|xn|, 1e-12) / 127, xq = round(xn / ax)) into shared
// memory by quantize_row (common.cuh, K10's routine); the fp32 accumulator
// seeded with x + b2 in shared memory; then, for each group of 512 hidden
// columns, h = gelu((acc1 * ax) * s1 + b1) in fp32, the group's per-row
// absmax ah, hq = round(h / ah) int8, and acc += (acc2 * ah) * s2. The
// group of 512 is the JAX plan's ct of every mlpblocki8 row of its tuned
// table; the plan there moves it with the batch, the port fixes it, so mlp
// must be a multiple of 512 (every VARIANTS entry is).
//
// With `partial` set it is the tensor-parallel shard form
// (mlp_block_i8dot's partial_out=True, block.py:537-539): this shard's MLP
// columns, the accumulator seeded with zero, b2 not read.
//
// Layout: 16 rows a block, 256 threads, D = NT * 128 up to 1280 (H/14).
// Shared memory holds the fp32 accumulator (16 x D), the group's hidden
// (16 x 512 fp32, first its int32 fc1 sums), xq and hq as int8 16-column
// slices (wmma wants each fragment 32-byte aligned), and one staged weight
// tile of 32 K rows, also in 16-column slices: 135 KB at D=768, 188 KB at
// D=1280. Warp w computes the group's hidden columns [64w, 64w + 64) and
// the output columns of fragments [w * NT, (w + 1) * NT), whose int32 sums
// stay in registers through the group's K.
//
// Bound on the card: compute, 4*M*D*mlp int8 operations (62.8 GOP at B/16
// bs=32, 31.7 us at 1,979 TOP/s). This first version is far from it: 2.26
// ms in bf16 at B/16 bs=32 on an NVIDIA H100 80GB HBM3 at 700 W, slower
// than the bf16 K3 (1.68 ms). Every 16-row block re-reads both int8 weight
// matrices (4.7 MB at B/16) from L2 through 240 staged tiles, nothing is
// pipelined, and one block fits an SM. Larger row tiles with the
// accumulator in registers, TMA-staged weight tiles and wgmma are later
// work.

#include <mma.h>

#include "common.cuh"

namespace vit {

using namespace nvcuda;

constexpr int kI8Threads = 256;
constexpr int kI8Warps = kI8Threads / 32;
constexpr int kI8BM = 16;      // rows a block
constexpr int kI8Group = 512;  // hidden columns a quant group
constexpr int kI8KS = 32;      // K rows of a staged weight tile
constexpr int kI8MaxNT = 10;   // D up to 1280

inline size_t mlp_i8_smem(int d) {
  const size_t stage = static_cast<size_t>(kI8KS) *
                       (d > kI8Group ? d : kI8Group);
  return static_cast<size_t>(kI8BM) * d * sizeof(float)  // acc
         + kI8BM * kI8Group * sizeof(float)              // h
         + kI8Warps * 256 * sizeof(int)                  // per-warp tiles
         + 2 * kI8BM * sizeof(float)                     // ax, ah
         + static_cast<size_t>(kI8BM) * d                // xq
         + kI8BM * kI8Group                              // hq
         + stage;                                        // weight tile
}

// Element (r, c) of a 16-row int8 matrix stored as 16-column slices.
__device__ __forceinline__ int slice_off(int r, int c) {
  return (c / 16) * (kI8BM * 16) + r * 16 + c % 16;
}

// Copy rows [r0, r0 + kI8KS) and columns [c0, c0 + cols) of a row-major
// int8 matrix with leading dimension ld into `stage` as 16-column slices of
// kI8KS rows, 16 bytes a thread.
__device__ __forceinline__ void stage_weights(signed char* __restrict__ stage,
                                              const signed char* __restrict__ w,
                                              size_t ld, int r0, int c0,
                                              int cols) {
  for (int ch = threadIdx.x; ch < kI8KS * cols / 16; ch += kI8Threads) {
    const int r = ch % kI8KS, sl = ch / kI8KS;
    *reinterpret_cast<uint4*>(stage + sl * (kI8KS * 16) + r * 16) =
        *reinterpret_cast<const uint4*>(w + (r0 + r) * ld + c0 + sl * 16);
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(kI8Threads, 1)
    mlp_i8_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const T* __restrict__ b, const signed char* __restrict__ w1,
                  const float* __restrict__ s1, const T* __restrict__ b1,
                  const signed char* __restrict__ w2,
                  const float* __restrict__ s2, const T* __restrict__ b2,
                  T* __restrict__ out, int m, int mlp, float eps,
                  int partial) {
  constexpr int D = NT * 128;
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // kI8BM x D
  float* h = acc + kI8BM * D;                   // kI8BM x kI8Group
  int* tiles = reinterpret_cast<int*>(h + kI8BM * kI8Group);
  float* ax = reinterpret_cast<float*>(tiles + kI8Warps * 256);
  float* ah = ax + kI8BM;
  signed char* xq = reinterpret_cast<signed char*>(ah + kI8BM);
  signed char* hq = xq + kI8BM * D;
  signed char* stage = hq + kI8BM * kI8Group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* tile = tiles + warp * 256;
  const int m0 = blockIdx.x * kI8BM;

  // LN, the per-row quantization, and the accumulator seeded with x + b2
  // (with zero for a partial).
  for (int r = warp; r < kI8BM; r += kI8Warps) {
    const int row = m0 + r;
    if (row < m) {
      const T* xr = x + static_cast<size_t>(row) * D;
      const float a = quantize_row(
          xr, g, b, D, eps, lane,
          [&](int i, signed char c) { xq[slice_off(r, i)] = c; });
      if (lane == 0) ax[r] = a;
      for (int i = lane; i < D; i += 32)
        acc[r * D + i] =
            partial ? 0.f : __fadd_rn(to_f32(xr[i]), to_f32(b2[i]));
    } else {
      for (int i = lane; i < D; i += 32) {
        xq[slice_off(r, i)] = 0;
        acc[r * D + i] = 0.f;
      }
      if (lane == 0) ax[r] = 0.f;
    }
  }

  for (int c0 = 0; c0 < mlp; c0 += kI8Group) {
    // fc1: this warp's 64 hidden columns of the group, int32 sums.
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> f1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(f1[j], 0);
    for (int k0 = 0; k0 < D; k0 += kI8KS) {
      __syncthreads();  // xq complete; the stage's previous readers are done
      stage_weights(stage, w1, mlp, k0, c0, kI8Group);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kI8KS; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, xq + slice_off(0, k0 + kk), 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                         wmma::row_major> wb;
          wmma::load_matrix_sync(
              wb, stage + (warp * 4 + j) * (kI8KS * 16) + kk * 16, 16);
          wmma::mma_sync(f1[j], a, wb, f1[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(reinterpret_cast<int*>(h) + (warp * 4 + j) * 16,
                              f1[j], kI8Group, wmma::mem_row_major);
    __syncthreads();
    // h = gelu((acc1 * ax) * s1 + b1) in fp32, in place over the sums.
    for (int e = threadIdx.x; e < kI8BM * kI8Group; e += kI8Threads) {
      const int r = e / kI8Group, c = c0 + e % kI8Group;
      h[e] = gelu(__fadd_rn(dequant(__float_as_int(h[e]), ax[r], s1[c]),
                            to_f32(b1[c])));
    }
    __syncthreads();
    // The group's per-row scale and codes.
    for (int r = warp; r < kI8BM; r += kI8Warps) {
      const float* hr = h + r * kI8Group;
      float mx = 0.f;
      for (int i = lane; i < kI8Group; i += 32) mx = fmaxf(mx, fabsf(hr[i]));
      const float a = quant_scale(warp_max(mx));
      for (int i = lane; i < kI8Group; i += 32)
        hq[slice_off(r, i)] = quant_code(hr[i], a);
      if (lane == 0) ah[r] = a;
    }

    // fc2: the group's hq @ W2[c0 : c0 + 512, :], this warp's NT fragments.
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> f2[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) wmma::fill_fragment(f2[j], 0);
    for (int k0 = 0; k0 < kI8Group; k0 += kI8KS) {
      __syncthreads();  // hq complete; the stage's previous readers are done
      stage_weights(stage, w2, D, c0 + k0, 0, D);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kI8KS; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, hq + slice_off(0, k0 + kk), 16);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                         wmma::row_major> wb;
          wmma::load_matrix_sync(
              wb, stage + (warp * NT + j) * (kI8KS * 16) + kk * 16, 16);
          wmma::mma_sync(f2[j], a, wb, f2[j]);
        }
      }
    }
    // acc += (acc2 * ah) * s2; each warp owns its columns of acc.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      wmma::store_matrix_sync(tile, f2[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int cb = (warp * NT + j) * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = cb + e % 16;
        acc[r * D + c] =
            __fadd_rn(acc[r * D + c], dequant(tile[e], ah[r], s2[c]));
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kI8BM * D; e += kI8Threads) {
    const int row = m0 + e / D;
    if (row < m)
      out[static_cast<size_t>(row) * D + e % D] = from_f32<T>(acc[e]);
  }
}

template <typename T, int NT>
cudaError_t launch_mlp_i8(const void* x, const void* g, const void* b,
                          const void* w1, const void* s1, const void* b1,
                          const void* w2, const void* s2, const void* b2,
                          void* out, int m, int mlp, float eps, int partial,
                          cudaStream_t st) {
  auto kernel = mlp_i8_kernel<T, NT>;
  const size_t smem = mlp_i8_smem(NT * 128);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kI8BM - 1) / kI8BM);
  kernel<<<grid, kI8Threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<const signed char*>(w1),
      static_cast<const float*>(s1), static_cast<const T*>(b1),
      static_cast<const signed char*>(w2), static_cast<const float*>(s2),
      static_cast<const T*>(b2), static_cast<T*>(out), m, mlp, eps, partial);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mlp_i8_typed(int nt, const void* x, const void* g,
                                const void* b, const void* w1, const void* s1,
                                const void* b1, const void* w2,
                                const void* s2, const void* b2, void* out,
                                int m, int mlp, float eps, int partial,
                                cudaStream_t st) {
  switch (nt) {
#define VIT_MLP_I8(NT)                                                      \
  case NT:                                                                  \
    return launch_mlp_i8<T, NT>(x, g, b, w1, s1, b1, w2, s2, b2, out, m, mlp, \
                                eps, partial, st);
    VIT_MLP_I8(1)
    VIT_MLP_I8(2)
    VIT_MLP_I8(3)
    VIT_MLP_I8(4)
    VIT_MLP_I8(5)
    VIT_MLP_I8(6)
    VIT_MLP_I8(7)
    VIT_MLP_I8(8)
    VIT_MLP_I8(9)
    VIT_MLP_I8(10)
#undef VIT_MLP_I8
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace vit

// x (m, d), LN scale and bias (d,), b1 (mlp,), b2 (d,) and out (m, d) in the
// dtype; w1 (d, mlp) and w2 (mlp, d) int8, 16-byte aligned; s1 (mlp,) and
// s2 (d,) fp32. d a multiple of 128 up to 1280, mlp a multiple of 512.
// partial != 0: the accumulator starts at zero and b2 is not read.
extern "C" int vit_mlp_block_i8(const void* x, const void* g, const void* b,
                                const void* w1, const void* s1,
                                const void* b1, const void* w2,
                                const void* s2, const void* b2, void* out,
                                int m, int d, int mlp, float eps,
                                int partial, int dtype, int device,
                                void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || d <= 0 || d % 128 || d / 128 > kI8MaxNT || mlp <= 0 ||
      mlp % kI8Group)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_mlp_i8_typed<float>(d / 128, x, g, b, w1, s1, b1, w2, s2,
                                      b2, out, m, mlp, eps, partial, st);
  if (dtype == kBF16)
    return launch_mlp_i8_typed<bf16>(d / 128, x, g, b, w1, s1, b1, w2, s2, b2,
                                     out, m, mlp, eps, partial, st);
  return cudaErrorInvalidValue;
}
