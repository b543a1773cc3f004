// K18: the out-projection and the MLP half of a full encoder layer in one
// kernel, with the activation between the halves kept in fp32 on chip:
//   y   = ctx @ Wout + bout + x                  (fp32, never rounded)
//   out = y + b2 + fc2(gelu(fc1(LN2(y))))        (one cast)
//
// Replaces the second half of vit_tpu/ops/pallas/block.py:layer_block
// (_layer_kernel, block.py:1687-1720; pallas_call :1805-1832). The TPU
// kernel runs a whole layer a grid step, the image's (S, 3D) QKV in VMEM;
// on Hopper that QKV (0.96 MB at B/16) does not fit one SM, so layer_block
// is four launches (vit_tpu_torch/ops/cuda/block.py): K1 LN1, K2 into the
// packed QKV buffer, the attention core (or K7), then this kernel on the
// (M, D) context. What sets the layer apart from attn_block + mlp_block is
// that y32 stays fp32 between the halves: LN2 reads it unrounded and the MLP
// accumulator starts at y32 + b2 (block.py:1709-1710), where the pair rounds
// y to the tensor's type in device memory. This kernel keeps y in shared
// memory and in the accumulator, so it never rounds and never leaves the SM.
//
// A block owns a tile of rows. It stages its ctx rows in shared memory,
// computes the out-projection into the fp32 accumulator, writes it to
// shared memory and adds bout, then x, in JAX's order; each warp then
// normalises whole rows of y into xn in the tensor's type (LN2, block.py:
// 1709) and adds b2 to the row; the accumulator is reloaded from y + b2 and
// K3's chunk loop (mlp_tile.cuh) runs on it.
//
// Bound on the card: operations, 2*M*D*(D + 2*mlp) (70.7 GFLOP at B/16
// bs=32, 0.0715 ms in bf16). Like K3 it reads every weight from L2 straight
// into fragments, unstaged and unpipelined; TMA staging and wgmma are the
// later work, shared with K3.
//
// bf16: 32 rows a block, eight warps, the accumulator in wmma fragments as
// in K3 (warp w owns columns [w*D/8, (w+1)*D/8)). Shared memory: y (32 x D
// fp32; the chunk buffers overlay it once the accumulator is loaded, and the
// output tile after the last chunk) and xn (32 x D bf16: first the ctx rows,
// then LN2(y)): 144 KB at D=768, 192 KB at D=1024. D and mlp multiples of
// 128, D at most 1024; rows are masked.
//
// fp32: true fp32 FFMA (no TF32), 16 rows a block, thread t owning output
// columns t, t+256, ... in registers, as K3. Shared memory: the ctx rows,
// then LN2(y), (16 x D), y (16 x D) and the chunk (16 x 256): 208 KB at
// D=1536, the limit. Rows, D and mlp are masked.

#include "mlp_tile.cuh"

namespace vit {

// ---------------------------------------------------------------- bf16 --

// The y region: 32 x D fp32, at least the chunk buffers that overlay it.
__host__ __device__ constexpr size_t layer_bf16_y_bytes(int d) {
  return static_cast<size_t>(kMlpBM) * d * sizeof(float) > kMlpChunkBytes
             ? static_cast<size_t>(kMlpBM) * d * sizeof(float)
             : kMlpChunkBytes;
}

inline size_t layer_bf16_smem(int d) {
  return layer_bf16_y_bytes(d) + static_cast<size_t>(kMlpBM) * d * sizeof(bf16);
}

template <int NT>  // D = NT * 128: each warp owns NT 16-wide column tiles
__global__ void __launch_bounds__(kMlpThreads, 1)
    layer_bf16_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ x,
                      const bf16* __restrict__ wout,
                      const bf16* __restrict__ bout,
                      const bf16* __restrict__ g2, const bf16* __restrict__ bn2,
                      const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                      const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                      bf16* __restrict__ out, int m, int mlp, float eps) {
  constexpr int D = NT * 128;
  constexpr int V = D / 8;  // 16-byte chunks of a bf16 row
  extern __shared__ __align__(128) unsigned char smem[];
  float* y = reinterpret_cast<float*>(smem);
  bf16* xn = reinterpret_cast<bf16*>(smem + layer_bf16_y_bytes(D));
  float* hpre = y;  // the chunk buffers overlay y once acc holds it
  bf16* hb = reinterpret_cast<bf16*>(hpre + kMlpBM * kMlpCT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kMlpBM;

  // The block's ctx rows, zero past m.
  for (int e = threadIdx.x; e < kMlpBM * V; e += kMlpThreads) {
    const int r = e / V;
    reinterpret_cast<uint4*>(xn)[e] =
        m0 + r < m ? reinterpret_cast<const uint4*>(
                         ctx + static_cast<size_t>(m0 + r) * D)[e % V]
                   : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // The out-projection: acc = ctx @ Wout in fp32.
  MlpFrag acc[2][NT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll 2
  for (int k = 0; k < D; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], xn + i * 16 * D + k, D);
    const bf16* wr = wout + static_cast<size_t>(k) * D;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> wb;
      wmma::load_matrix_sync(wb, wr + (warp * NT + j) * 16, D);
      wmma::mma_sync(acc[0][j], a[0], wb, acc[0][j]);
      wmma::mma_sync(acc[1][j], a[1], wb, acc[1][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wmma::store_matrix_sync(y + i * 16 * D + (warp * NT + j) * 16,
                              acc[i][j], D, wmma::mem_row_major);
  __syncthreads();  // y's products complete; every read of the ctx rows done

  // Row by row, one warp a row: y = (y + bout) + x, xn = LN2(y) rounded,
  // then y += b2, the accumulator's seed.
  for (int r = warp; r < kMlpBM; r += kMlpWarps) {
    float* yr = y + r * D;
    bf16* xr = xn + r * D;
    if (m0 + r < m) {
      const bf16* x0 = x + static_cast<size_t>(m0 + r) * D;
      for (int i = lane; i < D; i += 32)
        yr[i] = (yr[i] + to_f32(bout[i])) + to_f32(x0[i]);
      __syncwarp();
      layernorm_row<float, bf16, bf16>(yr, g2, bn2, xr, D, eps, lane);
      for (int i = lane; i < D; i += 32) yr[i] += to_f32(b2[i]);
    } else {
      for (int i = lane; i < D; i += 32) {
        yr[i] = 0.f;
        xr[i] = __float2bfloat16_rn(0.f);
      }
    }
  }
  __syncthreads();  // y + b2 and xn complete
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wmma::load_matrix_sync(acc[i][j], y + i * 16 * D + (warp * NT + j) * 16,
                             D, wmma::mem_row_major);
  __syncthreads();  // every warp holds its seed: the chunk buffers take y

  mlp_chunks_bf16<NT>(xn, hpre, hb, w1, b1, w2, mlp, acc);
  __syncthreads();  // the last chunk's reads of hb done: y takes the output

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wmma::store_matrix_sync(y + i * 16 * D + (warp * NT + j) * 16,
                              acc[i][j], D, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kMlpBM * D; e += kMlpThreads) {
    const int r = e / D;
    if (m0 + r < m)
      out[static_cast<size_t>(m0) * D + e] = from_f32<bf16>(y[e]);
  }
}

template <int NT>
cudaError_t launch_layer_bf16(const bf16* ctx, const bf16* x, const bf16* wout,
                              const bf16* bout, const bf16* g2,
                              const bf16* bn2, const bf16* w1, const bf16* b1,
                              const bf16* w2, const bf16* b2, bf16* out, int m,
                              int mlp, float eps, cudaStream_t st) {
  const size_t smem = layer_bf16_smem(NT * 128);
  cudaError_t err = cudaFuncSetAttribute(
      layer_bf16_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kMlpBM - 1) / kMlpBM);
  layer_bf16_kernel<NT><<<grid, kMlpThreads, smem, st>>>(
      ctx, x, wout, bout, g2, bn2, w1, b1, w2, b2, out, m, mlp, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 --

inline size_t layer_f32_smem(int d) {
  return (2 * static_cast<size_t>(kMlpFBM) * d + kMlpFBM * kMlpFCT) *
         sizeof(float);
}

// Two blocks an SM where their shared memory fits (D <= 768): left to
// itself, ptxas gives the D=768 kernel 178 registers, one block an SM, and
// it ran 1.6 times slower than at 128 registers.
template <int NJ>  // output columns a thread: t + 256*j, j < NJ
__global__ void __launch_bounds__(kMlpThreads, NJ <= 3 ? 2 : 1)
    layer_f32_kernel(const float* __restrict__ ctx,
                     const float* __restrict__ x,
                     const float* __restrict__ wout,
                     const float* __restrict__ bout,
                     const float* __restrict__ g2,
                     const float* __restrict__ bn2,
                     const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     int m, int d, int mlp, float eps) {
  extern __shared__ __align__(16) float smf[];
  float* xn = smf;                 // kMlpFBM x d: ctx rows, then LN2(y)
  float* ys = xn + kMlpFBM * d;    // kMlpFBM x d: y
  float* hs = ys + kMlpFBM * d;    // kMlpFBM x kMlpFCT
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int m0 = blockIdx.x * kMlpFBM;

  for (int e = t; e < kMlpFBM * d; e += kMlpThreads) {
    const int r = e / d;
    xn[e] = m0 + r < m ? ctx[static_cast<size_t>(m0) * d + e] : 0.f;
  }
  __syncthreads();

  float acc[kMlpFBM][NJ];
#pragma unroll
  for (int r = 0; r < kMlpFBM; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  for (int k = 0; k < d; ++k) {
    const float* wr = wout + static_cast<size_t>(k) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = t + j * kMlpThreads;
      if (n < d) {
        const float wv = wr[n];
#pragma unroll
        for (int r = 0; r < kMlpFBM; ++r)
          acc[r][j] = fmaf(xn[r * d + k], wv, acc[r][j]);
      }
    }
  }
  // y = (acc + bout) + x, kept in registers and copied for LN2.
#pragma unroll
  for (int r = 0; r < kMlpFBM; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = t + j * kMlpThreads;
      if (n < d) {
        acc[r][j] = m0 + r < m
                        ? (acc[r][j] + bout[n]) +
                              x[static_cast<size_t>(m0 + r) * d + n]
                        : 0.f;
        ys[r * d + n] = acc[r][j];
      }
    }
  __syncthreads();  // y complete; every read of the ctx rows done

  for (int r = warp; r < kMlpFBM; r += kMlpWarps)
    layernorm_row<float, float>(ys + r * d, g2, bn2, xn + r * d, d, eps, lane);
#pragma unroll
  for (int r = 0; r < kMlpFBM; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = t + j * kMlpThreads;
      if (n < d) acc[r][j] += b2[n];
    }
  __syncthreads();  // LN2(y) complete

  mlp_chunks_f32<NJ>(xn, hs, w1, b1, w2, d, mlp, acc);

#pragma unroll
  for (int r = 0; r < kMlpFBM; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = t + j * kMlpThreads;
      if (m0 + r < m && n < d)
        out[static_cast<size_t>(m0 + r) * d + n] = acc[r][j];
    }
}

template <int NJ>
cudaError_t launch_layer_f32(const float* ctx, const float* x,
                             const float* wout, const float* bout,
                             const float* g2, const float* bn2,
                             const float* w1, const float* b1, const float* w2,
                             const float* b2, float* out, int m, int d,
                             int mlp, float eps, cudaStream_t st) {
  const size_t smem = layer_f32_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      layer_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kMlpFBM - 1) / kMlpFBM);
  layer_f32_kernel<NJ><<<grid, kMlpThreads, smem, st>>>(
      ctx, x, wout, bout, g2, bn2, w1, b1, w2, b2, out, m, d, mlp, eps);
  return cudaGetLastError();
}

}  // namespace vit

extern "C" int vit_layer_block(const void* ctx, const void* x,
                               const void* wout, const void* bout,
                               const void* g2, const void* bn2,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int m, int d,
                               int mlp, float eps, int dtype, int device,
                               void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || d <= 0 || mlp <= 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (d % 128 || mlp % 128) return cudaErrorInvalidValue;
#define VIT_LAYER_BF16(NT)                                                   \
  case NT:                                                                   \
    return launch_layer_bf16<NT>(                                            \
        static_cast<const bf16*>(ctx), static_cast<const bf16*>(x),          \
        static_cast<const bf16*>(wout), static_cast<const bf16*>(bout),      \
        static_cast<const bf16*>(g2), static_cast<const bf16*>(bn2),         \
        static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),          \
        static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),          \
        static_cast<bf16*>(out), m, mlp, eps, st);
    switch (d / 128) {
      VIT_LAYER_BF16(1)
      VIT_LAYER_BF16(2)
      VIT_LAYER_BF16(3)
      VIT_LAYER_BF16(4)
      VIT_LAYER_BF16(5)
      VIT_LAYER_BF16(6)
      VIT_LAYER_BF16(7)
      VIT_LAYER_BF16(8)
      default:
        return cudaErrorInvalidValue;
    }
#undef VIT_LAYER_BF16
  }
  if (dtype == kF32) {
#define VIT_LAYER_F32(NJ)                                                     \
  case NJ:                                                                    \
    return launch_layer_f32<NJ>(                                              \
        static_cast<const float*>(ctx), static_cast<const float*>(x),         \
        static_cast<const float*>(wout), static_cast<const float*>(bout),     \
        static_cast<const float*>(g2), static_cast<const float*>(bn2),        \
        static_cast<const float*>(w1), static_cast<const float*>(b1),         \
        static_cast<const float*>(w2), static_cast<const float*>(b2),         \
        static_cast<float*>(out), m, d, mlp, eps, st);
    switch ((d + kMlpThreads - 1) / kMlpThreads) {
      VIT_LAYER_F32(1)
      VIT_LAYER_F32(2)
      VIT_LAYER_F32(3)
      VIT_LAYER_F32(4)
      VIT_LAYER_F32(5)
      VIT_LAYER_F32(6)
      default:
        return cudaErrorInvalidValue;
    }
#undef VIT_LAYER_F32
  }
  return cudaErrorInvalidValue;
}
