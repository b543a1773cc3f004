// K3: the MLP half of an encoder layer in one kernel,
//   out = x + fc2(gelu(fc1(LN(x)))),
// and the (M, mlp) hidden never reaches device memory.
//
// Replaces vit_tpu/ops/pallas/block.py:mlp_block and mlp_block_stacked
// (_mlp_kernel, block.py:49-93). As there, a block owns a tile of rows: it
// writes LN(x) into shared memory in the tensor's type (xn_ref,
// block.py:74), seeds an fp32 accumulator with x + b2 (block.py:77-78),
// then walks the MLP columns in chunks: h = gelu(xn @ W1[:, chunk] + b1),
// rounded to the tensor's type in shared memory (block.py:86), and
// acc += h @ W2[chunk, :]. The stacked form needs no launcher of its own:
// layer l's weights are the contiguous view w[l].
//
// With `partial` set it is the tensor-parallel shard form (mlp_block's
// partial_out=True, block.py:77-78, 199-202): w1 and w2 hold this shard's
// MLP columns, the accumulator starts at zero and b2 is not read, so the
// result is fc2_s(gelu(fc1_s(LN(x)))) in x's type, for the caller to
// all-reduce and add x + b2 to once.
//
// Bound on the card: compute (4*M*D*mlp flops) and the weights. Every row
// block re-reads all of W1 and W2 (9.4 MB in bf16 for B/16) from the 50 MB
// L2, straight into tensor-core fragments, without staging them in shared
// memory or overlapping the loads with the math. That is acceptable for a
// first kernel and is the first thing to change: stage W tiles with TMA and
// run wgmma on them.
//
// The chunk loop is shared with K18 (mlp_tile.cuh, which gives the layouts).
// bf16: 32 rows a block, eight warps; shared memory holds xn (32 x D bf16),
// the chunk buffers and a per-warp 16 x 16 fp32 tile for seeding and
// storing the accumulator fragments: 80 KB at D=768, so the launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize. D and mlp must be multiples
// of 128, D at most 1024; rows are masked. fp32: 16 rows a block; xn
// (16 x D fp32) and the chunk (16 x 256) sit in shared memory. D at most
// 1536; rows, D and mlp are masked.

#include "mlp_tile.cuh"

namespace vit {

// ---------------------------------------------------------------- bf16 --

inline size_t mlp_bf16_smem(int d) {
  return static_cast<size_t>(kMlpBM) * d * sizeof(bf16)  // xn
         + kMlpChunkBytes                                // hpre, hb
         + kMlpWarps * 256 * sizeof(float);              // per-warp tile
}

template <int NT>  // D = NT * 128: each warp owns NT 16-wide column tiles
__global__ void __launch_bounds__(kMlpThreads, 1)
    mlp_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                    const bf16* __restrict__ b, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, bf16* __restrict__ out, int m,
                    int mlp, float eps, int partial) {
  constexpr int D = NT * 128;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xn = reinterpret_cast<bf16*>(smem);
  float* hpre = reinterpret_cast<float*>(xn + kMlpBM * D);
  bf16* hb = reinterpret_cast<bf16*>(hpre + kMlpBM * kMlpCT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* tile = reinterpret_cast<float*>(hb + kMlpBM * kMlpCT) + warp * 256;
  const int m0 = blockIdx.x * kMlpBM;

  for (int r = warp; r < kMlpBM; r += kMlpWarps) {
    if (m0 + r < m) {
      layernorm_row<bf16, bf16>(x + static_cast<size_t>(m0 + r) * D, g, b,
                                xn + r * D, D, eps, lane);
    } else {
      for (int i = lane; i < D; i += 32) xn[r * D + i] = __float2bfloat16_rn(0.f);
    }
  }

  // acc[i][j]: rows [16i, 16i+16), columns [(warp*NT + j)*16, +16),
  // seeded with x + b2 (zero for a partial) through the warp's shared tile.
  MlpFrag acc[2][NT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c0 = (warp * NT + j) * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = m0 + i * 16 + e / 16, c = c0 + e % 16;
        tile[e] = r < m && !partial
                      ? to_f32(x[static_cast<size_t>(r) * D + c]) + to_f32(b2[c])
                      : 0.f;
      }
      __syncwarp();
      wmma::load_matrix_sync(acc[i][j], tile, 16, wmma::mem_row_major);
      __syncwarp();
    }
  __syncthreads();  // xn complete

  mlp_chunks_bf16<NT>(xn, hpre, hb, w1, b1, w2, mlp, acc);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      wmma::store_matrix_sync(tile, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int c0 = (warp * NT + j) * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = m0 + i * 16 + e / 16;
        if (r < m)
          out[static_cast<size_t>(r) * D + c0 + e % 16] = from_f32<bf16>(tile[e]);
      }
      __syncwarp();
    }
}

template <int NT>
cudaError_t launch_mlp_bf16(const bf16* x, const bf16* g, const bf16* b,
                            const bf16* w1, const bf16* b1, const bf16* w2,
                            const bf16* b2, bf16* out, int m, int mlp,
                            float eps, int partial, cudaStream_t st) {
  const size_t smem = mlp_bf16_smem(NT * 128);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bf16_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kMlpBM - 1) / kMlpBM);
  mlp_bf16_kernel<NT><<<grid, kMlpThreads, smem, st>>>(
      x, g, b, w1, b1, w2, b2, out, m, mlp, eps, partial);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 --

inline size_t mlp_f32_smem(int d) {
  return (static_cast<size_t>(kMlpFBM) * d + kMlpFBM * kMlpFCT) * sizeof(float);
}

template <int NJ>  // output columns a thread: t + 256*j, j < NJ
__global__ void __launch_bounds__(kMlpThreads)
    mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ b, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ out,
                   int m, int d, int mlp, float eps, int partial) {
  extern __shared__ __align__(16) float smf[];
  float* xn = smf;                 // kMlpFBM x d
  float* hs = smf + kMlpFBM * d;   // kMlpFBM x kMlpFCT
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int m0 = blockIdx.x * kMlpFBM;

  for (int r = warp; r < kMlpFBM; r += kMlpWarps) {
    if (m0 + r < m) {
      layernorm_row<float, float>(x + static_cast<size_t>(m0 + r) * d, g, b,
                                  xn + r * d, d, eps, lane);
    } else {
      for (int i = lane; i < d; i += 32) xn[r * d + i] = 0.f;
    }
  }

  float acc[kMlpFBM][NJ];
#pragma unroll
  for (int r = 0; r < kMlpFBM; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = t + j * kMlpThreads;
      acc[r][j] = (m0 + r < m && n < d && !partial)
                      ? x[static_cast<size_t>(m0 + r) * d + n] + b2[n]
                      : 0.f;
    }
  __syncthreads();  // xn complete

  mlp_chunks_f32<NJ>(xn, hs, w1, b1, w2, d, mlp, acc);

#pragma unroll
  for (int r = 0; r < kMlpFBM; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = t + j * kMlpThreads;
      if (m0 + r < m && n < d) out[static_cast<size_t>(m0 + r) * d + n] = acc[r][j];
    }
}

template <int NJ>
cudaError_t launch_mlp_f32(const float* x, const float* g, const float* b,
                           const float* w1, const float* b1, const float* w2,
                           const float* b2, float* out, int m, int d, int mlp,
                           float eps, int partial, cudaStream_t st) {
  const size_t smem = mlp_f32_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kMlpFBM - 1) / kMlpFBM);
  mlp_f32_kernel<NJ><<<grid, kMlpThreads, smem, st>>>(
      x, g, b, w1, b1, w2, b2, out, m, d, mlp, eps, partial);
  return cudaGetLastError();
}

}  // namespace vit

extern "C" int vit_mlp_block(const void* x, const void* g, const void* b,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, int m, int d, int mlp,
                             float eps, int partial, int dtype, int device,
                             void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || d <= 0 || mlp <= 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (d % 128 || mlp % 128) return cudaErrorInvalidValue;
#define VIT_MLP_BF16(NT)                                                   \
  case NT:                                                                 \
    return launch_mlp_bf16<NT>(                                            \
        static_cast<const bf16*>(x), static_cast<const bf16*>(g),          \
        static_cast<const bf16*>(b), static_cast<const bf16*>(w1),         \
        static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),        \
        static_cast<const bf16*>(b2), static_cast<bf16*>(out), m, mlp, eps, \
        partial, st);
    switch (d / 128) {
      VIT_MLP_BF16(1)
      VIT_MLP_BF16(2)
      VIT_MLP_BF16(3)
      VIT_MLP_BF16(4)
      VIT_MLP_BF16(5)
      VIT_MLP_BF16(6)
      VIT_MLP_BF16(7)
      VIT_MLP_BF16(8)
      default:
        return cudaErrorInvalidValue;
    }
#undef VIT_MLP_BF16
  }
  if (dtype == kF32) {
#define VIT_MLP_F32(NJ)                                                     \
  case NJ:                                                                  \
    return launch_mlp_f32<NJ>(                                              \
        static_cast<const float*>(x), static_cast<const float*>(g),         \
        static_cast<const float*>(b), static_cast<const float*>(w1),        \
        static_cast<const float*>(b1), static_cast<const float*>(w2),       \
        static_cast<const float*>(b2), static_cast<float*>(out), m, d, mlp, \
        eps, partial, st);
    switch ((d + kMlpThreads - 1) / kMlpThreads) {
      VIT_MLP_F32(1)
      VIT_MLP_F32(2)
      VIT_MLP_F32(3)
      VIT_MLP_F32(4)
      VIT_MLP_F32(5)
      VIT_MLP_F32(6)
      default:
        return cudaErrorInvalidValue;
    }
#undef VIT_MLP_F32
  }
  return cudaErrorInvalidValue;
}
