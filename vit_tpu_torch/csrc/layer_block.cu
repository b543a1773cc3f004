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
// y to the tensor's type in device memory.
//
// bf16: K3's wgmma cluster tile with its K18 flag (mlp_wgmma.cuh, where the
// phases are set out): a cluster of two blocks a 64-row tile, ctx's rows
// and Wout's boxes by TMA, y in the fc2 accumulators (each block its half
// of the columns), LN2's statistics exchanged across the cluster, the
// LN2(y) boxes copied to the other block, then K3's chunk loop. At D >= 896
// the tile takes two passes over the hidden as K3 does, the second pass's
// y kept unrounded in the output's bytes in between: at L/16 bs=8 about
// 3.9 times faster on the card than the wmma tile it replaced, and level
// with K2 -> K3 on the same operands (PERF.md). D and mlp multiples
// of 128, D at most 1024; rows are masked. ctx, Wout, W1 and W2 are read
// through TMA tensor maps: 16-byte aligned bases (the wrapper checks ctx's
// 16 and the weights' 32).
//
// Bound on the card: operations, 2*M*D*(D + 2*mlp) (70.7 GFLOP at B/16
// bs=32, 0.0715 ms in bf16). What the tile leaves is K3's: every cluster
// reads the weights from L2, and at D >= 896 fc1 runs in each pass.
//
// fp32, two forms, chosen by geometry alone before the launch
// (ops/cuda/block.py:mlp_f32_form over ctx, x, out and the weights, the
// entry point's `form`; neither stands in for the other when a build or a
// launch fails):
// - "tf32" (form 1): K3's fp32 tile on the tensor cores with its LAYER flag
//   (mlp_tf32.cuh, launched by layer_block_tf32.cu), every product three
//   TF32 passes: the out-projection transposed on the same tile into the
//   fc2 totals, y written unrounded into the block's rows of out and read
//   back by TMA for LN2, then K3's chunk loop. Bound: 2*M*D*(D + 2*mlp) in
//   three TF32 passes, 0.428 ms at B/16 bs=32. Where TMA can read the
//   operands: 16-byte aligned bases, D and mlp multiples of 4.
// - "ffma" (form 0): true fp32 FFMA (no TF32), 16 rows a block, thread t
//   owning output columns t, t+256, ... in registers, as K3's FFMA form.
//   Shared memory: the ctx rows, then LN2(y), (16 x D), y (16 x D) and the
//   chunk (16 x 256): 208 KB at D=1536, the limit. Rows, D and mlp are
//   masked.

#include "mlp_tile.cuh"
#include "mlp_wgmma.cuh"

namespace vit {

// ---------------------------------------------------------------- bf16 --

// Defined in matmul_wgmma.cu: a bf16 tensor map with 128-byte swizzle over
// a rows x cols row-major matrix, boxes of box_cols x box_rows.
bool tensor_map(CUtensorMap* map, const void* p, int rows, int cols, int ld,
                int box_cols, int box_rows);

constexpr int kLayerMaxDevices = 64;

template <int T>  // D = 128 T
cudaError_t launch_layer_bf16(const bf16* ctx, const bf16* x, const bf16* wout,
                              const bf16* bout, const bf16* g2,
                              const bf16* bn2, const bf16* w1, const bf16* b1,
                              const bf16* w2, const bf16* b2, bf16* out, int m,
                              int mlp, float eps, int device,
                              cudaStream_t st) {
  using C = mw::Cfg<T>;
  auto kernel = mw::mlp_bf16_wgmma<T, true>;
  // Per device, once: the shared-memory limit, and whether the kernel got
  // the registers its setmaxnreg split needs (as K3's launcher).
  static bool ready[kLayerMaxDevices];
  if (device < 0 || device >= kLayerMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * mw::kThreads < mw::kPoolRegs)
      return cudaErrorLaunchOutOfResources;
    ready[device] = true;
  }
  CUtensorMap m1, m2, mc, mo;
  // W1 (D, mlp) in boxes of 64 MLP columns x 64 rows; W2 (mlp, D) and Wout
  // (D, D) in boxes of 64 output columns x KS2 rows; ctx (m, D) in 64 x 64
  // boxes.
  if (!tensor_map(&m1, w1, C::D, mlp, mlp, 64, 64) ||
      !tensor_map(&m2, w2, mlp, C::D, C::D, 64, C::KS2) ||
      !tensor_map(&mc, ctx, m, C::D, C::D, 64, 64) ||
      !tensor_map(&mo, wout, C::D, C::D, C::D, 64, C::KS2))
    return cudaErrorInvalidValue;
  const mw::MlpArgs args{x, g2, bn2, b1, b2, out, m, mlp, eps, 0, 0, bout};
  const dim3 grid(2 * ((m + mw::kBM - 1) / mw::kBM));
  kernel<<<grid, mw::kThreads, C::kSmem, st>>>(m1, m2, mc, mo, args);
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

// layer_block_tf32.cu: the tensor-core form (mlp_tf32.cuh).
cudaError_t launch_layer_tf32(const float* ctx, const float* x,
                              const float* wout, const float* bout,
                              const float* g2, const float* bn2,
                              const float* w1, const float* b1,
                              const float* w2, const float* b2, float* out,
                              int m, int d, int mlp, float eps, int device,
                              cudaStream_t st);

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
                               int mlp, float eps, int form, int dtype,
                               int device, void* stream) {
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
        static_cast<bf16*>(out), m, mlp, eps, device, st);
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
  if (dtype == kF32 && form == 1)
    return launch_layer_tf32(
        static_cast<const float*>(ctx), static_cast<const float*>(x),
        static_cast<const float*>(wout), static_cast<const float*>(bout),
        static_cast<const float*>(g2), static_cast<const float*>(bn2),
        static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2),
        static_cast<float*>(out), m, d, mlp, eps, device, st);
  if (dtype == kF32 && form == 0) {
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
