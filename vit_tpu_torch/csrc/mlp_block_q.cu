// K17: the weight-only int8 MLP half of an encoder layer in one kernel,
//   out = x + fc2(gelu(fc1(LN(x)))) with int8 weights and fp32
// per-output-channel scales, the activations in the tensor's type, and the
// (M, mlp) hidden never in device memory.
//
// Replaces vit_tpu/ops/pallas/block.py:mlp_block_q (_mlp_q_kernel,
// block.py:335-382; pallas_call :416) and its stacked form (mlp_block_q_stacked
// with i8dot=False, :1588; layer l's weights are the view w[l]). As there, a
// block owns a tile of rows: LN in fp32, rounded to the tensor's type, in
// shared memory; an fp32 accumulator seeded with x + b2; then, for each chunk
// of 512 hidden columns, h = gelu((xn @ w1) * s1 + b1) in fp32, rounded to
// the type, and acc += (h @ w2) * s2; one cast at the end. Nothing is
// quantized but the weights, which are converted to the tensor's type,
// exactly, as they are staged (as gemm_tile.cuh converts K9's int8 weights).
// JAX scales fc2 per chunk of its plan's ct; the port's chunk is fixed at
// 512 (reference.mlp_block_q's chunk), which moves only the fp32 sum order.
// With `partial` set it is the tensor-parallel shard form (mlp_block_q's
// partial_out=True, block.py:362-365): this shard's MLP columns, the
// accumulator seeded with zero, b2 not read.
//
// Layout, after K12 (mlp_block_i8.cu): 16 rows a block, 256 threads, D a
// multiple of 128 up to 1280 (H/14), mlp a multiple of 512.
// - bf16: nvcuda::wmma 16x16x16 with fp32 sums. Shared memory holds acc
//   (16 x D fp32), xn (16 x D bf16), the chunk's hidden in bf16 (16 x 512),
//   per-warp epilogue tiles, and one staged weight tile of 16 K rows
//   converted to bf16 (16 x 512 of W1, 16 x D of W2), which the chunk's fp32
//   fc1 sums reuse: 184 KB at D=1280, 128 KB at D=768. Warp w computes
//   hidden columns [64w, 64w + 64) of the chunk and output fragments
//   [w * NT, (w + 1) * NT) of fc2, whose sums stay in registers through the
//   chunk.
// - fp32: true fp32 FFMA (no TF32: the JAX kernel runs fp32 at
//   Precision.HIGHEST). Thread t computes hidden columns t and t + 256 of
//   the chunk for the 16 rows, reading its int8 weights straight from device
//   memory, then output columns t + 256j of fc2; acc, xn and the chunk's
//   hidden (16 x 512) sit in shared memory: 192 KB at D=1280.
//
// Bound on the card: compute, 4*M*D*mlp operations (62.8 GFLOP at B/16
// bs=32, 63.5 us at 989 TFLOP/s in bf16), on a quarter of K3's weight bytes
// in bf16. Every 16-row block re-reads both weight matrices from L2 through
// staged tiles, nothing is pipelined, and one block fits an SM: a simple
// kernel, far from its bound, like K12.

#include <mma.h>

#include "common.cuh"

namespace vit {

using namespace nvcuda;

constexpr int kQThreads = 256;
constexpr int kQWarps = kQThreads / 32;
constexpr int kQBM = 16;     // rows a block
constexpr int kQCT = 512;    // hidden columns a chunk
constexpr int kQKS = 16;     // K rows of a staged weight tile (bf16)
constexpr int kQMaxNT = 10;  // D up to 1280

// ---------------------------------------------------------------- bf16 --

inline size_t mlp_q_bf16_smem(int d) {
  size_t stage = static_cast<size_t>(kQKS) * (d > kQCT ? d : kQCT) *
                 sizeof(bf16);
  const size_t hpre = static_cast<size_t>(kQBM) * kQCT * sizeof(float);
  if (stage < hpre) stage = hpre;
  return static_cast<size_t>(kQBM) * d * sizeof(float)  // acc
         + static_cast<size_t>(kQBM) * d * sizeof(bf16)  // xn
         + kQBM * kQCT * sizeof(bf16)                    // h in bf16
         + kQWarps * 256 * sizeof(float)                 // per-warp tiles
         + stage;                                        // weights / fc1 sums
}

// Rows [r0, r0 + kQKS) and columns [c0, c0 + cols) of a row-major int8
// matrix with leading dimension ld, converted to bf16 into `stage` (row-major,
// leading dimension cols), eight values (8 bytes in, 16 out) a step.
__device__ __forceinline__ void stage_bf16(bf16* __restrict__ stage,
                                           const signed char* __restrict__ w,
                                           size_t ld, int r0, int c0,
                                           int cols) {
  for (int ch = threadIdx.x; ch < kQKS * cols / 8; ch += kQThreads) {
    const int r = ch / (cols / 8), c = (ch % (cols / 8)) * 8;
    const uint2 u = *reinterpret_cast<const uint2*>(
        w + (r0 + r) * ld + c0 + c);
    const signed char* e = reinterpret_cast<const signed char*>(&u);
    uint4 o;
    bf16* od = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int i = 0; i < 8; ++i) od[i] = from_f32<bf16>(to_f32(e[i]));
    *reinterpret_cast<uint4*>(stage + r * cols + c) = o;
  }
}

template <int NT>
__global__ void __launch_bounds__(kQThreads, 1)
    mlp_q_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                      const bf16* __restrict__ b,
                      const signed char* __restrict__ w1,
                      const float* __restrict__ s1,
                      const bf16* __restrict__ b1,
                      const signed char* __restrict__ w2,
                      const float* __restrict__ s2,
                      const bf16* __restrict__ b2, bf16* __restrict__ out,
                      int m, int mlp, float eps, int partial) {
  constexpr int D = NT * 128;
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);             // kQBM x D
  bf16* xn = reinterpret_cast<bf16*>(acc + kQBM * D);      // kQBM x D
  bf16* hb = xn + kQBM * D;                                // kQBM x kQCT
  float* tiles = reinterpret_cast<float*>(hb + kQBM * kQCT);
  bf16* stage = reinterpret_cast<bf16*>(tiles + kQWarps * 256);
  float* hpre = reinterpret_cast<float*>(stage);  // kQBM x kQCT, after fc1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* tile = tiles + warp * 256;
  const int m0 = blockIdx.x * kQBM;

  // LN rounded to bf16, and the accumulator seeded with x + b2 (with zero
  // for a partial).
  for (int r = warp; r < kQBM; r += kQWarps) {
    const int row = m0 + r;
    if (row < m) {
      const bf16* xr = x + static_cast<size_t>(row) * D;
      layernorm_row<bf16, bf16>(xr, g, b, xn + r * D, D, eps, lane);
      for (int i = lane; i < D; i += 32)
        acc[r * D + i] =
            partial ? 0.f : __fadd_rn(to_f32(xr[i]), to_f32(b2[i]));
    } else {
      for (int i = lane; i < D; i += 32) {
        xn[r * D + i] = from_f32<bf16>(0.f);
        acc[r * D + i] = 0.f;
      }
    }
  }

  for (int c0 = 0; c0 < mlp; c0 += kQCT) {
    // fc1: this warp's 64 hidden columns of the chunk.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> f1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(f1[j], 0.f);
    for (int k0 = 0; k0 < D; k0 += kQKS) {
      __syncthreads();  // xn complete; the stage's previous readers are done
      stage_bf16(stage, w1, mlp, k0, c0, kQCT);
      __syncthreads();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xn + k0, D);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> wb;
        wmma::load_matrix_sync(wb, stage + (warp * 4 + j) * 16, kQCT);
        wmma::mma_sync(f1[j], a, wb, f1[j]);
      }
    }
    __syncthreads();  // the stage's readers are done: it takes the sums
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(hpre + (warp * 4 + j) * 16, f1[j], kQCT,
                              wmma::mem_row_major);
    __syncthreads();
    // h = gelu(sum * s1 + b1) in fp32, rounded to bf16.
    for (int e = threadIdx.x; e < kQBM * kQCT; e += kQThreads) {
      const int c = c0 + e % kQCT;
      hb[e] = from_f32<bf16>(
          gelu(__fadd_rn(__fmul_rn(hpre[e], s1[c]), to_f32(b1[c]))));
    }

    // fc2: the chunk's h @ W2[c0 : c0 + 512, :], this warp's NT fragments.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> f2[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) wmma::fill_fragment(f2[j], 0.f);
    for (int k0 = 0; k0 < kQCT; k0 += kQKS) {
      __syncthreads();  // hb complete; the stage's previous readers are done
      stage_bf16(stage, w2, D, c0 + k0, 0, D);
      __syncthreads();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, hb + k0, kQCT);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> wb;
        wmma::load_matrix_sync(wb, stage + (warp * NT + j) * 16, D);
        wmma::mma_sync(f2[j], a, wb, f2[j]);
      }
    }
    // acc += sum * s2; each warp owns its columns of acc.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      wmma::store_matrix_sync(tile, f2[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int cb = (warp * NT + j) * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = cb + e % 16;
        acc[r * D + c] = __fadd_rn(acc[r * D + c], __fmul_rn(tile[e], s2[c]));
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kQBM * D; e += kQThreads) {
    const int row = m0 + e / D;
    if (row < m)
      out[static_cast<size_t>(row) * D + e % D] = from_f32<bf16>(acc[e]);
  }
}

template <int NT>
cudaError_t launch_mlp_q_bf16(const void* x, const void* g, const void* b,
                              const void* w1, const void* s1, const void* b1,
                              const void* w2, const void* s2, const void* b2,
                              void* out, int m, int mlp, float eps,
                              int partial, cudaStream_t st) {
  auto kernel = mlp_q_bf16_kernel<NT>;
  const size_t smem = mlp_q_bf16_smem(NT * 128);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(m + kQBM - 1) / kQBM, kQThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const bf16*>(b), static_cast<const signed char*>(w1),
      static_cast<const float*>(s1), static_cast<const bf16*>(b1),
      static_cast<const signed char*>(w2), static_cast<const float*>(s2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), m, mlp, eps,
      partial);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 --

inline size_t mlp_q_f32_smem(int d) {
  return (2 * static_cast<size_t>(kQBM) * d + kQBM * kQCT) * sizeof(float);
}

template <int NJ>  // output columns a thread: t + 256 j, j < NJ
__global__ void __launch_bounds__(kQThreads, 1)
    mlp_q_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ b,
                     const signed char* __restrict__ w1,
                     const float* __restrict__ s1,
                     const float* __restrict__ b1,
                     const signed char* __restrict__ w2,
                     const float* __restrict__ s2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     int m, int d, int mlp, float eps, int partial) {
  extern __shared__ __align__(16) float smq[];
  float* acc = smq;               // kQBM x d
  float* xn = acc + kQBM * d;     // kQBM x d
  float* hs = xn + kQBM * d;      // kQBM x kQCT
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int m0 = blockIdx.x * kQBM;

  for (int r = warp; r < kQBM; r += kQWarps) {
    const int row = m0 + r;
    if (row < m) {
      const float* xr = x + static_cast<size_t>(row) * d;
      layernorm_row<float, float>(xr, g, b, xn + r * d, d, eps, lane);
      for (int i = lane; i < d; i += 32)
        acc[r * d + i] = partial ? 0.f : __fadd_rn(xr[i], b2[i]);
    } else {
      for (int i = lane; i < d; i += 32) xn[r * d + i] = acc[r * d + i] = 0.f;
    }
  }
  __syncthreads();  // xn and acc complete

  for (int c0 = 0; c0 < mlp; c0 += kQCT) {
    // fc1: hidden columns c0 + t and c0 + t + 256 for the 16 rows.
    float a0[kQBM], a1[kQBM];
#pragma unroll
    for (int r = 0; r < kQBM; ++r) a0[r] = a1[r] = 0.f;
    const signed char* w1c = w1 + c0 + t;
    for (int k = 0; k < d; ++k) {
      const float v0 = to_f32(w1c[static_cast<size_t>(k) * mlp]);
      const float v1 = to_f32(w1c[static_cast<size_t>(k) * mlp + 256]);
#pragma unroll
      for (int r = 0; r < kQBM; ++r) {
        const float xv = xn[r * d + k];
        a0[r] = fmaf(xv, v0, a0[r]);
        a1[r] = fmaf(xv, v1, a1[r]);
      }
    }
    const int c = c0 + t;
#pragma unroll
    for (int r = 0; r < kQBM; ++r) {
      hs[r * kQCT + t] =
          gelu(__fadd_rn(__fmul_rn(a0[r], s1[c]), b1[c]));
      hs[r * kQCT + t + 256] =
          gelu(__fadd_rn(__fmul_rn(a1[r], s1[c + 256]), b1[c + 256]));
    }
    __syncthreads();  // the chunk's hidden complete

    // fc2: output columns t + 256 j, the chunk's sums, then acc += sum * s2.
    float y[kQBM][NJ];
#pragma unroll
    for (int r = 0; r < kQBM; ++r)
#pragma unroll
      for (int j = 0; j < NJ; ++j) y[r][j] = 0.f;
    for (int cc = 0; cc < kQCT; ++cc) {
      const signed char* w2r = w2 + static_cast<size_t>(c0 + cc) * d;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = t + j * kQThreads;
        const float wv = n < d ? to_f32(w2r[n]) : 0.f;
#pragma unroll
        for (int r = 0; r < kQBM; ++r)
          y[r][j] = fmaf(hs[r * kQCT + cc], wv, y[r][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = t + j * kQThreads;
      if (n < d) {
#pragma unroll
        for (int r = 0; r < kQBM; ++r)
          acc[r * d + n] = __fadd_rn(acc[r * d + n], __fmul_rn(y[r][j], s2[n]));
      }
    }
    __syncthreads();  // the next chunk overwrites hs
  }

  for (int e = t; e < kQBM * d; e += kQThreads) {
    const int row = m0 + e / d;
    if (row < m) out[static_cast<size_t>(row) * d + e % d] = acc[e];
  }
}

template <int NJ>
cudaError_t launch_mlp_q_f32(const void* x, const void* g, const void* b,
                             const void* w1, const void* s1, const void* b1,
                             const void* w2, const void* s2, const void* b2,
                             void* out, int m, int d, int mlp, float eps,
                             int partial, cudaStream_t st) {
  auto kernel = mlp_q_f32_kernel<NJ>;
  const size_t smem = mlp_q_f32_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(m + kQBM - 1) / kQBM, kQThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<const signed char*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const signed char*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<float*>(out), m, d, mlp,
      eps, partial);
  return cudaGetLastError();
}

}  // namespace vit

// x (m, d), LN scale and bias (d,), b1 (mlp,), b2 (d,) and out (m, d) in the
// dtype; w1 (d, mlp) and w2 (mlp, d) int8, 16-byte aligned; s1 (mlp,) and
// s2 (d,) fp32. d a multiple of 128 up to 1280, mlp a multiple of 512.
// partial != 0: the accumulator starts at zero and b2 is not read.
extern "C" int vit_mlp_block_q(const void* x, const void* g, const void* b,
                               const void* w1, const void* s1, const void* b1,
                               const void* w2, const void* s2, const void* b2,
                               void* out, int m, int d, int mlp, float eps,
                               int partial, int dtype, int device,
                               void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || d <= 0 || d % 128 || d / 128 > kQMaxNT || mlp <= 0 ||
      mlp % kQCT)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    switch (d / 128) {
#define VIT_MLP_Q_BF16(NT)                                                    \
  case NT:                                                                    \
    return launch_mlp_q_bf16<NT>(x, g, b, w1, s1, b1, w2, s2, b2, out, m, mlp, \
                                 eps, partial, st);
      VIT_MLP_Q_BF16(1)
      VIT_MLP_Q_BF16(2)
      VIT_MLP_Q_BF16(3)
      VIT_MLP_Q_BF16(4)
      VIT_MLP_Q_BF16(5)
      VIT_MLP_Q_BF16(6)
      VIT_MLP_Q_BF16(7)
      VIT_MLP_Q_BF16(8)
      VIT_MLP_Q_BF16(9)
      VIT_MLP_Q_BF16(10)
#undef VIT_MLP_Q_BF16
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (dtype == kF32) {
    switch ((d + kQThreads - 1) / kQThreads) {
#define VIT_MLP_Q_F32(NJ)                                                     \
  case NJ:                                                                    \
    return launch_mlp_q_f32<NJ>(x, g, b, w1, s1, b1, w2, s2, b2, out, m, d,   \
                                mlp, eps, partial, st);
      VIT_MLP_Q_F32(1)
      VIT_MLP_Q_F32(2)
      VIT_MLP_Q_F32(3)
      VIT_MLP_Q_F32(4)
      VIT_MLP_Q_F32(5)
#undef VIT_MLP_Q_F32
      default:
        return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
