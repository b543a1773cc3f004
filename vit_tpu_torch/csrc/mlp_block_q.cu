// K17: the weight-only int8 MLP half of an encoder layer in one kernel,
//   out = x + fc2(gelu(fc1(LN(x)))) with int8 weights and fp32
// per-output-channel scales, the activations in the tensor's type, and the
// (M, mlp) hidden never in device memory.
//
// Replaces vit_tpu/ops/pallas/block.py:mlp_block_q (_mlp_q_kernel,
// block.py:335-382; pallas_call :416) and its stacked form (mlp_block_q_stacked
// with i8dot=False, :1588; layer l's weights are the view w[l]). As there:
// LN in fp32, rounded to the tensor's type; an fp32 accumulator seeded with
// x + b2; then, for each quant group of 512 hidden columns, h = gelu((xn @
// w1) * s1 + b1) in fp32, rounded to the type, and acc += (h @ w2) * s2; one
// cast at the end. Nothing is quantized but the weights, which are
// converted to the tensor's type, exactly, on chip. JAX scales fc2 per
// chunk of its plan's ct; the port's group is fixed at 512
// (reference.mlp_block_q's), which moves only the fp32 sum order. With
// `partial` set it is the tensor-parallel shard form (mlp_block_q's
// partial_out=True, block.py:362-365): this shard's MLP columns, the
// accumulator seeded with zero, b2 not read.
//
// bf16: the wgmma tile of mlp_q_wgmma.cuh (K3's cluster tile of two blocks
// a 64-row tile, the int8 weight boxes staged by TMA as they lie and
// converted to bf16 in shared memory, fc2 scaled per group; see there).
// D a multiple of 128 up to 1280 (H/14), mlp a multiple of 512; rows are
// masked. W1 and W2 are read through TMA tensor maps: bases 16-byte
// aligned (the wrapper checks).
//
// fp32: true fp32 FFMA (no TF32: the JAX kernel runs fp32 at
// Precision.HIGHEST), 16 rows a block of 256 threads. Thread t computes
// hidden columns t and t + 256 of the chunk for the 16 rows, reading its
// int8 weights straight from device memory, then output columns t + 256j
// of fc2; acc, xn and the chunk's hidden (16 x 512) sit in shared memory:
// 192 KB at D=1280.
//
// Bound on the card: compute, 4*M*D*mlp operations (62.8 GFLOP at B/16
// bs=32, 63.5 us at 989 TFLOP/s in bf16), on half of K3's weight bytes.

#include "mlp_q_wgmma.cuh"

namespace vit {

constexpr int kQThreads = 256;
constexpr int kQWarps = kQThreads / 32;
constexpr int kQBM = 16;     // rows a block (fp32)
constexpr int kQCT = 512;    // hidden columns a chunk (fp32)
constexpr int kQMaxT = 10;   // D up to 1280

// ---------------------------------------------------------------- bf16 --

// Defined in matmul_wgmma.cu: an int8 tensor map without swizzle over a
// rows x cols row-major matrix, boxes of box_cols x box_rows.
bool tensor_map_i8_dense(CUtensorMap* map, const void* p, int rows, int cols,
                         int ld, int box_cols, int box_rows);

constexpr int kQMaxDevices = 64;

template <int T>  // D = 128 T
cudaError_t launch_mlp_q_bf16(const void* x, const void* g, const void* b,
                              const void* w1, const void* s1, const void* b1,
                              const void* w2, const void* s2, const void* b2,
                              void* out, int m, int mlp, float eps,
                              int partial, int device, cudaStream_t st) {
  using C = mqw::Cfg<T>;
  auto kernel = mqw::mlp_q_bf16_wgmma<T>;
  // Per device, once: the shared-memory limit.
  static bool ready[kQMaxDevices];
  if (device < 0 || device >= kQMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  CUtensorMap m1, m2;
  // W1 (D, mlp) in boxes of 64 MLP columns x 64 rows; W2 (mlp, D) in boxes
  // of 64 output columns x KS2 hidden rows; int8 as they lie.
  if (!tensor_map_i8_dense(&m1, w1, C::D, mlp, mlp, 64, 64) ||
      !tensor_map_i8_dense(&m2, w2, mlp, C::D, C::D, 64, C::KS2))
    return cudaErrorInvalidValue;
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const mqw::QArgs args{
      {static_cast<const bf16*>(x), static_cast<const bf16*>(g),
       static_cast<const bf16*>(b), static_cast<const bf16*>(b1),
       static_cast<const bf16*>(b2), static_cast<bf16*>(out), m, mlp, eps,
       partial, a16(x) && a16(g) && a16(b)},
      static_cast<const float*>(s1), static_cast<const float*>(s2)};
  const dim3 grid(2 * ((m + mqw::kBM - 1) / mqw::kBM));
  kernel<<<grid, mqw::kThreads, C::kSmem, st>>>(m1, m2, args);
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
  if (m <= 0 || d <= 0 || d % 128 || d / 128 > kQMaxT || mlp <= 0 ||
      mlp % kQCT)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    switch (d / 128) {
#define VIT_MLP_Q_BF16(T)                                                     \
  case T:                                                                     \
    return launch_mlp_q_bf16<T>(x, g, b, w1, s1, b1, w2, s2, b2, out, m, mlp, \
                                eps, partial, device, st);
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
