// K3: the MLP half of an encoder layer in one kernel,
//   out = x + fc2(gelu(fc1(LN(x)))),
// and the (M, mlp) hidden never reaches device memory.
//
// Replaces vit_tpu/ops/pallas/block.py:mlp_block and mlp_block_stacked
// (_mlp_kernel, block.py:49-93). As there, LN(x) is rounded to the
// tensor's type (xn_ref, block.py:74), an fp32 accumulator is seeded with
// x + b2 (block.py:77-78), and the MLP columns are walked in chunks: h =
// gelu(xn @ W1[:, chunk] + b1), rounded to the tensor's type (block.py:86),
// and acc += h @ W2[chunk, :], chunk after chunk in order. The stacked
// form needs no launcher of its own: layer l's weights are the contiguous
// view w[l].
//
// With `partial` set it is the tensor-parallel shard form (mlp_block's
// partial_out=True, block.py:77-78, 199-202): w1 and w2 hold this shard's
// MLP columns, the accumulator starts at zero and b2 is not read, so the
// result is fc2_s(gelu(fc1_s(LN(x)))) in x's type, for the caller to
// all-reduce and add x + b2 to once.
//
// bf16: the wgmma tile of mlp_wgmma.cuh (a cluster of two blocks a 64-row
// tile, TMA-fed weights, h exchanged through distributed shared memory;
// see there). D and mlp must be multiples of 128, D at most 1024; rows are
// masked. W1 and W2 are read through TMA tensor maps, so their rows (mlp
// and D elements) must be 16-byte multiples and their bases 16-byte
// aligned (the wrapper checks 32). Bound on the card: the tensor cores,
// 4*M*D*mlp operations.
//
// fp32, two forms, chosen by geometry alone before the launch
// (ops/cuda/block.py:mlp_f32_form, the entry point's `form`; neither
// stands in for the other when a build or a launch fails):
// - "tf32" (form 1): the tensor cores in the three-pass TF32 split,
//   mlp_tf32.cuh's tile, launched by mlp_block_tf32.cu (see there for its
//   design, bound and times), wherever TMA can read x, W1 and W2 (16-byte
//   aligned bases, D and mlp multiples of 4): every VARIANTS width, the
//   tensor-parallel shards and the tests' widths.
// - "ffma" (form 0): true fp32 FFMA, the chunk loop of mlp_tile.cuh
//   (shared with K18), 16 rows a block; xn (16 x D fp32) and the chunk
//   (16 x 256) sit in shared memory. Rows, D and mlp are masked.
// D at most 1536 in both.

#include "mlp_tile.cuh"
#include "mlp_wgmma.cuh"

namespace vit {

// ---------------------------------------------------------------- bf16 --

// Defined in matmul_wgmma.cu: a bf16 tensor map with 128-byte swizzle over
// a rows x cols row-major matrix, boxes of box_cols x box_rows.
bool tensor_map(CUtensorMap* map, const void* p, int rows, int cols, int ld,
                int box_cols, int box_rows);

constexpr int kMlpMaxDevices = 64;

template <int T>  // D = 128 T
cudaError_t launch_mlp_bf16(const bf16* x, const bf16* g, const bf16* b,
                            const bf16* w1, const bf16* b1, const bf16* w2,
                            const bf16* b2, bf16* out, int m, int mlp,
                            float eps, int partial, int device,
                            cudaStream_t st) {
  using C = mw::Cfg<T>;
  auto kernel = mw::mlp_bf16_wgmma<T>;
  // Per device, once: the shared-memory limit, and whether the kernel got
  // the registers its setmaxnreg split needs (setmaxnreg.inc would wait
  // forever otherwise, so the launch is refused).
  static bool ready[kMlpMaxDevices];
  if (device < 0 || device >= kMlpMaxDevices) return cudaErrorInvalidDevice;
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
  CUtensorMap m1, m2;
  // W1 (D, mlp) in boxes of 64 MLP columns x 64 rows; W2 (mlp, D) in boxes
  // of 64 output columns x KS2 hidden rows.
  if (!tensor_map(&m1, w1, C::D, mlp, mlp, 64, 64) ||
      !tensor_map(&m2, w2, mlp, C::D, C::D, 64, C::KS2))
    return cudaErrorInvalidValue;
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const mw::MlpArgs args{x,       g,   b,   b1,      b2,
                         out,     m,   mlp, eps,     partial,
                         a16(x) && a16(g) && a16(b), nullptr};
  const dim3 grid(2 * ((m + mw::kBM - 1) / mw::kBM));
  // K3 reads no ctx and no Wout: their map arguments repeat W1's and W2's.
  kernel<<<grid, mw::kThreads, C::kSmem, st>>>(m1, m2, m1, m2, args);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 --

// mlp_block_tf32.cu: the tensor-core form (mlp_tf32.cuh).
cudaError_t launch_mlp_tf32(const float* x, const float* g, const float* b,
                            const float* w1, const float* b1, const float* w2,
                            const float* b2, float* out, int m, int d,
                            int mlp, float eps, int partial, int device,
                            cudaStream_t st);

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
                             float eps, int partial, int form, int dtype,
                             int device, void* stream) {
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
        partial, device, st);
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
  if (dtype == kF32 && form == 1)
    return launch_mlp_tf32(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out), m, d, mlp,
        eps, partial, device, st);
  if (dtype == kF32 && form == 0) {
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
