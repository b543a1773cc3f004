// K12: the int8 MLP half of an encoder layer in one kernel,
//   out = x + fc2(gelu(fc1(LN(x)))) with both products s8 x s8 -> s32,
// and the (M, mlp) hidden never reaches device memory.
//
// Replaces vit_tpu/ops/pallas/block.py:mlp_block_i8dot (_mlp_i8dot_kernel,
// block.py:511-560) and its stacked form (mlp_block_q_stacked with i8dot,
// :1588; layer l's weights are the view w[l]). As there: LN in fp32, not
// rounded to the tensor's type, quantized per row (ax = max(max|xn|,
// 1e-12) / 127, xq = round(xn / ax)); the fp32 accumulator seeded with
// x + b2; then, for each group of 512 hidden columns, h = gelu((acc1 * ax)
// * s1 + b1) in fp32, the group's per-row absmax ah, hq = round(h / ah)
// int8, and acc += (acc2 * ah) * s2. The group of 512 is the JAX plan's ct
// of every mlpblocki8 row of its tuned table; the plan there moves it with
// the batch, the port fixes it, so mlp must be a multiple of 512 (every
// VARIANTS entry is).
//
// With `partial` set it is the tensor-parallel shard form
// (mlp_block_i8dot's partial_out=True, block.py:537-539): this shard's MLP
// columns, the accumulator seeded with zero, b2 not read.
//
// The kernel is the wgmma tile of mlp_i8_wgmma.cuh (a cluster of two blocks
// a 64-row tile, the int8 weights read by TMA where they lie and turned
// K-major on chip, the quant group's maxima and codes exchanged through
// distributed shared memory; see there). D a multiple of 128 up to 1280;
// rows are masked. W1 and W2 are read through TMA tensor maps: their bases
// 16-byte aligned (the wrapper checks), their rows (mlp and D bytes)
// multiples of 16. Bound on the card: the tensor cores, 4*M*D*mlp int8
// operations.

#include "mlp_i8_wgmma.cuh"

namespace vit {

constexpr int kI8MaxT = 10;  // D up to 1280
constexpr int kI8MaxDevices = 64;

template <typename T>
cudaError_t launch_mlp_i8(const void* x, const void* g, const void* b,
                          const void* w1, const void* s1, const void* b1,
                          const void* w2, const void* s2, const void* b2,
                          void* out, int m, int d, int mlp, float eps,
                          int partial, int device, cudaStream_t st) {
  auto kernel = mq::mlp_i8_wgmma<T>;
  // Per device, once: the shared-memory limit (the largest layout's), and
  // whether the kernel got the registers its setmaxnreg split needs
  // (setmaxnreg.inc would wait forever otherwise, so the launch is
  // refused).
  static bool ready[kI8MaxDevices];
  if (device < 0 || device >= kI8MaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, mq::kSmemMax);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * i8::kThreads < i8::kPoolRegs)
      return cudaErrorLaunchOutOfResources;
    ready[device] = true;
  }
  CUtensorMap m1, m2;
  // W1 (d, mlp) and W2 (mlp, d) in raw boxes of 128 columns x 128 rows.
  if (!tensor_map_i8(&m1, w1, d, mlp, mlp, i8::kBK, i8::kBK) ||
      !tensor_map_i8(&m2, w2, mlp, d, d, i8::kBK, i8::kBK))
    return cudaErrorInvalidValue;
  const mq::Args<T> args{
      static_cast<const T*>(x),   static_cast<const T*>(g),
      static_cast<const T*>(b),   static_cast<const float*>(s1),
      static_cast<const T*>(b1),  static_cast<const float*>(s2),
      static_cast<const T*>(b2),  static_cast<T*>(out),
      m, d / 128, mlp, eps, partial};
  const dim3 grid(2 * ((m + mq::kBM - 1) / mq::kBM));
  kernel<<<grid, i8::kThreads, mq::Layout(d / 128).smem, st>>>(m1, m2, args);
  return cudaGetLastError();
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
  if (m <= 0 || d <= 0 || d % 128 || d / 128 > kI8MaxT || mlp <= 0 ||
      mlp % mq::kGroup)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_mlp_i8<float>(x, g, b, w1, s1, b1, w2, s2, b2, out, m, d,
                                mlp, eps, partial, device, st);
  if (dtype == kBF16)
    return launch_mlp_i8<bf16>(x, g, b, w1, s1, b1, w2, s2, b2, out, m, d,
                               mlp, eps, partial, device, st);
  return cudaErrorInvalidValue;
}
