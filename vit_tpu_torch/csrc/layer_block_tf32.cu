// K18's fp32 launch on the tensor cores (mlp_tf32.cuh: K3's tile with its
// LAYER flag, layer_tf32_kernel; the design and the bound are there): the
// fp32 tensor maps of ctx, out (y is read back from it), Wout, W1 and W2,
// encoded on the host, and one block of BM rows each, K3's forms.
// layer_block.cu's entry point calls it where ops/cuda/block.py:
// mlp_f32_form gives "tf32" for ctx, x, out and the weights. It is its own
// unit so that the other kernels compile as they did without it, and in
// parallel with them.

#include "mlp_tf32.cuh"

namespace vit {

// matmul_tf32.cu: a 2-D fp32 tensor map, boxes of 32 columns x box_rows,
// 128-byte swizzle, zeros outside the matrix.
bool tensor_map_f32(CUtensorMap* map, const void* p, int rows, int cols,
                    int ld, int box_rows);

constexpr int kLtMaxDevices = 64;

template <int BM, int G>
cudaError_t launch_layer_tf32_tile(const CUtensorMap& my,
                                   const CUtensorMap& m1,
                                   const CUtensorMap& m2,
                                   const CUtensorMap& mc,
                                   const CUtensorMap& mo,
                                   const mt::MlpTf32Args& a, const float* bout,
                                   int device, cudaStream_t st) {
  auto kernel = mt::layer_tf32_kernel<BM, G>;
  constexpr int smem = mt::Cfg<BM>::kSmem;
  // Per device, once: the shared-memory limit, and whether the kernel got
  // the registers its setmaxnreg split needs (as K3's launcher).
  static bool ready[kLtMaxDevices];
  if (device < 0 || device >= kLtMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * mt::kThreads < mt::kPoolRegs)
      return cudaErrorLaunchOutOfResources;
    ready[device] = true;
  }
  const dim3 grid((a.m + BM - 1) / BM);
  kernel<<<grid, mt::kThreads, smem, st>>>(my, m1, m2, mc, mo, a, bout);
  return cudaGetLastError();
}

// ctx, x and out (m, d), wout (d, d), w1 (d, mlp), w2 (mlp, d), row-major,
// 16-byte-aligned bases, d and mlp multiples of 4, d <= 1536; bout, g2,
// bn2, b1 and b2 as K18's FFMA form takes them. BM and G as K3's
// (mlp_block_tf32.cu).
cudaError_t launch_layer_tf32(const float* ctx, const float* x,
                              const float* wout, const float* bout,
                              const float* g2, const float* bn2,
                              const float* w1, const float* b1,
                              const float* w2, const float* b2, float* out,
                              int m, int d, int mlp, float eps, int device,
                              cudaStream_t st) {
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (d % 4 || mlp % 4 || d > mt::kMaxD || !a16(ctx) || !a16(x) ||
      !a16(wout) || !a16(w1) || !a16(w2) || !a16(out))
    return cudaErrorInvalidValue;
  const int ng = (d + 127) / 128;
  const int bm = ng <= 6 ? 32 : 16;
  CUtensorMap my, m1, m2, mc, mo;
  if (!tensor_map_f32(&my, out, m, d, d, bm) ||
      !tensor_map_f32(&m1, w1, d, mlp, mlp, mt::kBK) ||
      !tensor_map_f32(&m2, w2, mlp, d, d, mt::kBK) ||
      !tensor_map_f32(&mc, ctx, m, d, d, bm) ||
      !tensor_map_f32(&mo, wout, d, d, d, mt::kBK))
    return cudaErrorInvalidValue;
  const mt::MlpTf32Args a{x, g2, bn2, b1, b2, out, m, d, mlp, eps, 0};
#define VIT_LT(BM, G) \
  launch_layer_tf32_tile<BM, G>(my, m1, m2, mc, mo, a, bout, device, st)
  if (ng <= 2) return VIT_LT(32, 2);
  if (ng <= 4) return VIT_LT(32, 4);
  if (ng <= 6) return VIT_LT(32, 6);
  if (ng <= 8) return VIT_LT(16, 8);
  return VIT_LT(16, 12);
#undef VIT_LT
}

}  // namespace vit
