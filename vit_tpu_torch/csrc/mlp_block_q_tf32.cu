// K17's fp32 launch on the tensor cores (mlp_tf32.cuh: K3's tile with its
// Q flag, mlp_q_tf32_kernel; the design and the bound are there): x's fp32
// tensor map and the int8 maps of W1 and W2, encoded on the host, and one
// block of BM rows each, K3's forms. mlp_block_q.cu's entry point calls it
// where ops/cuda/quant.py:mlp_q_f32_form gives "tf32". It is its own unit
// so that the other kernels compile as they did without it, and in
// parallel with them.

#include "mlp_tf32.cuh"

namespace vit {

// matmul_tf32.cu: a 2-D fp32 tensor map, boxes of 32 columns x box_rows,
// 128-byte swizzle, zeros outside the matrix.
bool tensor_map_f32(CUtensorMap* map, const void* p, int rows, int cols,
                    int ld, int box_rows);
// matmul_wgmma.cu: the same over int8, boxes of box_cols x box_rows.
bool tensor_map_i8(CUtensorMap* map, const void* p, int rows, int cols,
                   int ld, int box_cols, int box_rows);

constexpr int kMqMaxDevices = 64;

template <int BM, int G>
cudaError_t launch_mlp_q_tf32_tile(const CUtensorMap& mx,
                                   const CUtensorMap& m1,
                                   const CUtensorMap& m2,
                                   const mt::MlpTf32Args& a, const float* s1,
                                   const float* s2, int device,
                                   cudaStream_t st) {
  auto kernel = mt::mlp_q_tf32_kernel<BM, G>;
  constexpr int smem = mt::Cfg<BM, true>::kSmem;
  // Per device, once: the shared-memory limit, and whether the kernel got
  // the registers its setmaxnreg split needs (as K3's launcher).
  static bool ready[kMqMaxDevices];
  if (device < 0 || device >= kMqMaxDevices) return cudaErrorInvalidDevice;
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
  kernel<<<grid, mt::kThreads, smem, st>>>(mx, m1, m2, a, s1, s2);
  return cudaGetLastError();
}

// x and out (m, d) fp32, w1 (d, mlp) and w2 (mlp, d) int8, row-major,
// 16-byte-aligned bases; d a multiple of 128 up to 1280 and mlp of 512
// (ops.mlp_q_plan); g, b, s1, b1, s2 and b2 as K17's FFMA form takes them.
// BM and G as K3's (mlp_block_tf32.cu).
cudaError_t launch_mlp_q_tf32(const float* x, const float* g, const float* b,
                              const signed char* w1, const float* s1,
                              const float* b1, const signed char* w2,
                              const float* s2, const float* b2, float* out,
                              int m, int d, int mlp, float eps, int partial,
                              int device, cudaStream_t st) {
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (d % 128 || d > 1280 || mlp % 512 || !a16(x) || !a16(w1) || !a16(w2) ||
      !a16(out))
    return cudaErrorInvalidValue;
  const int ng = d / 128;
  const int bm = ng <= 6 ? 32 : 16;
  CUtensorMap mx, m1, m2;
  if (!tensor_map_f32(&mx, x, m, d, d, bm) ||
      !tensor_map_i8(&m1, w1, d, mlp, mlp, 128, mt::kBK) ||
      !tensor_map_i8(&m2, w2, mlp, d, d, 128, mt::kBK))
    return cudaErrorInvalidValue;
  const mt::MlpTf32Args a{x, g, b, b1, b2, out, m, d, mlp, eps, partial};
#define VIT_MQ(BM, G) \
  launch_mlp_q_tf32_tile<BM, G>(mx, m1, m2, a, s1, s2, device, st)
  if (ng <= 2) return VIT_MQ(32, 2);
  if (ng <= 4) return VIT_MQ(32, 4);
  if (ng <= 6) return VIT_MQ(32, 6);
  if (ng <= 8) return VIT_MQ(16, 8);
  return VIT_MQ(16, 12);
#undef VIT_MQ
}

}  // namespace vit
