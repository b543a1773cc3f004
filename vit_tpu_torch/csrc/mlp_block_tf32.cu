// K3's fp32 launch on the tensor cores (mlp_tf32.cuh: the tile, its design
// and its bound): the fp32 tensor maps of x, W1 and W2, encoded on the
// host, and one block of BM rows each. mlp_block.cu's entry point calls it
// where ops/cuda/block.py:mlp_f32_form gives "tf32". It is its own unit so
// that the other kernels compile as they did without it, and in parallel
// with them.

#include "mlp_tf32.cuh"

namespace vit {

// matmul_tf32.cu: a 2-D fp32 tensor map, boxes of 32 columns x box_rows,
// 128-byte swizzle, zeros outside the matrix.
bool tensor_map_f32(CUtensorMap* map, const void* p, int rows, int cols,
                    int ld, int box_rows);

constexpr int kMtMaxDevices = 64;

template <int BM, int G>
cudaError_t launch_mlp_tf32_tile(const CUtensorMap& mx, const CUtensorMap& m1,
                                 const CUtensorMap& m2,
                                 const mt::MlpTf32Args& a, int device,
                                 cudaStream_t st) {
  auto kernel = mt::mlp_tf32_kernel<BM, G>;
  constexpr int smem = mt::Cfg<BM>::kSmem;
  // Per device, once: the shared-memory limit, and whether the kernel got
  // the registers its setmaxnreg split needs (setmaxnreg.inc would wait
  // forever otherwise, so the launch is refused).
  static bool ready[kMtMaxDevices];
  if (device < 0 || device >= kMtMaxDevices) return cudaErrorInvalidDevice;
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
  kernel<<<grid, mt::kThreads, smem, st>>>(mx, m1, m2, a);
  return cudaGetLastError();
}

// x (m, d), w1 (d, mlp), w2 (mlp, d), row-major, 16-byte-aligned bases, d
// and mlp multiples of 4, d <= 1536; g, b, b1, b2 and out as K3's FFMA form
// takes them. BM = 32 rows a block up to 6 output groups (D <= 768), else
// 16 (mlp_tf32.cuh: the sums a consumer thread holds).
cudaError_t launch_mlp_tf32(const float* x, const float* g, const float* b,
                            const float* w1, const float* b1, const float* w2,
                            const float* b2, float* out, int m, int d,
                            int mlp, float eps, int partial, int device,
                            cudaStream_t st) {
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (d % 4 || mlp % 4 || d > mt::kMaxD || !a16(x) || !a16(w1) || !a16(w2) ||
      !a16(out))
    return cudaErrorInvalidValue;
  const int ng = (d + 127) / 128;
  const int bm = ng <= 6 ? 32 : 16;
  CUtensorMap mx, m1, m2;
  if (!tensor_map_f32(&mx, x, m, d, d, bm) ||
      !tensor_map_f32(&m1, w1, d, mlp, mlp, mt::kBK) ||
      !tensor_map_f32(&m2, w2, mlp, d, d, mt::kBK))
    return cudaErrorInvalidValue;
  const mt::MlpTf32Args a{x, g, b, b1, b2, out, m, d, mlp, eps, partial};
  if (ng <= 2) return launch_mlp_tf32_tile<32, 2>(mx, m1, m2, a, device, st);
  if (ng <= 4) return launch_mlp_tf32_tile<32, 4>(mx, m1, m2, a, device, st);
  if (ng <= 6) return launch_mlp_tf32_tile<32, 6>(mx, m1, m2, a, device, st);
  if (ng <= 8) return launch_mlp_tf32_tile<16, 8>(mx, m1, m2, a, device, st);
  return launch_mlp_tf32_tile<16, 12>(mx, m1, m2, a, device, st);
}

}  // namespace vit
