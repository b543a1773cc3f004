// K2's fp32 launch on the tf32 wgmma tile of gemm_tf32.cuh (see there and
// matmul.cu): the fp32 tensor maps of both operands, encoded on the host,
// and one persistent block an SM. It is its own unit so that the other
// kernels compile as they did without it.

#include "gemm_tf32.cuh"
#include "gemm_tile.cuh"

namespace vit {

// cuTensorMapEncodeTiled through the runtime's driver entry point
// (matmul_wgmma.cu).
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);
EncodeTiledFn encode_tiled();

// A 2-D fp32 tensor map over the rows x cols row-major matrix at p with
// leading dimension ld (elements), boxes of 32 columns (128 bytes) x
// box_rows, 128-byte swizzle, zeros outside the matrix (K3's fp32 tile,
// mlp_block_tf32.cu, encodes its maps with it too).
bool tensor_map_f32(CUtensorMap* map, const void* p, int rows,
                           int cols, int ld, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(tf::kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(p),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

template <int TA, int TB>
cudaError_t launch_tf32_tile(const CUtensorMap& ma, const CUtensorMap& mb,
                             const tf::Tf32Epilogue& ep, int k, int device,
                             cudaStream_t st) {
  auto kernel = tf::gemm_tf32_wgmma<TA, TB>;
  static int sm_count[kMaxDevices];  // 0 until the device's first launch
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int& sms = sm_count[device];
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tf::kSmem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    // Fewer registers than the split needs: setmaxnreg.inc would wait
    // forever, so refuse the launch.
    if (attr.numRegs * tf::kThreads < tf::kPoolRegs)
      return cudaErrorLaunchOutOfResources;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    sms = count;
  }
  const long long tiles =
      static_cast<long long>((ep.m + tf::kBM - 1) / tf::kBM) *
      ((ep.n + tf::kBN - 1) / tf::kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, tf::kThreads, tf::kSmem, st>>>(ma, mb, ep, k);
  return cudaGetLastError();
}

// K2 in fp32 on the tf32 tile: x (m, k), or with trans_a the view x.t() of
// a contiguous (k, m) matrix; w (k, n), or with trans_b the view w.t() of a
// contiguous (n, k) matrix; TMA reads both (16-byte-aligned bases, row
// strides a multiple of 4 floats: ops/cuda/matmul.py:gemm_path).
cudaError_t launch_tf32(const void* x, const void* w, const void* bias,
                        const void* residual, void* out, int m, int n, int k,
                        int gelu_act, int trans_a, int trans_b, int device,
                        cudaStream_t st) {
  CUtensorMap ma, mb;
  const bool ok_a = trans_a ? tensor_map_f32(&ma, x, k, m, m, 32)
                            : tensor_map_f32(&ma, x, m, k, k, tf::kBM);
  const bool ok_b = trans_b ? tensor_map_f32(&mb, w, n, k, k, tf::kBN)
                            : tensor_map_f32(&mb, w, k, n, n, 32);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  const bool vec =
      n % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0 &&
      (!residual || reinterpret_cast<uintptr_t>(residual) % 8 == 0);
  const tf::Tf32Epilogue ep{static_cast<const float*>(bias),
                            static_cast<const float*>(residual),
                            static_cast<float*>(out), m, n, gelu_act, vec};
  if (trans_a)
    return trans_b ? launch_tf32_tile<1, 1>(ma, mb, ep, k, device, st)
                   : launch_tf32_tile<1, 0>(ma, mb, ep, k, device, st);
  return trans_b ? launch_tf32_tile<0, 1>(ma, mb, ep, k, device, st)
                 : launch_tf32_tile<0, 0>(ma, mb, ep, k, device, st);
}

}  // namespace vit
