// K2's, K6's and K8's fp32 launches on the tf32 wgmma tile of
// gemm_tf32.cuh (see there, matmul.cu and embed.cu): the fp32 tensor maps
// of both operands, encoded on the host, and one persistent block an SM.
// It is its own unit so that the other kernels compile as they did without
// it.

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
// box_rows, 128-byte swizzle, zeros outside the matrix (K3's and K18's fp32
// tile, mlp_block_tf32.cu and layer_block_tf32.cu, encode their maps with
// it too).
bool tensor_map_f32(CUtensorMap* map, const void* p, int rows, int cols,
                    int ld, int box_rows) {
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

namespace tf {

// K6 in fp32: LN(x) (m, k) @ w (k, n), both contiguous, k = the LN width.
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32_ln_wgmma(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       Tf32Epilogue ep, int k, Tf32Ln ln) {
  gemm_tf32_walk<0, 0, true>(map_a, map_b, ep, k, ln);
}

// K8 in fp32: patches (m, k) @ w (k, n), both contiguous, into the token
// rows of the embedding (Tf32Embed).
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32_embed_wgmma(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          Tf32Embed ep, int k) {
  gemm_tf32_walk<0, 0, false, Tf32Embed>(map_a, map_b, ep, k, Tf32Ln{});
}

}  // namespace tf

// One launch of a kernel of the tile, K2's (gemm_tf32_wgmma<TA, TB>) or,
// with LN, K6's, or with EMB, K8's (tf::launch_walk, a count of SMs a
// device for each kernel).
template <int TA, int TB, bool LN, bool EMB = false, typename... Args>
cudaError_t launch_tf32_tile(int m, int n, int device, cudaStream_t st,
                             const Args&... args) {
  auto kernel = [] {
    if constexpr (EMB)
      return tf::gemm_tf32_embed_wgmma;
    else if constexpr (LN)
      return tf::gemm_tf32_ln_wgmma;
    else
      return tf::gemm_tf32_wgmma<TA, TB>;
  }();
  static int sm_count[tf::kMaxDevices];  // 0 until the first launch
  if (device < 0 || device >= tf::kMaxDevices)
    return cudaErrorInvalidDevice;
  return tf::launch_walk(kernel, sm_count[device], m, n, device, st,
                         args...);
}

// The epilogue of out (m, n): pairs stored as 8 bytes where n, out and the
// residual allow it.
tf::Tf32Epilogue tf32_epilogue(const void* bias, const void* residual,
                               void* out, int m, int n, int gelu_act) {
  const bool vec =
      n % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0 &&
      (!residual || reinterpret_cast<uintptr_t>(residual) % 8 == 0);
  return tf::Tf32Epilogue{static_cast<const float*>(bias),
                          static_cast<const float*>(residual),
                          static_cast<float*>(out), m, n, gelu_act, vec};
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
  const tf::Tf32Epilogue ep =
      tf32_epilogue(bias, residual, out, m, n, gelu_act);
  if (trans_a)
    return trans_b ? launch_tf32_tile<1, 1, false>(m, n, device, st, ma, mb,
                                                   ep, k)
                   : launch_tf32_tile<1, 0, false>(m, n, device, st, ma, mb,
                                                   ep, k);
  return trans_b ? launch_tf32_tile<0, 1, false>(m, n, device, st, ma, mb, ep,
                                                 k)
                 : launch_tf32_tile<0, 0, false>(m, n, device, st, ma, mb, ep,
                                                 k);
}

// Whether K6 in fp32 takes the tf32 tile (matmul.cu:vit_fused_linear_tile):
// TMA reads the contiguous x (m, k) and w (k, n) -- 16-byte-aligned bases,
// k and n multiples of 4 floats, gemm_path's fp32 rule.
bool tf32_takes(const void* x, const void* w, int n, int k) {
  return aligned16(x) && aligned16(w) && k % 4 == 0 && n % 4 == 0;
}

// K6 in fp32 on the tf32 tile (tf32_takes): act(LN(x) @ w + bias) +
// residual with K5's mu and rstd.
cudaError_t launch_tf32_ln(const void* x, const void* w, const void* bias,
                           const void* residual, const float* mu,
                           const float* rstd, const void* gamma,
                           const void* beta, void* out, int m, int n, int k,
                           int gelu_act, int device, cudaStream_t st) {
  CUtensorMap ma, mb;
  if (!tensor_map_f32(&ma, x, m, k, k, tf::kBM) ||
      !tensor_map_f32(&mb, w, k, n, n, 32))
    return cudaErrorInvalidValue;
  const tf::Tf32Ln ln{mu, rstd, static_cast<const float*>(gamma),
                      static_cast<const float*>(beta)};
  return launch_tf32_tile<0, 0, true>(
      m, n, device, st, ma, mb,
      tf32_epilogue(bias, residual, out, m, n, gelu_act), k, ln);
}

// K8 in fp32 on the tf32 tile (tf32_takes(patches, w, d, k)): patches (b
// * n_tok, k) @ w (k, d) + bias, + pos, into the token rows of out (b, sp,
// d), with each image's cls row and zero pad rows.
cudaError_t launch_tf32_embed(const void* patches, const void* w,
                              const void* bias, const void* cls_row,
                              const void* pos, void* out, int b, int n_tok,
                              int k, int d, int sp, int device,
                              cudaStream_t st) {
  const int m = b * n_tok;
  CUtensorMap ma, mb;
  if (!tensor_map_f32(&ma, patches, m, k, k, tf::kBM) ||
      !tensor_map_f32(&mb, w, k, d, d, 32))
    return cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(out) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(pos) % 8 == 0;
  const tf::Tf32Embed ep{static_cast<const float*>(bias),
                         static_cast<const float*>(pos),
                         static_cast<const float*>(cls_row),
                         static_cast<float*>(out), m, d, n_tok, sp, b, vec};
  return launch_tf32_tile<0, 0, false, true>(m, d, device, st, ma, mb, ep, k);
}

}  // namespace vit
