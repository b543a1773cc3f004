// K2's and K6's bf16 launches on the wgmma tile of gemm_wgmma.cuh (see
// there and matmul.cu): the tensor maps of both operands, encoded on the
// host, and one persistent block an SM. It is its own unit so that
// matmul.cu's kernels (K2's and K6's other tiles, K11) compile as they did
// without it.

#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"

namespace vit {

// cuTensorMapEncodeTiled, found through the runtime's driver entry point
// so that the library links without -lcuda.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D tensor map of `type` (elements of `elem` bytes) over the rows x
// cols row-major matrix at p with leading dimension ld (elements), boxes of
// box_cols x box_rows, 128-byte swizzle (or none), zeros outside the
// matrix.
static bool encode_map(CUtensorMap* map, CUtensorMapDataType type,
                       size_t elem, const void* p, int rows, int cols, int ld,
                       int box_cols, int box_rows,
                       CUtensorMapSwizzle swizzle =
                           CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(p), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 map (K2, K3) and the int8 one (K11, K12) of encode_map.
bool tensor_map(CUtensorMap* map, const void* p, int rows, int cols, int ld,
                int box_cols, int box_rows) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), p,
                    rows, cols, ld, box_cols, box_rows);
}

bool tensor_map_i8(CUtensorMap* map, const void* p, int rows, int cols,
                   int ld, int box_cols, int box_rows) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p, rows, cols, ld,
                    box_cols, box_rows);
}

// The int8 map without swizzle (K17's raw boxes: dense rows of box_cols
// bytes).
bool tensor_map_i8_dense(CUtensorMap* map, const void* p, int rows, int cols,
                         int ld, int box_cols, int box_rows) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p, rows, cols, ld,
                    box_cols, box_rows, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Per device: its SM count, and whether each wgmma kernel may use kSmem
// bytes of shared memory and got the registers its setmaxnreg split needs
// (set once: the host cost of a launch counts at K2's smaller shapes).
constexpr int kMaxDevices = 64;

template <int TA, int TB, bool LN = false, bool EMB = false,
          int XEP = wg::kXepNone>
cudaError_t launch_wgmma_tile(const CUtensorMap& ma, const CUtensorMap& mb,
                              const wg::WgEpilogue& ep, int k, int device,
                              cudaStream_t st, const wg::WgLn& ln = {}) {
  auto kernel = wg::gemm_bf16_wgmma<TA, TB, LN, EMB, XEP>;
  static int sm_count[kMaxDevices];  // 0 until the device's first launch
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int& sms = sm_count[device];
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kSmem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    // Fewer registers than the split needs: setmaxnreg.inc would wait
    // forever, so refuse the launch.
    if (attr.numRegs * wg::kThreads < wg::kPoolRegs)
      return cudaErrorLaunchOutOfResources;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    sms = count;
  }
  const long long tiles =
      static_cast<long long>((ep.m + wg::kBM - 1) / wg::kBM) *
      ((ep.n + wg::kBN - 1) / wg::kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, wg::kThreads, wg::kSmem, st>>>(ma, mb, ep, k, ln);
  return cudaGetLastError();
}

// The epilogue of K2 and K6 on this tile.
static wg::WgEpilogue wg_epilogue(const void* bias, const void* residual,
                                  void* out, int m, int n, int gelu_act) {
  return wg::WgEpilogue{
      static_cast<const bf16*>(bias), static_cast<const bf16*>(residual),
      static_cast<bf16*>(out), m, n, gelu_act,
      residual != nullptr && reinterpret_cast<uintptr_t>(residual) % 4 == 0 &&
          n % 2 == 0,
      aligned16(out) && n % 8 == 0};
}

// K2 on the wgmma tile.
cudaError_t launch_wgmma(const void* x, const void* w, const void* bias,
                         const void* residual, void* out, int m, int n, int k,
                         int gelu_act, int trans_a, int trans_b, int device,
                         cudaStream_t st) {
  CUtensorMap ma, mb;
  // A: x (m, k), or x.t() of a (k, m) matrix in boxes of 64 rows of M.
  const bool ok_a = trans_a ? tensor_map(&ma, x, k, m, m, 64, 64)
                            : tensor_map(&ma, x, m, k, k, 64, wg::kBM);
  // B: w (k, n) in boxes of 64 columns of N, or w.t() of an (n, k) matrix.
  const bool ok_b = trans_b ? tensor_map(&mb, w, n, k, k, 64, wg::kBN)
                            : tensor_map(&mb, w, k, n, n, 64, 64);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  const wg::WgEpilogue ep =
      wg_epilogue(bias, residual, out, m, n, gelu_act);
  if (trans_a)
    return trans_b ? launch_wgmma_tile<1, 1>(ma, mb, ep, k, device, st)
                   : launch_wgmma_tile<1, 0>(ma, mb, ep, k, device, st);
  return trans_b ? launch_wgmma_tile<0, 1>(ma, mb, ep, k, device, st)
                 : launch_wgmma_tile<0, 0>(ma, mb, ep, k, device, st);
}

// Whether K6 (and K2 on the same contiguous operands) runs on this tile:
// TMA reads x (m, k) and w (k, n) where both bases are 16-byte aligned and
// both row strides a multiple of 8 elements
// (vit_tpu_torch/ops/cuda/matmul.py:gemm_path's rule).
bool wgmma_takes(const void* x, const void* w, int n, int k) {
  return aligned16(x) && aligned16(w) && k % 8 == 0 && n % 8 == 0;
}

// K6 on the wgmma tile: act(LN(x) @ w + bias) + residual, x (m, k) and w
// (k, n) contiguous, LN with K5's mu and rstd.
cudaError_t launch_wgmma_ln(const void* x, const void* w, const void* bias,
                            const void* residual, const float* mu,
                            const float* rstd, const void* gamma,
                            const void* beta, void* out, int m, int n, int k,
                            int gelu_act, int device, cudaStream_t st) {
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, x, m, k, k, 64, wg::kBM) ||
      !tensor_map(&mb, w, k, n, n, 64, 64))
    return cudaErrorInvalidValue;
  const wg::WgLn ln{mu, rstd, static_cast<const bf16*>(gamma),
                    static_cast<const bf16*>(beta), k,
                    aligned16(gamma) && aligned16(beta)};
  return launch_wgmma_tile<0, 0, true>(
      ma, mb, wg_epilogue(bias, residual, out, m, n, gelu_act), k, device,
      st, ln);
}

// K8 on the wgmma tile: patches (b * n_tok, k) @ w (k, d) + bias, cast,
// + pos, into token rows of out (b, sp, d), with each image's cls row and
// zero pad rows; patches and w contiguous (wgmma_takes).
cudaError_t launch_wgmma_embed(const void* patches, const void* w,
                               const void* bias, const void* cls_row,
                               const void* pos, void* out, int b, int n_tok,
                               int k, int d, int sp, int device,
                               cudaStream_t st) {
  const int m = b * n_tok;
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, patches, m, k, k, 64, wg::kBM) ||
      !tensor_map(&mb, w, k, d, d, 64, 64))
    return cudaErrorInvalidValue;
  wg::WgEpilogue ep = wg_epilogue(bias, nullptr, out, m, d, 0);
  ep.pos = static_cast<const bf16*>(pos);
  ep.cls = static_cast<const bf16*>(cls_row);
  ep.n_tok = n_tok;
  ep.sp = sp;
  ep.batch = b;
  ep.vec_pos = reinterpret_cast<uintptr_t>(pos) % 4 == 0 && d % 2 == 0;
  return launch_wgmma_tile<0, 0, false, true>(ma, mb, ep, k, device, st);
}

// K23's probe GEMMs on the wgmma tile (attn_core_probe.cu, where
// wgmma_takes(x, w, n, k)): x (m, k) @ w (k, n), both contiguous and read
// as they lie, with the epilogue form xep (wg::WgXep, kXepSplitQ ..
// kXepOutT); bias, res, alt and d as vit_attn_probe_gemm takes them.
cudaError_t launch_wgmma_probe(int xep, const void* x, const void* w,
                               const void* bias, const void* res, void* out,
                               void* alt, int m, int n, int k, int d,
                               int device, cudaStream_t st) {
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, x, m, k, k, 64, wg::kBM) ||
      !tensor_map(&mb, w, k, n, n, 64, 64))
    return cudaErrorInvalidValue;
  const bool trans_out = xep == wg::kXepAllT || xep == wg::kXepOutT;
  // kXepOutX's residual is (m, n) as K2's; kXepOutT's (n, m) is read in
  // the transposed rows (vec_t).
  wg::WgEpilogue ep =
      wg_epilogue(bias, xep == wg::kXepOutX ? res : nullptr, out, m, n, 0);
  ep.residual = static_cast<const bf16*>(res);
  ep.alt = static_cast<bf16*>(alt);
  ep.d = d;
  ep.vec_alt = aligned16(alt) &&
               (xep == wg::kXepSplitQ ? d % 8 == 0 : m % 8 == 0);
  ep.vec_t = trans_out && m % 8 == 0 && aligned16(out) &&
             (xep != wg::kXepOutT || (aligned16(res) && aligned16(bias)));
#define VIT_PROBE_XEP(X)                                                   \
  case X:                                                                  \
    return launch_wgmma_tile<0, 0, false, false, X>(ma, mb, ep, k, device, \
                                                    st);
  switch (xep) {
    VIT_PROBE_XEP(wg::kXepSplitQ)
    VIT_PROBE_XEP(wg::kXepSplitKT)
    VIT_PROBE_XEP(wg::kXepAllT)
    VIT_PROBE_XEP(wg::kXepRowBias)
    VIT_PROBE_XEP(wg::kXepOutX)
    VIT_PROBE_XEP(wg::kXepOutT)
    default:
      return cudaErrorInvalidValue;
  }
#undef VIT_PROBE_XEP
}

// K22's bf16 dot on the wgmma tile (dot_probe.cu, where wgmma_takes(x, w,
// n, k)): x (m, k) @ w (k, n), both contiguous, the fp32 sums into out
// (m, n) as they stand.
cudaError_t launch_wgmma_raw(const void* x, const void* w, float* out, int m,
                             int n, int k, int device, cudaStream_t st) {
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, x, m, k, k, 64, wg::kBM) ||
      !tensor_map(&mb, w, k, n, n, 64, 64))
    return cudaErrorInvalidValue;
  wg::WgEpilogue ep = wg_epilogue(nullptr, nullptr, nullptr, m, n, 0);
  ep.out_f32 = out;
  ep.vec_out = n % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  return launch_wgmma_tile<0, 0, false, false, wg::kXepRawF32>(ma, mb, ep, k,
                                                              device, st);
}

}  // namespace vit
