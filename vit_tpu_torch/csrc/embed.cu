// K8: embed_fused -- patch projection, CLS row, positions and the zero pad
// to sp rows in one launch: (B, N, K) patches -> (B, sp, D) tokens.
//
// Replaces vit_tpu/ops/pallas/patch_embed.py:embed_fused (_embed_kernel,
// patch_embed.py:47-63), which assembles the padded (sp, D) token matrix in
// VMEM so that the unpadded embedding never exists in HBM. Here the same
// holds for device memory: the output is written once, already padded.
//
// bf16, wherever K2 would get the wgmma tile on the same contiguous
// (B*N, K) patches and (K, D) weight (wgmma_takes, gemm_path's rule: both
// bases 16-byte aligned, K and D multiples of 8): K2's persistent wgmma
// tile with the EMB epilogue (gemm_wgmma.cuh, matmul_wgmma.cu:
// launch_wgmma_embed), K2's sum order, so its rows are bit for bit K2 ->
// cast -> + pos. fp32, wherever K2 would get the tf32 tile on them
// (tf32_takes: both bases 16-byte aligned, K and D multiples of 4 floats;
// H/14's K = 588 included, its last 32-deep step ragged and zero-filled by
// TMA): K2's three-pass TF32 walk with the Tf32Embed epilogue
// (gemm_tf32.cuh, matmul_tf32.cu:launch_tf32_embed), each 32-deep K step
// summed apart, so its rows are bit for bit K2's fp32 rows + pos.
// Elsewhere (bf16 where TMA cannot read the operands, as H/14's K = 588,
// whose rows are not whole 16-byte chunks; fp32 on a misaligned base or a
// K or D that is not a multiple of 4) gemm_tile.cuh's loop with the
// epilogue below: a rule on the operands, decided before the launch, not
// a fallback when a launch fails. Either way patch row g*N + i becomes
// output row g*sp + 1 + i, with _embed_kernel's rounding -- z = acc + bias
// in fp32, cast to the tensor's type, then z + pos[i] in that type (one
// more rounding in bf16), the composed route's numbers exactly -- and each
// image's row 0 (cls_row, which already holds pos[0]) and pad rows N+1 ..
// sp-1 (zeros), the rows that _embed_kernel takes from `base`, are written
// once: on the wgmma tiles by the block that walks the column tile's first
// row tile, on gemm_tile.cuh's by the first row of blocks. Tiles past the
// edges are zero-filled as in K2.
//
// Bound on the card: at bs <= 4 the (K, D) weight (1.2 MB at B/16 bf16)
// and the patches are read once; a few microseconds at 3.35 TB/s, so the
// bf16 kernel is latency-bound: 12 tiles of 128 x 128 at B/16 bs=1, 42 at
// bs=4, 144 at L/16-384 bs=4 on 132 SMs, each a serial walk over K's
// 64-deep steps. In fp32 the three TF32 passes bound it (2 B N K D x 3 at
// 495 TFLOP/s: 0.022 ms at L/16-384 bs=4), and the same tiles walk K in
// 32-deep steps. What the wgmma forms still leave: at bs <= 4 most SMs
// idle (a 64-row tile or a deterministic split over K would fill more of
// them).

#include "gemm_tile.cuh"

namespace vit {

// Defined in matmul_wgmma.cu.
bool wgmma_takes(const void* x, const void* w, int n, int k);
cudaError_t launch_wgmma_embed(const void* patches, const void* w,
                               const void* bias, const void* cls_row,
                               const void* pos, void* out, int b, int n_tok,
                               int k, int d, int sp, int device,
                               cudaStream_t st);
// Defined in matmul_tf32.cu.
bool tf32_takes(const void* x, const void* w, int n, int k);
cudaError_t launch_tf32_embed(const void* patches, const void* w,
                              const void* bias, const void* cls_row,
                              const void* pos, void* out, int b, int n_tok,
                              int k, int d, int sp, int device,
                              cudaStream_t st);

template <typename T>
struct EmbedEpilogue {
  const T* bias;  // (D,)
  const T* pos;   // (N, D)
  T* out;         // (B, sp, D)
  int n_tok, sp, d;

  __device__ __forceinline__ void store(int row, int col, float acc) const {
    const int g = row / n_tok, i = row % n_tok;
    const float z = to_f32(from_f32<T>(acc + to_f32(bias[col])));
    out[(static_cast<size_t>(g) * sp + 1 + i) * d + col] =
        from_f32<T>(z + to_f32(pos[static_cast<size_t>(i) * d + col]));
  }
};

template <typename T>
__global__ void __launch_bounds__(kMmThreads)
    embed_kernel(const T* __restrict__ patches, const T* __restrict__ w,
                 EmbedEpilogue<T> ep, const T* __restrict__ cls_row, int b,
                 int k, bool vec_x, bool vec_w) {
  __shared__ typename Gemm<T>::Smem sm;
  const int n0 = blockIdx.x * Gemm<T>::BN;
  gemm_tile<false>(patches, w, b * ep.n_tok, ep.d, k,
                   blockIdx.y * Gemm<T>::BM, n0, vec_x, vec_w,
                   LnPrologue<T>{}, ep, sm);
  if (blockIdx.y != 0) return;
  // Row 0 and the pad rows of every image, in this block's columns.
  const int extra = ep.sp - ep.n_tok;  // row 0, rows n_tok+1 .. sp-1
  const int cols = min(Gemm<T>::BN, ep.d - n0);
  for (int e = threadIdx.x; e < b * extra * cols; e += kMmThreads) {
    const int c = e % cols, r = e / cols;
    const int g = r / extra, j = r % extra;
    const int row = j == 0 ? 0 : ep.n_tok + j;
    ep.out[(static_cast<size_t>(g) * ep.sp + row) * ep.d + n0 + c] =
        j == 0 ? cls_row[n0 + c] : from_f32<T>(0.f);
  }
}

template <typename T>
cudaError_t launch_embed(const void* patches, const void* w, const void* bias,
                         const void* cls_row, const void* pos, void* out,
                         int b, int n, int k, int d, int sp, cudaStream_t st) {
  EmbedEpilogue<T> ep{static_cast<const T*>(bias),
                      static_cast<const T*>(pos), static_cast<T*>(out), n, sp,
                      d};
  const dim3 grid((d + Gemm<T>::BN - 1) / Gemm<T>::BN,
                  (b * n + Gemm<T>::BM - 1) / Gemm<T>::BM);
  const bool vec_x = aligned16(patches) && k % 8 == 0;
  const bool vec_w = aligned16(w) && d % 8 == 0;
  embed_kernel<T><<<grid, kMmThreads, 0, st>>>(
      static_cast<const T*>(patches), static_cast<const T*>(w), ep,
      static_cast<const T*>(cls_row), b, k, vec_x, vec_w);
  return cudaGetLastError();
}

}  // namespace vit

// patches (b, n, k), w (k, d), bias (d,), cls_row (d,), pos (n, d) -> out
// (b, sp, d); sp >= n + 1.
extern "C" int vit_embed_fused(const void* patches, const void* w,
                               const void* bias, const void* cls_row,
                               const void* pos, void* out, int b, int n,
                               int k, int d, int sp, int dtype, int device,
                               void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || n <= 0 || k <= 0 || d <= 0 || sp < n + 1)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    if (tf32_takes(patches, w, d, k))
      return launch_tf32_embed(patches, w, bias, cls_row, pos, out, b, n, k,
                               d, sp, device, st);
    return launch_embed<float>(patches, w, bias, cls_row, pos, out, b, n, k,
                               d, sp, st);
  }
  if (dtype == kBF16) {
    if (wgmma_takes(patches, w, d, k))
      return launch_wgmma_embed(patches, w, bias, cls_row, pos, out, b, n, k,
                                d, sp, device, st);
    return launch_embed<bf16>(patches, w, bias, cls_row, pos, out, b, n, k, d,
                              sp, st);
  }
  return cudaErrorInvalidValue;
}
