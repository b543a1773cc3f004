// K19: image -> patch rows (the unfold),
//   (B, C, H, W) -> (B, (H/P)*(W/P), C*P*P), element order (c, kh, kw),
// a pure gather copy, bit for bit.
//
// Replaces vit_tpu/ops/pallas/patching.py:patchify (_patching_kernel :41,
// pallas_call :67). The TPU kernel splits W into (W/P, P) outside the
// kernel (a lane reshape Mosaic cannot do inside) and pads each patch row's
// W/P patches to a sublane multiple of 8 before slicing the pad off. On
// Hopper neither constraint exists: each thread writes one 16-bit or 32-bit
// element of the output, so the writes are coalesced, and reads the
// element it needs; a ragged W/P (224/P16: 14; 80/P16: 5) takes no padding.
//
// Bound on the card: bytes, the image read once and the patch rows written
// once (2 * B*C*H*W * itemsize; 19.3 MB at B/16 bs=32 bf16, 5.75 us). The
// reads of one warp fall on P-element runs of P rows, so they hit each
// 32-byte sector about once; nothing is staged.

#include "common.cuh"

namespace vit {

constexpr int kPatchThreads = 256;

template <typename T>  // any 2- or 4-byte element, copied as bits
__global__ void __launch_bounds__(kPatchThreads)
    patchify_kernel(const T* __restrict__ x, T* __restrict__ out,
                    long long total, int c, int h, int w, int p) {
  const int wp = w / p, n = (h / p) * wp, k = c * p * p;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(e % k);
    const long long row = e / k;  // b * n + patch
    const int patch = static_cast<int>(row % n);
    const long long b = row / n;
    const int ch = col / (p * p), kh = col / p % p, kw = col % p;
    const int hh = patch / wp * p + kh, ww = patch % wp * p + kw;
    out[e] = x[((b * c + ch) * h + hh) * w + ww];
  }
}

}  // namespace vit

extern "C" int vit_patchify(const void* x, void* out, int b, int c, int h,
                            int w, int p, int dtype, int device,
                            void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || c <= 0 || p <= 0 || h < p || w < p || h % p || w % p)
    return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(b) * c * h * w;
  const long long blocks = (total + kPatchThreads - 1) / kPatchThreads;
  const dim3 grid(static_cast<unsigned>(blocks < 1048576 ? blocks : 1048576));
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    patchify_kernel<unsigned int><<<grid, kPatchThreads, 0, st>>>(
        static_cast<const unsigned int*>(x), static_cast<unsigned int*>(out),
        total, c, h, w, p);
  else if (dtype == kBF16)
    patchify_kernel<unsigned short><<<grid, kPatchThreads, 0, st>>>(
        static_cast<const unsigned short*>(x),
        static_cast<unsigned short*>(out), total, c, h, w, p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
