// A probe of the three-pass TF32 split's numerics on the card, no TPU
// kernel's counterpart: it measures what the fp32 forms of K2 (gemm_tf32.cuh)
// and K13 (flash_attention_bwd.cu) may expect of the tensor cores before
// either tile relies on them (vit_tpu_torch/tools/tf32_probe.py runs it;
// tests/test_torch_cuda.py holds it to the plain fp32 product).
//
// (M, K) @ (K, N), both operands row-major fp32, on one of two paths:
// - path 0, the wgmma form: a warpgroup a 64 x 128 output tile, K in steps
//   of 32; each step's B (32 x 128) split into hi and lo and written
//   K-major with the 128-byte swizzle (sw128_f32), A's fragments loaded
//   from device memory and split in registers, then four k8 slices of
//   wgmma.mma_async m64n128k8 tf32 (tf32_split.cuh:wgmma_tf32) -- the
//   instruction, operand layouts and pass order of K2's tile;
// - path 1, the mma.sync form: a warp a 16 x 8 output tile, K in steps of
//   8, mma.sync m16n8k8 tf32 (tf32_split.cuh:mma_tf32) -- K13's.
// mode 0: three passes into one fp32 accumulator (lo hi, hi lo, hi hi);
// mode 1 (wgmma only): the same, each K step of 32 summed into a fresh
// accumulator and added to an fp32 total on the FFMA units, to tell the
// tensor cores' accumulation from the split; mode 2: one pass, hi hi
// (plain TF32), to show what the split buys.
// Nothing is pipelined or tuned: loads and products alternate.

#include "gemm_wgmma.cuh"
#include "tf32_split.cuh"

namespace vit {

constexpr int kProbeBK = 32;

template <int MODE>
__global__ void __launch_bounds__(128)
    tf32_probe_wgmma(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(1024) uint8_t sm[2 * 128 * kProbeBK * 4];
  const uint32_t hi_s = wg::smem_u32(sm), lo_s = hi_s + 128 * kProbeBK * 4;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 128;
  float d[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = part[i] = 0.f;
  for (int k0 = 0; k0 < k; k0 += kProbeBK) {
    __syncthreads();  // the previous step's products are done
    for (int e = t; e < 128 * kProbeBK; e += 128) {
      const int kk = e / 128, nn = e % 128;
      const float x = k0 + kk < k && n0 + nn < n
                          ? b[static_cast<size_t>(k0 + kk) * n + n0 + nn]
                          : 0.f;
      uint32_t h, l;
      split_tf32(x, h, l);
      const uint32_t off = sw128_f32(nn, kk);
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(hi_s + off), "r"(h)
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(lo_s + off), "r"(l)
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    uint32_t ah[kProbeBK / 8][4], al[kProbeBK / 8][4];
#pragma unroll
    for (int s = 0; s < kProbeBK / 8; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + 16 * warp + g + 8 * (i & 1);
        const int c = k0 + 8 * s + q + 4 * (i >> 1);
        const float x =
            r < m && c < k ? a[static_cast<size_t>(r) * k + c] : 0.f;
        split_tf32(x, ah[s][i], al[s][i]);
      }
    wg::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kProbeBK / 8; ++s) {
      const uint64_t dh = wg::sw128_desc(hi_s + 32 * s, 16, 1024);
      const uint64_t dl = wg::sw128_desc(lo_s + 32 * s, 16, 1024);
      if constexpr (MODE == 2) {
        wgmma_tf32(d, ah[s], dh, 1);
      } else if constexpr (MODE == 1) {
        wgmma_tf32(part, al[s], dh, s > 0);
        wgmma_tf32(part, ah[s], dl, 1);
        wgmma_tf32(part, ah[s], dh, 1);
      } else {
        wgmma_tf32(d, al[s], dh, 1);
        wgmma_tf32(d, ah[s], dl, 1);
        wgmma_tf32(d, ah[s], dh, 1);
      }
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(d);
    wg::fence_acc(part);
    if constexpr (MODE == 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] += part[i];
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + 16 * warp + g + 8 * (i >> 1);
      const int c = n0 + 8 * j + 2 * q + (i & 1);
      if (r < m && c < n) out[static_cast<size_t>(r) * n + c] = d[4 * j + i];
    }
}

template <int MODE>
__global__ void __launch_bounds__(128)
    tf32_probe_mma(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, int m, int n, int k) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int tile = blockIdx.x * 4 + threadIdx.x / 32;
  const int tiles_n = (n + 7) / 8;
  const int r0 = tile / tiles_n * 16, c0 = tile % tiles_n * 8;
  if (r0 >= m) return;
  auto at = [&](int r, int c) {
    return r < m && c < k ? a[static_cast<size_t>(r) * k + c] : 0.f;
  };
  auto bt = [&](int r, int c) {
    return r < k && c < n ? b[static_cast<size_t>(r) * n + c] : 0.f;
  };
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < k; k0 += 8) {
    uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
    split_tf32(at(r0 + g, k0 + q), ah[0], al[0]);
    split_tf32(at(r0 + g + 8, k0 + q), ah[1], al[1]);
    split_tf32(at(r0 + g, k0 + q + 4), ah[2], al[2]);
    split_tf32(at(r0 + g + 8, k0 + q + 4), ah[3], al[3]);
    split_tf32(bt(k0 + q, c0 + g), bh0, bl0);
    split_tf32(bt(k0 + q + 4, c0 + g), bh1, bl1);
    if constexpr (MODE == 2)
      mma_tf32(d, ah, bh0, bh1);
    else
      mma_tf32x3(d, ah, al, bh0, bh1, bl0, bl1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + 8 * (i >> 1), c = c0 + 2 * q + (i & 1);
    if (r < m && c < n) out[static_cast<size_t>(r) * n + c] = d[i];
  }
}

template <int MODE>
cudaError_t launch_tf32_probe(int path, const float* a, const float* b,
                              float* out, int m, int n, int k,
                              cudaStream_t st) {
  if (path == 0) {
    const dim3 grid((n + 127) / 128, (m + 63) / 64);
    tf32_probe_wgmma<MODE><<<grid, 128, 0, st>>>(a, b, out, m, n, k);
  } else {
    const long long tiles =
        static_cast<long long>((m + 15) / 16) * ((n + 7) / 8);
    tf32_probe_mma<MODE><<<static_cast<int>((tiles + 3) / 4), 128, 0, st>>>(
        a, b, out, m, n, k);
  }
  return cudaGetLastError();
}

}  // namespace vit

// a (m, k) @ b (k, n) into out (m, n), all fp32 row-major; path 0 wgmma, 1
// mma.sync; mode 0 the three-pass split, 1 (wgmma) the split with each K
// step's sum added on FFMA, 2 one pass.
extern "C" int vit_tf32_split_probe(const void* a, const void* b, void* out,
                                    int m, int n, int k, int path, int mode,
                                    int dtype, int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (dtype != kF32 || m <= 0 || n <= 0 || k <= 0 || path < 0 || path > 1 ||
      mode < 0 || mode > 2 || (path == 1 && mode == 1))
    return cudaErrorInvalidValue;
  auto* pa = static_cast<const float*>(a);
  auto* pb = static_cast<const float*>(b);
  auto* po = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_tf32_probe<0>(path, pa, pb, po, m, n, k, st);
    case 1: return launch_tf32_probe<1>(path, pa, pb, po, m, n, k, st);
    default: return launch_tf32_probe<2>(path, pa, pb, po, m, n, k, st);
  }
}
