// K23's fp32 core (attn_core_probe.cu): attention_tf32.cuh's tensor-core
// routine on K4's fp32 block -- 128 threads, four warps of 16 query rows,
// a 64-row query tile, grid (batch, heads, ceil(S / 64)) -- with the mode
// as a template parameter. The modes are built in two sources, as the bf16
// core's are (attn_core_probe.cuh), so that neither compile outgrows the
// library's slowest: attn_core_probe_tf32_masked.cu (the modes that mask
// the keys past seq_len) and attn_core_probe_tf32_all_keys.cu (those that
// score every key). kAttnFull takes K4's own NK, min(dh' / 8, 8) as
// attention_tf32.cu builds it, so that it is K4's fp32 core bit for bit;
// every other mode builds NK = 8 (kAttnTf32MaxK), whose slices past dh'
// are skipped: one form a mode.

#pragma once

#include "attention_tf32.cuh"

namespace vit {

template <int NK, int MODE>
__global__ void __launch_bounds__(kAttnTf32Threads)
    attn_probe_kernel_tf32(const float* __restrict__ qkv,
                           const float* __restrict__ tbuf,
                           float* __restrict__ out, int s, int d, int dh,
                           float scale, int seq_len, int ldt) {
  extern __shared__ __align__(16) unsigned char smem[];
  attention_tile_tf32<NK, MODE>(qkv, out, s, d, dh, scale, seq_len,
                                blockIdx.x, blockIdx.y, blockIdx.z * kAttnQT,
                                smem, tbuf, ldt);
}

template <int NK, int MODE>
cudaError_t launch_probe_tf32_nk(const float* qkv, const float* tbuf,
                                 float* out, int batch, int s, int d,
                                 int heads, int seq_len, int ldt, float scale,
                                 cudaStream_t st) {
  const int dh = d / heads;
  const size_t smem = attn_tf32_probe_smem(MODE, s, dh);
  if (smem > kProbeMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_probe_kernel_tf32<NK, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch, heads, (s + kAttnQT - 1) / kAttnQT);
  attn_probe_kernel_tf32<NK, MODE><<<grid, kAttnTf32Threads, smem, st>>>(
      qkv, tbuf, out, s, d, dh, scale, seq_len, ldt);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_probe_tf32(const float* qkv, const float* tbuf,
                              float* out, int batch, int s, int d, int heads,
                              int seq_len, int ldt, float scale,
                              cudaStream_t st) {
#define VIT_PROBE_NK(K)                                                     \
  case K:                                                                   \
    return launch_probe_tf32_nk<K, MODE>(qkv, tbuf, out, batch, s, d, heads, \
                                         seq_len, ldt, scale, st)
  if constexpr (MODE == kAttnFull) {  // K4's NK (attention_tf32.cu)
    const int nk = attn_tf32_dhp(d / heads) / 8;
    switch (nk < kAttnTf32MaxK ? nk : kAttnTf32MaxK) {
      VIT_PROBE_NK(1);
      VIT_PROBE_NK(2);
      VIT_PROBE_NK(3);
      VIT_PROBE_NK(4);
      VIT_PROBE_NK(5);
      VIT_PROBE_NK(6);
      VIT_PROBE_NK(7);
      default: VIT_PROBE_NK(8);
    }
  } else {
    return launch_probe_tf32_nk<kAttnTf32MaxK, MODE>(
        qkv, tbuf, out, batch, s, d, heads, seq_len, ldt, scale, st);
  }
#undef VIT_PROBE_NK
}

// The two sources' launchers: mode an AttnMode of their half.
cudaError_t launch_probe_core_tf32_masked(int mode, const float* qkv,
                                          const float* tbuf, float* out,
                                          int batch, int s, int d, int heads,
                                          int seq_len, int ldt, float scale,
                                          cudaStream_t st);
cudaError_t launch_probe_core_tf32_all_keys(int mode, const float* qkv,
                                            const float* tbuf, float* out,
                                            int batch, int s, int d,
                                            int heads, int seq_len, int ldt,
                                            float scale, cudaStream_t st);

}  // namespace vit
