// K23's bf16 core (attn_core_probe.cu): attention_mma.cuh's tensor-core
// tile on K4's block -- 128 threads, four warps of 16 query rows, a 64-row
// query tile, grid (batch, heads, ceil(S / 64)) -- with the mode as a
// template parameter. The modes are built in two sources so that neither
// compile outgrows the library's slowest (encoder_stack.cu):
// attn_core_probe_masked.cu (the modes that mask the keys past seq_len)
// and attn_core_probe_all_keys.cu (those that score every key). kAttnFull
// takes K4's own instantiation, NK = min(dh' / 16, 8) as attention.cu
// builds it, so that it is K4's core bit for bit; every other mode builds
// NK = attn_mma_nk_of(dh), three forms, as K9 does.

#pragma once

#include "attention_mma.cuh"

namespace vit {

template <int NK, int MODE>
__global__ void __launch_bounds__(kAttnMmaThreads)
    attn_probe_kernel_mma(const bf16* __restrict__ qkv,
                          const bf16* __restrict__ tbuf,
                          bf16* __restrict__ out, int s, int d, int dh,
                          float scale, int seq_len, int ldt) {
  extern __shared__ __align__(16) unsigned char smem[];
  attention_tile_mma<NK, 1, kAttnMmaThreads, MODE>(
      qkv, out, s, d, dh, scale, seq_len, blockIdx.x, blockIdx.y,
      blockIdx.z * kAttnQT, smem, tbuf, ldt);
}

template <int NK, int MODE>
cudaError_t launch_probe_mma_nk(const bf16* qkv, const bf16* tbuf,
                                bf16* out, int batch, int s, int d,
                                int heads, int seq_len, int ldt, float scale,
                                cudaStream_t st) {
  const int dh = d / heads;
  const size_t smem = attn_mma_probe_smem(MODE, s, dh);
  if (smem > kProbeMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_probe_kernel_mma<NK, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch, heads, (s + kAttnQT - 1) / kAttnQT);
  attn_probe_kernel_mma<NK, MODE><<<grid, kAttnMmaThreads, smem, st>>>(
      qkv, tbuf, out, s, d, dh, scale, seq_len, ldt);
  return cudaGetLastError();
}

// The core in MODE; qcore and head-major take heads up to 128 columns
// (their q is held whole).
template <int MODE>
cudaError_t launch_probe_mma(const bf16* qkv, const bf16* tbuf, bf16* out,
                             int batch, int s, int d, int heads, int seq_len,
                             int ldt, float scale, cudaStream_t st) {
  const int dh = d / heads;
#define VIT_PROBE_NK(K)                                                    \
  case K:                                                                  \
    return launch_probe_mma_nk<K, MODE>(qkv, tbuf, out, batch, s, d, heads, \
                                        seq_len, ldt, scale, st)
  if constexpr (MODE == kAttnFull) {  // K4's NK (attention.cu)
    const int nk = attn_mma_dhp(dh) / 16;
    switch (nk < kAttnMmaMaxK ? nk : kAttnMmaMaxK) {
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
    if ((MODE == kAttnQcore || MODE == kAttnHeadMajor) &&
        attn_mma_dhp(dh) > 16 * kAttnMmaMaxK)
      return cudaErrorInvalidValue;
    switch (attn_mma_nk_of(dh)) {
      VIT_PROBE_NK(2);
      VIT_PROBE_NK(4);
      default: VIT_PROBE_NK(8);
    }
  }
#undef VIT_PROBE_NK
}

// The two sources' launchers: mode an AttnMode of their half.
cudaError_t launch_probe_core_masked(int mode, const bf16* qkv,
                                     const bf16* tbuf, bf16* out, int batch,
                                     int s, int d, int heads, int seq_len,
                                     int ldt, float scale, cudaStream_t st);
cudaError_t launch_probe_core_all_keys(int mode, const bf16* qkv,
                                       const bf16* tbuf, bf16* out, int batch,
                                       int s, int d, int heads, int seq_len,
                                       int ldt, float scale, cudaStream_t st);

}  // namespace vit
