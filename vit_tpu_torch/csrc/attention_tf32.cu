// K4's fp32 attention core on the tensor cores (attention.cu has the C
// entry point, which launches this one for fp32, and the bf16 core): the
// kAttnFull instantiation of attention_tf32.cuh's routine (its header has
// the design and the bound), one block of four warps an (image, head,
// 64-query tile), both products on mma.sync m16n8k8 tf32 in the three-pass
// split of tf32_split.cuh. Its own unit, so that the bf16 kernels compile
// as they did without it; K23's fp32 modes of the same routine are built
// in attn_core_probe_tf32_masked.cu and _all_keys.cu.

#include "attention_tf32.cuh"

namespace vit {

template <int NK>
__global__ void __launch_bounds__(kAttnTf32Threads)
    attention_tf32_kernel(const float* __restrict__ qkv,
                          float* __restrict__ out, int s, int d, int dh,
                          float scale, int seq_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  attention_tile_tf32<NK>(qkv, out, s, d, dh, scale, seq_len, blockIdx.x,
                          blockIdx.y, blockIdx.z * kAttnQT, smem);
}

template <int NK>
cudaError_t launch_attention_tf32_nk(const float* qkv, float* out, int batch,
                                     int s, int d, int heads, int seq_len,
                                     float scale, cudaStream_t st) {
  const size_t smem = attention_tf32_smem(s, d / heads);
  cudaError_t err = cudaFuncSetAttribute(
      attention_tf32_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch, heads, (s + kAttnQT - 1) / kAttnQT);
  attention_tf32_kernel<NK><<<grid, kAttnTf32Threads, smem, st>>>(
      qkv, out, s, d, d / heads, scale, seq_len);
  return cudaGetLastError();
}

cudaError_t launch_attention_tf32(const float* qkv, float* out, int batch,
                                  int s, int d, int heads, int seq_len,
                                  float scale, cudaStream_t st) {
  if (attention_tf32_smem(s, d / heads) > 232448)
    return cudaErrorInvalidValue;
  const int nk = attn_tf32_dhp(d / heads) / 8;
#define VIT_ATTN_TF32(K)                                                    \
  case K:                                                                   \
    return launch_attention_tf32_nk<K>(qkv, out, batch, s, d, heads,        \
                                       seq_len, scale, st)
  switch (nk < kAttnTf32MaxK ? nk : kAttnTf32MaxK) {
    VIT_ATTN_TF32(1);
    VIT_ATTN_TF32(2);
    VIT_ATTN_TF32(3);
    VIT_ATTN_TF32(4);
    VIT_ATTN_TF32(5);
    VIT_ATTN_TF32(6);
    VIT_ATTN_TF32(7);
    default: VIT_ATTN_TF32(8);
  }
#undef VIT_ATTN_TF32
}

}  // namespace vit
