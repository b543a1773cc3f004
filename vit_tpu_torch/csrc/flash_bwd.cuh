// What K13's two translation units share (flash_attention_bwd.cu: the
// bf16 form and the C entry point; flash_attention_bwd_tf32.cu: the fp32
// form on the tensor cores): the launch arguments, the probability of one
// score, and the launch of one kernel with its dynamic shared memory.

#pragma once

#include <math.h>

#include "flash_tiles.cuh"

namespace vit {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  FaStrides sq, sk, sv, sg, sdq, sdk, sdv;
  float* stats;  // (3, B*H, S): m, l, delta of each query row
  int bh, heads, s, seq_len;
  float scale;
  bool vec;  // rows of q, k, v and g may be copied in 16-byte chunks
};

// p of one score: exp(s * scale - m) / l, 0 where the key is masked (or
// the query row is past S). The product is rounded before the subtraction,
// as in JAX (s = dot * scale, then s - max).
__device__ __forceinline__ float prob(float raw, bool keep, float scale,
                                      float m, float l) {
  return keep ? expf(__fmul_rn(raw, scale) - m) / l : 0.f;
}

template <typename K>
cudaError_t launch_bwd_kernel(K kernel, size_t smem, int threads, dim3 grid,
                              const BwdArgs& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// K13's fp32 form at head width hd (flash_attention_bwd_tf32.cu).
cudaError_t launch_bwd_f32(const BwdArgs& a, int hd, cudaStream_t st);

}  // namespace vit
