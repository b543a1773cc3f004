// K23's fp32 core (attn_core_probe_tf32.cuh) in the modes that mask the
// keys past seq_len (attention_core.cuh:attn_masked): full (K4's fp32
// core), maskonly, addmask (which scores every key and adds the mask), vsum,
// qcore (exact int8 codes, one TF32 pass a product), kt and head-major
// (tcore, xcore).

#include "attn_core_probe_tf32.cuh"

namespace vit {

cudaError_t launch_probe_core_tf32_masked(int mode, const float* qkv,
                                          const float* tbuf, float* out,
                                          int batch, int s, int d, int heads,
                                          int seq_len, int ldt, float scale,
                                          cudaStream_t st) {
#define VIT_PROBE_MODE(M)                                                  \
  case M:                                                                  \
    return launch_probe_tf32<M>(qkv, tbuf, out, batch, s, d, heads,        \
                                seq_len, ldt, scale, st);
  switch (mode) {
    VIT_PROBE_MODE(kAttnFull)
    VIT_PROBE_MODE(kAttnMaskOnly)
    VIT_PROBE_MODE(kAttnAddMask)
    VIT_PROBE_MODE(kAttnVsum)
    VIT_PROBE_MODE(kAttnQcore)
    VIT_PROBE_MODE(kAttnKt)
    VIT_PROBE_MODE(kAttnHeadMajor)
    default:
      return cudaErrorInvalidValue;
  }
#undef VIT_PROBE_MODE
}

}  // namespace vit
