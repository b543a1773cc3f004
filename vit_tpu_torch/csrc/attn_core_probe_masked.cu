// K23's bf16 core (attn_core_probe.cuh) in the modes that mask the keys
// past seq_len (attention_core.cuh:attn_masked): full (K4's core), maskonly,
// addmask (which scores every key and adds the mask), vsum, qcore (int8
// codes on mma.sync m16n8k32), kt and head-major (tcore, xcore).

#include "attn_core_probe.cuh"

namespace vit {

cudaError_t launch_probe_core_masked(int mode, const bf16* qkv,
                                     const bf16* tbuf, bf16* out, int batch,
                                     int s, int d, int heads, int seq_len,
                                     int ldt, float scale, cudaStream_t st) {
#define VIT_PROBE_MODE(M)                                                  \
  case M:                                                                  \
    return launch_probe_mma<M>(qkv, tbuf, out, batch, s, d, heads, seq_len, \
                               ldt, scale, st);
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
