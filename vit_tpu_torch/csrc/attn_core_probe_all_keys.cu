// K23's bf16 core (attn_core_probe.cuh) in the modes that score every key
// of S (attention_core.cuh:attn_all_keys, but addmask): nosm, mxu, divonly,
// recip, sumonly, bf16div and wide (heads paired by the caller). alldiv and
// mxudiv combine as recip does (attn_combine), so they launch recip's
// build: the same function and the same code.

#include "attn_core_probe.cuh"

namespace vit {

cudaError_t launch_probe_core_all_keys(int mode, const bf16* qkv,
                                       const bf16* tbuf, bf16* out, int batch,
                                       int s, int d, int heads, int seq_len,
                                       int ldt, float scale, cudaStream_t st) {
#define VIT_PROBE_MODE(M)                                                  \
  return launch_probe_mma<M>(qkv, tbuf, out, batch, s, d, heads, seq_len,   \
                             ldt, scale, st);
  switch (mode) {
    case kAttnNoSm: VIT_PROBE_MODE(kAttnNoSm)
    case kAttnMxu: VIT_PROBE_MODE(kAttnMxu)
    case kAttnDivOnly: VIT_PROBE_MODE(kAttnDivOnly)
    case kAttnRecip:
    case kAttnAllDiv:
    case kAttnMxuDiv: VIT_PROBE_MODE(kAttnRecip)
    case kAttnSumOnly: VIT_PROBE_MODE(kAttnSumOnly)
    case kAttnBf16Div: VIT_PROBE_MODE(kAttnBf16Div)
    case kAttnWide: VIT_PROBE_MODE(kAttnWide)
    default:
      return cudaErrorInvalidValue;
  }
#undef VIT_PROBE_MODE
}

}  // namespace vit
