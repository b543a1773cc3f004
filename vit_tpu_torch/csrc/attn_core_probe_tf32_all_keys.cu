// K23's fp32 core (attn_core_probe_tf32.cuh) in the modes that score every
// key of S (attention_core.cuh:attn_all_keys, but addmask): nosm, mxu,
// divonly, recip, sumonly and wide (heads paired by the caller). alldiv and
// mxudiv combine as recip does, and in fp32 bf16div as divonly does (its
// two roundings to the tensor's type are no-ops, attn_combine<float>):
// they launch those builds, the same function and the same code.

#include "attn_core_probe_tf32.cuh"

namespace vit {

cudaError_t launch_probe_core_tf32_all_keys(int mode, const float* qkv,
                                            const float* tbuf, float* out,
                                            int batch, int s, int d,
                                            int heads, int seq_len, int ldt,
                                            float scale, cudaStream_t st) {
#define VIT_PROBE_MODE(M)                                                  \
  return launch_probe_tf32<M>(qkv, tbuf, out, batch, s, d, heads, seq_len, \
                              ldt, scale, st);
  switch (mode) {
    case kAttnNoSm: VIT_PROBE_MODE(kAttnNoSm)
    case kAttnMxu: VIT_PROBE_MODE(kAttnMxu)
    case kAttnDivOnly:
    case kAttnBf16Div: VIT_PROBE_MODE(kAttnDivOnly)
    case kAttnRecip:
    case kAttnAllDiv:
    case kAttnMxuDiv: VIT_PROBE_MODE(kAttnRecip)
    case kAttnSumOnly: VIT_PROBE_MODE(kAttnSumOnly)
    case kAttnWide: VIT_PROBE_MODE(kAttnWide)
    default:
      return cudaErrorInvalidValue;
  }
#undef VIT_PROBE_MODE
}

}  // namespace vit
