"""Where K9's, K17's and K6's time goes on the card, by ablation.

The machinery of ``tools/i8_ablate.py``: each variant is a copy of this
checkout's package under ``build/stack_ablate/<name>/`` whose CUDA sources
have one part of the work taken out by a textual substitution
(``VARIANTS``), built on its own; its outputs are wrong by design, and the
time it saves against ``base`` is what the part costs on the path (less
than its own duration where it overlaps other work). The variants:

- ``no_attention``: K9's attention phase computes nothing (its barrier
  stays);
- ``attn_four_parts``, ``attn_two_parts``: K9's bf16 attention phase on
  32-row query tiles with the keys in four parts, or on 64-row tiles with
  the keys in two, at every batch, where K9 takes four parts if their
  tiles fit the grid in one round and two if not (each keeps all eight
  warps at work);
- ``no_gemm``: K9's bf16 GEMM phases do nothing (the LN passes, the
  barriers, the split-K reductions, FOLD's phase 0 and the final LN
  stay);
- ``no_mma``: K9's GEMM phases issue no ``wgmma`` (the TMA ring, the LN
  pass and the epilogues stay);
- ``no_ln``: K9's LN pass writes nothing (the products read the stale
  context buffer; its barrier stays);
- ``no_reduce``: K9's split-K reductions and their barriers are skipped;
- ``no_fence``: K9's global proxy fences (around the phases, after the
  attention) are empty;
- ``only_barriers``: K9 without its attention, LN passes, GEMM phases
  and split-K reductions: its grid barriers, FOLD's phase 0 and the
  final LN;
- ``no_split``: K9's out-projection and fc2 run whole (S = 1), stored
  directly;
- ``no_convert``: K17's warpgroups convert nothing (they still take and
  release each raw box);
- ``no_k17_fc2``: K17's fc2 ``wgmma`` are not issued (rings and waits
  stay);
- ``k6_no_ln``: K6's LN threads normalise nothing (they still wait for
  each box, fence and hand it on; ``wgmma`` reads x's raw box): what LN
  on the A operand costs.

Times (bf16, the mean of 30 calls queued back to back between two CUDA
events, variants in turns with ``base`` first and last): K9 at B/16 bs=1
and bs=2 (12 layers, 197 real tokens of 208; ``encoder_stack`` and
``encoder_stack_q``) and at L/16 bs=1 (24 layers, 16 heads), K17 at B/16
bs=32 (6656 x 768, mlp 3072) and its model=2 shard (mlp 1536,
``partial_out``), K6 (with K5, as ``fused_linear`` launches them) at
L/16-384 bs=8's LN1 + QKV (4736 x 1024 @ 1024 x 3072) and at the B/16
bs=32 train step's (6656 x 768 @ 768 x 2304). Prints one line a variant
and a JSON line with the card::

    python -m vit_tpu_torch.tools.stack_ablate [--variants base no_gemm]
"""

from __future__ import annotations

import argparse
import json
import sys

from vit_tpu_torch.tools.i8_ablate import HERE, run_variants

OUT = HERE / "build" / "stack_ablate"

#: name -> [(file glob under csrc, pattern, replacement)], re.MULTILINE.
VARIANTS = {
    "base": [],
    "no_attention": [("encoder_stack.cu", r"^(\s*)attention_phase\(a, smem\);",
                      r"\1if (a.b < 0) attention_phase(a, smem);")],
    "attn_four_parts": [("encoder_stack.cu",
                         r"<= static_cast<int>\(gridDim\.x\)\)",
                         "<= 1 << 30)")],
    "attn_two_parts": [("encoder_stack.cu",
                        r"<= static_cast<int>\(gridDim\.x\)\)", "< 0)")],
    "no_gemm": [("stack_phase.cuh", r"^(\s*)sw::wgmma_phase<W>\(",
                 r"\1if (m < 0) sw::wgmma_phase<W>(")],
    "no_mma": [("stack_wgmma.cuh", r"^(\s*)mw::wgmma_ss<64>\(acc,",
                r"\1if (m < 0) mw::wgmma_ss<64>(acc,")],
    "no_ln": [("stack_phase.cuh", r"^(\s*)sw::ln_pass\(",
               r"\1if (m < 0) sw::ln_pass(")],
    "no_reduce": [("stack_phase.cuh", r"if \(splits > 1\) \{",
                   "if (splits < 0) {")],
    "no_fence": [("stack_wgmma.cuh", r'asm volatile\("fence\.proxy\.async;"',
                  'asm volatile(""')],
    "only_barriers": [
        ("encoder_stack.cu", r"^(\s*)attention_phase\(a, smem\);",
         r"\1if (a.b < 0) attention_phase(a, smem);"),
        ("stack_phase.cuh", r"^(\s*)sw::wgmma_phase<W>\(",
         r"\1if (m < 0) sw::wgmma_phase<W>("),
        ("stack_phase.cuh", r"^(\s*)sw::ln_pass\(",
         r"\1if (m < 0) sw::ln_pass("),
        ("stack_phase.cuh", r"if \(splits > 1\) \{", "if (splits < 0) {")],
    "no_split": [("stack_wgmma.cuh",
                  r"int s = split \? static_cast<int>\(gridDim.x\) / tiles",
                  "int s = 0 ? static_cast<int>(gridDim.x) / tiles")],
    "no_convert": [("mlp_q_wgmma.cuh", r"^(\s*)qc::store_chunk\(base \+",
                    r"\1if (k < 0) qc::store_chunk(base +")],
    "no_k17_fc2": [("mlp_q_wgmma.cuh", r"^(\s*)wgmma_ss<64 \* NB>\(",
                    r"\1if (ks < 0) wgmma_ss<64 * NB>(")],
    "k6_no_ln": [("gemm_wgmma.cuh", r"^(\s*)ln_box\(base \+",
                  r"\1if (kb < 0) ln_box(base +")],
}

WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from vit_tpu_torch import ops
from vit_tpu_torch.quant import quantize_params, quantize_weight
gen = torch.Generator(device="cuda").manual_seed(0)
bf = torch.bfloat16


def rnd(*shape, std=1.0, mean=0.0):
    return (torch.randn(shape, generator=gen, device="cuda") * std
            + mean).to(bf)


def queued_ms(fn, iters=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


res = {}
L, d, mlp, sp = 12, 768, 3072, 208
enc = {g: {"kernel": rnd(L, *s, std=0.03), "bias": rnd(L, s[1], std=0.02)}
       for g, s in (("qkv", (d, 3 * d)), ("out", (d, d)), ("fc1", (d, mlp)),
                    ("fc2", (mlp, d)))}
for g in ("ln1", "ln2"):
    enc[g] = {"scale": rnd(L, d, std=0.1, mean=1.0),
              "bias": rnd(L, d, std=0.05)}
qenc = quantize_params({"encoder": enc})["encoder"]
with torch.inference_mode():
    for b in (1, 2):
        x = rnd(b, sp, d)
        res[f"k9_bs{b}"] = queued_ms(lambda: ops.encoder_stack(
            x, enc, num_heads=12, seq_len=197))
        res[f"k9q_bs{b}"] = queued_ms(lambda: ops.encoder_stack_q(
            x, qenc, num_heads=12, seq_len=197))
    # L/16 at bs=1: 24 layers of D = 1024, MLP 4096, 16 heads.
    enc16 = {g: {"kernel": rnd(24, *s, std=0.03), "bias": rnd(24, s[1],
                                                              std=0.02)}
             for g, s in (("qkv", (1024, 3072)), ("out", (1024, 1024)),
                          ("fc1", (1024, 4096)), ("fc2", (4096, 1024)))}
    for g in ("ln1", "ln2"):
        enc16[g] = {"scale": rnd(24, 1024, std=0.1, mean=1.0),
                    "bias": rnd(24, 1024, std=0.05)}
    x16 = rnd(1, sp, 1024)
    res["k9_l16_bs1"] = queued_ms(lambda: ops.encoder_stack(
        x16, enc16, num_heads=16, seq_len=197))
    del enc16
    for tag, m_, k_, n_ in (("k6_l16_384", 4736, 1024, 3072),
                            ("k6_b16", 6656, 768, 2304)):
        args6 = (rnd(m_, k_, std=1.5, mean=0.2), rnd(k_, n_, std=0.03),
                 rnd(n_, std=0.02))
        g6, b6 = rnd(k_, std=0.1, mean=1.0), rnd(k_, std=0.05)
        res[tag] = queued_ms(lambda: ops.fused_linear(
            *args6, ln_scale=g6, ln_bias=b6))
    for tag, mlp_, partial in (("k17_b16", 3072, False),
                               ("k17_shard", 1536, True)):
        w1 = quantize_weight(rnd(d, mlp_, std=0.03))
        w2 = quantize_weight(rnd(mlp_, d, std=0.03))
        args = (rnd(6656, d, std=1.5, mean=0.2), rnd(d, std=0.1, mean=1.0),
                rnd(d, std=0.05), w1["q"], w1["scale"], rnd(mlp_, std=0.02),
                w2["q"], w2["scale"], rnd(d, std=0.02))
        res[tag] = queued_ms(lambda: ops.mlp_block_q(
            *args, partial_out=partial))
print(json.dumps(res))
"""


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args(argv)
    runs = run_variants(args.variants, VARIANTS, OUT, WORKER)
    from vit_tpu_torch.tools import card_line
    print(json.dumps({"ablation": runs, "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
