"""Time the same kernels of two checkouts of the port in turns on one card.

A change to a kernel's source must leave the kernels that share it
compiled as before: this script times the kernel cases of ``CASES``, taken
by name and label from this checkout's ``chip_smoke.py`` (its
``kernel_cases*`` builders, the same inputs for both trees): K2 at B/16
bs=32 (the QKV 6656x768 @ 768x2304 + bias in bf16 and fp32, the backward's
``g @ w.t()`` and ``x.t() @ g``, each beside its ``torch`` call), K4's
attention core (bf16; fp32 beside SDPA), K6 (LN 4736x1024 @ 1024x3072 and
the B/16 train step's LN 6656x768 @ 768x2304, each beside K1 -> K2), K7
(B/16 bs=32 and L/16-384 bs=8 on packed QKV views, each beside SDPA, and
the int8 tier's fp32-output B/16 shape; fp32 at B/16 bs=32 and L/16-384
bs=8, beside SDPA), K8 (``embed_fused`` at L/16-384 bs=4 and B/16 bs=4 and
1, each beside K2 on the same operands; in fp32 also beside ``addmm``), K9
(its three forms at B/16 bs=1, 12 layers; the fused one beside K24's
``dma``), K10 (``quantize_rows`` at B/16 bs=32 with LN in bf16 and on the
fp32 context), K11 (``matmul_i8``, the QKV), K12 (``mlp_block_i8dot`` at B/16 bs=32 and H/14 bs=2, each beside
its composed K10 -> K11 -> K10 -> K11 chain), K13
(``ops.flash_attention_bwd``, B/16 bs=32 in bf16 and fp32), K16
(``matmul3``, the scores, the context and the scores at 200 tokens, each
beside ``baddbmm``; in fp32 also at K = 2304), K22
(``int8_probe.dot``, int8 and bf16), K23 (the
``full`` core alone on B/16 bs=32's packed QKV, beside SDPA -- K4's core
is ``core`` -- and the ``tcore`` block, whose GEMMs are K23's), K3 (B/16
bs=32, L/16-384 bs=8 and the B/16 bs=32 shard over model=2, and in fp32
also at H/14 bs=2, each beside the case's composed K1 -> K2 -> K2 chain),
K17 (``mlp_block_q`` at B/16
bs=32 and its shard over model=2, each beside K3 on the dequantized
weights; in fp32 also at L/16-384 bs=8 and H/14 bs=2), K22's fp32 dot
beside ``torch.matmul``, K23 in fp32 (the ``full`` core beside SDPA, the
block in every mode but ``wide``, the kt QKV GEMM beside ``addmm``), K21
(the example's matmul in both dtypes, beside ``torch.matmul``), and K18 (B/16 bs=32 and L/16 bs=8, each beside K2 -> K3 on the
same operands, which rounds y); then the B/16 bs=32 bf16 forward on the
default route, on the full-layer route (``layer_block=True``), on
``(flash, fused=False)``, ``(unfused, fused=False)`` and ``(unfused,
fused=True)`` (K6), the int8 forward (``forward_quant``; also with
``int8_dot=False`` and at L/16-384 bs=8), the B/16 bs=1 forwards in bf16
and int8 and the L/16 bs=1 bf16 forward (the stack route, K9), the
L/16-384 bs=8 bf16 forward (the composed route, K6), the B/16 bs=32 bf16
train step, and the B/16 bs=32 fp32 forward (default route and
``layer_block=True``, K18's fp32 form; and the int8 forward with
``int8_dot=False``, K17's fp32 form) and train step (K2's, K6's and
K13's fp32 forms; K2's fp32 ``g @ w.t()`` and ``x.t() @ g`` are kernel
cases too, and so are K18's fp32 form at B/16 bs=32 and L/16 bs=8 beside
K2 -> K3 and K6's at L/16-384 and the B/16 QKV beside K1 -> K2). A checkout whose K2 reads no transposed view (no
``ops.cuda.matmul.gemm_path``) gets contiguous copies first, as its
backward made them. Trees run in turns (other, this, this, other), each in
its own process that builds that checkout's kernels into the checkout's
own ``build/``. Each time is the median of CUDA-event times of single
calls after warm-up, beside the pipelined time (calls queued back to back
between two events: the device time where the host keeps ahead) and the
profiler's device time (each launch's time over the records kept). Each
kernel case's output is hashed too, and the last lines say which cases
gave the same bits in both trees. It prints one line a run and a JSON
line::

    git archive <parent> | tar -x -C build/parent    # a listed directory
    python -m vit_tpu_torch.tools.turns --other build/parent

``--cases k1,k2`` times only those keys of ``CASES`` and ``--no-forwards``
leaves out the forwards and the train step, for a quick A/B of one
kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

#: The kernel cases timed: key -> (``chip_smoke`` builder, dtype, case
#: name, a part of its label, whether to time its library call too).
CASES = {
    "k2_qkv_bfloat16": ("kernel_cases", "bfloat16", "matmul",
                        "(6656,768)@(768,2304)+bias", True),
    "k2_qkv_float32": ("kernel_cases", "float32", "matmul",
                       "(6656,768)@(768,2304)+bias", True),
    "k2_g_wt": ("kernel_cases", "bfloat16", "matmul", "@ w.t()", True),
    "k2_xt_g": ("kernel_cases", "bfloat16", "matmul", "x.t() (", True),
    "k2_g_wt_float32": ("kernel_cases", "float32", "matmul", "@ w.t()", True),
    "k2_xt_g_float32": ("kernel_cases", "float32", "matmul", "x.t() (",
                        True),
    "core": ("kernel_cases", "bfloat16", "attention", "qkv", False),
    # K4's fp32 core and K7's fp32 form (three TF32 passes), each beside
    # SDPA in fp32.
    "k4_core_float32": ("kernel_cases", "float32", "attention", "qkv",
                        True),
    "k7_b16_float32": ("kernel_cases", "float32", "flash_attention",
                       "S=208", True),
    "k7_l16_384_float32": ("kernel_cases_l16_384", "float32",
                           "flash_attention", "S=592", True),
    "fused_linear_ln": ("kernel_cases_l16_384", "bfloat16", "fused_linear",
                        "LN ", False),
    "fused_linear_b16": ("kernel_cases", "bfloat16", "fused_linear",
                         "LN (6656", False),
    "embed_fused": ("kernel_cases_small_batch", "bfloat16", "embed_fused",
                    "(4,576,768)", False),
    "embed_fused_b16_bs4": ("kernel_cases_small_batch", "bfloat16",
                            "embed_fused", "(4,196,768)", False),
    "embed_fused_b16_bs1": ("kernel_cases_small_batch", "bfloat16",
                            "embed_fused", "(1,196,768)", False),
    # K8's fp32 form (K2's three-pass TF32 tile) at L/16-384 bs=4, B/16
    # bs=4 and 1, each beside addmm; K10 at B/16 bs=32 with LN (bf16) and
    # on the fp32 context.
    "embed_fused_float32": ("kernel_cases_small_batch", "float32",
                            "embed_fused", "(4,576,768)@", True),
    "embed_fused_b16_bs4_float32": ("kernel_cases_small_batch", "float32",
                                    "embed_fused", "(4,196,768)@", True),
    "embed_fused_b16_bs1_float32": ("kernel_cases_small_batch", "float32",
                                    "embed_fused", "(1,196,768)@", True),
    "quantize_rows_ln": ("kernel_cases_int8", "bfloat16", "quantize_rows",
                         "B/16 LN", False),
    "quantize_rows_context": ("kernel_cases_int8", "bfloat16",
                              "quantize_rows", "B/16 fp32 context", False),
    "encoder_stack": ("kernel_cases_small_batch", "bfloat16",
                      "encoder_stack", "(1,208,768)", False),
    "matmul_i8": ("kernel_cases_int8", "bfloat16", "matmul_i8",
                  "(6656,768)@(768,2304)+bias", False),
    "flash_b16": ("kernel_cases", "bfloat16", "flash_attention", "S=208",
                  True),
    "flash_l16_384": ("kernel_cases_l16_384", "bfloat16", "flash_attention",
                      "S=592", True),
    "flash_int8_b16": ("kernel_cases_int8", "bfloat16", "flash_attention",
                       "B/16 fp32 output", False),
    "matmul3_scores": ("kernel_cases_chain", "bfloat16", "matmul3",
                       "scores", True),
    "matmul3_context": ("kernel_cases_chain", "bfloat16", "matmul3",
                        "context", True),
    "matmul3_aligned": ("kernel_cases_chain", "bfloat16", "matmul3",
                        "aligned", True),
    "dot_probe_int8": ("kernel_cases_probes", "bfloat16", "dot_probe",
                       "int8", False),
    "dot_probe_bf16": ("kernel_cases_probes", "bfloat16", "dot_probe",
                       "bfloat16", False),
    "attn_core_probe_full": ("kernel_cases_probes", "bfloat16",
                             "attn_core_probe", "core full", True),
    "attn_core_probe_tcore": ("kernel_cases_probes", "bfloat16",
                              "attn_core_probe", "block tcore", False),
    "attention_bwd_bfloat16": ("kernel_cases_train", "bfloat16",
                               "flash_attention_bwd", "B/16", False),
    "attention_bwd_float32": ("kernel_cases_train", "float32",
                              "flash_attention_bwd", "B/16", False),
    # K3 in bf16 at B/16 bs=32 and L/16-384 bs=8, and its shard form at
    # B/16 bs=32 over model=2, each beside the same MLP as K1 -> K2 -> K2
    # (the case's composed chain); K18 on K3's tile, beside K2 -> K3.
    "mlp_b16": ("kernel_cases", "bfloat16", "mlp_block", "(6656,768)",
                False),
    "mlp_l16_384": ("kernel_cases_l16_384", "bfloat16", "mlp_block",
                    "(4736,1024)", False),
    "mlp_partial_b16": ("kernel_cases_tp", "bfloat16", "mlp_block_partial",
                        "B/16 bs=32 model=2", False),
    # K3's fp32 form (three TF32 passes) at B/16 bs=32, L/16-384 bs=8,
    # H/14 bs=2 and the B/16 bs=32 shard over model=2, each beside its
    # composed K1 -> K2 -> K2 chain; K16's fp32 form at the scores, the
    # context, the scores at 200 tokens and K = 2304, beside baddbmm.
    "mlp_b16_float32": ("kernel_cases", "float32", "mlp_block",
                        "(6656,768)", False),
    "mlp_l16_384_float32": ("kernel_cases_l16_384", "float32", "mlp_block",
                            "(4736,1024)", False),
    "mlp_h14_float32": ("kernel_cases_l16_384", "float32", "mlp_block",
                        "H/14 bs=2", False),
    "mlp_partial_b16_float32": ("kernel_cases", "float32",
                                "mlp_block_partial", "B/16 bs=32 model=2",
                                False),
    "matmul3_scores_float32": ("kernel_cases_chain", "float32", "matmul3",
                               "scores", True),
    "matmul3_context_float32": ("kernel_cases_chain", "float32", "matmul3",
                                "context", True),
    "matmul3_aligned_float32": ("kernel_cases_chain", "float32", "matmul3",
                                "aligned", True),
    "matmul3_deep_float32": ("kernel_cases_chain", "float32", "matmul3",
                             "deep", True),
    "layer_block_k18": ("kernel_cases_layer", "bfloat16", "layer_block",
                        "K18 B/16", False),
    "layer_block_k18_l16": ("kernel_cases_layer", "bfloat16", "layer_block",
                            "K18 L/16", False),
    # K18's and K6's fp32 forms (three TF32 passes on K3's and K2's tiles):
    # K18 at B/16 bs=32 and L/16 bs=8, each beside K2 -> K3; K6 at
    # L/16-384's LN + QKV and the B/16 train step's, each beside K1 -> K2.
    "layer_block_k18_float32": ("kernel_cases_layer", "float32",
                                "layer_block", "K18 B/16", False),
    "layer_block_k18_l16_float32": ("kernel_cases_layer", "float32",
                                    "layer_block", "K18 L/16", False),
    "fused_linear_ln_float32": ("kernel_cases_l16_384", "float32",
                                "fused_linear", "LN ", False),
    "fused_linear_b16_float32": ("kernel_cases", "float32", "fused_linear",
                                 "LN (6656,768)@(768,2304)", False),
    # K12 at B/16 bs=32 and H/14 bs=2 (D = 1280), each beside the same MLP
    # as K10 -> K11 -> K10 -> K11 (the case's composed chain).
    "mlp_i8_b16": ("kernel_cases_int8", "bfloat16", "mlp_block_i8dot",
                   "B/16 (6656,768)", False),
    "mlp_i8_h14": ("kernel_cases_int8", "bfloat16", "mlp_block_i8dot",
                   "H/14 (544,1280)", False),
    # K17 at B/16 bs=32 and its shard form over model=2, each beside K3 on
    # the dequantized weights (the case's composed yardstick); K9's fused
    # and int8 forms at B/16 bs=1 (the float form is "encoder_stack"), the
    # fused one beside K24's dma, K9's weight stream alone.
    "mlp_q_b16": ("kernel_cases_chain", "bfloat16", "mlp_block_q",
                  "B/16 bs=32", False),
    "mlp_q_partial_b16": ("kernel_cases_tp", "bfloat16",
                          "mlp_block_q_partial", "B/16 bs=32 model=2",
                          False),
    # K17's fp32 form (K3's tf32 tile with its Q flag, two TF32 passes) at
    # B/16 bs=32, its shard over model=2, L/16-384 bs=8 and H/14 bs=2,
    # each beside K3's fp32 tile on the dequantized weights; K22's fp32
    # dot (K2's tf32 tile) beside torch.matmul.
    "mlp_q_b16_float32": ("kernel_cases_chain", "float32", "mlp_block_q",
                          "B/16 bs=32", False),
    "mlp_q_partial_b16_float32": ("kernel_cases_chain", "float32",
                                  "mlp_block_q_partial",
                                  "B/16 bs=32 model=2", False),
    "mlp_q_l16_384_float32": ("kernel_cases_chain", "float32",
                              "mlp_block_q", "L/16-384 bs=8", False),
    "mlp_q_h14_float32": ("kernel_cases_chain", "float32", "mlp_block_q",
                          "H/14 bs=2", False),
    "dot_probe_float32": ("kernel_cases_probes", "float32", "dot_probe",
                          "float32", True),
    # K23's fp32 full core (beside SDPA), its fp32 block in every mode
    # but wide (whose fp32 core did not fit at 208 tokens before it ran on
    # K4's tf32 tile) and its fp32 kt QKV GEMM alone (beside addmm); K21 in
    # both dtypes beside torch.matmul.
    "attn_core_probe_full_float32": ("kernel_cases_probes", "float32",
                                     "attn_core_probe", "core full", True),
    **{f"attn_core_probe_block_{mode}_float32": (
        "kernel_cases_probes", "float32", "attn_core_probe",
        f"block {mode} (", False)
       for mode in ("full", "maskonly", "nosm", "mxu", "divonly", "recip",
                    "sumonly", "bf16div", "alldiv", "mxudiv", "addmask",
                    "vsum", "qcore", "kt", "projonly", "tcore", "xcore")},
    "attn_core_probe_gemm_kt_float32": ("kernel_cases_probes", "float32",
                                        "attn_core_probe", "gemm kt", True),
    "minimal_matmul_bfloat16": ("kernel_cases_layer", "bfloat16",
                                "minimal_matmul", "(256,384)@(384,512)",
                                True),
    "minimal_matmul_float32": ("kernel_cases_layer", "float32",
                               "minimal_matmul", "(256,384)@(384,512)",
                               True),
    "encoder_stack_fused": ("kernel_cases_small_batch", "bfloat16",
                            "encoder_stack_fused", "(1,196,768)", False),
    "encoder_stack_q": ("kernel_cases_stack_q", "bfloat16",
                        "encoder_stack_q", "B/16 12 layers", False),
}

#: Run in a fresh process with the checkout's root, this checkout's
#: ``chip_smoke.py``, the cases (``CASES``' form) and whether to time the
#: forwards (1 or 0) as arguments; prints one JSON line. It uses only what
#: every checkout of the port has.
WORKER = r"""
import hashlib, importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from vit_tpu_torch.config import VARIANTS
from vit_tpu_torch.models.vit import forward, init_params
from vit_tpu_torch.ops.cuda import _build
from vit_tpu_torch.ops.cuda import matmul as cuda_matmul
from vit_tpu_torch.quant import forward_quant, quantize_params
from vit_tpu_torch.train import make_optimizer, make_train_step
from vit_tpu_torch.utils.timing import pipelined_ms

spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build()
if not hasattr(cuda_matmul, "gemm_path"):
    # This checkout's K2 reads contiguous operands only; its backward
    # copied a transposed one first, so the copy is timed with the call.
    k2 = cuda_matmul.matmul
    cuda_matmul.matmul = lambda x, w, *a, **kw: k2(
        x.contiguous(), w.contiguous(), *a, **kw)


def times(fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return {"ms": float(np.median(out)), "pipelined_ms": pipelined_ms(fn),
            "device_ms": device_ms(fn)}


def device_ms(fn, iters=20):
    # Each kernel's time over the records kept, times its launches a call
    # (utils.profiling.kernel_times, which the other checkout may not
    # have): the profiler misses records at a window's start, so the
    # launches a call are count / iters rounded, where that is >= 1. A
    # window with no record at all is taken again, twice at most; then
    # None.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = 0.0
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                n = round(e.count / iters)
                if n < 1:
                    n = e.count / iters
                dev += e.self_device_time_total / e.count * n
        if dev > 0:
            return dev / 1e3
    return None


res = {}
wanted = json.loads(sys.argv[3])
groups = {}
for key, (builder, dt, name, label, library) in wanted.items():
    groups.setdefault((builder, dt), []).append((key, name, label, library))
with torch.inference_mode():
    for (builder, dt), picks in groups.items():
        cases = getattr(smoke, builder)(torch, getattr(torch, dt))
        for key, name, label, library in picks:
            (c,) = [c for c in cases
                    if c["name"] == name and label in c["label"]]
            res[key] = times(lambda: c["run"]("cuda"))
            # The output's bytes, to hold the two trees bit for bit.
            out = c["run"]("cuda")
            outs = out if isinstance(out, tuple) else (out,)
            res[key]["sha256"] = hashlib.sha256(b"".join(
                o.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                for o in outs)).hexdigest()[:16]
            if library:
                res[key + "_library"] = times(c["library"])
            if c.get("composed") is not None:
                res[key + "_composed"] = times(c["composed"])
        del cases
        torch.cuda.empty_cache()
if sys.argv[4] == "0":
    print(json.dumps(res))
    sys.exit(0)
gen = torch.Generator(device="cuda").manual_seed(0)
cfg = VARIANTS["B/16"].replace(dtype=torch.bfloat16, num_classes=1000)
params = init_params(cfg, generator=gen, device="cuda")
px = torch.randn((32, 3, 224, 224), generator=gen,
                 device="cuda").to(torch.bfloat16)
qparams = quantize_params(params)
with torch.inference_mode():
    res["forward"] = times(lambda: forward(params, px, cfg), iters=20)
    res["forward_layer"] = times(
        lambda: forward(params, px, cfg, layer_block=True), iters=20)
    res["forward_flash_chain"] = times(
        lambda: forward(params, px, cfg, fused=False), iters=20)
    res["forward_unfused_chain"] = times(
        lambda: forward(params, px, cfg, attention="unfused", fused=False),
        iters=20)
    res["forward_unfused_fused"] = times(
        lambda: forward(params, px, cfg, attention="unfused", fused=True),
        iters=20)
    res["forward_int8"] = times(lambda: forward_quant(qparams, px, cfg),
                                iters=20)
    # K17's route (int8_dot=False) at bs=32, and the stack route at bs=1
    # (K9: encoder_stack_fused in bf16, encoder_stack_q in int8).
    res["forward_int8_nodot"] = times(
        lambda: forward_quant(qparams, px, cfg, int8_dot=False), iters=20)
    res["forward_bs1"] = times(lambda: forward(params, px[:1], cfg),
                               iters=20)
    res["forward_int8_bs1"] = times(
        lambda: forward_quant(qparams, px[:1], cfg), iters=20)
del qparams
# L/16 at bs=1 in bf16 (the stack route, K9 with 16 heads).
cfg_16 = VARIANTS["L/16"].replace(dtype=torch.bfloat16, num_classes=1000)
p_16 = init_params(cfg_16, generator=gen, device="cuda")
with torch.inference_mode():
    res["forward_l16_bs1"] = times(lambda: forward(p_16, px[:1], cfg_16),
                                   iters=20)
del p_16
# L/16-384 at bs=8: the bf16 forward (the composed route: K6 carries LN1 +
# QKV and LN2 + fc1) and the int8 one (24 layers, D = 1024: K12 in two
# passes).
cfg_l = VARIANTS["L/16-384"].replace(dtype=torch.bfloat16, num_classes=1000)
p_l = init_params(cfg_l, generator=gen, device="cuda")
px_l = torch.randn((8, 3, cfg_l.image_size, cfg_l.image_size),
                   generator=gen, device="cuda").to(torch.bfloat16)
with torch.inference_mode():
    res["forward_l16_384_bs8"] = times(lambda: forward(p_l, px_l, cfg_l),
                                       iters=10)
q_l = quantize_params(p_l)
del p_l
with torch.inference_mode():
    res["forward_int8_l16_384_bs8"] = times(
        lambda: forward_quant(q_l, px_l, cfg_l), iters=10)
del q_l, px_l
torch.cuda.empty_cache()
labels = torch.randint(0, 1000, (32,), generator=gen, device="cuda")
init_fn, step_fn = make_train_step(cfg, make_optimizer(1e-4, 0.05))
opt = init_fn(params)
res["train_step"] = times(lambda: step_fn(params, opt, px, labels),
                          iters=10, warmup=2)
del params, opt
torch.cuda.empty_cache()
# The fp32 B/16 bs=32 forward and train step (K2's and K13's fp32 forms).
cfg32 = VARIANTS["B/16"].replace(dtype=torch.float32, num_classes=1000)
p32 = init_params(cfg32, generator=gen, device="cuda")
px32 = px.float()
q32 = quantize_params(p32)
with torch.inference_mode():
    res["forward_fp32"] = times(lambda: forward(p32, px32, cfg32), iters=10)
    res["forward_fp32_layer"] = times(
        lambda: forward(p32, px32, cfg32, layer_block=True), iters=10)
    # The fp32 int8 forward with K17 in its MLP halves (int8_dot=False).
    res["forward_fp32_int8_nodot"] = times(
        lambda: forward_quant(q32, px32, cfg32, int8_dot=False), iters=10)
del q32
init_fn, step_fn = make_train_step(cfg32, make_optimizer(1e-4, 0.05))
opt = init_fn(p32)
res["train_step_fp32"] = times(lambda: step_fn(p32, opt, px32, labels),
                               iters=5, warmup=2)
print(json.dumps(res))
"""

HERE = Path(__file__).resolve().parents[2]


def run_tree(root: Path, timeout: int, cases: dict = CASES,
             forwards: bool = True) -> dict:
    """The worker's timings for the checkout at ``root``."""
    proc = subprocess.run([sys.executable, "-c", WORKER, str(root),
                           str(HERE / "chip_smoke.py"), json.dumps(cases),
                           str(int(forwards))],
                          cwd=root, capture_output=True, text=True,
                          timeout=timeout,
                          env={**os.environ, "PYTHONPATH": str(root)})
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: worker failed\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout (e.g. the parent "
                         "commit unpacked under build/)")
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--cases", default=None,
                    help="comma-separated keys of CASES (default: all)")
    ap.add_argument("--no-forwards", action="store_true",
                    help="time the kernel cases only")
    args = ap.parse_args(argv)
    cases = CASES
    if args.cases:
        unknown = set(args.cases.split(",")) - set(CASES)
        if unknown:
            raise SystemExit(f"unknown cases {sorted(unknown)}")
        cases = {k: CASES[k] for k in args.cases.split(",")}
    other = Path(args.other).resolve()
    if not (other / "vit_tpu_torch").is_dir():
        raise SystemExit(f"{other} holds no vit_tpu_torch/")
    runs = []
    for tag, root in (("other", other), ("this", HERE), ("this", HERE),
                      ("other", other)):
        got = run_tree(root, args.timeout, cases, not args.no_forwards)
        runs.append({"tree": tag, **got})
        print(f"{tag:5s} " + "  ".join(
            f"{k} {v['ms']:.4f} ms (device {v['device_ms']})"
            for k, v in got.items()), flush=True)
    # Which kernel cases give the same bits in both trees.
    same = {k: len({r[k]["sha256"] for r in runs}) == 1
            for k in runs[0] if "sha256" in runs[0][k]}
    print("bit for bit with the other tree: " + ", ".join(
        f"{k} {'same' if v else 'DIFFERS'}" for k, v in same.items()),
        flush=True)
    from vit_tpu_torch.tools import card_line
    print(json.dumps({"turns": runs, "bit_for_bit": same,
                      "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
