#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vit_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits non-zero
without printing the final ``ok`` line:

1. device: the card's name and power limit (``nvidia-smi``), CUDA, TF32 off;
2. build: compile the hand-written kernels from ``vit_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version, in fp32 and bf16, at the
   ViT-B/16 path's shapes (bs=32), at the ViT-L/16-384 path's shapes
   (bs=8: 8 x 592 = 4736 rows, D=1024, 16 heads of 64), ``embed_fused`` at
   B/16 (bs=4), H/14 (bs=2, K=588) and L/16-384 (bs=4, phase 7's bucket),
   both forms of ``encoder_stack`` as whole 12-layer B/16 encoders at bs=1
   and bs=2 (197 of 208 tokens); the int8 kernels at B/16 bs=32, L/16-384
   bs=8 (K7's fp32 output at 592 tokens) and H/14 bs=2 (D=1280, MLP 5120),
   ``matmul_i8`` bit for bit, and ``encoder_stack_q`` as the whole B/16 and
   L/16 encoders at bs=1; K13 ``flash_attention_bwd`` at B/16 bs=32 in
   both dtypes, L/16-384 bs=2 (592 tokens) in bf16 and H/14 bs=2 (d=80)
   in fp32; the reference op chain at B/16 bs=32's unfused shapes: K14
   ``add`` bit for bit, K15 ``softmax``, K16 ``matmul3`` (scores and
   context), and K17 ``mlp_block_q`` there and, in bf16, at L/16-384 bs=8
   and H/14 bs=2;
4. golden: synthetic B/16 weights in fp32 through the kernels, held to the
   ``transformers`` recording ``tests/fixtures/golden_b16.npz``, with the
   exact per-forward launch counts; the same weights through
   ``encoder_stack_fused`` directly and through ``attention="unfused",
   fused=False``; and through the int8 tier, with K12 and with the
   weight-only K17 (``int8_dot=False``), each within rel 5e-2 and corr
   0.999 of the float forward and as accurate as its plain version;
5. B/16 serving: a bf16 B/16 ``Predictor`` with a 1000-class head answers
   requests of 1, 5, 32 and 37 images, with exact launch counts -- the
   first main path: bs=1 buckets take ``encoder_stack_fused`` and the
   head, bs=32 buckets every layer on the two half-block mega-kernels;
   5b. the same requests through ``Predictor(quant=True)``, the int8 main
   path: 11 bs=1 forwards on ``encoder_stack_q``, 2 bs=32 on the per-layer
   int8 route, exact launch counts, every request equal to its bucket
   forwards bit for bit;
6. L/16-384 fp32 at full depth (24 layers, bs=2) through the kernels
   against ``impl="torch"``, with exact launch counts: ``embed_fused``,
   then every layer's attention half composed (layernorm_stats +
   fused_linear -> flash_attention -> fused_linear), its MLP half
   ``mlp_block``;
7. L/16-384 serving: a bf16 ``Predictor(buckets=(4, 8))`` with a
   1000-class head answers 3, 8 and 11 images, with exact launch counts --
   the second main path (bucket 4 embeds through ``embed_fused``);
   7b. L/16-384 int8 bf16 at bs=8, full depth, and 7c. H/14 int8 at 4
   layers in both dtypes, each as accurate against the float forward as
   its plain version (``check_int8_forward``);
8. H/14 at 4 layers in bf16 (attention mega, MLP composed) and fp32
   (attention composed at head_dim 80, MLP mega) against ``impl="torch"``;
9. DeiT-B/16 bf16 at bs=1, full depth, against ``impl="torch"``: composed
   embed, ``encoder_stack``, final LN -- the third main path;
10. L/16 bf16 at bs=1, full depth, against ``impl="torch"``: one
    ``encoder_stack_fused`` at D=1024 -- the fourth main path;
11. timings (CUDA events, median of 20 after warm-up): each kernel against
    its plain version and, where one PyTorch call computes the same
    function, that call (``library_ms``, a yardstick the port never
    calls); the bf16 forwards of B/16 at bs=32 and L/16-384 at bs=8
    through the kernels and through ``impl="torch"``; B/16 at bs=1 and 2
    and L/16 at bs=1 through the stack route, the per-layer kernel route
    (the stack plans patched off) and ``impl="torch"``, each with its
    device idle share; one B/16 layer's launches at bs=1, stand-ins for
    K9's phases; the int8 forward against the bf16 kernel forward at
    B/16 bs=32 and bs=1 and L/16-384 bs=8, in turns, with device times;
    the B/16 bs=32 bf16 forward on each ``(attention, fused)`` route; and
    the int8 forward with K12 and with K17 at B/16 bs=32 and L/16-384
    bs=8, in turns;
12. training, the fifth main path (``vit_tpu_torch/train.py``): K13 twice
    bit for bit; one ``make_train_step`` step through the kernels, each
    with its exact launch counts and every parameter's gradient held to
    ``impl="torch"`` (``TRAIN_F32_BAR``, ``TRAIN_BF16_REL_BAR``), at B/16
    fp32 bs=32 (then two more AdamW steps on the batch: the loss falls),
    B/16 bf16 at bs=32, 2 (the fold's forward, the per-layer remat
    backward) and 4 (``embed_fused``), L/16-384 bf16 bs=2 at 4 layers
    (composed attention, K13 at 592 tokens), and on the unfused route
    (K16 in the backward) at B/16 bf16 bs=32 and fp32 bs=8; the step's
    ms, images/s and device idle share at B/16 bs=32, kernels and plain,
    in both dtypes;
13. the other forward modes (``forward_modes_phase``): B/16 bf16 bs=32 at
    full depth on (unfused, fused=False), (unfused, True) and (flash,
    False) against ``impl="torch"``; ``Predictor(attention="unfused")``
    and ``Predictor(quant=True, int8_dot=False)`` serving requests of 1,
    5 and 32; ``forward_quant(int8_dot=False)`` at L/16-384 bf16 bs=8;
14. tensor and batch parallelism (``tp_phase``): the shard forms (B16
    ``attn_block_partial``, B17 ``attn_block_q_partial``, K3 / K12 / K17
    with ``partial_out=True``) are checked and timed with the other
    kernels in phases 3 and 11 (``kernel_cases_tp``: B/16 bs=8 in both
    dtypes, L/16-384 bs=2 and H/14 bs=2 in bf16, over model=2 and 4; B/16
    bs=32 over model=2, the case the kernels line reports for K3 / K12 /
    K17's forms; B16 and B17 are timed as blocks, like K4); here, the
    shards' sums plus bias and residual against the whole-block kernels,
    then two ranks spawned on the card (this script with ``--tp-rank``,
    gloo over a ``file://`` store): ``make_tp_forward`` at B/16 bf16 bs=8
    (12 layers: float, int8 with K12 and with K17) and H/14 bf16 bs=2 (4
    layers),
    ``Predictor(mesh=make_mesh(data=1, model=2))`` on requests of 1, 5
    and 8, a DP forward and one DP train step at B/16 bf16 bs=8 over
    data=2, with exact launch counts, held to the single-device forwards
    and train step;
15. the full-layer route (``layer_phase``; ``layer_block=True``: K1, K2,
    the attention core and K18 a layer, the activation between the halves
    kept in fp32) and the last standalone kernels. K18, the whole
    ``layer_block``, K19 ``patchify`` (bit for bit), K20 ``print_if`` and
    K21 ``minimal_matmul`` are checked in phase 3 and timed in phase 11
    (``kernel_cases_layer``). Here, through the entry points: the golden
    fp32 B/16 bs=2 (< 1e-3); B/16 bf16 bs=32 at full depth against
    ``impl="torch"`` and the default route, in turns with its times and
    idle share, and one layer's ``layer_block`` against K4 + K3;
    ``Predictor(layer_block=True)`` serving 1, 5, 32 and 37 images; L/16
    bf16 bs=8 at 4 layers; one B/16 bf16 bs=32 train step; K20's printed
    lines at grids (2,) and (3, 4), captured from the process's standard
    output; ``ops.patchify`` and the minimal matmul example's ``main``.
    Exact launch counts throughout.

The last three lines of standard output are the kernels JSON line (each
kernel's launches on the main paths, error vs the plain version, kernel,
plain and library times, and its bound: the larger of its bytes over the
memory rate and its operations over the peak rate of their type), the
card's ``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``. Imports only torch, numpy and the port.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: Per-forward launches of each kernel of B/16 with a classifier head on
#: the per-layer route (12 LN1 + final LN; patch projection + 12 QKV + 12
#: out-proj + head).
PER_FORWARD = {"layernorm": 13, "matmul": 26, "attention": 12, "mlp_block": 12}
#: One layer on the layer route (``layer_block=True``): K1, the QKV on K2,
#: the attention core, K18 -- in place of the out-projection's K2 and K3.
LAYER_ROUTE = {"layernorm": 1, "matmul": 1, "attention": 1, "layer_block": 1}
#: B/16 with a head on the stack route (bf16, bs <= 2): one launch for
#: embed, encoder and final LN, then the head.
PER_FORWARD_STACK = {"encoder_stack_fused": 1, "matmul": 1}
#: The encoder and final LN of L/16-384: 24 composed attention halves
#: (layernorm_stats + fused_linear, flash_attention, fused_linear) and 24
#: mlp_block. The embedding adds ``embed_fused`` at bs <= 4, the patch
#: projection ``matmul`` above.
L16_384_ENCODER = {"layernorm": 1, "mlp_block": 24, "layernorm_stats": 24,
                   "fused_linear": 48, "flash_attention": 24}
#: H/14 at 4 layers without its head (pooling="cls") at bs=2, per dtype:
#: ``embed_fused``, then in bf16 the attention half is attn_block and the
#: MLP half composed; in fp32 the other way round.
PER_FORWARD_H14_4 = {
    "bfloat16": {"embed_fused": 1, "layernorm": 5, "matmul": 8,
                 "attention": 4, "layernorm_stats": 4, "fused_linear": 8},
    "float32": {"embed_fused": 1, "layernorm": 1, "mlp_block": 4,
                "layernorm_stats": 4, "fused_linear": 8,
                "flash_attention": 4},
}
#: DeiT-B/16 bf16 at bs=1: two prefix tokens, so no fold: the composed
#: embed (patch projection), one encoder_stack, the final LN.
PER_FORWARD_DEIT_STACK = {"matmul": 1, "encoder_stack": 1, "layernorm": 1}
#: One layer of the int8 per-layer route: attn_block_q's five launches
#: (quantize_rows, matmul_i8, flash_attention with an fp32 output,
#: quantize_rows, matmul_i8) and mlp_block_i8dot.
Q_LAYER = {"quantize_rows": 2, "matmul_i8": 2, "flash_attention": 1,
           "mlp_block_i8dot": 1}
#: B/16 bf16 with a head on the int8 stack route (bs=1): embed_fused, one
#: encoder_stack_q, the final LN, the head.
PER_FORWARD_Q_STACK = {"embed_fused": 1, "encoder_stack_q": 1,
                       "layernorm": 1, "matmul": 1}
#: Where each kernel's source is and which TPU kernel it replaces.
KERNEL_SOURCES = {
    "layernorm": ("vit_tpu_torch/csrc/layernorm.cu",
                  "vit_tpu/ops/pallas/layernorm.py:80"),
    "matmul": ("vit_tpu_torch/csrc/matmul.cu",
               "vit_tpu/ops/pallas/matmul.py:212"),
    "attention": ("vit_tpu_torch/csrc/attention.cu",
                  "vit_tpu/ops/pallas/block.py:892"),
    "mlp_block": ("vit_tpu_torch/csrc/mlp_block.cu",
                  "vit_tpu/ops/pallas/block.py:218"),
    "layernorm_stats": ("vit_tpu_torch/csrc/layernorm.cu",
                        "vit_tpu/ops/pallas/layernorm.py:58"),
    "fused_linear": ("vit_tpu_torch/csrc/matmul.cu",
                     "vit_tpu/ops/pallas/matmul.py:388"),
    "flash_attention": ("vit_tpu_torch/csrc/flash_attention.cu",
                        "vit_tpu/ops/pallas/attention.py:311"),
    "embed_fused": ("vit_tpu_torch/csrc/embed.cu",
                    "vit_tpu/ops/pallas/patch_embed.py:96"),
    "encoder_stack": ("vit_tpu_torch/csrc/encoder_stack.cu",
                      "vit_tpu/ops/pallas/block.py:2203"),
    "encoder_stack_fused": ("vit_tpu_torch/csrc/encoder_stack.cu",
                            "vit_tpu/ops/pallas/block.py:2331"),
    # K10 and K11 are four of the five launches of attn_block_q (B11).
    "quantize_rows": ("vit_tpu_torch/csrc/layernorm.cu",
                      "vit_tpu/ops/pallas/block.py:1385"),
    "matmul_i8": ("vit_tpu_torch/csrc/matmul.cu",
                  "vit_tpu/ops/pallas/block.py:1385"),
    "mlp_block_i8dot": ("vit_tpu_torch/csrc/mlp_block_i8.cu",
                        "vit_tpu/ops/pallas/block.py:591"),
    "encoder_stack_q": ("vit_tpu_torch/csrc/encoder_stack.cu",
                        "vit_tpu/ops/pallas/block.py:2558"),
    "flash_attention_bwd": ("vit_tpu_torch/csrc/flash_attention_bwd.cu",
                            "vit_tpu/ops/pallas/vjp.py:406"),
    "add": ("vit_tpu_torch/csrc/elementwise.cu",
            "vit_tpu/ops/pallas/add.py:35"),
    "softmax": ("vit_tpu_torch/csrc/elementwise.cu",
                "vit_tpu/ops/pallas/softmax.py:39"),
    # K16 replaces both pallas_calls of matmul3: the group kernel (:105)
    # and the general one (:130).
    "matmul3": ("vit_tpu_torch/csrc/matmul3.cu",
                "vit_tpu/ops/pallas/matmul3.py:105"),
    "mlp_block_q": ("vit_tpu_torch/csrc/mlp_block_q.cu",
                    "vit_tpu/ops/pallas/block.py:416"),
    # The tensor-parallel shard forms of K3, K12 and K17, partial_out=True
    # (the same pallas_calls). B16 and B17 (block.py:1054, :1483) are K1,
    # K2 and the attention core or K7, and K10, K11 and K7: their kernels
    # count their launches, and phase 11 times each block whole.
    "mlp_block_partial": ("vit_tpu_torch/csrc/mlp_block.cu",
                          "vit_tpu/ops/pallas/block.py:218"),
    "mlp_block_i8dot_partial": ("vit_tpu_torch/csrc/mlp_block_i8.cu",
                                "vit_tpu/ops/pallas/block.py:591"),
    "mlp_block_q_partial": ("vit_tpu_torch/csrc/mlp_block_q.cu",
                            "vit_tpu/ops/pallas/block.py:416"),
    # K18 is the last of layer_block's four launches (K1, K2 and the
    # attention core count theirs), as K4's core is of attn_block's.
    "layer_block": ("vit_tpu_torch/csrc/layer_block.cu",
                    "vit_tpu/ops/pallas/block.py:1805"),
    "patchify": ("vit_tpu_torch/csrc/patching.cu",
                 "vit_tpu/ops/pallas/patching.py:67"),
    # The Pallas kernel that calls vit_tpu/ops/pallas/debug.py:print_if.
    "print_if": ("vit_tpu_torch/csrc/debug.cu", "tests/test_ops_pallas.py:248"),
    "minimal_matmul": ("vit_tpu_torch/csrc/minimal_matmul.cu",
                       "examples/minimal_pallas_matmul.py:50"),
}
#: Kernels that run a whole encoder: held to the model bars.
WHOLE_ENCODER = ("encoder_stack", "encoder_stack_fused", "encoder_stack_q")
#: Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet, dense): device
#: memory bytes/s, and operations/s by the type the work runs in (bf16 and
#: int8 on the tensor cores, fp32 on the FFMA units, no TF32).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
FP32_BAR = 1e-4       # max|diff|: only the fp32 sum order differs
BF16_REL_BAR = 2e-2   # |diff| <= bar * (1 + |ref|): about two bf16 ulps
BF16_MEAN_BAR = 3e-3  # mean|diff|
GOLDEN_BAR = 1e-3     # tests/test_golden.py:58; every fp32 forward
#: A bf16 forward through the kernels against impl="torch": the rounding
#: points are the same, but each fp32 sum-order difference that flips a
#: bf16 rounding carries through the following layers
#: (tests/test_torch_model.py's bar against the JAX XLA tier).
MODEL_BF16_REL_BAR = 5e-2
MODEL_BF16_MEAN_BAR = 1e-2
#: A training step's gradients through the kernels against PyTorch's
#: autograd of the plain ops, per parameter tensor. fp32: max|diff| <=
#: 1e-3 max|ref|, the golden bar scaled to the tensor, for sum orders
#: through 12 layers of remat and K13 (a tensor's largest entries set the
#: scale: the key third of each QKV bias has a gradient of round-off, zero
#: in exact arithmetic). bf16: relative norm <= 5e-2, the model bar: the
#: kernel route rounds where JAX's VJPs round (dh, dw and the GELU'd
#: gradient in bf16), autograd where the plain forward casts, and the
#: differences compound over 12 layers.
TRAIN_F32_BAR = 1e-3
TRAIN_BF16_REL_BAR = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(torch, got, want, dtype, *, fp32_bar=FP32_BAR,
            bf16_bar=BF16_REL_BAR, mean_bar=BF16_MEAN_BAR) -> dict:
    """Hold ``got`` to ``want`` with the bar of ``dtype``; raise if off.
    A pair of tensors (``layernorm_stats``) is held in fp32, each half."""
    if isinstance(got, tuple):
        parts = [compare(torch, g, w, torch.float32, fp32_bar=fp32_bar)
                 for g, w in zip(got, want)]
        return {"max_abs_err": max(p["max_abs_err"] for p in parts),
                "mean_abs_err": max(p["mean_abs_err"] for p in parts)}
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("non-finite values")
    diff = (g - w).abs()
    res = {"max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean())}
    if dtype == torch.float32:
        ok = res["max_abs_err"] <= fp32_bar
    else:
        excess = float((diff - bf16_bar * (1 + w.abs())).max())
        res["max_excess"] = excess
        ok = excess <= 0 and res["mean_abs_err"] <= mean_bar
    if not ok:
        raise AssertionError(f"outside the {dtype} bar: {res}")
    return res


def compare_model(torch, got, want, dtype) -> dict:
    """A whole forward (or encoder) through the kernels against
    ``impl="torch"``."""
    return compare(torch, got, want, dtype, fp32_bar=GOLDEN_BAR,
                   bf16_bar=MODEL_BF16_REL_BAR, mean_bar=MODEL_BF16_MEAN_BAR)


def compare_exact(torch, got, want, dtype) -> dict:
    """Bit for bit (K11, and K10 without LN)."""
    for g, w in zip(got, want) if isinstance(got, tuple) else [(got, want)]:
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError("not equal bit for bit")
    return {"max_abs_err": 0.0, "mean_abs_err": 0.0}


def compare_codes(torch, got, want, dtype) -> dict:
    """K10 with LN: the LN sum orders differ, so at most 0.1% of codes may
    flip, by one; the scales agree to 1e-5. The error is that of the
    dequantized rows, codes times scale."""
    (q, a), (qw, aw) = got, want
    flips = (q.int() - qw.int()).abs()
    share = float((flips > 0).float().mean())
    arel = float(((a - aw).abs() / aw).max())
    deq = (q.float() * a - qw.float() * aw).abs()
    res = {"max_abs_err": float(deq.max()), "mean_abs_err": float(deq.mean()),
           "max_code_flip": int(flips.max()), "flip_share": share,
           "scale_rel": arel}
    if res["max_code_flip"] > 1 or share > 1e-3 or arel > 1e-5:
        raise AssertionError(f"quantize_rows outside its bar: {res}")
    return res


def compare_i8(torch, got, want, dtype) -> dict:
    """An int8 kernel that quantizes activations inside (K12,
    attn_block_q): the bf16 model bars in both dtypes. Where the LN sum
    orders differ, an activation code can flip at a .5 boundary (K10 flips
    about one in 10^6); the flip moves the following product by one
    quantization step, and a bf16 rounding of the result may flip with it,
    as a sum-order difference carries through a whole bf16 forward."""
    return compare_model(torch, got, want, torch.bfloat16)


def compare_rel(torch, got, want, dtype) -> dict:
    """A whole bf16 encoder on int8 weights (K9): relative norm <= 2e-2,
    the int8 tier's kernel-vs-plain bar; fp32 the model bar. Over 24 bf16
    layers the residual stream grows (mean |x| near 2 at L/16) and its
    rounding differences grow with it past the absolute model bars;
    :func:`kernel_cases_stack_q` also holds the kernel to be as close to
    an fp32 run of the same weights as its plain version."""
    if dtype == torch.float32:
        return compare_model(torch, got, want, dtype)
    g, w = got.float(), want.float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError("shape or non-finite values")
    diff = (g - w).abs()
    res = {"max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean()),
           "rel": float((g - w).norm() / w.norm())}
    if not res["rel"] <= 2e-2:
        raise AssertionError(f"outside the relative bar: {res}")
    return res


def compare_bf16(torch, got, want, dtype) -> dict:
    """K7's fp32 output of bf16 inputs: the kernel bf16 bars."""
    return compare(torch, got, want, torch.bfloat16)


def case(name: str, label: str, run, work: tuple, *, library=None,
         check=None, primary: bool = True) -> dict:
    """A kernel case: ``run(impl)``; ``work`` = (bytes, operations, type)
    for its bound; ``library`` one PyTorch call of the same function, timed
    as a yardstick only; ``check(torch, got, want, dtype)`` its bar;
    ``primary`` whether the kernels line may report it."""
    if check is None:
        check = compare_model if name in WHOLE_ENCODER else compare
    return {"name": name, "label": label, "run": run, "work": work,
            "library": library, "check": check, "primary": primary}


def gemm_work(m: int, k: int, n: int, e: int, kind: str, *,
              out_e: int | None = None, residual: bool = False) -> tuple:
    """(bytes, operations, type) of (m, k) @ (k, n) + bias: each input read
    once, the output written once."""
    out_e = e if out_e is None else out_e
    return ((m * k + k * n + n) * e + m * n * out_e * (2 if residual else 1),
            2 * m * k * n, kind)


def attention_ops(b: int, heads: int, s: int, seq_len: int, hd: int) -> int:
    """QK^T and PV over the real keys for every query row."""
    return 4 * b * heads * s * seq_len * hd


def bound(work: tuple) -> tuple[float, str]:
    """The least time (ms) the card could take for ``work``, and what sets
    it: its bytes at the memory rate or its operations at the peak rate of
    their type."""
    nbytes, ops, kind = work
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def expect_counts(counts: dict, per_forward: dict, n: int = 1) -> dict:
    """``per_forward`` times ``n`` for every kernel, 0 where not named."""
    return {k: per_forward.get(k, 0) * n for k in counts}


def add_counts(*parts: dict) -> dict:
    """The sum of several ``expect_counts`` results."""
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def route_counts(attention: str, fused: bool, layers: int = 12, *,
                 head: bool = True, embed_fused: bool = False) -> dict:
    """Per-forward launches of a B/16-shaped model on a composed route of
    ``encoder_block`` (``attention``, ``fused``): each linear is K5 + K6
    (``fused_linear`` counts K2's launches without LN too) with ``fused``,
    K1 -> K2 -> K14 without; attention is K7, or K16 -> K15 -> K16
    ``unfused``. Then the final LN, the patch projection on K2 (or
    ``embed_fused``) and the head."""
    out = {"layernorm": 1, "matmul": int(head) + int(not embed_fused)}
    if embed_fused:
        out["embed_fused"] = 1
    if fused:
        out.update(layernorm_stats=2 * layers, fused_linear=4 * layers)
    else:
        out["layernorm"] += 2 * layers
        out["matmul"] += 4 * layers
        out["add"] = 2 * layers
    if attention == "unfused":
        out.update(matmul3=2 * layers, softmax=layers)
    else:
        out["flash_attention"] = layers
    return out


def q_weight_only(counts: dict) -> dict:
    """An int8 route's launches with the weight-only K17 in place of K12
    (``int8_dot=False``)."""
    out = dict(counts)
    out["mlp_block_q"] = out.pop("mlp_block_i8dot", 0)
    return out


def check_counts(label: str, counts: dict, expect: dict) -> None:
    if counts != expect:
        raise AssertionError(f"{label} launch counts {counts} != {expect}")


def event_times(torch, fn, iters: int = 20, warmup: int = 3) -> list:
    """The time of each of ``iters`` calls of ``fn`` after ``warmup``
    (CUDA events around one call, host launch cost included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median time of ``fn`` over ``iters`` calls (CUDA events)."""
    return float(np.median(event_times(torch, fn, iters, warmup)))


@contextlib.contextmanager
def per_layer_route():
    """Turn the stack route off (``ops.stack_plan``, ``stack_fused_plan``),
    so that the model runs one encoder_block a layer."""
    from vit_tpu_torch import ops
    saved = ops.stack_plan, ops.stack_fused_plan
    ops.stack_plan = lambda *a: False
    ops.stack_fused_plan = lambda *a: False
    try:
        yield
    finally:
        ops.stack_plan, ops.stack_fused_plan = saved


def _rnd_fn(torch, dtype, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        t = torch.randn(shape, generator=gen, device="cuda") * std + mean
        return t.to(dtype)
    return rnd


def _kind(torch, dtype) -> str:
    """The peak-rate type of a float kernel's products in ``dtype``."""
    return "bf16" if dtype == torch.bfloat16 else "fp32"


def _sdpa(torch, q, k, v, scale, seq_len):
    """One PyTorch call of masked attention (keys >= seq_len masked): the
    yardstick of K4's core and K7, used nowhere in the port."""
    import torch.nn.functional as F
    keep = torch.arange(k.shape[-2], device=k.device) < seq_len
    return F.scaled_dot_product_attention(q, k, v, attn_mask=keep[None, :],
                                          scale=scale)


def _sdpa_bwd(torch, q, k, v, g, scale, seq_len):
    """The backward of one masked SDPA call, K13's yardstick: the first call
    (a warm-up) builds the forward's graph; each call runs
    ``torch.autograd.grad`` of it for ``g``."""
    state = {}

    def run():
        if not state:
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            with torch.enable_grad():
                state["out"] = _sdpa(torch, *leaves, scale, seq_len)
            state["leaves"] = leaves
        return torch.autograd.grad(state["out"], state["leaves"], g,
                                   retain_graph=True)
    return run


def kernel_cases_train(torch, dtype):
    """K13, the flash-attention backward, at the training path's shapes:
    B/16 bs=32 (384 heads, 197 of 208 tokens, d=64) in both dtypes, the
    case the kernels line reports in bf16; L/16-384 bs=2 (32 heads, 577 of
    592) in bf16; H/14 bs=2 (32 heads, 257 of 272, d=80) in fp32. q, k and
    v are views of a packed QKV buffer, g a (B, S, H, d) buffer's view, as
    the training step gives them. Bound: JAX's cost estimate
    (``vjp.py:414-417``) over the keys this run's data keeps, 10*B*H*S*
    seq_len*d operations (every query row, the real keys; the masked keys'
    dk and dv are zeros), and the four inputs and three outputs once."""
    from vit_tpu_torch import ops

    rnd = _rnd_fn(torch, dtype, 13)
    shapes = [("B/16", 32, 12, 208, 197, 64)]
    shapes.append(("L/16-384", 2, 16, 592, 577, 64) if dtype == torch.bfloat16
                  else ("H/14", 2, 16, 272, 257, 80))
    cases = []
    for tag, b, h, s, seq_len, hd in shapes:
        qkv = rnd(b * s, 3 * h * hd)
        q, k, v = qkv.view(b, s, 3, h, hd).permute(2, 0, 3, 1, 4)
        g = rnd(b, s, h, hd).transpose(1, 2)
        args = (q, k, v, g, hd ** -0.5, seq_len)
        cases.append(case(
            "flash_attention_bwd",
            f"{tag} B={b} H={h} S={s} seq_len {seq_len} d={hd}",
            lambda impl, a=args: ops.flash_attention_bwd(
                *a[:4], scale=a[4], seq_len=a[5], impl=impl),
            (7 * b * h * s * hd * dtype.itemsize,
             10 * b * h * s * seq_len * hd, _kind(torch, dtype)),
            library=_sdpa_bwd(torch, *args), primary=tag == "B/16"))
    return cases


def kernel_cases(torch, dtype):
    """Kernel cases at the B/16 path's shapes: bs=32 is M = 32*208 = 6656
    rows (6272 = 32*196 for the patch rows)."""
    import torch.nn.functional as F

    from vit_tpu_torch import ops
    from vit_tpu_torch.ops import reference
    from vit_tpu_torch.ops.cuda import block as cuda_block

    rnd = _rnd_fn(torch, dtype, 0)
    e, kind = dtype.itemsize, _kind(torch, dtype)
    b, sp, s, d, mlp, heads = 32, 208, 197, 768, 3072, 12
    m, hd = b * sp, d // heads
    x = rnd(m, d)
    g, beta = rnd(d, std=0.1, mean=1.0), rnd(d, std=0.05)
    w_dd, b_d = rnd(d, d, std=0.04), rnd(d, std=0.02)
    w_dm, b_m = rnd(d, mlp, std=0.03), rnd(mlp, std=0.02)
    w_md = rnd(mlp, d, std=0.03)
    wqkv, bqkv = rnd(d, 3 * d, std=0.04), rnd(3 * d, std=0.02)
    patches = rnd(32 * 196, d)
    qkv = rnd(m, 3 * d)
    x3 = x.reshape(b, sp, d)
    scale = hd ** -0.5
    q, k, v = qkv.view(b, sp, 3, heads, hd).permute(2, 0, 3, 1, 4)

    def attn_core(impl):
        if impl == "torch":
            return reference.attention_core(qkv, batch=b, num_heads=heads,
                                            scale=scale, seq_len=s)
        return cuda_block.attention_core(qkv, batch=b, num_heads=heads,
                                         scale=scale, seq_len=s)

    att_ops = attention_ops(b, heads, sp, s, hd)
    return [
        case("layernorm", f"({m},{d})",
             lambda impl: ops.layernorm(x, g, beta, impl=impl),
             (2 * m * d * e + 2 * d * e, 8 * m * d, "fp32"),
             library=lambda: F.layer_norm(x, (d,), g, beta, 1e-12)),
        case("matmul", f"({32 * 196},{d})@({d},{d})+bias",
             lambda impl: ops.matmul(patches, w_dd, b_d, impl=impl),
             gemm_work(32 * 196, d, d, e, kind), primary=False),
        case("matmul", f"({m},{d})@({d},{mlp})+bias+gelu",
             lambda impl: ops.matmul(x, w_dm, b_m, "gelu", impl=impl),
             gemm_work(m, d, mlp, e, kind), primary=False),
        case("matmul", f"({m},{d})@({d},{d})+bias+residual",
             lambda impl: ops.matmul(x, w_dd, b_d, residual=x, impl=impl),
             gemm_work(m, d, d, e, kind, residual=True), primary=False),
        case("matmul", f"({m},{d})@({d},{3 * d})+bias",
             lambda impl: ops.matmul(x, wqkv, bqkv, impl=impl),
             gemm_work(m, d, 3 * d, e, kind),
             library=lambda: torch.addmm(bqkv, x, wqkv)),
        case("mlp_block", f"({m},{d}) mlp {mlp}",
             lambda impl: ops.mlp_block(x, g, beta, w_dm, b_m, w_md, b_d,
                                        impl=impl),
             ((2 * m * d + 2 * d * mlp + mlp + 3 * d) * e, 4 * m * d * mlp,
              kind)),
        case("attention", f"qkv ({m},{3 * d}) heads {heads} seq_len {s}",
             attn_core, (4 * m * d * e, att_ops, kind),
             library=lambda: _sdpa(torch, q, k, v, scale, s)),
        case("attn_block", f"({b},{sp},{d}) seq_len {s}",
             lambda impl: ops.attn_block(x3, g, beta, wqkv, bqkv, w_dd, b_d,
                                         num_heads=heads, seq_len=s,
                                         impl=impl),
             ((2 * m * d + 4 * d * d + 6 * d) * e,
              2 * m * d * 4 * d + att_ops, kind)),
    ]


def kernel_cases_l16_384(torch, dtype):
    """Kernel cases at the L/16-384 path's shapes: bs=8 is M = 8*592 =
    4736 rows, D=1024, MLP 4096, 16 heads of 64, 577 real tokens.
    Attention reads q, k and v as views of a packed QKV buffer."""
    from vit_tpu_torch import ops

    rnd = _rnd_fn(torch, dtype, 1)
    e, kind = dtype.itemsize, _kind(torch, dtype)
    b, sp, s, d, mlp, heads = 8, 592, 577, 1024, 4096, 16
    hd, m = d // heads, b * sp
    x = rnd(m, d, std=1.5, mean=0.2)
    g, beta = rnd(d, std=0.1, mean=1.0), rnd(d, std=0.05)
    wqkv, bqkv = rnd(d, 3 * d, std=0.03), rnd(3 * d, std=0.02)
    w_dd, b_d = rnd(d, d, std=0.03), rnd(d, std=0.02)
    w_dm, b_m = rnd(d, mlp, std=0.03), rnd(mlp, std=0.02)
    w_md = rnd(mlp, d, std=0.02)
    qkv = rnd(m, 3 * d)
    q, k, v = qkv.view(b, sp, 3, heads, hd).permute(2, 0, 3, 1, 4)
    return [
        case("layernorm_stats", f"({m},{d})",
             lambda impl: ops.layernorm_stats(x, impl=impl),
             (m * d * e + 8 * m, 5 * m * d, "fp32")),
        case("fused_linear", f"({m},{d})@({d},{d})+bias+residual",
             lambda impl: ops.fused_linear(x, w_dd, b_d, residual=x,
                                           impl=impl),
             gemm_work(m, d, d, e, kind, residual=True), primary=False),
        case("fused_linear", f"LN ({m},{d})@({d},{3 * d})+bias",
             lambda impl: ops.fused_linear(x, wqkv, bqkv, ln_scale=g,
                                           ln_bias=beta, impl=impl),
             gemm_work(m, d, 3 * d, e, kind)),
        case("flash_attention", f"packed qkv B={b} H={heads} S={sp} "
             f"seq_len {s} d={hd}",
             lambda impl: ops.flash_attention(q, k, v, scale=hd ** -0.5,
                                              seq_len=s, impl=impl),
             (4 * m * d * e, attention_ops(b, heads, sp, s, hd), kind),
             library=lambda: _sdpa(torch, q, k, v, hd ** -0.5, s)),
        case("mlp_block", f"({m},{d}) mlp {mlp}",
             lambda impl: ops.mlp_block(x, g, beta, w_dm, b_m, w_md, b_d,
                                        impl=impl),
             ((2 * m * d + 2 * d * mlp + mlp + 3 * d) * e, 4 * m * d * mlp,
              kind), primary=False),
    ]


def _stack_work(b, sp, s, d, mlp, heads, layers, e, kind, w_e=None):
    """(bytes, operations, type) of a whole encoder: weights once (int8
    projections with their fp32 scales when ``w_e`` is 1), the activation
    in and out."""
    w_e = e if w_e is None else w_e
    proj = layers * (4 * d * d + 2 * d * mlp)
    vecs = layers * (8 * d + mlp) * e
    scales = layers * (5 * d + mlp) * 4 if w_e == 1 else 0
    m = b * sp
    ops = layers * (8 * m * d * d + 4 * m * d * mlp
                    + attention_ops(b, heads, sp, s, d // heads))
    return (proj * w_e + vecs + scales + 2 * m * d * e, ops, kind)


def kernel_cases_small_batch(torch, dtype):
    """Kernel cases of the small-batch route: K8 at the B/16 embedding
    (bs=4: 196 patches of 768 into 208 rows), the H/14 one (bs=2: 256
    patches of 588 into 272 rows of 1280) and, last, the L/16-384 one of
    phase 7's bucket 4 (576 patches of 768 into 592 rows of 1024), whose
    bf16 time the kernels line reports; K9 in both forms as the whole
    12-layer B/16 encoder at bs=1 and bs=2, 197 of 208 tokens, with the
    random B/16 weights of ``init_params``."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.config import VARIANTS
    from vit_tpu_torch.models.vit import fold_base, init_params

    rnd = _rnd_fn(torch, dtype, 5)
    e, kind = dtype.itemsize, _kind(torch, dtype)
    cases = []
    for b, n, k, d, sp in ((4, 196, 768, 768, 208), (2, 256, 588, 1280, 272),
                           (4, 576, 768, 1024, 592)):
        args = (rnd(b, n, k), rnd(k, d, std=0.03), rnd(d, std=0.1), rnd(d),
                rnd(n, d))
        cases.append(case(
            "embed_fused", f"({b},{n},{k})@({k},{d}) -> ({b},{sp},{d})",
            lambda impl, a=args, sp=sp: ops.embed_fused(*a, sp, impl=impl),
            ((b * n * k + k * d + n * d + 2 * d + b * sp * d) * e,
             2 * b * n * k * d, kind)))
    cfg = VARIANTS["B/16"].replace(dtype=dtype)
    p = init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(
        6))
    base = fold_base(p, cfg)
    kw = dict(num_heads=12, scale=64 ** -0.5, seq_len=197,
              eps=cfg.layernorm_eps)
    for b in (1, 2):
        x = rnd(b, 208, 768)
        x[:, 197:] = 0
        patches = rnd(b, 196, 768)
        work = _stack_work(b, 208, 197, 768, 3072, 12, 12, e, kind)
        cases.append(case("encoder_stack", f"B/16 12 layers ({b},208,768)",
                          lambda impl, x=x: ops.encoder_stack(
                              x, p["encoder"], impl=impl, **kw),
                          work, primary=b == 1))
        nbytes, ops_, _ = work
        cases.append(case(
            "encoder_stack_fused",
            f"B/16 embed + 12 layers + LN, patches ({b},196,768)",
            lambda impl, pt=patches: ops.encoder_stack_fused(
                pt, p["encoder"], p["embeddings"]["patch_embed"]["kernel"],
                base, p["ln_final"], sp=208, impl=impl, **kw),
            (nbytes + (b * 196 * 768 + 768 * 768 + 208 * 768) * e,
             ops_ + 2 * b * 196 * 768 * 768, kind), primary=b == 1))
    return cases


def kernel_cases_int8(torch, dtype):
    """The int8 kernels at the main paths' shapes: B/16 bs=32 (M=6656,
    D=768, MLP 3072; K11's QKV case is the one the kernels line reports,
    with ``torch._int_mm`` as its yardstick), L/16-384 bs=8 (attention at
    592 tokens through K7 with an fp32 output) and H/14 bs=2 (D=1280, MLP
    5120, fc2's K=5120); ``attn_block_q`` whole at B/16 and L/16-384."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.quant import quantize_weight

    rnd = _rnd_fn(torch, dtype, 9)
    e = dtype.itemsize
    cases = []

    def qw(*shape, std):
        return quantize_weight(rnd(*shape, std=std))

    for tag, b, sp, s, d, mlp, heads in (("B/16", 32, 208, 197, 768, 3072, 12),
                                         ("L/16-384", 8, 592, 577, 1024,
                                          4096, 16),
                                         ("H/14", 2, 272, 257, 1280, 5120,
                                          16)):
        m, hd = b * sp, d // heads
        main = tag == "B/16"
        x = rnd(m, d, std=1.5, mean=0.2)
        g, beta = rnd(d, std=0.1, mean=1.0), rnd(d, std=0.05)
        wqkv, wout = qw(d, 3 * d, std=0.04), qw(d, d, std=0.04)
        w1, w2 = qw(d, mlp, std=0.03), qw(mlp, d, std=0.03)
        bqkv, b_d, b_m = rnd(3 * d, std=0.02), rnd(d, std=0.02), rnd(mlp)
        xq, ax = ops.quantize_rows(x, ln_scale=g, ln_bias=beta, impl="torch")
        ctx = torch.randn((m, d), device="cuda")
        cq, ac = ops.quantize_rows(ctx, impl="torch")
        hq, ah = ops.quantize_rows(torch.randn((m, mlp), device="cuda"),
                                   impl="torch")
        qkv = rnd(m, 3 * d)
        q, k, v = qkv.view(b, sp, 3, heads, hd).permute(2, 0, 3, 1, 4)
        x3 = x.reshape(b, sp, d)
        att_ops = attention_ops(b, heads, sp, s, hd)
        if tag != "L/16-384":
            cases += [
                case("quantize_rows", f"{tag} LN ({m},{d})",
                     lambda impl, x=x, g=g, beta=beta: ops.quantize_rows(
                         x, ln_scale=g, ln_bias=beta, impl=impl),
                     (m * d * (e + 1) + 4 * m + 2 * d * e, 10 * m * d,
                      "fp32"), check=compare_codes, primary=main),
                case("quantize_rows", f"{tag} fp32 context ({m},{d})",
                     lambda impl, c=ctx: ops.quantize_rows(c, impl=impl),
                     (m * d * 5 + 4 * m, 3 * m * d, "fp32"),
                     check=compare_exact, primary=False),
                case("matmul_i8", f"{tag} ({m},{mlp})@({mlp},{d})"
                     "+bias+residual",
                     lambda impl, a=(hq, ah, w2, b_d, x): ops.matmul_i8(
                         a[0], a[1], a[2]["q"], a[2]["scale"], a[3],
                         residual=a[4], out_dtype=dtype, impl=impl),
                     gemm_work(m, mlp, d, 1, "int8", out_e=e, residual=True),
                     library=lambda a=(hq, w2): torch._int_mm(a[0],
                                                              a[1]["q"]),
                     check=compare_exact, primary=False),
                case("matmul_i8", f"{tag} ({m},{d})@({d},{d})+bias+residual",
                     lambda impl, a=(cq, ac, wout, b_d, x): ops.matmul_i8(
                         a[0], a[1], a[2]["q"], a[2]["scale"], a[3],
                         residual=a[4], out_dtype=dtype, impl=impl),
                     gemm_work(m, d, d, 1, "int8", out_e=e, residual=True),
                     library=lambda a=(cq, wout): torch._int_mm(a[0],
                                                                a[1]["q"]),
                     check=compare_exact, primary=False),
                case("matmul_i8", f"{tag} ({m},{d})@({d},{3 * d})+bias",
                     lambda impl, a=(xq, ax, wqkv, bqkv): ops.matmul_i8(
                         a[0], a[1], a[2]["q"], a[2]["scale"], a[3],
                         out_dtype=dtype, impl=impl),
                     gemm_work(m, d, 3 * d, 1, "int8", out_e=e),
                     library=lambda a=(xq, wqkv): torch._int_mm(a[0],
                                                                a[1]["q"]),
                     check=compare_exact, primary=main),
                case("mlp_block_i8dot", f"{tag} ({m},{d}) mlp {mlp}",
                     lambda impl, a=(x, g, beta, w1, b_m, w2, b_d):
                     ops.mlp_block_i8dot(
                         a[0], a[1], a[2], a[3]["q"], a[3]["scale"], a[4],
                         a[5]["q"], a[5]["scale"], a[6], impl=impl),
                     ((2 * m * d + mlp + 3 * d) * e + 2 * d * mlp
                      + 4 * (mlp + d), 4 * m * d * mlp, "int8"),
                     check=compare_i8, primary=main),
            ]
        if tag != "H/14":
            cases += [
                case("flash_attention", f"{tag} fp32 output, packed qkv "
                     f"B={b} H={heads} S={sp} seq_len {s} d={hd}",
                     lambda impl, a=(q, k, v, hd, s): ops.flash_attention(
                         a[0], a[1], a[2], scale=a[3] ** -0.5, seq_len=a[4],
                         out_dtype=torch.float32, impl=impl),
                     (3 * m * d * e + 4 * m * d, att_ops, _kind(torch, dtype)),
                     library=lambda a=(q, k, v, hd, s): _sdpa(
                         torch, a[0], a[1], a[2], a[3] ** -0.5, a[4]),
                     check=compare_bf16, primary=False),
                case("attn_block_q", f"{tag} ({b},{sp},{d}) seq_len {s}",
                     lambda impl, a=(x3, g, beta, wqkv, bqkv, wout, b_d,
                                     heads, s): ops.attn_block_q(
                         a[0], a[1], a[2], a[3]["q"], a[3]["scale"], a[4],
                         a[5]["q"], a[5]["scale"], a[6], num_heads=a[7],
                         seq_len=a[8], impl=impl),
                     (2 * m * d * e + 4 * d * d + 16 * d + 4 * d * e,
                      8 * m * d * d + att_ops, "int8"), check=compare_i8),
            ]
    return cases


def kernel_cases_stack_q(torch, dtype):
    """K9 on int8 weights as the whole L/16 (24 layers) and B/16 (12
    layers, the one the kernels line reports) encoders at bs=1, 197 of 208
    tokens, the int8 stack route's geometries, with the random weights of
    ``init_params`` quantized in fp32. Besides its bar, each case holds
    the kernel to be as close to the fp32 plain run of the same int8
    weights as the plain version in ``dtype`` is: the rounding of ``dtype``
    is all that may separate kernel and plain."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.config import VARIANTS
    from vit_tpu_torch.models.vit import init_params
    from vit_tpu_torch.quant import quantize_params

    rnd = _rnd_fn(torch, dtype, 10)
    cases = []
    for variant in ("L/16", "B/16"):
        cfg = VARIANTS[variant]
        d, heads = cfg.hidden_dim, cfg.num_heads
        q32 = quantize_params(init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(11)))["encoder"]
        qenc = {name: {k: v if k == "kernel" else v.to(dtype)
                       for k, v in p.items()} for name, p in q32.items()}
        x = rnd(1, 208, d)
        x[:, 197:] = 0
        kw = dict(num_heads=heads, scale=cfg.head_dim ** -0.5, seq_len=197,
                  eps=1e-12)

        def check(torch, got, want, dtype, x=x, q32=q32, kw=kw):
            res = compare_rel(torch, got, want, dtype)
            truth = ops.encoder_stack_q(x.float(), q32, impl="torch", **kw)
            res["kernels_vs_fp32_rel"] = rel_corr(torch, got, truth)[0]
            res["plain_vs_fp32_rel"] = rel_corr(torch, want, truth)[0]
            # In fp32 the plain run is the truth itself: the kernel may
            # differ from it by its fp32 sum order.
            if (res["kernels_vs_fp32_rel"]
                    > 1.25 * res["plain_vs_fp32_rel"] + 1e-4):
                raise AssertionError(f"encoder_stack_q less accurate than "
                                     f"its plain version: {res}")
            return res
        cases.append(case(
            "encoder_stack_q", f"{variant} {cfg.num_layers} layers "
            f"(1,208,{d})",
            lambda impl, x=x, qenc=qenc, kw=kw: ops.encoder_stack_q(
                x, qenc, impl=impl, **kw),
            _stack_work(1, 208, 197, d, cfg.mlp_dim, heads, cfg.num_layers,
                        dtype.itemsize, _kind(torch, dtype), w_e=1),
            check=check, primary=variant == "B/16"))
    return cases


def kernel_cases_chain(torch, dtype):
    """The reference op chain's kernels at B/16 bs=32's unfused shapes (197
    real tokens, no padding): K14 on the (6304, 768) residual, bit for bit;
    K15 on the 384*197 score rows of 197; K16 on the scores (384, 197, 64)
    @ (384, 64, 197) * 1/8, the case the kernels line reports, and the
    context (384, 197, 197) @ (384, 197, 64); K17 at the int8 per-layer
    route's B/16 bs=32 MLP (6656 x 768, MLP 3072), and in bf16 at
    L/16-384 bs=8 (4736 x 1024, 4096) and H/14 bs=2 (544 x 1280, 5120).
    Library yardsticks (the port calls none): ``torch.add``,
    ``torch.softmax``, ``torch.baddbmm`` with ``alpha=scale``; none for
    K17."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.quant import quantize_weight

    rnd = _rnd_fn(torch, dtype, 14)
    e, kind = dtype.itemsize, _kind(torch, dtype)
    m, d, bh, s, hd = 32 * 197, 768, 384, 197, 64
    x, r = rnd(m, d, std=1.5), rnd(m, d)
    scores = rnd(bh, s, s, std=3.0)
    probs = torch.softmax(scores.float(), -1).to(dtype)
    q, kt, v = rnd(bh, s, hd), rnd(bh, hd, s), rnd(bh, s, hd)

    def bmm_work(b, mm, k, n):
        return ((b * mm * k + b * k * n + b * mm * n) * e, 2 * b * mm * n * k,
                kind)

    def baddbmm(a, b, scale):
        out = a.new_empty((a.shape[0], a.shape[1], b.shape[2]))
        return lambda: torch.baddbmm(out, a, b, beta=0, alpha=scale)
    cases = [
        case("add", f"({m},{d})", lambda impl: ops.add(x, r, impl=impl),
             (3 * m * d * e, m * d, "fp32"),
             library=lambda: torch.add(x, r), check=compare_exact),
        case("softmax", f"({bh},{s},{s})",
             lambda impl: ops.softmax(scores, impl=impl),
             (2 * bh * s * s * e, 5 * bh * s * s, "fp32"),
             library=lambda: torch.softmax(scores, -1)),
        case("matmul3", f"context ({bh},{s},{s})@({bh},{s},{hd})",
             lambda impl: ops.matmul3(probs, v, impl=impl),
             bmm_work(bh, s, s, hd), library=baddbmm(probs, v, 1.0),
             primary=False),
        case("matmul3", f"scores ({bh},{s},{hd})@({bh},{hd},{s})*0.125",
             lambda impl: ops.matmul3(q, kt, scale=0.125, impl=impl),
             bmm_work(bh, s, hd, s), library=baddbmm(q, kt, 0.125)),
    ]
    shapes = [("H/14 bs=2", 544, 1280, 5120),
              ("L/16-384 bs=8", 4736, 1024, 4096)] if dtype == torch.bfloat16 \
        else []
    for tag, mm, dd, mlp in shapes + [("B/16 bs=32", 6656, 768, 3072)]:
        w1 = quantize_weight(rnd(dd, mlp, std=0.03))
        w2 = quantize_weight(rnd(mlp, dd, std=0.03))
        args = (rnd(mm, dd, std=1.5, mean=0.2), rnd(dd, std=0.1, mean=1.0),
                rnd(dd, std=0.05), w1["q"], w1["scale"], rnd(mlp, std=0.02),
                w2["q"], w2["scale"], rnd(dd, std=0.02))
        cases.append(case(
            "mlp_block_q", f"{tag} ({mm},{dd}) mlp {mlp}",
            lambda impl, a=args: ops.mlp_block_q(*a, impl=impl),
            ((2 * mm * dd + mlp + 3 * dd) * e + 2 * dd * mlp
             + 4 * (mlp + dd), 4 * mm * dd * mlp, kind),
            primary=tag == "B/16 bs=32"))
    return cases


#: The shard geometries of phase 14's kernel cases: (tag, batch, padded
#: and real tokens, D, heads, MLP, model axes, dtypes). B/16 bs=32 over
#: model=2 is the case the kernels line reports.
TP_SHAPES = (
    ("B/16 bs=8", 8, 208, 197, 768, 12, 3072, (2, 4), ("fp32", "bf16")),
    ("L/16-384 bs=2", 2, 592, 577, 1024, 16, 4096, (2, 4), ("bf16",)),
    ("H/14 bs=2", 2, 272, 257, 1280, 16, 5120, (2, 4), ("bf16",)),
    ("B/16 bs=32", 32, 208, 197, 768, 12, 3072, (2,), ("bf16",)),
)


def kernel_cases_tp(torch, dtype):
    """Phase 14's kernels alone: one shard of each tensor-parallel partial
    at the main paths' shapes over model=2 and 4 (:data:`TP_SHAPES`): K3
    ``mlp_block`` with ``partial_out=True`` where ``mlp_plan`` takes the
    shard (not at H/14 in bf16, D=1280), K12 / K17 with it where
    ``mlp_q_plan`` does (whole 512-column groups), and, as blocks timed
    whole like ``attn_block``'s case, B16 ``attn_block_partial`` (the
    attention core; at L/16-384's 592 tokens K7) and B17
    ``attn_block_q_partial``, which count no launches of their own. Bound:
    the shard's bytes once, its products at the peak of their type (int8
    for the int8 projections, as ``attn_block_q``'s case counts them)."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.quant import quantize_weight

    rnd = _rnd_fn(torch, dtype, 51)
    e, kind = dtype.itemsize, _kind(torch, dtype)
    cases = []
    for tag, b, sp, s, d, heads, mlp, models, dts in TP_SHAPES:
        if kind not in dts:
            continue
        m_rows, hd = b * sp, d // heads
        x = rnd(b, sp, d, std=1.5, mean=0.2)
        x[:, s:] = 0
        g, beta = rnd(d, std=0.1, mean=1.0), rnd(d, std=0.05)
        for model in models:
            hl, dl, ml = heads // model, d // model, mlp // model
            lbl = f"{tag} model={model} shard"
            main = tag == "B/16 bs=32"
            wqkv, bqkv = rnd(d, 3 * dl, std=0.04), rnd(3 * dl, std=0.02)
            wout, b_d = rnd(dl, d, std=0.04), rnd(d, std=0.02)
            qqkv, qout = (quantize_weight(rnd(d, 3 * dl, std=0.04)),
                          quantize_weight(rnd(dl, d, std=0.04)))
            att_ops = attention_ops(b, hl, sp, s, hd)
            cases += [
                case("attn_block_partial",
                     f"{lbl} ({b},{sp},{d}) dl={dl} seq_len {s}",
                     lambda impl, a=(x, g, beta, wqkv, bqkv, wout, hl, s):
                     ops.attn_block_partial(*a[:6], num_heads=a[6],
                                            seq_len=a[7], impl=impl),
                     ((2 * m_rows * d + 4 * d * dl + 3 * dl + 2 * d) * e,
                      8 * m_rows * d * dl + att_ops, kind), primary=main),
                case("attn_block_q_partial",
                     f"{lbl} ({b},{sp},{d}) dl={dl} seq_len {s}",
                     lambda impl, a=(x, g, beta, qqkv, bqkv, qout, hl, s):
                     ops.attn_block_q_partial(
                         a[0], a[1], a[2], a[3]["q"], a[3]["scale"], a[4],
                         a[5]["q"], a[5]["scale"], num_heads=a[6],
                         seq_len=a[7], impl=impl),
                     (2 * m_rows * d * e + 4 * d * dl + 4 * (3 * dl + d)
                      + (3 * dl + 2 * d) * e, 8 * m_rows * d * dl + att_ops,
                      "int8"), check=compare_i8, primary=main),
            ]
            w1, b_m = rnd(d, ml, std=0.03), rnd(ml, std=0.02)
            w2 = rnd(ml, d, std=0.03)
            mlp_work = ((2 * m_rows * d + 2 * d * ml + ml + 2 * d) * e,
                        4 * m_rows * d * ml)
            if ops.mlp_plan(d, ml, dtype):
                cases.append(case(
                    "mlp_block_partial", f"{lbl} ({m_rows},{d}) mlp {ml}",
                    lambda impl, a=(x, g, beta, w1, b_m, w2, b_d):
                    ops.mlp_block(*a, partial_out=True, impl=impl),
                    (*mlp_work, kind), primary=main))
            if ops.mlp_q_plan(d, ml):
                q1, q2 = (quantize_weight(rnd(d, ml, std=0.03)),
                          quantize_weight(rnd(ml, d, std=0.03)))
                args = (x, g, beta, q1["q"], q1["scale"], b_m, q2["q"],
                        q2["scale"], b_d)
                work = ((2 * m_rows * d + ml + 2 * d) * e + 2 * d * ml
                        + 4 * (ml + d), 4 * m_rows * d * ml)
                cases += [
                    case("mlp_block_i8dot_partial",
                         f"{lbl} ({m_rows},{d}) mlp {ml}",
                         lambda impl, a=args: ops.mlp_block_i8dot(
                             *a, partial_out=True, impl=impl),
                         (*work, "int8"), check=compare_i8, primary=main),
                    case("mlp_block_q_partial",
                         f"{lbl} ({m_rows},{d}) mlp {ml}",
                         lambda impl, a=args: ops.mlp_block_q(
                             *a, partial_out=True, impl=impl),
                         (*work, kind), primary=main),
                ]
    return cases


def kernel_cases_layer(torch, dtype):
    """Phase 15's kernels alone. K18 (``layer_tail``: the out-projection,
    LN2 and the MLP from the attention context, y kept in fp32) at B/16
    bs=32 (6656 x 768, MLP 3072), the case the kernels line reports, and in
    bf16 at L/16 bs=8 (1664 x 1024, 4096); the whole ``layer_block`` (K1,
    K2, the core, K18) at B/16 bs=32, held to the model bars (the MLP half
    carries the attention half's rounding flips), timed as a block like
    K4. K19 ``patchify`` bit for bit at B/16 bs=32, H/14 bs=2 (P=14) and
    L/16-384 bs=8, against ``F.unfold`` (the port never calls it). K20 at
    the JAX test's (16, 128) over a grid of 2 with a condition no block
    meets, so that nothing prints while it is timed (phase 15 checks the
    printing). K21 at the example's (256, 384) @ (384, 512), against
    ``torch.matmul``. No PyTorch call computes K18, K20 or the layer."""
    import torch.nn.functional as F

    from vit_tpu_torch import ops
    from vit_tpu_torch.examples import minimal_matmul
    from vit_tpu_torch.ops import debug, reference
    from vit_tpu_torch.ops.cuda import block as cuda_block

    rnd = _rnd_fn(torch, dtype, 15)
    e, kind = dtype.itemsize, _kind(torch, dtype)
    cases = []
    shapes = [("B/16 bs=32", 32, 768, 3072, 12)]
    if dtype == torch.bfloat16:
        shapes.append(("L/16 bs=8", 8, 1024, 4096, 16))
    for tag, b, d, mlp, heads in shapes:
        m = b * 208
        tail = (rnd(m, d), rnd(m, d, std=1.5), rnd(d, d, std=0.03),
                rnd(d, std=0.02), rnd(d, std=0.1, mean=1.0),
                rnd(d, std=0.05), rnd(d, mlp, std=0.03), rnd(mlp, std=0.02),
                rnd(mlp, d, std=0.03), rnd(d, std=0.02))

        def run(impl, a=tail):
            fn = reference.layer_tail if impl == "torch" \
                else cuda_block.layer_tail
            return fn(*a)
        cases.append(case(
            "layer_block", f"K18 {tag} ({m},{d}) mlp {mlp}", run,
            ((3 * m * d + d * d + 2 * d * mlp + mlp + 5 * d) * e,
             2 * m * d * (d + 2 * mlp), kind), primary=tag == "B/16 bs=32"))
    b, sp, s, d, mlp, heads = 32, 208, 197, 768, 3072, 12
    m = b * sp
    layer = (rnd(b, sp, d, std=1.5), rnd(d, std=0.1, mean=1.0),
             rnd(d, std=0.05), rnd(d, 3 * d, std=0.04), rnd(3 * d, std=0.02),
             rnd(d, d, std=0.03), rnd(d, std=0.02), rnd(d, std=0.1, mean=1.0),
             rnd(d, std=0.05), rnd(d, mlp, std=0.03), rnd(mlp, std=0.02),
             rnd(mlp, d, std=0.03), rnd(d, std=0.02))
    cases.append(case(
        "full_layer", f"layer_block ({b},{sp},{d}) mlp {mlp} seq_len {s}",
        lambda impl: ops.layer_block(*layer, num_heads=heads, seq_len=s,
                                     impl=impl),
        ((2 * m * d + 4 * d * d + 2 * d * mlp + mlp + 10 * d) * e,
         2 * m * d * (4 * d + 2 * mlp)
         + attention_ops(b, heads, sp, s, d // heads), kind),
        check=compare_model))
    for tag, shape, p in (("B/16 bs=32", (32, 3, 224, 224), 16),
                          ("H/14 bs=2", (2, 3, 224, 224), 14),
                          ("L/16-384 bs=8", (8, 3, 384, 384), 16)):
        img = rnd(*shape)
        cases.append(case(
            "patchify", f"{tag} {shape} P={p}",
            lambda impl, x=img, p=p: ops.patchify(x, p, impl=impl),
            (2 * img.numel() * e, 0, "fp32"),
            library=lambda x=img, p=p: F.unfold(
                x, p, stride=p).transpose(1, 2).contiguous(),
            check=compare_exact, primary=tag == "B/16 bs=32"))
    small = rnd(16, 128)
    cases.append(case(
        "print_if", "(16,128) grid (2,), no block matching",
        lambda impl: debug.print_if_smoke(small, "=9", grid=(2,), impl=impl),
        (2 * small.numel() * e, small.numel(), "fp32"), check=compare_exact))
    x, w = rnd(256, 384, std=0.1), rnd(384, 512, std=0.1)
    cases.append(case(
        "minimal_matmul", "(256,384)@(384,512)",
        lambda impl: minimal_matmul.matmul(x, w, impl=impl),
        ((256 * 384 + 384 * 512 + 256 * 512) * e, 2 * 256 * 384 * 512,
         kind), library=lambda: torch.matmul(x, w)))
    return cases


def device_ms(torch, fn, iters: int = 20) -> tuple[float, dict]:
    """Device time of ``fn``'s kernels per call, from ``torch.profiler``
    (CUPTI): the sum over kernels, and the time of each kernel by name.
    Unlike :func:`time_ms` it leaves out the host's time between
    launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us > 0:
            by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + (
                us / iters / 1e3)
    return sum(by_name.values()), by_name


def layer_breakdown(torch) -> dict:
    """bf16 times of one B/16 layer's launches at bs=1 (208 rows): CUDA
    events around one call (host launch cost included) and device time
    (profiler). K2 runs the tile loop of K9's GEMM phases, one tile a
    block, so each stands for a phase of K9; the attention core for its
    attention phase; mlp_block is the per-layer route's MLP half."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import block as cuda_block

    rnd = _rnd_fn(torch, torch.bfloat16, 8)
    m, d, mlp, heads = 208, 768, 3072, 12
    x, h, qkv = rnd(m, d), rnd(m, mlp), rnd(m, 3 * d)
    g, beta = rnd(d, std=0.1, mean=1.0), rnd(d, std=0.05)
    w_dd, w_dq = rnd(d, d, std=0.04), rnd(d, 3 * d, std=0.04)
    w_dm, w_md = rnd(d, mlp, std=0.03), rnd(mlp, d, std=0.03)
    b_d, b_q, b_m = rnd(d), rnd(3 * d), rnd(mlp)
    cases = {
        "qkv (208,768)@(768,2304)": lambda: ops.matmul(x, w_dq, b_q),
        "attention core b=1": lambda: cuda_block.attention_core(
            qkv, batch=1, num_heads=heads, scale=64 ** -0.5, seq_len=197),
        "out-proj (208,768)@(768,768)+res": lambda: ops.matmul(
            x, w_dd, b_d, residual=x),
        "fc1 (208,768)@(768,3072)+gelu": lambda: ops.matmul(x, w_dm, b_m,
                                                            "gelu"),
        "fc2 (208,3072)@(3072,768)+res": lambda: ops.matmul(
            h, w_md, b_d, residual=x),
        "mlp_block (208,768) mlp 3072": lambda: ops.mlp_block(
            x, g, beta, w_dm, b_m, w_md, b_d),
    }
    return {label: {"event_ms": time_ms(torch, fn),
                    "device_ms": device_ms(torch, fn)[0]}
            for label, fn in cases.items()}


def route_times(torch, forward, params, cfg, bs: int, gen) -> dict:
    """bf16 forward ms and images/s at ``bs`` through the stack route, the
    per-layer kernel route and ``impl="torch"``, with each route's device
    busy time and idle share, and each kernel route's launches for one
    forward. Each forward gets the fold's base rows built once, as
    ``Predictor`` passes them."""
    from vit_tpu_torch.models.vit import fold_base
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    xb = torch.randn((bs, 3, cfg.image_size, cfg.image_size), generator=gen,
                     device="cuda").to(cfg.dtype)
    base = fold_base(params, cfg)
    res = {}
    with torch.inference_mode():
        for route in ("stack", "layers", "plain"):
            ctx = (per_layer_route() if route == "layers"
                   else contextlib.nullcontext())
            impl = "torch" if route == "plain" else None

            def fwd():
                return forward(params, xb, cfg, impl=impl, base=base)
            with ctx:
                if route != "plain":
                    reset_launch_counts()
                    fwd()
                    res[f"{route}_launches"] = {
                        k: v for k, v in launch_counts().items() if v}
                times = event_times(torch, fwd)
                busy, by_name = device_ms(torch, fwd)
            ms = float(np.median(times))
            res[f"{route}_ms"] = ms
            res[f"{route}_images_per_s"] = bs * 1e3 / ms
            # The share of a forward's event time with no kernel running:
            # the profiler's mean busy time per call over the mean event
            # time of the same number of calls, unclamped.
            res[f"{route}_mean_ms"] = float(np.mean(times))
            res[f"{route}_device_busy_ms"] = busy
            res[f"{route}_idle_share"] = 1 - busy / float(np.mean(times))
            if route == "stack":
                res["stack_kernels_ms"] = by_name
    return res


def per_layer_q(layers: int, **extra) -> dict:
    """Per-forward launches of the int8 per-layer route: ``layers`` times
    :data:`Q_LAYER`, plus ``extra``."""
    out = {k: v * layers for k, v in Q_LAYER.items()}
    for k, v in extra.items():
        out[k] = out.get(k, 0) + v
    return out


def rel_corr(torch, got, want) -> tuple[float, float]:
    """Relative norm of the difference and the correlation, in float64."""
    g, w = got.double().flatten(), want.double().flatten()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("non-finite values")
    rel = float((g - w).norm() / w.norm())
    corr = float(torch.corrcoef(torch.stack([g, w]))[0, 1])
    return rel, corr


def check_rel(label: str, rel: float, bar: float) -> None:
    if not rel <= bar:
        raise AssertionError(f"{label}: relative error {rel} > {bar}")


def check_int8_forward(torch, label: str, kern, plain, flt, *,
                       absolute: bool) -> dict:
    """An int8 forward through the kernels (``kern``) and its plain version
    (``plain``), both against the float forward of the same weights
    (``flt``). Dynamic activation quantization amplifies any difference:
    a value that moves by d flips codes with a probability of about d over
    the quantization step, and each flip moves the next product by a whole
    step, so after a few layers two evaluations of the same int8 model
    differ by about the step itself, as much as either differs from the
    float model. So the kernels are held to be as accurate as the plain
    version: their error against the float forward at most 1.25 times the
    plain version's, and the two within 5e-2 of each other; with
    ``absolute``, also within rel 5e-2 and corr 0.999 of the float forward
    (``tests/test_quant.py:95-96``)."""
    rel_kp, _ = rel_corr(torch, kern, plain)
    rel_k, corr_k = rel_corr(torch, kern, flt)
    rel_p, corr_p = rel_corr(torch, plain, flt)
    res = {"kernels_vs_plain_rel": rel_kp, "kernels_vs_float_rel": rel_k,
           "kernels_vs_float_corr": corr_k, "plain_vs_float_rel": rel_p,
           "plain_vs_float_corr": corr_p}
    log(f"[{label}] {res}")
    check_rel(f"{label} kernels vs plain", rel_kp, 5e-2)
    check_rel(f"{label} kernels vs float", rel_k, 1.25 * rel_p)
    if absolute:
        check_rel(f"{label} kernels vs float", rel_k, 5e-2)
        if not corr_k > 0.999:
            raise AssertionError(f"{label}: correlation {corr_k} <= 0.999")
    return res


def forward_stats(torch, fn) -> dict:
    """A forward's event time (median and mean of 20) and the card's busy
    time per call (profiler), with the idle share and the device time of
    each kernel per call."""
    times = event_times(torch, fn)
    busy, by_name = device_ms(torch, fn)
    mean = float(np.mean(times))
    return {"ms": float(np.median(times)), "mean_ms": mean,
            "device_busy_ms": busy, "idle_share": 1 - busy / mean,
            "kernels_ms": by_name}


def train_step_counts(forward: dict, layers: int, *, attn_remat: bool = True,
                      embed_dw: int = 1) -> dict:
    """One training step's launches: the forward's (``forward``), then the
    backward's. The head: dx and dw on K2. Each layer's MLP half (K3 in the
    forward) recomputes fc1 (K5 + K6) and fc2 (K2, counted as
    ``fused_linear``) and runs five products on K2 (fc2 dw, dh; fc1's
    pre-activation, dw, dh). Its attention half runs K13 once and four
    products (out-projection dw, dh; QKV dw, dh); where the forward ran the
    mega-kernel (``attn_remat``) it first recomputes QKV (K5 + K6), K7 and
    the out-projection (K2 as ``fused_linear``). ``embed_dw``: the patch
    projection's dw on K2 (none on the fold, whose remat is torch ops)."""
    out = dict(forward)
    bwd = {"layernorm_stats": layers, "fused_linear": 2 * layers,
           "matmul": 9 * layers + 2 + embed_dw, "flash_attention_bwd": layers}
    if attn_remat:
        bwd["layernorm_stats"] += layers
        bwd["fused_linear"] += 2 * layers
        bwd["flash_attention"] = layers
    for k, v in bwd.items():
        out[k] = out.get(k, 0) + v
    return out


def train_step_counts_unfused(layers: int) -> dict:
    """One training step on the unfused route (``attention="unfused"``):
    the forward's launches (:func:`route_counts`), then the backward's,
    with no remat, since no mega-kernel ran: nine products a layer on K2
    (the four linears' dw and dh, fc1's pre-activation), two K16 launches
    for each of the two matmul3 (dx, dy), the head's dx and dw and the
    patch projection's dw on K2."""
    out = route_counts("unfused", True, layers)
    out["matmul"] += 9 * layers + 3
    out["matmul3"] += 4 * layers
    return out


def train_grads(torch, params, cfg, px, labels, impl, attention="flash",
                layer_block=False):
    """The loss and every parameter's gradient (``tree_leaves`` order)."""
    from vit_tpu_torch.train import cross_entropy_loss
    from vit_tpu_torch.weights.convert import tree_leaves

    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss = cross_entropy_loss(params, px, labels, cfg, impl=impl,
                              attention=attention, layer_block=layer_block)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def check_train_grads(torch, label: str, got, want, dtype) -> float:
    """Every parameter has a finite, nonzero gradient within the training
    bar of the plain tier's; returns the worst ratio to the bar."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or not bool(torch.isfinite(g).all()) or not bool(
                g.abs().max() > 0):
            raise AssertionError(f"{label}: parameter {i} has no usable "
                                 "gradient")
        g, w = g.float(), w.float()
        if dtype == torch.float32:
            r = float((g - w).abs().max() / w.abs().max()) / TRAIN_F32_BAR
        else:
            r = float((g - w).norm() / w.norm()) / TRAIN_BF16_REL_BAR
        worst = max(worst, r)
        if r > 1:
            raise AssertionError(f"{label}: parameter {i} {tuple(g.shape)} "
                                 f"at {r:.3f} of its bar")
    return worst


def train_phase(torch, main_counts: dict) -> dict:
    """Phase 12: the training step (``vit_tpu_torch/train.py``) through the
    kernels, on the flash and the unfused route, against ``impl="torch"``,
    with exact launch counts; the loss of 3 AdamW steps on one batch; the
    step's times."""
    from vit_tpu_torch.config import VARIANTS
    from vit_tpu_torch.models.vit import init_params
    from vit_tpu_torch.ops import reference
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from vit_tpu_torch.train import make_optimizer, make_train_step
    from vit_tpu_torch.weights.convert import tree_leaves

    res = {}
    gen = torch.Generator(device="cuda").manual_seed(31)
    # K13 twice on one input: bit for bit (no atomics).
    c = kernel_cases_train(torch, torch.bfloat16)[0]
    first, again = c["run"]("cuda"), c["run"]("cuda")
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("flash_attention_bwd is not deterministic")
    dk, dv = reference.split_qkv(first)[1:]
    if dk[:, :, 197:].any() or dv[:, :, 197:].any():
        raise AssertionError("flash_attention_bwd: masked keys have "
                             "nonzero dk or dv")
    log("[train] flash_attention_bwd: two calls equal bit for bit; masked "
        "keys get zero dk, dv")
    del first, again

    b16 = dict(PER_FORWARD)
    cases = (
        # (tag, variant, dtype, layers, bs, attention, the step's launches:
        #  the forward's, attention remat, patch projection dw on K2)
        ("B/16 fp32 bs=32", "B/16", torch.float32, 12, 32, "flash",
         train_step_counts(b16, 12)),
        ("B/16 bf16 bs=32", "B/16", torch.bfloat16, 12, 32, "flash",
         train_step_counts(b16, 12)),
        ("B/16 bf16 bs=2", "B/16", torch.bfloat16, 12, 2, "flash",
         train_step_counts(PER_FORWARD_STACK, 12, embed_dw=0)),
        ("B/16 bf16 bs=4", "B/16", torch.bfloat16, 12, 4, "flash",
         train_step_counts(dict(b16, embed_fused=1, matmul=25), 12)),
        ("L/16-384 bf16 bs=2, 4 layers", "L/16-384", torch.bfloat16, 4, 2,
         "flash", train_step_counts(
             {"embed_fused": 1, "layernorm_stats": 4, "fused_linear": 8,
              "flash_attention": 4, "mlp_block": 4, "layernorm": 1,
              "matmul": 1}, 4, attn_remat=False)),
        ("B/16 unfused bf16 bs=32", "B/16", torch.bfloat16, 12, 32,
         "unfused", train_step_counts_unfused(12)),
        ("B/16 unfused fp32 bs=8", "B/16", torch.float32, 12, 8, "unfused",
         train_step_counts_unfused(12)),
    )
    for tag, variant, dtype, layers, bs, attention, step_counts in cases:
        cfg = VARIANTS[variant].replace(dtype=dtype, num_classes=1000,
                                        num_layers=layers)
        params = init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(32), device="cuda")
        px = torch.randn((bs, 3, cfg.image_size, cfg.image_size),
                         generator=gen, device="cuda")
        labels = torch.randint(0, 1000, (bs,), generator=gen, device="cuda")
        want_loss, want = train_grads(torch, params, cfg, px, labels, "torch",
                                      attention)
        init_fn, step_fn = make_train_step(cfg, make_optimizer(1e-4, 0.05),
                                           attention=attention)
        opt = init_fn(params)
        torch.cuda.synchronize()
        reset_launch_counts()
        params, opt, loss = step_fn(params, opt, px, labels)
        torch.cuda.synchronize()
        main_counts[f"{tag} train step"] = counts = launch_counts()
        check_counts(f"{tag} train step", counts,
                     expect_counts(counts, step_counts))
        got = [t.grad for t in tree_leaves(params)]
        worst = check_train_grads(torch, tag, got, want, dtype)
        dl = abs(float(loss) - float(want_loss))
        bar = 1e-4 if dtype == torch.float32 else MODEL_BF16_REL_BAR * (
            1 + abs(float(want_loss)))
        if not dl <= bar:
            raise AssertionError(f"{tag}: loss {float(loss)} vs "
                                 f"{float(want_loss)}")
        entry = {"loss": float(loss), "plain_loss": float(want_loss),
                 "worst_grad_vs_bar": worst}
        if tag == "B/16 fp32 bs=32":
            # Two more AdamW steps on the same batch: the loss falls.
            losses = [float(loss)]
            for _ in range(2):
                params, opt, loss = step_fn(params, opt, px, labels)
                losses.append(float(loss))
            if not (np.isfinite(losses).all() and losses[2] < losses[0]):
                raise AssertionError(f"{tag}: losses {losses} do not fall")
            entry["losses_3_steps"] = losses
        log(f"[train] {tag}: {entry}; launches {counts}")
        res[tag] = entry
        del params, opt, got, want
        torch.cuda.empty_cache()

    # The step's times at B/16 bs=32, kernels and plain, in each dtype.
    for dtype in (torch.bfloat16, torch.float32):
        cfg = VARIANTS["B/16"].replace(dtype=dtype, num_classes=1000)
        px = torch.randn((32, 3, 224, 224), generator=gen, device="cuda")
        labels = torch.randint(0, 1000, (32,), generator=gen, device="cuda")
        dname = str(dtype).replace("torch.", "")
        for impl in (None, "torch"):
            params = init_params(cfg, generator=torch.Generator(
                device="cuda").manual_seed(33), device="cuda")
            init_fn, step_fn = make_train_step(cfg,
                                               make_optimizer(1e-4, 0.05),
                                               impl=impl)
            opt = init_fn(params)

            def step():
                return step_fn(params, opt, px, labels)
            times = event_times(torch, step, iters=10, warmup=2)
            busy, by_name = device_ms(torch, step, iters=3)
            mean = float(np.mean(times))
            ms = float(np.median(times))
            tier = "kernels" if impl is None else "plain"
            res[f"step_b16_{dname}_bs32_{tier}"] = {
                "ms": ms, "images_per_s": 32e3 / ms, "mean_ms": mean,
                "device_busy_ms": busy, "idle_share": 1 - busy / mean,
                "kernels_ms": dict(sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:8])}
            log(f"[train] B/16 {dname} bs=32 step, {tier}: {ms:.2f} ms "
                f"({32e3 / ms:.1f} images/s), idle {1 - busy / mean:.3f}")
            del params, opt
            torch.cuda.empty_cache()
    return res


def bucket_forwards(torch, pred, fwd, req):
    """``req`` through ``fwd`` one bucket at a time as ``pred`` plans it,
    the tail padded with zero images: what ``pred(req)`` must equal bit for
    bit (every kernel is deterministic)."""
    off, parts = 0, []
    for b in pred._plan(req.shape[0]):
        chunk = req[off:off + b].to(pred.cfg.dtype)
        if chunk.shape[0] < b:
            chunk = torch.cat([chunk, chunk.new_zeros(
                (b - chunk.shape[0], *chunk.shape[1:]))])
        parts.append(fwd(chunk))
        off += b
    return torch.cat(parts)[:req.shape[0]]


def forward_modes_phase(torch, main_counts: dict, cfg, params, cfg_l, p_l,
                        q_l) -> None:
    """Phase 13: the JAX package's other forward modes through the kernels.
    B/16 bf16 at bs=32, full depth, on each of (``attention``, ``fused``)
    = (unfused, False), (unfused, True), (flash, False) against
    ``impl="torch"`` at the model bars; ``Predictor(attention="unfused")``
    and ``Predictor(quant=True, int8_dot=False)`` answering requests of 1,
    5 and 32, each request equal to its bucket forwards bit for bit; the
    weight-only int8 MLP at L/16-384 bf16 bs=8, as accurate as its plain
    version. Exact launch counts throughout."""
    from vit_tpu_torch.models.vit import forward
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from vit_tpu_torch.quant import forward_quant
    from vit_tpu_torch.serving import Predictor

    gen = torch.Generator(device="cuda").manual_seed(41)
    xb = torch.randn((32, 3, 224, 224), generator=gen,
                     device="cuda").to(cfg.dtype)
    with torch.inference_mode():
        for attention, fused in (("unfused", False), ("unfused", True),
                                 ("flash", False)):
            tag = f"B/16 bf16 bs=32 {attention} fused={fused}"
            reset_launch_counts()
            got = forward(params, xb, cfg, attention=attention, fused=fused)
            torch.cuda.synchronize()
            main_counts[tag] = counts = launch_counts()
            check_counts(tag, counts, expect_counts(
                counts, route_counts(attention, fused)))
            res = compare_model(torch, got, forward(
                params, xb, cfg, attention=attention, fused=fused,
                impl="torch"), torch.bfloat16)
            log(f"[modes] {tag}, kernels vs impl=torch: {res}; launches "
                f"{counts}")

    sizes = (1, 5, 32)
    requests = [torch.randn((n, 3, 224, 224), generator=gen, device="cuda")
                for n in sizes]
    pred_u = Predictor(params, cfg, buckets=(1, 8, 32), attention="unfused")
    pred_w = Predictor(params, cfg, buckets=(1, 8, 32), quant=True,
                       int8_dot=False)
    # bs=1 takes the int8 stack route (weight-only already), bs=32 the
    # per-layer route with K17.
    weight_only = {1: PER_FORWARD_Q_STACK,
                   32: q_weight_only(per_layer_q(12, matmul=2, layernorm=1))}
    for tag, pred, fwd, per_bucket in (
            ("B/16 unfused serving", pred_u,
             lambda x: forward(params, x, cfg, attention="unfused"),
             lambda b: route_counts("unfused", True)),
            ("B/16 int8 int8_dot=False serving", pred_w,
             lambda x: forward_quant(pred_w.params, x, cfg, int8_dot=False),
             weight_only.__getitem__)):
        torch.cuda.synchronize()
        reset_launch_counts()
        answers = [pred(r) for r in requests]
        torch.cuda.synchronize()
        main_counts[tag] = counts = launch_counts()
        plans = [b for n in sizes for b in pred._plan(n)]
        if sorted(plans) != [1] * 6 + [32]:
            raise AssertionError(f"{tag} plans {plans}")
        check_counts(tag, counts, add_counts(
            *(expect_counts(counts, per_bucket(b)) for b in plans)))
        with torch.inference_mode():
            for n, req, ans in zip(sizes, requests, answers):
                if tuple(ans.shape) != (n, 1000):
                    raise AssertionError(f"{tag} request {n}: shape "
                                         f"{tuple(ans.shape)}")
                if not torch.equal(ans, bucket_forwards(torch, pred, fwd,
                                                        req)):
                    raise AssertionError(f"{tag} request {n} != its bucket "
                                         "forwards")
        log(f"[modes] {tag}: requests {sizes} == their bucket forwards, bit "
            f"for bit; launches {counts}")
    del pred_u, pred_w

    with torch.inference_mode():
        px = torch.randn((8, 3, 384, 384), generator=gen,
                         device="cuda").to(cfg_l.dtype)
        reset_launch_counts()
        got = forward_quant(q_l, px, cfg_l, int8_dot=False)
        torch.cuda.synchronize()
        tag = "L/16-384 int8 int8_dot=False bs=8"
        main_counts[tag] = counts = launch_counts()
        check_counts(tag, counts, expect_counts(counts, q_weight_only(
            per_layer_q(24, matmul=2, layernorm=1))))
        log(f"[modes] {tag}, 24 layers; launches {counts}")
        check_int8_forward(torch, f"{tag} logits", got, forward_quant(
            q_l, px, cfg_l, impl="torch", int8_dot=False),
            forward(p_l, px, cfg_l), absolute=False)


def tp_counts(layers: int, *, quant: bool = False, mlp_mega: bool = True,
              head: bool = True, int8_dot: bool = True) -> dict:
    """Per-forward launches of ``make_tp_forward`` on one rank: the patch
    projection (the embedding takes no ``sp``, as JAX's), each layer's
    attention partial (B16: K1, K2, the core, K2; B17: K10, K11, K7, K10,
    K11) and MLP partial (K3 / K12 with ``partial_out``, else composed: K1,
    K2, K2 / K10, K11, K10, K11; K17 for K12 without ``int8_dot``), the
    final LN and the head."""
    out = {"matmul": 1 + int(head), "layernorm": 1}
    if quant:
        out.update(quantize_rows=2 * layers, matmul_i8=2 * layers,
                   flash_attention=layers)
        if mlp_mega:
            out["mlp_block_i8dot_partial" if int8_dot
                else "mlp_block_q_partial"] = layers
        else:
            out["quantize_rows"] += 2 * layers
            out["matmul_i8"] += 2 * layers
        return out
    out["attention"] = layers
    out["layernorm"] += layers
    out["matmul"] += 2 * layers
    if mlp_mega:
        out["mlp_block_partial"] = layers
    else:
        out["layernorm"] += layers
        out["matmul"] += 2 * layers
    return out


#: Phase 14's two ranks: the models they build from these seeds, so that
#: the parent builds the same ones for the single-device references.
TP_SEEDS = {"b16": 61, "h14": 62, "pixels": 63, "train": 64}


def _tp_models(torch, tag: str):
    """(config, params) of phase 14's models: B/16 bf16 with a 1000-class
    head, and H/14 bf16 at 4 layers (``pooling="cls"``)."""
    from vit_tpu_torch.config import VARIANTS
    from vit_tpu_torch.models.vit import init_params

    cfg = (VARIANTS["B/16"].replace(dtype=torch.bfloat16, num_classes=1000)
           if tag == "b16" else
           VARIANTS["H/14"].replace(dtype=torch.bfloat16, num_layers=4))
    return cfg, init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(TP_SEEDS[tag]), device="cuda")


def _tp_inputs(torch):
    """Phase 14's inputs, the same in every process: B/16 pixels at bs=8,
    H/14 at bs=2, serving requests of 1, 5 and 8, training labels."""
    gen = torch.Generator(device="cuda").manual_seed(TP_SEEDS["pixels"])
    px = {"b16": torch.randn((8, 3, 224, 224), generator=gen, device="cuda"),
          "h14": torch.randn((2, 3, 224, 224), generator=gen, device="cuda"),
          "requests": [torch.randn((n, 3, 224, 224), generator=gen,
                                   device="cuda") for n in (1, 5, 8)],
          "labels": torch.randint(0, 1000, (8,), generator=gen,
                                  device="cuda")}
    return px


def tp_rank_main(rank: int, world: int, store: str, out_dir: str) -> int:
    """One of phase 14's two ranks on the one card (``chip_smoke.py
    --tp-rank``): gloo over a ``file://`` store, a data=1 x model=2 mesh
    for tensor parallelism and a data=2 x model=1 mesh for batch
    parallelism, both on ``cuda:0``. Runs the TP forward at B/16 bf16 bs=8
    (12 layers: float, int8 with K12 and with K17) and H/14 bf16 bs=2 (4
    layers), TP serving
    of requests 1, 5 and 8 (each held here to its bucket forwards, bit for
    bit), a DP forward and one DP train step at B/16 bf16 bs=8, each with
    its launch counts; writes the outputs and counts to ``out_dir`` for
    the parent, which holds them to the single-device forwards."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from vit_tpu_torch.parallel import (make_mesh, make_tp_forward,
                                        prepare_tp_params)
    from vit_tpu_torch.quant import quantize_params
    from vit_tpu_torch.serving import Predictor
    from vit_tpu_torch.train import make_optimizer, make_train_step

    dist_backend = dist.get_backend()
    log(f"[tp rank {rank}] backend {dist_backend}, world {world}, "
        f"{torch.cuda.get_device_name(0)}")
    tp_mesh = make_mesh(1, 2, device="cuda:0")
    dp_mesh = make_mesh(2, 1, device="cuda:0")
    counts, outs, times = {}, {}, {}

    def counted(tag, fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts[tag] = launch_counts()
        return out

    inputs = _tp_inputs(torch)
    cfg, params = _tp_models(torch, "b16")
    cfg_h, p_h = _tp_models(torch, "h14")
    with torch.inference_mode():
        for tag, c, p, px, q, dot in (
                ("b16", cfg, params, inputs["b16"], False, True),
                ("b16_int8", cfg, params, inputs["b16"], True, True),
                ("b16_int8_weight_only", cfg, params, inputs["b16"], True,
                 False),
                ("h14", cfg_h, p_h, inputs["h14"], False, True)):
            tp = prepare_tp_params(quantize_params(p) if q else p, c, tp_mesh)
            fn = make_tp_forward(c, tp_mesh, quant=q, int8_dot=dot)
            outs[tag] = counted(f"TP {tag}", lambda: fn(tp, px)).cpu()
            # Host clock around synchronised forwards (both ranks in step).
            t = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn(tp, px)
                torch.cuda.synchronize()
                t.append((time.perf_counter() - t0) * 1e3)
            times[f"TP {tag}"] = float(np.median(t))
            del tp
        pred = Predictor(params, cfg, buckets=(1, 8), mesh=tp_mesh)
        answers = counted("TP serving", lambda: [
            pred(r) for r in inputs["requests"]])
        fn = make_tp_forward(cfg, tp_mesh)
        for r, a in zip(inputs["requests"], answers):
            if not torch.equal(a, bucket_forwards(
                    torch, pred, lambda x: fn(pred.params, x), r)):
                raise AssertionError(f"TP serving request {r.shape[0]} != "
                                     "its bucket forwards")
        outs["serving"] = [a.cpu() for a in answers]
        del pred
        pred_dp = Predictor(params, cfg, buckets=(8,), mesh=dp_mesh)
        outs["dp_forward"] = counted(
            "DP forward", lambda: pred_dp(inputs["b16"])).cpu()
        del pred_dp
    _, tparams = _tp_models(torch, "b16")
    init_fn, step_fn = make_train_step(cfg, make_optimizer(1e-4, 0.05),
                                       mesh=dp_mesh)
    opt = init_fn(tparams)
    _, _, loss = counted("DP train step", lambda: step_fn(
        tparams, opt, inputs["b16"], inputs["labels"]))
    from vit_tpu_torch.weights.convert import tree_leaves
    outs["dp_loss"] = loss.cpu()
    if rank == 0:
        outs["dp_grads"] = [t.grad.cpu() for t in tree_leaves(tparams)]
    dist.barrier()
    dist.destroy_process_group()
    torch.save(outs, os.path.join(out_dir, f"rank{rank}.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"counts": counts, "backend": dist_backend,
                   "ms": times}, f)
    log(f"[tp rank {rank}] done")
    return 0


def tp_phase(torch, main_counts: dict) -> dict:
    """Phase 14, tensor and batch parallelism on the one card: (a) the
    shards' partial sums plus bias and residual against the whole-block
    kernels (model bars) at B/16 bf16 bs=8 over model=2 and 4; (b) two
    ranks spawned with gloo (:func:`tp_rank_main`), their exact launch
    counts, and their outputs held to the single-device forwards: the TP
    forwards at the model bar, the int8 one as accurate against the float
    forward as the single-device int8 forward, serving requests at the
    model bar, the DP forward likewise, the DP train step's gradients at
    the training bar. A rank's failure fails the phase."""
    import shutil
    import tempfile

    from vit_tpu_torch import ops
    from vit_tpu_torch.models.vit import forward
    from vit_tpu_torch.parallel import Mesh, prepare_tp_params
    from vit_tpu_torch.quant import forward_quant, quantize_params

    res = {}
    t0 = time.perf_counter()
    # (a) One B/16 layer's shards summed against the whole block.
    cfg, params = _tp_models(torch, "b16")
    dev = torch.device("cuda", torch.cuda.current_device())
    lp = {k: {kk: vv[0] for kk, vv in v.items()}
          for k, v in params["encoder"].items()}
    gen = torch.Generator(device="cuda").manual_seed(65)
    x = (torch.randn((8, 208, 768), generator=gen, device="cuda")
         * 1.5).to(torch.bfloat16)
    x[:, 197:] = 0
    with torch.inference_mode():
        whole_a = ops.attn_block(x, lp["ln1"]["scale"], lp["ln1"]["bias"],
                                 lp["qkv"]["kernel"], lp["qkv"]["bias"],
                                 lp["out"]["kernel"], lp["out"]["bias"],
                                 num_heads=12, seq_len=197)
        whole_m = ops.mlp_block(x, lp["ln2"]["scale"], lp["ln2"]["bias"],
                                lp["fc1"]["kernel"], lp["fc1"]["bias"],
                                lp["fc2"]["kernel"], lp["fc2"]["bias"])
        for model in (2, 4):
            shards = [prepare_tp_params(params, cfg, Mesh(1, model, r, dev))
                      for r in range(model)]
            pa = pm = None
            for sh in shards:
                s = {k: {kk: vv[0] for kk, vv in v.items()}
                     for k, v in sh["encoder"].items()}
                a = ops.attn_block_partial(
                    x, s["ln1"]["scale"], s["ln1"]["bias"],
                    s["qkv"]["kernel"], s["qkv"]["bias"], s["out"]["kernel"],
                    num_heads=12 // model, seq_len=197)
                m = ops.mlp_block(x, s["ln2"]["scale"], s["ln2"]["bias"],
                                  s["fc1"]["kernel"], s["fc1"]["bias"],
                                  s["fc2"]["kernel"], s["fc2"]["bias"],
                                  partial_out=True)
                pa, pm = (a, m) if pa is None else (pa + a, pm + m)
            for half, got, want in (
                    ("attention", x + pa + lp["out"]["bias"], whole_a),
                    ("MLP", x + pm + lp["fc2"]["bias"], whole_m)):
                r = compare_model(torch, got[:, :197], want[:, :197],
                                  torch.bfloat16)
                res[f"shard_sum_{half}_model{model}"] = r
                log(f"[tp] B/16 bf16 bs=8 {half}: {model} shards summed + "
                    f"bias + x vs the whole block: {r}")
            del shards
    del params, lp

    # (b) Two ranks on the one card.
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_",
                            dir=os.path.join(HERE, "build"))
    try:
        procs = []
        for r in range(2):
            logf = open(os.path.join(work, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--tp-rank", str(r), "--world", "2", "--store",
                 os.path.join(work, "store"), "--out", work],
                stdout=logf, stderr=subprocess.STDOUT, cwd=HERE), logf))
        failed, deadline = [], time.monotonic() + 300
        for r, (p, logf) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            logf.close()
            text = open(os.path.join(work, f"rank{r}.log")).read()
            log("\n".join(f"  {line}" for line in text.splitlines()[-8:]))
            if rc != 0:
                failed.append(f"rank {r}: {rc}\n{text[-3000:]}")
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if failed:
            raise AssertionError("a tensor-parallel rank failed: "
                                 + "\n".join(failed))
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
        info = [json.load(open(os.path.join(work, f"rank{r}.json")))
                for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["ranks_s"] = time.perf_counter() - t0
    res["rank_ms"] = [inf["ms"] for inf in info]
    log(f"[tp] two ranks on one card, backend {info[0]['backend']}: done "
        f"({res['ranks_s']:.1f} s with (a)); forward ms (host clock, median "
        f"of 5) {res['rank_ms']}")

    expect = {
        "TP b16": tp_counts(12), "TP b16_int8": tp_counts(12, quant=True),
        "TP b16_int8_weight_only": tp_counts(12, quant=True,
                                             int8_dot=False),
        "TP h14": tp_counts(4, mlp_mega=False, head=False),
        # Requests 1, 5, 8 on buckets (1, 8): six bs=1 and one bs=8.
        "TP serving": {k: 7 * v for k, v in tp_counts(12).items()},
        # bs=4 a rank: embed_fused, the per-layer route, the head.
        "DP forward": dict(PER_FORWARD, embed_fused=1, matmul=25),
        "DP train step": train_step_counts(
            dict(PER_FORWARD, embed_fused=1, matmul=25), 12)}
    for r, inf in enumerate(info):
        for tag, want in expect.items():
            got = inf["counts"][tag]
            check_counts(f"rank {r} {tag}", got, expect_counts(got, want))
            main_counts[f"rank {r} {tag}"] = got
    for key in ("b16", "b16_int8", "b16_int8_weight_only", "h14",
                "dp_forward", "dp_loss"):
        if not torch.equal(ranks[0][key], ranks[1][key]):
            raise AssertionError(f"the ranks' {key} differ")
    cfg, params = _tp_models(torch, "b16")
    cfg_h, p_h = _tp_models(torch, "h14")
    inputs = _tp_inputs(torch)
    with torch.inference_mode():
        px = inputs["b16"].to(cfg.dtype)
        flt = forward(params, px, cfg)
        t = []
        for _ in range(5):
            t1 = time.perf_counter()
            forward(params, px, cfg)
            torch.cuda.synchronize()
            t.append((time.perf_counter() - t1) * 1e3)
        res["single_device_b16_bs8_ms"] = float(np.median(t))
        for key, want in (("b16", flt),
                          ("h14", forward(p_h, inputs["h14"].to(cfg.dtype),
                                          cfg_h)),
                          ("dp_forward", flt)):
            r = compare_model(torch, ranks[0][key].cuda(), want,
                              torch.bfloat16)
            res[key] = r
            log(f"[tp] {key} vs the single-device forward: {r}")
        qparams = quantize_params(params)
        for key, dot in (("b16_int8", True), ("b16_int8_weight_only", False)):
            res[key] = check_int8_forward(
                torch, f"tp {key} B/16 bf16 bs=8 logits",
                ranks[0][key].cuda(),
                forward_quant(qparams, px, cfg, int8_dot=dot), flt,
                absolute=False)
        for n, req, ans in zip((1, 5, 8), inputs["requests"],
                               ranks[0]["serving"]):
            if tuple(ans.shape) != (n, 1000):
                raise AssertionError(f"TP request {n}: {tuple(ans.shape)}")
            r = compare_model(torch, ans.cuda(), forward(
                params, req.to(cfg.dtype), cfg), torch.bfloat16)
            log(f"[tp] serving request {n} vs forward at bs={n}: {r}")
    del params
    _, tparams = _tp_models(torch, "b16")
    want_loss, want = train_grads(torch, tparams, cfg, inputs["b16"],
                                  inputs["labels"], None)
    got = [g.cuda() for g in ranks[0]["dp_grads"]]
    worst = check_train_grads(torch, "DP train step", got, want,
                              torch.bfloat16)
    dl = abs(float(ranks[0]["dp_loss"]) - float(want_loss))
    if not dl <= MODEL_BF16_REL_BAR * (1 + abs(float(want_loss))):
        raise AssertionError(f"DP loss {float(ranks[0]['dp_loss'])} vs "
                             f"{float(want_loss)}")
    res["dp_train"] = {"loss": float(ranks[0]["dp_loss"]),
                       "single_loss": float(want_loss),
                       "worst_grad_vs_bar": worst}
    log(f"[tp] DP train step (2 ranks x 4 images) vs one step on the 8: "
        f"{res['dp_train']}")
    res["phase_s"] = time.perf_counter() - t0
    return res


def layer_route_counts(layers: int, *, head: bool = True,
                       embed_fused: bool = False) -> dict:
    """Per-forward launches of a model on the layer route: ``layers`` times
    :data:`LAYER_ROUTE`, the final LN, the patch projection on K2 (or
    ``embed_fused``) and the head."""
    out = {k: v * layers for k, v in LAYER_ROUTE.items()}
    out["layernorm"] += 1
    out["matmul"] += int(head) + int(not embed_fused)
    if embed_fused:
        out["embed_fused"] = 1
    return out


def capture_stdout(torch, fn):
    """``fn()``, then synchronise, and what the process wrote to its
    standard output meanwhile (file descriptor 1: the device's printf lands
    there at the synchronisation, through C's stdio, flushed here)."""
    import ctypes
    import tempfile

    libc = ctypes.CDLL(None)
    sys.stdout.flush()
    libc.fflush(None)
    saved = os.dup(1)
    with tempfile.TemporaryFile() as tmp:
        os.dup2(tmp.fileno(), 1)
        try:
            out = fn()
            torch.cuda.synchronize()
            libc.fflush(None)
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        tmp.seek(0)
        return out, tmp.read().decode()


def layer_phase(torch, main_counts: dict) -> dict:
    """Phase 15: the full-layer route (``layer_block=True``: K1, K2, the
    attention core and K18 a layer, the activation between the halves in
    fp32) and the standalone kernels, each through the entry point a user
    calls, with exact launch counts: the golden fp32 B/16 bs=2; K18's
    rounding point (bf16, the CPU pin's seed-5 inputs: the K18 route within
    the kernel mean bar of the plain layer, the y-rounding pair outside
    it); B/16 bf16 bs=32 at full depth against ``impl="torch"`` and the default route, in
    turns with its times and idle share, and one layer's ``layer_block``
    against K4 + K3 on the same inputs; ``Predictor(layer_block=True)`` on
    buckets (1, 8, 32) (bs=1 stays on the stack route); L/16 bf16 bs=8 at
    4 layers; one B/16 bf16 bs=32 train step; K20's printed lines at grids
    (2,) and (3, 4); ``ops.patchify`` at B/16 bs=32; the minimal matmul
    example's ``main``."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.config import VARIANTS
    from vit_tpu_torch.examples import minimal_matmul
    from vit_tpu_torch.models.vit import forward, init_params
    from vit_tpu_torch.ops import debug
    from vit_tpu_torch.ops.cuda import (KERNELS, launch_counts,
                                        reset_launch_counts)
    from vit_tpu_torch.serving import Predictor
    from vit_tpu_torch.train import make_optimizer, make_train_step
    from vit_tpu_torch.weights.convert import tree_leaves
    from vit_tpu_torch.weights.hf import params_from_state_dict
    from vit_tpu_torch.weights.synthetic import (golden_pixels,
                                                 synthetic_hf_state_dict)

    zero = dict.fromkeys(KERNELS, 0)
    res = {}
    gen = torch.Generator(device="cuda").manual_seed(71)

    def counted(tag, fn, expect):
        """``fn()`` with the counts set to 0 before and read after, held
        to ``expect`` (every kernel)."""
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        main_counts[tag] = counts = launch_counts()
        check_counts(tag, counts, expect)
        return out

    # The golden weights through the layer route, fp32 bs=2: embed_fused,
    # then one layer_block a layer.
    fx = np.load(os.path.join(HERE, "tests", "fixtures", "golden_b16.npz"))
    cfg32 = VARIANTS["B/16"]
    params32 = params_from_state_dict(synthetic_hf_state_dict(
        cfg32, seed=int(fx["weights_seed"])), cfg32, device="cuda")
    px = torch.from_numpy(
        golden_pixels(cfg32, seed=int(fx["pixels_seed"]))).cuda()
    with torch.inference_mode():
        got = counted("B/16 golden layer route",
                      lambda: forward(params32, px, cfg32, layer_block=True),
                      expect_counts(zero, layer_route_counts(
                          12, head=False, embed_fused=True)))
    gdiff = float((got.float() - torch.from_numpy(
        fx["final_hidden"]).cuda()).abs().max())
    log(f"[layer] golden fp32 bs=2 through layer_block max|diff| "
        f"{gdiff:.3e}")
    if not gdiff < GOLDEN_BAR:
        raise AssertionError(f"layer route golden max|diff| {gdiff} >= "
                             f"{GOLDEN_BAR}")
    res["golden_max_abs_diff"] = gdiff
    del params32

    # K18's rounding point, at the CPU pin's inputs (tests/test_block.py's
    # _layer_inputs, seed 5, seq_len 27, bf16): over the real rows the kernel
    # route is within the mean bar of the plain layer_block, and the plain
    # pair attn_block -> mlp_block, which rounds y between the halves, is
    # not.
    rng = np.random.default_rng(5)
    b, s, d, mlp, seq_len = 2, 32, 256, 512, 27
    arr = lambda *sh, sc=0.1: (  # noqa: E731
        rng.standard_normal(sh) * sc).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    x[:, seq_len:] = 0
    args = [torch.from_numpy(a).to("cuda", torch.bfloat16) for a in (
        x, arr(d, sc=0.5) + 1, arr(d), arr(d, 3 * d), arr(3 * d),
        arr(d, d), arr(d), arr(d, sc=0.5) + 1, arr(d), arr(d, mlp),
        arr(mlp), arr(mlp, d), arr(d))]
    kw = dict(num_heads=4, seq_len=seq_len)
    want = ops.reference.layer_block(*args, **kw)[:, :seq_len].float()
    got = ops.layer_block(*args, **kw, impl="cuda")[:, :seq_len].float()
    pair = ops.reference.mlp_block(ops.reference.attn_block(
        *args[:7], **kw), *args[7:])[:, :seq_len].float()
    d_got = float((got - want).abs().mean())
    d_pair = float((pair - want).abs().mean())
    log(f"[layer] rounding point, bf16 seed 5: mean|diff| vs the plain "
        f"layer_block: K18 route {d_got:.3e}, rounded pair {d_pair:.3e} "
        f"(bar {BF16_MEAN_BAR})")
    if not d_got <= BF16_MEAN_BAR < d_pair:
        raise AssertionError(f"layer_block rounding point: K18 route "
                             f"{d_got}, pair {d_pair}")
    res["rounding_point_mean_abs_diff"] = {"k18_route": d_got,
                                           "rounded_pair": d_pair}

    # B/16 bf16 bs=32, full depth: against impl="torch" and the default
    # route; times in turns (default, layer, layer, default).
    cfg = VARIANTS["B/16"].replace(dtype=torch.bfloat16, num_classes=1000)
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(72), device="cuda")
    xb = torch.randn((32, 3, 224, 224), generator=gen,
                     device="cuda").to(cfg.dtype)
    with torch.inference_mode():
        def layer_fwd():
            return forward(params, xb, cfg, layer_block=True)

        def default_fwd():
            return forward(params, xb, cfg)
        got = counted("B/16 bf16 bs=32 layer route", layer_fwd,
                      expect_counts(zero, layer_route_counts(12)))
        vs_plain = compare_model(torch, got, forward(
            params, xb, cfg, layer_block=True, impl="torch"), torch.bfloat16)
        vs_default = compare_model(torch, got, default_fwd(), torch.bfloat16)
        runs = [forward_stats(torch, fn) for fn in (
            default_fwd, layer_fwd, layer_fwd, default_fwd)]
        for r in runs:
            r["kernels_ms"] = dict(sorted(r["kernels_ms"].items(),
                                          key=lambda kv: -kv[1])[:6])
        res["b16_bf16_bs32"] = {"vs_plain": vs_plain,
                                "vs_default_route": vs_default,
                                "default": [runs[0], runs[3]],
                                "layer": [runs[1], runs[2]]}
        log(f"[layer] B/16 bf16 bs=32, 12 layers: vs impl=torch {vs_plain}, "
            f"vs the default route {vs_default}; ms default "
            f"{runs[0]['ms']:.3f}/{runs[3]['ms']:.3f}, layer "
            f"{runs[1]['ms']:.3f}/{runs[2]['ms']:.3f}; idle default "
            f"{runs[0]['idle_share']:.3f}, layer {runs[1]['idle_share']:.3f}")
        # One layer's block against K4's block + K3 on the same inputs.
        lp = {n: {k: t[0] for k, t in p.items()}
              for n, p in params["encoder"].items()}
        attn = (lp["ln1"]["scale"], lp["ln1"]["bias"], lp["qkv"]["kernel"],
                lp["qkv"]["bias"], lp["out"]["kernel"], lp["out"]["bias"])
        mlp = (lp["ln2"]["scale"], lp["ln2"]["bias"], lp["fc1"]["kernel"],
               lp["fc1"]["bias"], lp["fc2"]["kernel"], lp["fc2"]["bias"])
        x3 = torch.randn((32, 208, 768), generator=gen,
                         device="cuda").to(cfg.dtype)
        kw = dict(num_heads=12, seq_len=197)

        def block():
            return ops.layer_block(x3, *attn, *mlp, **kw)

        def pair():
            return ops.mlp_block(ops.attn_block(x3, *attn, **kw), *mlp)
        t = [time_ms(torch, fn) for fn in (pair, block, block, pair)]
        res["one_layer_ms"] = {"layer_block": [t[1], t[2]],
                               "attn_block_plus_mlp_block": [t[0], t[3]]}
        log(f"[layer] one B/16 bs=32 layer: layer_block {t[1]:.4f}/"
            f"{t[2]:.4f} ms, attn_block + mlp_block {t[0]:.4f}/{t[3]:.4f}")

    # Serving: bs=1 buckets stay on the stack route, bs=32 take the layer
    # route; every request equals its bucket forwards bit for bit.
    pred = Predictor(params, cfg, buckets=(1, 8, 32), layer_block=True)
    sizes = (1, 5, 32, 37)
    requests = [torch.randn((n, 3, 224, 224), generator=gen, device="cuda")
                for n in sizes]
    plans = [b for n in sizes for b in pred._plan(n)]
    if (plans.count(1), plans.count(32)) != (11, 2):
        raise AssertionError(f"layer route serving plans {plans}")
    answers = counted("B/16 layer route serving",
                      lambda: [pred(r) for r in requests],
                      add_counts(expect_counts(zero, PER_FORWARD_STACK, 11),
                                 expect_counts(zero, layer_route_counts(12),
                                               2)))
    with torch.inference_mode():
        for n, req, ans in zip(sizes, requests, answers):
            if tuple(ans.shape) != (n, 1000) or not torch.equal(
                    ans, bucket_forwards(torch, pred, lambda x: forward(
                        pred.params, x, cfg, layer_block=True), req)):
                raise AssertionError(f"layer route request {n} != its "
                                     "bucket forwards")
    log("[layer] Predictor(layer_block=True): requests (1, 5, 32, 37) == "
        "their bucket forwards, bit for bit")
    del pred, requests, answers

    # L/16 bf16 bs=8 at 4 layers (D=1024), no head.
    cfg_l = VARIANTS["L/16"].replace(dtype=torch.bfloat16, num_layers=4)
    p_l = init_params(cfg_l, generator=torch.Generator(
        device="cuda").manual_seed(73), device="cuda")
    px = torch.randn((8, 3, 224, 224), generator=gen, device="cuda")
    with torch.inference_mode():
        got = counted("L/16 bf16 bs=8 layer route",
                      lambda: forward(p_l, px, cfg_l, layer_block=True),
                      expect_counts(zero, layer_route_counts(4, head=False)))
        res["l16_bf16_bs8_4_layers_vs_plain"] = r = compare_model(
            torch, got, forward(p_l, px, cfg_l, layer_block=True,
                                impl="torch"), torch.bfloat16)
    log(f"[layer] L/16 bf16 bs=8, 4 layers, vs impl=torch: {r}")
    del p_l

    # One train step, B/16 bf16 bs=32: the forward swap above, and the
    # per-layer route's backward.
    cfg_t = VARIANTS["B/16"].replace(dtype=torch.bfloat16, num_classes=1000)
    params_t = init_params(cfg_t, generator=torch.Generator(
        device="cuda").manual_seed(74), device="cuda")
    px = torch.randn((32, 3, 224, 224), generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (32,), generator=gen, device="cuda")
    want_loss, want = train_grads(torch, params_t, cfg_t, px, labels,
                                  "torch", layer_block=True)
    init_fn, step_fn = make_train_step(cfg_t, make_optimizer(1e-4, 0.05),
                                       layer_block=True)
    opt = init_fn(params_t)
    _, _, loss = counted(
        "B/16 bf16 bs=32 layer route train step",
        lambda: step_fn(params_t, opt, px, labels),
        expect_counts(zero, train_step_counts(layer_route_counts(12), 12)))
    worst = check_train_grads(torch, "layer route train step",
                              [t.grad for t in tree_leaves(params_t)], want,
                              torch.bfloat16)
    if not abs(float(loss) - float(want_loss)) <= MODEL_BF16_REL_BAR * (
            1 + abs(float(want_loss))):
        raise AssertionError(f"layer route train step: loss {float(loss)} "
                             f"vs {float(want_loss)}")
    res["train_step_b16_bf16_bs32"] = {
        "loss": float(loss), "plain_loss": float(want_loss),
        "worst_grad_vs_bar": worst}
    log(f"[layer] train step B/16 bf16 bs=32: loss {float(loss):.6f} "
        f"(plain {float(want_loss):.6f}), worst gradient {worst:.3f} of its "
        "bar")
    del params_t, opt, want, params
    torch.cuda.empty_cache()

    # K20: exactly the matching blocks print their tile's sum (integer
    # values: exact fp32 sums in any order); the copy is bit for bit.
    printed = {}

    def print_cases():
        outs = []
        for grid, conds, shape in (((2,), "=0", (16, 128)),
                                   ((3, 4), "=1,>1", (24, 512))):
            x = torch.randint(-3, 4, shape, generator=gen,
                              device="cuda").float()
            out, text = capture_stdout(torch, lambda: debug.print_if_smoke(
                x, conds, grid=grid))
            lines = sorted(ln for ln in text.splitlines()
                           if ln.startswith("block ("))
            want_lines = sorted(debug.print_if_lines(x.cpu(), conds,
                                                     grid=grid))
            if lines != want_lines or not torch.equal(out, x):
                raise AssertionError(f"print_if grid {grid} {conds!r}: "
                                     f"printed {lines}, want {want_lines}")
            printed[f"{grid} {conds}"] = lines
            outs.append(out)
        return outs
    counted("print_if", print_cases, expect_counts(zero, {"print_if": 2}))
    log(f"[layer] print_if: exactly the matching blocks printed {printed}")
    res["print_if_lines"] = printed

    img = torch.randn((32, 3, 224, 224), generator=gen,
                      device="cuda").to(torch.bfloat16)
    got = counted("ops.patchify B/16 bs=32", lambda: ops.patchify(img, 16),
                  expect_counts(zero, {"patchify": 1}))
    if not torch.equal(got, ops.reference.patchify(img, 16)):
        raise AssertionError("ops.patchify != the layout copy")
    rc = counted("minimal_matmul example", lambda: minimal_matmul.main([]),
                 expect_counts(zero, {"minimal_matmul": 1}))
    if rc != 0:
        raise AssertionError("the minimal matmul example failed")
    log("[layer] ops.patchify bit for bit at B/16 bs=32; the minimal matmul "
        "example passed")
    return res


def main() -> int:
    if "--tp-rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        return tp_rank_main(int(args["--tp-rank"]), int(args["--world"]),
                            args["--store"], args["--out"])
    if not os.path.isdir(os.path.join(HERE, "vit_tpu_torch")):
        raise SystemExit("vit_tpu_torch/ not found beside chip_smoke.py: "
                         "run it from a checkout of the repository")
    sys.path.insert(0, HERE)

    import torch

    # -- 1. device ---------------------------------------------------------
    smi = smi_line()
    log(f"[device] nvidia-smi: {smi}")
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from vit_tpu_torch import ops
    from vit_tpu_torch.config import VARIANTS
    from vit_tpu_torch.models.vit import fold_base, forward, init_params
    from vit_tpu_torch.ops.cuda import (_build, launch_counts,
                                        reset_launch_counts)
    from vit_tpu_torch.serving import Predictor
    from vit_tpu_torch.weights.hf import params_from_state_dict
    from vit_tpu_torch.weights.synthetic import (golden_pixels,
                                                 synthetic_hf_state_dict)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"[build] {lib_path.name} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # -- 3. each kernel vs its plain version -------------------------------
    errors: dict[str, float] = {}
    timing_cases = []
    for cases in (kernel_cases, kernel_cases_l16_384,
                  kernel_cases_small_batch, kernel_cases_int8,
                  kernel_cases_stack_q, kernel_cases_train,
                  kernel_cases_chain, kernel_cases_tp, kernel_cases_layer):
        for dtype in (torch.float32, torch.bfloat16):
            for c in cases(torch, dtype):
                got = c["run"]("cuda")
                want = c["run"]("torch")
                torch.cuda.synchronize()
                res = c["check"](torch, got, want, dtype)
                log(f"[kernel] {c['name']} {c['label']} {dtype}: {res}")
                if dtype == torch.bfloat16:
                    errors[c["name"]] = max(errors.get(c["name"], 0.0),
                                            res["max_abs_err"])
                timing_cases.append((c, dtype))
            del got, want
    torch.cuda.empty_cache()

    # -- 4. golden ---------------------------------------------------------
    fx = np.load(os.path.join(HERE, "tests", "fixtures", "golden_b16.npz"))
    cfg32 = VARIANTS["B/16"]
    sd = synthetic_hf_state_dict(cfg32, seed=int(fx["weights_seed"]))
    params32 = params_from_state_dict(sd, cfg32, device="cuda")
    px = torch.from_numpy(
        golden_pixels(cfg32, seed=int(fx["pixels_seed"]))).cuda()
    want = torch.from_numpy(fx["final_hidden"]).cuda()
    reset_launch_counts()
    got = forward(params32, px, cfg32)
    torch.cuda.synchronize()
    counts = launch_counts()
    # fp32 at bs=2: embed_fused, then the per-layer route; no head.
    check_counts("golden", counts, expect_counts(
        counts, dict(PER_FORWARD, matmul=24, embed_fused=1)))
    gdiff = float((got.float() - want).abs().max())
    plain_diff = float((forward(params32, px, cfg32, impl="torch").float()
                        - want).abs().max())
    log(f"[golden] max|diff| kernels {gdiff:.3e}, plain {plain_diff:.3e}; "
        f"launches {counts}")
    if not gdiff < GOLDEN_BAR:
        raise AssertionError(f"golden max|diff| {gdiff} >= {GOLDEN_BAR}")
    stack_out = ops.encoder_stack_fused(
        ops.reference.patchify(px, cfg32.patch_size), params32["encoder"],
        params32["embeddings"]["patch_embed"]["kernel"],
        fold_base(params32, cfg32), params32["ln_final"], num_heads=12,
        sp=208, scale=64 ** -0.5, seq_len=197, eps=cfg32.layernorm_eps)
    kdiff = float((stack_out[:, :197].float() - want).abs().max())
    log(f"[golden] encoder_stack_fused (fp32, bs=2) max|diff| {kdiff:.3e}")
    if not kdiff < GOLDEN_BAR:
        raise AssertionError(f"encoder_stack_fused golden max|diff| {kdiff} "
                             f">= {GOLDEN_BAR}")
    # The reference op chain: K1 -> K2 -> K14 for every linear, K16 -> K15
    # -> K16 for attention, at the real 197 tokens.
    reset_launch_counts()
    chain = forward(params32, px, cfg32, attention="unfused", fused=False)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_counts("golden unfused chain", counts, expect_counts(
        counts, route_counts("unfused", False, head=False)))
    cdiff = float((chain.float() - want).abs().max())
    log(f"[golden] attention='unfused', fused=False max|diff| {cdiff:.3e}; "
        f"launches {counts}")
    if not cdiff < GOLDEN_BAR:
        raise AssertionError(f"unfused chain golden max|diff| {cdiff} >= "
                             f"{GOLDEN_BAR}")
    del chain
    # The int8 tier on the same weights: kernels against the kernels' float
    # forward (the bars of tests/test_quant.py:95-96) and against its own
    # plain version.
    from vit_tpu_torch.quant import forward_quant, quantize_params
    with torch.inference_mode():
        q32 = quantize_params(params32)
        reset_launch_counts()
        gq = forward_quant(q32, px, cfg32)
        torch.cuda.synchronize()
        counts = launch_counts()
        # fp32 at bs=2: embed_fused, the per-layer int8 route, final LN.
        check_counts("golden int8", counts, expect_counts(
            counts, per_layer_q(12, embed_fused=1, layernorm=1)))
        check_int8_forward(torch, "golden int8 fp32 bs=2", gq, forward_quant(
            q32, px, cfg32, impl="torch"), got, absolute=True)
        rel_g, corr_g = rel_corr(torch, gq, want)
        log(f"[golden int8] vs the recording: rel {rel_g:.3e}, corr "
            f"{corr_g:.6f}; launches {counts}")
        # The weight-only MLP (int8_dot=False): K17 in place of K12.
        reset_launch_counts()
        gw = forward_quant(q32, px, cfg32, int8_dot=False)
        torch.cuda.synchronize()
        counts = launch_counts()
        check_counts("golden int8 weight-only MLP", counts, expect_counts(
            counts, q_weight_only(per_layer_q(12, embed_fused=1,
                                              layernorm=1))))
        check_int8_forward(torch, "golden int8 int8_dot=False fp32 bs=2", gw,
                           forward_quant(q32, px, cfg32, impl="torch",
                                         int8_dot=False), got, absolute=True)
        rel_g, corr_g = rel_corr(torch, gw, want)
    log(f"[golden int8 int8_dot=False] vs the recording: rel {rel_g:.3e}, "
        f"corr {corr_g:.6f}; launches {counts}")
    del params32, sd, stack_out, q32

    # -- 5. B/16 serving: the first main path ------------------------------
    cfg = VARIANTS["B/16"].replace(dtype=torch.bfloat16, num_classes=1000)
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    pred = Predictor(params, cfg, buckets=(1, 8, 32), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    sizes = (1, 5, 32, 37)
    requests = [torch.randn((n, 3, 224, 224), generator=gen, device="cuda")
                for n in sizes]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    answers = [pred(r) for r in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    main_counts = {"B/16 serving": launch_counts()}
    plans = [b for n in sizes for b in pred._plan(n)]
    counts = main_counts["B/16 serving"]
    check_counts("B/16 serving", counts, add_counts(
        expect_counts(counts, PER_FORWARD_STACK, plans.count(1)),
        expect_counts(counts, PER_FORWARD, plans.count(32))))
    log(f"[serve] {sizes} in {serve_s:.3f} s (host clock, first calls); "
        f"{len(plans)} bucket forwards ({plans.count(1)} of bs=1 on the "
        f"stack route); launches {counts}")
    with torch.inference_mode():
        for n, req, ans in zip(sizes, requests, answers):
            if tuple(ans.shape) != (n, 1000):
                raise AssertionError(f"request {n}: shape {tuple(ans.shape)}")
            # A request of n images runs other buckets, and so other
            # routes, than one forward at bs=n: the model bar.
            res = compare_model(torch, ans, forward(
                params, req.to(cfg.dtype), cfg), torch.bfloat16)
            log(f"[serve] request {n} vs forward at bs={n}: {res}")
        ones = torch.cat([forward(params, requests[1][i:i + 1].to(cfg.dtype),
                                  cfg) for i in range(5)])
        if not torch.equal(answers[1], ones):
            raise AssertionError("request of 5 != five bs=1 forwards")
        log("[serve] request of 5 == five bs=1 forwards, bit for bit")
        padded = torch.cat([requests[1], requests[1].new_zeros(3, 3, 224, 224)])
        bucket8 = forward(params, padded.to(cfg.dtype), cfg)[:5]
        res = compare_model(torch, answers[1], bucket8, torch.bfloat16)
        log(f"[serve] request of 5 (stack route) vs rows 0-4 of the "
            f"bucket-8 forward (per-layer route): {res}")
    del requests, answers

    # -- 5b. B/16 int8 serving: the int8 main path ------------------------
    pred_q = Predictor(params, cfg, buckets=(1, 8, 32), quant=True)
    # The int8 phases draw from their own generator, so that the inputs of
    # the float phases stay those of the runs recorded before them.
    gen_q = torch.Generator(device="cuda").manual_seed(21)
    requests = [torch.randn((n, 3, 224, 224), generator=gen_q, device="cuda")
                for n in sizes]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    answers = [pred_q(r) for r in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    main_counts["B/16 int8 serving"] = counts = launch_counts()
    plans = [b for n in sizes for b in pred_q._plan(n)]
    if (plans.count(1), plans.count(32)) != (11, 2):
        raise AssertionError(f"B/16 int8 serving plans {plans}")
    check_counts("B/16 int8 serving", counts, add_counts(
        expect_counts(counts, PER_FORWARD_Q_STACK, 11),
        expect_counts(counts, per_layer_q(12, matmul=2, layernorm=1), 2)))
    log(f"[serve int8] {sizes} in {serve_s:.3f} s (host clock, first "
        f"calls); 11 bs=1 forwards on encoder_stack_q, 2 bs=32 on the "
        f"per-layer int8 route; launches {counts}")
    qp = pred_q.params
    with torch.inference_mode():
        for n, req, ans in zip(sizes, requests, answers):
            if tuple(ans.shape) != (n, 1000):
                raise AssertionError(f"int8 request {n}: shape "
                                     f"{tuple(ans.shape)}")
            # The same buckets one by one: every kernel is deterministic.
            if not torch.equal(ans, bucket_forwards(
                    torch, pred_q, lambda x: forward_quant(qp, x, cfg), req)):
                raise AssertionError(f"int8 request {n} != its bucket "
                                     "forwards")
        log("[serve int8] every request == its bucket forwards, bit for "
            "bit (the request of 5: five bs=1 forwards)")
        for bs, req in ((1, requests[0]), (32, requests[2])):
            xb = req.to(cfg.dtype)
            check_int8_forward(
                torch, f"serve int8 bs={bs} logits", forward_quant(qp, xb, cfg),
                forward_quant(qp, xb, cfg, impl="torch"),
                forward(params, xb, cfg), absolute=True)
    del requests, answers

    # -- 6. L/16-384 fp32, full depth, against impl="torch" ----------------
    with torch.inference_mode():
        cfg_l32 = VARIANTS["L/16-384"]
        p_l32 = init_params(cfg_l32, generator=torch.Generator(
            device="cuda").manual_seed(2), device="cuda")
        px = torch.randn((2, 3, 384, 384), generator=gen, device="cuda")
        reset_launch_counts()
        got = forward(p_l32, px, cfg_l32)
        torch.cuda.synchronize()
        counts = launch_counts()
        check_counts("L/16-384 fp32", counts, expect_counts(
            counts, dict(L16_384_ENCODER, embed_fused=1)))
        want = forward(p_l32, px, cfg_l32, impl="torch")
        res = compare_model(torch, got, want, torch.float32)
        log(f"[l16-384 fp32] bs=2, 24 layers, kernels vs impl=torch: {res}; "
            f"launches {counts}")
        del p_l32, got, want

    # -- 7. L/16-384 serving: the second main path -------------------------
    cfg_l = VARIANTS["L/16-384"].replace(dtype=torch.bfloat16,
                                         num_classes=1000)
    p_l = init_params(cfg_l, generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda")
    pred_l = Predictor(p_l, cfg_l, buckets=(4, 8), device="cuda")
    sizes_l = (3, 8, 11)
    requests = [torch.randn((n, 3, 384, 384), generator=gen, device="cuda")
                for n in sizes_l]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    answers = [pred_l(r) for r in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    main_counts["L/16-384 serving"] = counts = launch_counts()
    plans = [b for n in sizes_l for b in pred_l._plan(n)]
    if sorted(plans) != [4, 4, 8, 8]:
        raise AssertionError(f"L/16-384 serving plans {plans}")
    # Bucket 4 embeds through embed_fused; bucket 8 through the patch
    # projection. Each adds the head's matmul.
    check_counts("L/16-384 serving", counts, add_counts(
        expect_counts(counts, dict(L16_384_ENCODER, embed_fused=1, matmul=1),
                      2),
        expect_counts(counts, dict(L16_384_ENCODER, matmul=2), 2)))
    log(f"[serve l16-384] {sizes_l} in {serve_s:.3f} s (host clock, first "
        f"calls); {len(plans)} bucket forwards; launches {counts}")
    with torch.inference_mode():
        for n, req, ans in zip(sizes_l, requests, answers):
            if tuple(ans.shape) != (n, 1000):
                raise AssertionError(f"request {n}: shape {tuple(ans.shape)}")
            res = compare(torch, ans, forward(p_l, req.to(cfg_l.dtype), cfg_l),
                          torch.bfloat16)
            log(f"[serve l16-384] request {n} vs forward: {res}")
        padded = torch.cat([requests[0],
                            requests[0].new_zeros(1, 3, 384, 384)])
        bucket4 = forward(p_l, padded.to(cfg_l.dtype), cfg_l)[:3]
        if not torch.equal(answers[0], bucket4):
            raise AssertionError("request of 3 != rows 0-2 of the bucket-4 "
                                 "forward")
        log("[serve l16-384] request of 3 == rows 0-2 of the bucket-4 "
            "forward, bit for bit")
    del requests, answers, pred_l

    # -- 7b. L/16-384 int8 bf16 at bs=8, full depth ------------------------
    with torch.inference_mode():
        q_l = quantize_params(p_l)
        px = torch.randn((8, 3, 384, 384), generator=gen_q,
                         device="cuda").to(cfg_l.dtype)
        reset_launch_counts()
        got = forward_quant(q_l, px, cfg_l)
        torch.cuda.synchronize()
        main_counts["L/16-384 int8 bs=8"] = counts = launch_counts()
        # bs=8: the patch projection and the head on matmul.
        check_counts("L/16-384 int8", counts, expect_counts(
            counts, per_layer_q(24, matmul=2, layernorm=1)))
        log(f"[l16-384 int8] bf16 bs=8, 24 layers; launches {counts}")
        check_int8_forward(torch, "l16-384 int8 bf16 bs=8 logits", got,
                           forward_quant(q_l, px, cfg_l, impl="torch"),
                           forward(p_l, px, cfg_l), absolute=False)

    # -- 7c. H/14 int8 at 4 layers, both dtypes ----------------------------
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            cfg_h = VARIANTS["H/14"].replace(num_layers=4, dtype=dtype)
            p_h = init_params(cfg_h, generator=torch.Generator(
                device="cuda").manual_seed(12))
            q_h = quantize_params(p_h)
            px = torch.randn((2, 3, 224, 224), generator=gen_q, device="cuda")
            reset_launch_counts()
            got = forward_quant(q_h, px, cfg_h)
            torch.cuda.synchronize()
            counts = launch_counts()
            dname = str(dtype).replace("torch.", "")
            check_counts(f"H/14 int8 {dname}", counts, expect_counts(
                counts, per_layer_q(4, embed_fused=1, layernorm=1)))
            log(f"[h14 int8 {dname}] bs=2, 4 layers; launches {counts}")
            check_int8_forward(torch, f"h14 int8 {dname} bs=2 pooled", got,
                               forward_quant(q_h, px, cfg_h, impl="torch"),
                               forward(p_h, px, cfg_h), absolute=False)
            del p_h, q_h

    # -- 8. H/14 at 4 layers, both dtypes, against impl="torch" ------------
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            cfg_h = VARIANTS["H/14"].replace(num_layers=4, dtype=dtype)
            p_h = init_params(cfg_h, generator=torch.Generator(
                device="cuda").manual_seed(4), device="cuda")
            px = torch.randn((2, 3, 224, 224), generator=gen, device="cuda")
            reset_launch_counts()
            got = forward(p_h, px, cfg_h)
            torch.cuda.synchronize()
            counts = launch_counts()
            dname = str(dtype).replace("torch.", "")
            check_counts(f"H/14 {dname}", counts,
                         expect_counts(counts, PER_FORWARD_H14_4[dname]))
            res = compare_model(torch, got,
                                forward(p_h, px, cfg_h, impl="torch"), dtype)
            log(f"[h14 {dname}] bs=2, 4 layers, kernels vs impl=torch: "
                f"{res}; launches {counts}")
            del p_h
    torch.cuda.empty_cache()

    # -- 9, 10. DeiT-B/16 and L/16 bf16 at bs=1: the stack at full depth ---
    small = {}
    with torch.inference_mode():
        for tag, variant, per_forward in (
                ("DeiT-B/16 bs=1", "DeiT-B/16", PER_FORWARD_DEIT_STACK),
                ("L/16 bs=1", "L/16", {"encoder_stack_fused": 1})):
            c = VARIANTS[variant].replace(dtype=torch.bfloat16)
            p = init_params(c, generator=torch.Generator(
                device="cuda").manual_seed(7), device="cuda")
            px = torch.randn((1, 3, 224, 224), generator=gen, device="cuda")
            reset_launch_counts()
            got = forward(p, px, c)
            torch.cuda.synchronize()
            main_counts[tag] = counts = launch_counts()
            check_counts(tag, counts, expect_counts(counts, per_forward))
            res = compare_model(torch, got, forward(p, px, c, impl="torch"),
                                torch.bfloat16)
            log(f"[{tag}] bf16, {c.num_layers} layers, kernels vs "
                f"impl=torch: {res}; launches {counts}")
            small[tag] = (c, p)

    # -- 11. timings -------------------------------------------------------
    timings = []
    for c, dtype in timing_cases:
        ms = time_ms(torch, lambda: c["run"]("cuda"))
        plain = time_ms(torch, lambda: c["run"]("torch"))
        library = None
        if c["library"] is not None:
            try:
                library = time_ms(torch, c["library"])
            except RuntimeError as err:  # a yardstick only; say why
                log(f"[timing] {c['name']} {c['label']}: library call "
                    f"failed: {err}")
        bound_ms, bound_by = bound(c["work"])
        timings.append({"kernel": c["name"], "shape": c["label"],
                        "dtype": str(dtype).replace("torch.", ""),
                        "ms": ms, "plain_ms": plain, "library_ms": library,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "primary": c["primary"]})
    e2e = {}
    for tag, c, p, bs in (("b16", cfg, params, 32),
                          ("l16_384", cfg_l, p_l, 8)):
        xb = torch.randn((bs, 3, c.image_size, c.image_size), generator=gen,
                         device="cuda").to(c.dtype)
        with torch.inference_mode():
            fwd_ms = time_ms(torch, lambda: forward(p, xb, c))
            plain_ms = time_ms(torch, lambda: forward(p, xb, c, impl="torch"))
        e2e[f"forward_{tag}_bf16_bs{bs}_ms"] = fwd_ms
        e2e[f"forward_{tag}_bf16_bs{bs}_images_per_s"] = bs * 1e3 / fwd_ms
        e2e[f"plain_forward_{tag}_bf16_bs{bs}_ms"] = plain_ms
        e2e[f"plain_forward_{tag}_bf16_bs{bs}_images_per_s"] = (
            bs * 1e3 / plain_ms)
    c_l16, p_l16 = small["L/16 bs=1"]
    for tag, c, p, bs in (("b16", cfg, params, 1), ("b16", cfg, params, 2),
                          ("l16", c_l16, p_l16, 1)):
        e2e[f"routes_{tag}_bf16_bs{bs}"] = route_times(torch, forward, p, c,
                                                       bs, gen)
    e2e["b16_bs1_layer_kernels_ms"] = layer_breakdown(torch)
    # The int8 tier against the bf16 kernel forward on the same weights and
    # inputs, in turns (float, int8, int8, float).
    for tag, c, fp, qpar, bs in (("b16", cfg, params, qp, 32),
                                 ("b16", cfg, params, qp, 1),
                                 ("l16_384", cfg_l, p_l, q_l, 8)):
        xb = torch.randn((bs, 3, c.image_size, c.image_size), generator=gen,
                         device="cuda").to(c.dtype)
        base = fold_base(fp, c)
        with torch.inference_mode():
            def f_fwd():
                return forward(fp, xb, c, base=base)

            def q_fwd():
                return forward_quant(qpar, xb, c)
            runs = [forward_stats(torch, fn)
                    for fn in (f_fwd, q_fwd, q_fwd, f_fwd)]
        e2e[f"int8_vs_bf16_{tag}_bs{bs}"] = {
            "bf16": [runs[0], runs[3]], "int8": [runs[1], runs[2]],
            "int8_images_per_s": bs * 1e3 / runs[1]["ms"],
            "bf16_images_per_s": bs * 1e3 / runs[0]["ms"]}
    # The JAX package's forward modes at B/16 bf16 bs=32, the default
    # route first; the int8 forward with K12 and with the weight-only K17,
    # in turns (int8_dot, weight-only, weight-only, int8_dot).
    xb = torch.randn((32, 3, 224, 224), generator=gen,
                     device="cuda").to(cfg.dtype)
    with torch.inference_mode():
        e2e["forward_modes_b16_bf16_bs32"] = {
            f"{a}_{'fused' if f else 'chain'}": forward_stats(
                torch, lambda a=a, f=f: forward(params, xb, cfg, attention=a,
                                                fused=f))
            for a, f in (("flash", True), ("unfused", False),
                         ("unfused", True), ("flash", False))}
    for tag, c, qpar, bs in (("b16", cfg, qp, 32), ("l16_384", cfg_l, q_l, 8)):
        xb = torch.randn((bs, 3, c.image_size, c.image_size), generator=gen,
                         device="cuda").to(c.dtype)
        with torch.inference_mode():
            def i8dot():
                return forward_quant(qpar, xb, c)

            def wonly():
                return forward_quant(qpar, xb, c, int8_dot=False)
            runs = [forward_stats(torch, fn)
                    for fn in (i8dot, wonly, wonly, i8dot)]
        e2e[f"int8_dot_vs_weight_only_{tag}_bs{bs}"] = {
            "int8_dot": [runs[0], runs[3]], "weight_only": [runs[1], runs[2]]}
    # -- 12. training: the fifth main path ----------------------------------
    e2e["training"] = train_phase(torch, main_counts)
    # -- 13. the other forward modes ----------------------------------------
    forward_modes_phase(torch, main_counts, cfg, params, cfg_l, p_l, q_l)
    # -- 14. tensor and batch parallelism: two ranks on the card -----------
    del params, p_l, q_l, qp, pred, pred_q, small
    torch.cuda.empty_cache()
    e2e["tensor_parallel"] = tp_phase(torch, main_counts)
    # -- 15. the full-layer route and the standalone kernels ---------------
    e2e["layer_route"] = layer_phase(torch, main_counts)
    log(json.dumps({"timings": timings, "end_to_end": e2e, "card": smi,
                    "torch": torch.__version__, "cuda": torch.version.cuda}))

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        # The bf16 timing of the last primary case of the kernel.
        t = next(t for t in reversed(timings) if t["kernel"] == name
                 and t["dtype"] == "bfloat16" and t["primary"])
        by_path = {path: c[name] for path, c in main_counts.items()}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": errors[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"], "shape": t["shape"],
                        "dtype": "bfloat16"})
    if any(k["launches"] == 0 for k in kernels):
        raise AssertionError(f"a kernel was not launched by a main path: "
                             f"{kernels}")
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
