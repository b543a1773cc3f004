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
   B/16 (bs=4 and 1), H/14 (bs=2, K=588) and L/16-384 (bs=4, phase 7's
   bucket), in bf16 on the ``wgmma`` tile bit for bit with K2 -> cast ->
   ``+ pos`` (``k8_check``; H/14 on ``gemm_tile.cuh``), in fp32 also at
   H/14 bs=1 and at B/16 bs=1 on a misaligned base, on the tf32 tile (the
   misaligned case on FFMA) bit for bit with K2's fp32 + ``pos`` and over
   two calls, each timed beside K2 on the same operands (fp32 also beside
   ``addmm``); K10 (``k10_case``) at B/16, L/16-384 and H/14 widths with
   LN and on an fp32 context, and on B/16's model=4 context shard (D =
   192, the scalar form), two calls bit for bit and, in the row form, bit
   for bit with the scalar form; K18 ``layer_tail`` at B/16 bs=32, L/16 bs=8
   and, in bf16, ragged M (1, 65) at D = 128-1024, in fp32 H/14 bs=2 (D =
   1280) on the tensor-core form and B/16 bs=1 on the FFMA form (a ctx 4
   bytes past alignment), two calls bit for bit,
   both forms of ``encoder_stack`` as whole 12-layer B/16 encoders at bs=1
   and bs=2 (197 of 208 tokens); the int8 kernels at B/16 bs=32, L/16-384
   bs=8 (K7's fp32 output at 592 tokens) and H/14 bs=2 (D=1280, MLP 5120),
   ``matmul_i8`` bit for bit, and ``encoder_stack_q`` as the whole B/16 and
   L/16 encoders at bs=1; K13 ``flash_attention_bwd`` at B/16 bs=32 in
   both dtypes, L/16-384 bs=2 (592 tokens) in bf16 and H/14 bs=2 (d=80)
   in fp32; the reference op chain at B/16 bs=32's unfused shapes: K14
   ``add`` bit for bit, K15 ``softmax``, K16 ``matmul3`` (scores,
   context, and the scores at 200 tokens, whose rows are aligned; in fp32
   also K = 2304 in 36 runs, ragged M and N; the float cases two calls
   bit for bit), and
   K17 ``mlp_block_q`` there, at L/16-384 bs=8 and H/14 bs=2, in fp32
   (K3's tf32 tile with its Q flag, two TF32 passes a product, two calls
   bit for bit) also its shard at B/16 bs=32 over model=2; K2 also at the training backward's two products of the QKV, on
   the views it passes (``g @ w.t()``, ``x.t() @ g``); K7 also at B/16
   bs=32 on packed QKV views. The bars of K2's backward cases, of K6's
   LN cases (each timed beside K1 -> K2, two calls bit for bit; in fp32
   also the B/16 fc1 + GELU and, on the FFMA tile, an x 4 bytes past
   alignment), of K4's core and K7's three
   cases (the core and K7's float cases also two calls bit for bit), of K16's
   scores and context, of K3's, K12's and K17's cases (B/16 bs=32,
   L/16-384 bs=8, H/14 bs=2 -- K3 there in fp32 only -- every shard form,
   K3's fp32 shard also at B/16 bs=32 over model=2; K3's cases also two
   calls bit for bit) and of K8's cases are each
   held to two planted faults (``gemm_faults``, ``flash_faults``,
   ``mlp_faults``, ``mlp_q_faults``; K17's fp32 cases to a third, one
   32-row K step of fc2 left out), K18's to three (``layer_faults``: a
   64-deep K step of Wout, a 64-column hidden chunk, the output x 0.85),
   and each of K9's three forms to a zeroed K slice of
   one layer's fc2 and to context rows written from others in every head
   and layer (``stack_faults``), which they must refuse; K9's three forms
   also on one layer that passes the attention phase's context to the
   output, at the kernel bar, each refusing one head's query rows 32-63
   written from rows 64-95 (``kernel_cases_stack_tile``, B/16 bs=1 and 2,
   L/16 bs=1);
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
   every K2 call takes the ``wgmma`` tile (``gemm_path``, recorded by
   ``gemm_paths``);
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
    calls); K4's core, K13 and every case of K1, K2, K3, K7, K11, K14,
    K15 and K16 (``PIPELINED``) also pipelined, calls queued back to back
    (the device time where the host keeps ahead), and those of K1, K2,
    K3, K5, K7, K8, K10, K11, K14, K15, K16 and K18 on the card
    (``DEVICE_TIMED``: the profiler's device time), beside the library
    call timed the same way (fp32 ``addmm`` without TF32) and, for K3,
    beside the same MLP as K1 -> K2 -> K2 (``composed_ms``; K8 beside K2
    on the same operands, K12 beside
    K10 -> K11 -> K10 -> K11, K17 beside K3 on the dequantized weights,
    K9 at bs=1 beside K24's ``dma``, its weight stream alone); the
    bf16 forwards of B/16 at bs=32 and L/16-384 at bs=8
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
    (K16 in the backward) at B/16 bf16 bs=32 and fp32 bs=8, every bf16
    step's K2 calls on the ``wgmma`` tile (``gemm_paths``); the step's
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
    Exact launch counts throughout;
16. the probes (``probe_phase``; ``vit_tpu_torch/tools/``): K22
    ``dot_probe``, K23 ``attn_core_probe`` and K24 ``encstack_probe`` are
    checked in phase 3 and timed in phase 11 (``kernel_cases_probes``: K22
    int8 bit for bit, bf16 and fp32 (K2's tf32 tile; two calls bit for
    bit, two planted faults) at (1664, 768) @ (768, 3072); K23's ``full``
    core (also on the card) and the block in every mode at B/16 bs=32 in
    both dtypes (fp32 blocks two calls bit for bit), and its fp32 kt QKV
    GEMM (two planted faults); K24's ``dma`` over 12 B/16 layers at bs=1,
    the other variants cut to 2 layers). Here, through the probes' entry
    points with exact launch counts: the int8 probe's ``run`` (K22 on
    K11's s8 ``wgmma`` tile and K2's bf16 one); the attention block in
    every mode at B/16 bs=32 bf16 against its plain version (K23's core on
    K4's tensor-core tile, its GEMMs on K2's ``wgmma`` tile), each mode's
    planted faults refused and wide's rounding point held on its core, the
    fp32 GEMMs' tile (K2's tf32 walk), then each mode's event ms and the
    core launch's device ms in each dtype; K4's core against
    K23's ``full`` core bit for bit in both dtypes, then the two in turns;
    every encoder
    variant at the JAX probe's four cases (2 layers) against its plain
    version, then each timed at 12 layers for b = 1, 2, 3.

The last three lines of standard output are the kernels JSON line (each
kernel's launches on the main paths, error vs the plain version, kernel,
plain and library times, and its bound: the larger of its bytes over the
memory rate and its operations over the peak rate of their type; under
``fp32`` the same numbers of the kernel's fp32 form, where it has one:
K2's and K13's on the tensor cores in three TF32 passes), the
card's ``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``. Imports only torch, numpy and the port.
"""

from __future__ import annotations

import contextlib
import json
import math
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
#: Kernels whose primary case phase 11 also times pipelined (calls queued
#: back to back: the device time), beside the library call timed the same
#: way; every case of those in DEVICE_TIMED.
PIPELINED = ("attention", "flash_attention_bwd", "matmul", "flash_attention",
             "matmul3", "mlp_block", "mlp_block_partial", "layernorm",
             "softmax", "add", "matmul_i8", "layernorm_stats",
             "quantize_rows", "embed_fused", "layer_block", "dot_probe",
             "attn_core_probe", "minimal_matmul")
#: Kernels each of whose cases phase 11 also times on the card (the
#: profiler's device time), beside the library call: their wrappers' host
#: time can exceed the kernel, and then pipelined calls wait on the host.
#: K1, K15, K14 and K11 are here for their library calls' card times; K5,
#: K10, K8 and K18 for their own.
DEVICE_TIMED = ("matmul", "flash_attention", "matmul3", "mlp_block",
                "mlp_block_partial", "layernorm", "softmax", "add",
                "matmul_i8", "layernorm_stats", "quantize_rows",
                "embed_fused", "layer_block")
#: Where each kernel's source is and which TPU kernel it replaces.
KERNEL_SOURCES = {
    "layernorm": ("vit_tpu_torch/csrc/layernorm.cu",
                  "vit_tpu/ops/pallas/layernorm.py:80"),
    # K2's bf16 kernel (the kernels line's case); matmul.cu launches its
    # other tiles.
    "matmul": ("vit_tpu_torch/csrc/gemm_wgmma.cuh",
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
    # K8's bf16 kernel (the kernels line's case) is K2's wgmma tile with
    # its EMB epilogue; embed.cu launches it, and gemm_tile.cuh's form.
    "embed_fused": ("vit_tpu_torch/csrc/gemm_wgmma.cuh",
                    "vit_tpu/ops/pallas/patch_embed.py:96"),
    "encoder_stack": ("vit_tpu_torch/csrc/encoder_stack.cu",
                      "vit_tpu/ops/pallas/block.py:2203"),
    "encoder_stack_fused": ("vit_tpu_torch/csrc/encoder_stack.cu",
                            "vit_tpu/ops/pallas/block.py:2331"),
    # K10 and K11 are four of the five launches of attn_block_q (B11).
    "quantize_rows": ("vit_tpu_torch/csrc/layernorm.cu",
                      "vit_tpu/ops/pallas/block.py:1385"),
    "matmul_i8": ("vit_tpu_torch/csrc/matmul_i8_wgmma.cu",
                  "vit_tpu/ops/pallas/block.py:1385"),
    "mlp_block_i8dot": ("vit_tpu_torch/csrc/mlp_i8_wgmma.cuh",
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
    "mlp_block_q": ("vit_tpu_torch/csrc/mlp_q_wgmma.cuh",
                    "vit_tpu/ops/pallas/block.py:416"),
    # The tensor-parallel shard forms of K3, K12 and K17, partial_out=True
    # (the same pallas_calls). B16 and B17 (block.py:1054, :1483) are K1,
    # K2 and the attention core or K7, and K10, K11 and K7: their kernels
    # count their launches, and phase 11 times each block whole.
    "mlp_block_partial": ("vit_tpu_torch/csrc/mlp_block.cu",
                          "vit_tpu/ops/pallas/block.py:218"),
    "mlp_block_i8dot_partial": ("vit_tpu_torch/csrc/mlp_i8_wgmma.cuh",
                                "vit_tpu/ops/pallas/block.py:591"),
    "mlp_block_q_partial": ("vit_tpu_torch/csrc/mlp_q_wgmma.cuh",
                            "vit_tpu/ops/pallas/block.py:416"),
    # K18 is the last of layer_block's four launches (K1, K2 and the
    # attention core count theirs), as K4's core is of attn_block's. Its
    # bf16 kernel is K3's cluster tile with the K18 flag; layer_block.cu
    # launches it, and the fp32 forms (K3's tf32 tile with its LAYER flag
    # through layer_block_tf32.cu, the FFMA form).
    "layer_block": ("vit_tpu_torch/csrc/mlp_wgmma.cuh",
                    "vit_tpu/ops/pallas/block.py:1805"),
    "patchify": ("vit_tpu_torch/csrc/patching.cu",
                 "vit_tpu/ops/pallas/patching.py:67"),
    # The Pallas kernel that calls vit_tpu/ops/pallas/debug.py:print_if.
    "print_if": ("vit_tpu_torch/csrc/debug.cu", "tests/test_ops_pallas.py:248"),
    "minimal_matmul": ("vit_tpu_torch/csrc/minimal_matmul.cu",
                       "examples/minimal_pallas_matmul.py:50"),
    # The probes' kernels (phase 16). K22's int8 dot (the kernels line's
    # case) is K11's s8 wgmma tile with its raw epilogue, which
    # dot_probe.cu launches. K23's bf16 core (the kernels line's case:
    # full) is K4's tensor-core tile, which attn_core_probe_masked.cu
    # launches; its fp32 core K4's fp32 tile (attention_tf32.cuh, launched
    # by attn_core_probe_tf32_masked.cu and _all_keys.cu), its fp32 GEMMs
    # K2's tf32 walk (gemm_tf32.cuh, from attn_core_probe.cu). K23 also
    # replaces _probe_t's two pallas_calls (tools/attn_core_probe.py:432,
    # :447): tcore and xcore.
    "dot_probe": ("vit_tpu_torch/csrc/matmul_i8_wgmma.cu",
                  "tools/int8_probe.py:43"),
    "attn_core_probe": ("vit_tpu_torch/csrc/attention_mma.cuh",
                        "tools/attn_core_probe.py:389"),
    "encstack_probe": ("vit_tpu_torch/csrc/encstack_probe.cu",
                       "tools/encstack_minrepro.py:216"),
}
#: Kernels that run a whole encoder: held to the model bars.
WHOLE_ENCODER = ("encoder_stack", "encoder_stack_fused", "encoder_stack_q")
#: Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet, dense): device
#: memory bytes/s, and operations/s by the type the work runs in (bf16 and
#: int8 on the tensor cores, fp32 on the FFMA units; "tf32x3" the fp32
#: products of K2's and K13's tiles, three TF32 passes each on the tensor
#: cores at 495 TFLOP/s: ``csrc/tf32_split.cuh``; "tf32x2" K17's fp32
#: products, two passes each, the int8 codes exact in TF32:
#: ``csrc/mlp_tf32.cuh``'s Q flag).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12,
                  "tf32x3": 495e12 / 3, "tf32x2": 495e12 / 2}
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
         check=None, primary: bool = True, faults=None,
         composed=None, device: bool = False) -> dict:
    """A kernel case: ``run(impl)``; ``work`` = (bytes, operations, type)
    for its bound; ``library`` one PyTorch call of the same function, timed
    as a yardstick only; ``check(torch, got, want, dtype)`` its bar;
    ``primary`` whether the kernels line may report it; ``faults`` planted
    faults, ``{what: fn}`` with ``fn()`` a wrong kernel output that the bar
    must refuse against the plain version; ``composed`` the same function
    as a chain of the port's other kernels, timed beside it as a second
    yardstick; ``device`` whether phase 11 also times it pipelined and on
    the card (the profiler), beside its library call, as it times every
    case of a kernel in ``DEVICE_TIMED``."""
    if check is None:
        check = compare_model if name in WHOLE_ENCODER else compare
    return {"name": name, "label": label, "run": run, "work": work,
            "library": library, "check": check, "primary": primary,
            "faults": faults or {}, "composed": composed, "device": device}


def gemm_faults(torch, run, a, k_axis: int, start: int = 1024,
                width: int = 64) -> dict:
    """Two planted faults of a GEMM case whose kernel is ``run(a)``: the
    output scaled by 0.85, and one K step left out, made by zeroing K
    indices ``start`` .. ``start + width - 1`` of the operand ``a`` along
    ``k_axis`` (by default one 64-deep step of K2's wgmma tile)."""
    def skip_step():
        cut = a.clone()
        cut.narrow(k_axis, start, width).zero_()
        return run(cut)
    return {"output * 0.85": lambda: run(a) * 0.85,
            f"K {start}-{start + width - 1} skipped": skip_step}


def k6_case(torch, ops, x, w, bias, g, beta, e, kind, *,
            primary: bool = True, act: str | None = None,
            tag: str = "") -> dict:
    """K6 with LN, ``act(LN(x) @ w + bias)``: bound at the products' type
    on the tile it runs (fp32 on the tf32 tile: three TF32 passes), its bar
    held to ``gemm_faults`` (one 64-deep K step skipped by zeroing rows
    512-575 of w, where the LN stats stay as they are) and to two calls
    giving the same bits, and it is timed beside the same function as K1
    -> K2, two of the port's kernels."""
    from vit_tpu_torch.ops.cuda.matmul import fused_linear_tile

    m, k = x.shape
    n = w.shape[1]
    if x.dtype == torch.float32 and fused_linear_tile(x, w) == "wgmma":
        kind = "tf32x3"

    def run(wt=w):
        return ops.fused_linear(x, wt, bias, act, ln_scale=g, ln_bias=beta)
    return case(
        "fused_linear",
        f"{tag}LN ({m},{k})@({k},{n})+bias{'+' + act if act else ''}",
        lambda impl: ops.fused_linear(x, w, bias, act, ln_scale=g,
                                      ln_bias=beta, impl=impl),
        gemm_work(m, k, n, e, kind), primary=primary,
        check=twice_bit_for_bit(run),
        faults=gemm_faults(torch, run, w, 0, start=512),
        composed=lambda: ops.matmul(ops.layernorm(x, g, beta), w, bias, act))


def mlp_faults(torch, run, x, b2, w2, *, partial: bool,
               width: int = 64) -> dict:
    """Two planted faults of a K3 or K12 case whose kernel is ``run(w2,
    partial_out)``: the MLP's output (the partial form's) scaled by 0.85,
    which the whole form adds to x + b2 in fp32 and casts; and ``width``
    hidden columns skipped, made by zeroing rows mlp/2 .. mlp/2 + width - 1
    of ``w2``: for K3 one 64-column chunk (the columns one block of a
    cluster computes of a 128-column chunk), for K12 one 512-column quant
    group (``w2`` its int8 codes)."""
    start = w2.shape[0] // 2

    def scaled():
        out = run(w2, True).float() * 0.85
        if not partial:
            out = out + x.float() + b2.float()
        return out.to(x.dtype)

    def skip_chunk():
        cut = w2.clone()
        cut[start:start + width].zero_()
        return run(cut, partial)
    return {"MLP output * 0.85": scaled,
            f"hidden {start}-{start + width - 1} skipped": skip_chunk}


def mlp_q_faults(torch, ops, args, *, partial: bool) -> dict:
    """K17's planted faults (``mlp_faults`` with one 512-column quant group
    of ``w2q`` zeroed) for the case ``ops.mlp_block_q(*args)``; in fp32 a
    third: one 32-row K step of the tf32 tile's fc2 left out (32 rows of
    ``w2q`` zeroed), as ``k3_case`` plants for K3's fp32 tile."""
    x, b2, w2q = args[0], args[8], args[6]

    def run(w, p, a=args):
        return ops.mlp_block_q(*a[:6], w, *a[7:], partial_out=p)
    out = mlp_faults(torch, run, x, b2, w2q, partial=partial,
                     width=ops.reference.MLP_GROUP)
    if x.dtype == torch.float32:
        out.update(mlp_faults(torch, run, x, b2, w2q, partial=partial,
                              width=32))
    return out


def _q_kind(torch, x, args) -> str:
    """The peak-rate type of K17's products on ``x``: bf16, or in fp32 two
    TF32 passes on the tensor-core form (``mlp_q_f32_form``), else fp32 on
    the FFMA units."""
    if x.dtype == torch.bfloat16:
        return "bf16"
    try:
        from vit_tpu_torch.ops.cuda.quant import mlp_q_f32_form
    except ImportError:  # an older checkout (tools/turns.py): FFMA only
        return "fp32"
    d, mlp = args[3].shape
    form = mlp_q_f32_form(d, mlp, (x.data_ptr(), args[3].data_ptr(),
                                   args[6].data_ptr()))
    return "tf32x2" if form == "tf32" else "fp32"


def mlp_q_beside_k3(torch, ops, args, *, partial: bool = False):
    """K3 on the same MLP with the weights dequantized to the tensor's type
    (made once, here): K17's bf16 yardstick at its shape, or None where K3
    does not take the width."""
    x, g, beta, w1q, s1, b1, w2q, s2, b2 = args
    d, mlp = w1q.shape
    if not ops.mlp_plan(d, mlp, x.dtype):
        return None
    w1 = (w1q.float() * s1).to(x.dtype)
    w2 = (w2q.float() * s2).to(x.dtype)
    return lambda: ops.mlp_block(x, g, beta, w1, b1, w2, b2,
                                 partial_out=partial)


def stack_faults(torch, run, enc, *, layer: int = 5, start: int = 1536,
                 width: int = 512, quantized: bool = False) -> dict:
    """Two planted faults of a K9 case whose kernel is ``run(enc)`` and
    whose plain version is ``run(enc, "torch")``, each of which its bar
    must refuse: the K slice ``start`` .. ``start + width - 1`` of layer
    ``layer``'s fc2 weight zeroed (``q``'s codes for int8), one slice of
    fc2's split over K at B/16 bs=1, through the kernel; and an attention
    phase that writes context rows 64-127 of every head from rows 128-191,
    in every layer, planted in the plain version's
    ``reference.attention_core`` (the kernel's phase cannot be reached
    from outside). One head's tile in one layer moves the output less than
    the model bar at these weights: ``kernel_cases_stack_tile`` holds the
    phase to the kernel bar tile by tile."""
    def cut():
        fc2 = dict(enc["fc2"])
        if quantized:
            q = fc2["kernel"]["q"].clone()
            q[layer, start:start + width].zero_()
            fc2["kernel"] = {**fc2["kernel"], "q": q}
        else:
            w = fc2["kernel"].clone()
            w[layer, start:start + width].zero_()
            fc2["kernel"] = w
        return run({**enc, "fc2": fc2})

    def shifted():
        from vit_tpu_torch.ops import reference
        core = reference.attention_core

        def faulty(qkv, *, batch, num_heads, scale, seq_len):
            out = core(qkv, batch=batch, num_heads=num_heads, scale=scale,
                       seq_len=seq_len)
            o = out.view(batch, qkv.shape[0] // batch, -1)
            o[:, 64:128] = o[:, 128:192].clone()
            return out
        reference.attention_core = faulty
        try:
            return run(enc, "torch")
        finally:
            reference.attention_core = core
    return {f"layer {layer} fc2 K {start}-{start + width - 1} zeroed": cut,
            "rows 64-127's context written from rows 128-191, every head "
            "and layer": shifted}


def stack_dma(torch, enc, b: int, dtype):
    """K24's ``dma`` variant on the stacked weights of ``enc`` at b images
    of 208 tokens: K9's weight stream alone on the same grid, K9's floor
    beside it (a closure over its scratch, made at the first call)."""
    from vit_tpu_torch.tools import encstack_minrepro as em
    d = enc["qkv"]["kernel"].shape[1]
    L, mlp = enc["fc1"]["kernel"].shape[0], enc["fc1"]["kernel"].shape[2]
    fn = em.make_variant("dma@flat", b=b, sp=208, d=d, mlp=mlp, L=L,
                         cq=128, mt=128, dtype=dtype, heads=d // 64)
    x = torch.zeros((b * 208, d), dtype=dtype, device="cuda")
    ws = [enc[n]["kernel"] for n in ("qkv", "out", "fc1", "fc2")]
    return lambda: fn(x, *ws)


def _misaligned(torch, t):
    """A copy of ``t`` whose base lies one element past its allocation's
    (16-byte aligned) start: TMA cannot read it, so the kernels that take
    it run their FFMA forms."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def mlp_chain(ops, x, g, beta, w1, b1, w2, b2, *, partial: bool = False):
    """K3's function as three of the port's kernels: K1, K2 with bias and
    GELU, K2 with bias and residual (the ``(flash, fused=False)`` route's
    MLP), with the hidden in device memory."""
    h = ops.matmul(ops.layernorm(x, g, beta), w1, b1, "gelu")
    if partial:
        return ops.matmul(h, w2)
    return ops.matmul(h, w2, b2, residual=x)


def k3_case(torch, ops, name, label, args, dtype, *, partial=False,
            primary=True) -> dict:
    """A K3 case on ``args`` (x, g, beta, w1, b1, w2, b2): bound at the
    products' type (fp32: three TF32 passes), its bar held to two planted
    faults (the output x 0.85; 32 hidden columns, one K step of the fp32
    tile's fc2, or one 64-column chunk of the bf16 tile's, left out) and
    to two calls giving the same bits, timed beside the same MLP as K1 ->
    K2 -> K2."""
    x, g, beta, w1, b1, w2, b2 = args
    m, d = x.shape
    mlp = w1.shape[1]
    e = dtype.itemsize

    def run(w=w2, p=partial):
        return ops.mlp_block(x, g, beta, w1, b1, w, b2, partial_out=p)
    return case(
        name, label,
        lambda impl: ops.mlp_block(*args, partial_out=partial, impl=impl),
        ((2 * m * d + 2 * d * mlp + mlp + (2 if partial else 3) * d) * e,
         4 * m * d * mlp, _split_kind(torch, dtype)),
        check=twice_bit_for_bit(run), primary=primary,
        faults=mlp_faults(torch, run, x, b2, w2, partial=partial,
                          width=64 if dtype == torch.bfloat16 else 32),
        composed=lambda: mlp_chain(ops, *args, partial=partial))


def k3_h14_case(torch, ops, rnd) -> dict:
    """K3 in fp32 at H/14 bs=2 (544 x 1280, MLP 5120): the tf32 tile's
    16-row form (bf16 K3 stops at D = 1024)."""
    m, d, mlp = 2 * 272, 1280, 5120
    args = (rnd(m, d, std=1.5, mean=0.2), rnd(d, std=0.1, mean=1.0),
            rnd(d, std=0.05), rnd(d, mlp, std=0.03), rnd(mlp, std=0.02),
            rnd(mlp, d, std=0.02), rnd(d, std=0.02))
    return k3_case(torch, ops, "mlp_block", f"H/14 bs=2 ({m},{d}) mlp {mlp}",
                   args, torch.float32, primary=False)


def mlp_chain_i8(ops, x, g, beta, w1q, s1, b1, w2q, s2, b2, *,
                 partial: bool = False):
    """K12's work as four of the port's kernels: K10 with LN, K11 with bias
    and GELU, K10, K11 with bias and residual (none in the partial form),
    the hidden in device memory, rounded to the dtype and quantized per row
    over the whole hidden: a timing reference only."""
    xf = x.reshape(-1, x.shape[-1])
    xq, ax = ops.quantize_rows(xf, ln_scale=g, ln_bias=beta)
    h = ops.matmul_i8(xq, ax, w1q, s1, b1, "gelu", out_dtype=x.dtype)
    hq, ah = ops.quantize_rows(h)
    if partial:
        out = ops.matmul_i8(hq, ah, w2q, s2, out_dtype=x.dtype)
    else:
        out = ops.matmul_i8(hq, ah, w2q, s2, b2, residual=xf,
                            out_dtype=x.dtype)
    return out.view(x.shape)


def int_mm_layouts(torch, xq, wq) -> dict:
    """``torch._int_mm`` of ``xq @ wq`` with the weight as K11 reads it,
    N-major, and K-major: ``wt.t()`` of an (N, K) copy made once, here,
    outside the timed call. Phase 11 reports the faster as K11's library
    time."""
    wt = wq.t().contiguous()
    return {"N-major": lambda: torch._int_mm(xq, wq),
            "K-major": lambda: torch._int_mm(xq, wt.t())}


def flash_faults(run, seq_len: int) -> dict:
    """Two planted faults of a K7 or K4-core case whose kernel is
    ``run(seq_len)``:
    the output scaled by 0.85, and the last 16 real keys masked (one
    16-key fragment of a key tile dropped)."""
    return {"output * 0.85": lambda: run(seq_len) * 0.85,
            "last 16 real keys dropped": lambda: run(seq_len - 16)}


def check_faults(torch, c: dict, want, dtype) -> None:
    """Raise unless ``c``'s bar refuses each of its planted faults."""
    for what, fault in c["faults"].items():
        try:
            res = c["check"](torch, fault(), want, dtype)
        except AssertionError as err:
            log(f"[kernel] {c['name']} {c['label']} {dtype}: planted fault "
                f"({what}) refused: {err}")
            continue
        raise AssertionError(f"{c['name']} {c['label']} {dtype}: the bar "
                             f"passed a planted fault ({what}): {res}")


def gemm_work(m: int, k: int, n: int, e: int, kind: str, *,
              out_e: int | None = None, residual: bool = False,
              bias: bool = True) -> tuple:
    """(bytes, operations, type) of (m, k) @ (k, n) (+ bias): each input
    read once, the output written once."""
    out_e = e if out_e is None else out_e
    return ((m * k + k * n + n * bias) * e
            + m * n * out_e * (2 if residual else 1), 2 * m * k * n, kind)


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


@contextlib.contextmanager
def gemm_paths():
    """Record K2's tile choices inside the block: each call of
    ``ops.cuda.matmul.gemm_path``, its shape and transposes and the tile it
    named."""
    from vit_tpu_torch.ops.cuda import matmul as cuda_matmul
    choose, records = cuda_matmul.gemm_path, []

    def spy(*args):
        path = choose(*args)
        records.append((args[:3], args[4:6], path))
        return path
    cuda_matmul.gemm_path = spy
    try:
        yield records
    finally:
        cuda_matmul.gemm_path = choose


def check_gemm_paths(label: str, records: list, counts: dict) -> None:
    """Every K2 call of a bf16 path took the wgmma tile: a tile choice for
    each K2 launch (``fused_linear`` without LN is K2 too), all
    ``"wgmma"``."""
    other = [r for r in records if r[2] != "wgmma"]
    if len(records) < counts["matmul"] or other:
        raise AssertionError(f"{label}: {len(records)} K2 tile choices for "
                             f"{counts['matmul']} matmul launches; not "
                             f"wgmma: {other[:5]}")
    shapes = sorted({r[:2] for r in records})
    log(f"[gemm_path] {label}: {len(records)} K2 calls, all on the wgmma "
        f"tile; (m, n, k), (trans_a, trans_b): {shapes}")


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


def _split_kind(torch, dtype) -> str:
    """The peak-rate type of K2's, K4's core's, K7's and K13's products in
    ``dtype``: fp32 runs them as three TF32 passes on the tensor cores."""
    return "bf16" if dtype == torch.bfloat16 else "tf32x3"


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
             10 * b * h * s * seq_len * hd, _split_kind(torch, dtype)),
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
    k2kind = _split_kind(torch, dtype)
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
    # The QKV's output gradient, at a scale for each backward product:
    # unit for g @ w.t() (outputs near 1.9 over K = 2304); 0.01 for
    # x.t() @ g, whose K = 6656 sums would reach 80 with unit g, where fp32
    # sum orders differ by ~1e-3 against the absolute 1e-4 bar (0.01 puts
    # them near 0.8). Each case also holds its bar to two planted faults.
    gu, gf = rnd(m, 3 * d), rnd(m, 3 * d, std=0.01)
    x3 = x.reshape(b, sp, d)
    scale = hd ** -0.5
    q, k, v = qkv.view(b, sp, 3, heads, hd).permute(2, 0, 3, 1, 4)

    def attn_core(impl, seq_len=s):
        if impl == "torch":
            return reference.attention_core(qkv, batch=b, num_heads=heads,
                                            scale=scale, seq_len=seq_len)
        return cuda_block.attention_core(qkv, batch=b, num_heads=heads,
                                         scale=scale, seq_len=seq_len)

    def flash(n=s):
        return ops.flash_attention(q, k, v, scale=scale, seq_len=n)

    att_ops = attention_ops(b, heads, sp, s, hd)
    return [
        case("layernorm", f"({m},{d})",
             lambda impl: ops.layernorm(x, g, beta, impl=impl),
             (2 * m * d * e + 2 * d * e, 8 * m * d, "fp32"),
             library=lambda: F.layer_norm(x, (d,), g, beta, 1e-12)),
        case("matmul", f"({32 * 196},{d})@({d},{d})+bias",
             lambda impl: ops.matmul(patches, w_dd, b_d, impl=impl),
             gemm_work(32 * 196, d, d, e, k2kind),
             library=lambda: torch.addmm(b_d, patches, w_dd), primary=False),
        case("matmul", f"({m},{d})@({d},{mlp})+bias+gelu",
             lambda impl: ops.matmul(x, w_dm, b_m, "gelu", impl=impl),
             gemm_work(m, d, mlp, e, k2kind), primary=False),
        case("matmul", f"({m},{d})@({d},{d})+bias+residual",
             lambda impl: ops.matmul(x, w_dd, b_d, residual=x, impl=impl),
             gemm_work(m, d, d, e, k2kind, residual=True), primary=False),
        # The training backward's two products of the QKV, on the views
        # it hands K2 (the wgmma tile reads them where they lie).
        case("matmul", f"g ({m},{3 * d}) @ w.t() ({3 * d},{d})",
             lambda impl: ops.matmul(gu, wqkv.t(), impl=impl),
             gemm_work(m, 3 * d, d, e, k2kind, bias=False),
             library=lambda: torch.matmul(gu, wqkv.t()), primary=False,
             faults=gemm_faults(torch, lambda a: ops.matmul(a, wqkv.t()),
                                gu, 1)),
        case("matmul", f"x.t() ({d},{m}) @ g ({m},{3 * d})",
             lambda impl: ops.matmul(x.t(), gf, impl=impl),
             gemm_work(d, m, 3 * d, e, k2kind, bias=False),
             library=lambda: torch.matmul(x.t(), gf), primary=False,
             faults=gemm_faults(torch, lambda a: ops.matmul(a.t(), gf),
                                x, 0)),
        case("matmul", f"({m},{d})@({d},{3 * d})+bias",
             lambda impl: ops.matmul(x, wqkv, bqkv, impl=impl),
             gemm_work(m, d, 3 * d, e, k2kind),
             library=lambda: torch.addmm(bqkv, x, wqkv)),
        # K6 at the B/16 train step's LN1 + QKV (its forward and remat),
        # beside K1 -> K2 on the same operands; in fp32 also its LN2 + fc1
        # + GELU, and the FFMA tile on an x whose base is 4 bytes past
        # 16-byte alignment (where TMA cannot read it).
        k6_case(torch, ops, x, wqkv, bqkv, g, beta, e, kind, primary=False),
        *([] if dtype == torch.bfloat16 else [
            k6_case(torch, ops, x, w_dm, b_m, g, beta, e, kind,
                    primary=False, act="gelu"),
            k6_case(torch, ops, _misaligned(torch, x[:208]), wqkv, bqkv, g,
                    beta, e, kind, primary=False, tag="misaligned x ")]),
        # K3's bar refuses two planted faults and two calls give the same
        # bits; its second yardstick is the same MLP as K1 -> K2 -> K2. In
        # fp32 also the shard form over model=2 (the kernels line's fp32
        # figures for mlp_block_partial).
        k3_case(torch, ops, "mlp_block", f"({m},{d}) mlp {mlp}",
                (x, g, beta, w_dm, b_m, w_md, b_d), dtype),
        *([] if dtype == torch.bfloat16 else [k3_case(
            torch, ops, "mlp_block_partial",
            f"B/16 bs=32 model=2 shard ({m},{d}) mlp {mlp // 2}",
            (x, g, beta, w_dm[:, :mlp // 2].contiguous(), b_m[:mlp // 2],
             w_md[:mlp // 2].contiguous(), b_d), dtype, partial=True)]),
        # K4's core and K7 (fp32: three TF32 passes) refuse two planted
        # faults each, and give the same bits on two calls.
        case("attention", f"qkv ({m},{3 * d}) heads {heads} seq_len {s}",
             attn_core, (4 * m * d * e, att_ops, k2kind),
             library=lambda: _sdpa(torch, q, k, v, scale, s),
             check=twice_bit_for_bit(lambda: attn_core("cuda")),
             faults=flash_faults(lambda n: attn_core("cuda", n), s)),
        # K7 at the (flash, fused=False) route's shape: the heads of the
        # packed QKV buffer as views.
        case("flash_attention", f"packed qkv B={b} H={heads} S={sp} "
             f"seq_len {s} d={hd}",
             lambda impl: ops.flash_attention(q, k, v, scale=scale,
                                              seq_len=s, impl=impl),
             (4 * m * d * e, att_ops, k2kind),
             library=lambda: _sdpa(torch, q, k, v, scale, s), primary=False,
             check=twice_bit_for_bit(flash), faults=flash_faults(flash, s)),
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
             gemm_work(m, d, d, e, _split_kind(torch, dtype), residual=True),
             primary=False),
        k6_case(torch, ops, x, wqkv, bqkv, g, beta, e, kind),
        case("flash_attention", f"packed qkv B={b} H={heads} S={sp} "
             f"seq_len {s} d={hd}",
             lambda impl: ops.flash_attention(q, k, v, scale=hd ** -0.5,
                                              seq_len=s, impl=impl),
             (4 * m * d * e, attention_ops(b, heads, sp, s, hd),
              _split_kind(torch, dtype)),
             library=lambda: _sdpa(torch, q, k, v, hd ** -0.5, s),
             check=twice_bit_for_bit(lambda: ops.flash_attention(
                 q, k, v, scale=hd ** -0.5, seq_len=s)),
             faults=flash_faults(lambda n: ops.flash_attention(
                 q, k, v, scale=hd ** -0.5, seq_len=n), s)),
        k3_case(torch, ops, "mlp_block", f"({m},{d}) mlp {mlp}",
                (x, g, beta, w_dm, b_m, w_md, b_d), dtype, primary=False),
    ] + ([] if dtype == torch.bfloat16 else [k3_h14_case(torch, ops, rnd)])


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
    (bs=4 and 1: 196 patches of 768 into 208 rows), the H/14 one (bs=2:
    256 patches of 588 into 272 rows of 1280; in fp32 also bs=1, and B/16
    bs=1 on a misaligned base, K8's FFMA rule) and, last, the L/16-384 one
    of phase 7's bucket 4 (576 patches of 768 into 592 rows of 1024),
    whose time the kernels line reports; K9 in both forms as the whole
    12-layer B/16 encoder at bs=1 and bs=2, 197 of 208 tokens, with the
    random B/16 weights of ``init_params``."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.config import VARIANTS
    from vit_tpu_torch.models.vit import fold_base, init_params

    rnd = _rnd_fn(torch, dtype, 5)
    e, kind = dtype.itemsize, _kind(torch, dtype)
    cases = []
    shapes = [(4, 196, 768, 768, 208, False), (2, 256, 588, 1280, 272, False),
              (1, 196, 768, 768, 208, False)]
    if dtype == torch.float32:
        # H/14 bs=1 on the tf32 tile (K = 588: its last 32-deep step
        # ragged), and B/16 bs=1 with the patches one float past an
        # aligned base, which TMA cannot read: the FFMA rule.
        shapes += [(1, 256, 588, 1280, 272, False),
                   (1, 196, 768, 768, 208, True)]
    shapes.append((4, 576, 768, 1024, 592, False))
    for b, n, k, d, sp, off in shapes:
        pt = rnd(b, n, k)
        args = (_misaligned(torch, pt) if off else pt, rnd(k, d, std=0.03),
                rnd(d, std=0.1), rnd(d), rnd(n, d))
        cases.append(case(
            "embed_fused", f"({b},{n},{k}){' misaligned ' if off else ''}"
            f"@({k},{d}) -> ({b},{sp},{d})",
            lambda impl, a=args, sp=sp: ops.embed_fused(*a, sp, impl=impl),
            ((b * n * k + k * d + n * d + 2 * d + b * sp * d) * e,
             2 * b * n * k * d, kind if off else _split_kind(torch, dtype)),
            check=k8_check(torch, args, sp, off),
            faults=gemm_faults(torch, lambda pt, a=args, sp=sp:
                               ops.embed_fused(pt, *a[1:], sp), args[0], 2,
                               start=256),
            composed=lambda a=args, m=b * n: ops.matmul(
                a[0].reshape(m, a[0].shape[2]), a[1], a[2]),
            # fp32: its GEMM as one PyTorch call (PERF.md's fp32 rows).
            library=None if dtype == torch.bfloat16 else (
                lambda a=args, m=b * n: torch.addmm(
                    a[2], a[0].reshape(m, a[0].shape[2]), a[1]))))
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
        # Each form's bar refuses a zeroed K slice of one layer's fc2 and
        # a query tile's context written one tile off; at bs=1 each is
        # timed beside K24's dma, its weight stream alone.
        dma = stack_dma(torch, p["encoder"], b, dtype) if b == 1 else None
        cases.append(case("encoder_stack", f"B/16 12 layers ({b},208,768)",
                          lambda impl, x=x: ops.encoder_stack(
                              x, p["encoder"], impl=impl, **kw),
                          work, primary=b == 1,
                          faults=stack_faults(
                              torch, lambda enc, impl=None, x=x:
                              ops.encoder_stack(x, enc, impl=impl, **kw),
                              p["encoder"]),
                          composed=dma))
        nbytes, ops_, _ = work

        def fused(enc, impl=None, pt=patches):
            return ops.encoder_stack_fused(
                pt, enc, p["embeddings"]["patch_embed"]["kernel"], base,
                p["ln_final"], sp=208, impl=impl, **kw)
        cases.append(case(
            "encoder_stack_fused",
            f"B/16 embed + 12 layers + LN, patches ({b},196,768)",
            lambda impl, f=fused: f(p["encoder"], impl),
            (nbytes + (b * 196 * 768 + 768 * 768 + 208 * 768) * e,
             ops_ + 2 * b * 196 * 768 * 768, kind), primary=b == 1,
            faults=stack_faults(torch, fused, p["encoder"]),
            composed=dma))
    return cases


def k8_check(torch, args, sp: int, misaligned: bool = False):
    """K8's bar: the kernel bar against the plain version and, on the
    ``wgmma`` tiles (``ops.cuda.embed.embed_tile``; in fp32 also on the
    FFMA tile of the misaligned case), every token row bit for bit with K2
    on the same operands, cast, then ``+ pos`` in the dtype (row 0
    ``cls_row``, the pad rows zero). In fp32 the tile is asserted (the
    tf32 tile unless the patches are ``misaligned``) and two calls must
    give the same bits."""
    from vit_tpu_torch import ops

    def check(torch, got, want, dtype):
        # Imported here: tools/turns.py builds these cases against older
        # checkouts too, which have no embed_tile.
        from vit_tpu_torch.ops.cuda.embed import embed_tile

        res = compare(torch, got, want, dtype)
        tile = embed_tile(args[0], args[1])
        res["tile"] = tile
        if dtype == torch.float32:
            if tile != ("ffma" if misaligned else "wgmma"):
                raise AssertionError(f"fp32 K8 on the {tile} tile")
            if not torch.equal(got, ops.embed_fused(*args, sp)):
                raise AssertionError("two calls differ")
            res["two_calls_bit_for_bit"] = True
        if dtype == torch.float32 or tile == "wgmma":
            b, n, k = args[0].shape
            chain = torch.zeros_like(got)
            chain[:, 0] = args[3]
            chain[:, 1:n + 1] = ops.matmul(
                args[0].reshape(b * n, k), args[1], args[2]).reshape(
                    b, n, -1) + args[4]
            if not torch.equal(got, chain):
                raise AssertionError("not bit for bit with K2 -> cast -> "
                                     "+ pos")
            res["k2_chain_bit_for_bit"] = True
        return res
    return check


def stack_tile_fault(torch, run, *, head: int, rows: int) -> dict:
    """A planted fault of a one-layer K9 case whose plain version is
    ``run("torch")``: head ``head``'s context on query rows ``rows`` ..
    2 rows - 1 taken from the next ``rows`` rows, planted in the plain
    version's ``reference.attention_core``: one 32-row tile of one head at
    ``rows`` = 32, which the kernel bar must refuse."""
    def shifted():
        from vit_tpu_torch.ops import reference
        core = reference.attention_core

        def faulty(qkv, *, batch, num_heads, scale, seq_len):
            out = core(qkv, batch=batch, num_heads=num_heads, scale=scale,
                       seq_len=seq_len)
            dh = out.shape[1] // num_heads
            o = out.view(batch, qkv.shape[0] // batch, -1)
            cols = slice(head * dh, (head + 1) * dh)
            o[:, rows:2 * rows, cols] = o[:, 2 * rows:3 * rows, cols].clone()
            return out
        reference.attention_core = faulty
        try:
            return run("torch")
        finally:
            reference.attention_core = core
    return {f"head {head}'s query rows {rows}-{2 * rows - 1} written from "
            f"rows {2 * rows}-{3 * rows - 1}": shifted}


def kernel_cases_stack_tile(torch, dtype):
    """K9's attention phase held tile by tile: each form (``encoder_stack``,
    ``_fused``, ``_q``) on one layer whose out-projection is the identity
    (bias 0) and whose MLP is zero, so that the output is x plus the
    attention phase's context (with FOLD, the final LN of it), against the
    plain version at the kernel bar (the whole-encoder cases hold twelve
    layers to the model bar, under which one tile of one head stays);
    B/16 at bs=1 and 2 and L/16 at bs=1, 197 of 208 tokens, x (and FOLD's
    embedding) small beside the context, QKV weights of std 0.04 (score
    spread about 1.2; the phase's 32-row tiles at bs=1, 64-row ones at
    bs=2). Each refuses one head's query rows 32-63 written from rows
    64-95."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.config import VARIANTS
    from vit_tpu_torch.quant import quantize_params

    rnd = _rnd_fn(torch, dtype, 12)
    e, kind = dtype.itemsize, _kind(torch, dtype)

    def zero(*shape):
        return torch.zeros(shape, dtype=dtype, device="cuda")
    cases = []
    for variant, b in (("B/16", 1), ("B/16", 2), ("L/16", 1)):
        cfg = VARIANTS[variant]
        d, heads, mlp = cfg.hidden_dim, cfg.num_heads, cfg.mlp_dim
        enc = {"ln1": {"scale": rnd(1, d, std=0.1, mean=1.0),
                       "bias": rnd(1, d, std=0.05)},
               "qkv": {"kernel": rnd(1, d, 3 * d, std=0.04),
                       "bias": rnd(1, 3 * d, std=0.02)},
               "out": {"kernel": torch.eye(d, dtype=dtype,
                                           device="cuda")[None],
                       "bias": zero(1, d)},
               "ln2": {"scale": rnd(1, d, std=0.1, mean=1.0),
                       "bias": rnd(1, d, std=0.05)},
               "fc1": {"kernel": zero(1, d, mlp), "bias": zero(1, mlp)},
               "fc2": {"kernel": zero(1, mlp, d), "bias": zero(1, d)}}
        qenc = quantize_params({"encoder": {
            k: {n: t.float() if n == "kernel" else t for n, t in v.items()}
            for k, v in enc.items()}})["encoder"]
        x = rnd(b, 208, d, std=0.01)
        x[:, 197:] = 0
        patches = rnd(b, 196, 768)
        wemb, base = rnd(768, d, std=0.0004), rnd(208, d, std=0.01)
        lnf = {"scale": rnd(d, std=0.1, mean=1.0), "bias": rnd(d, std=0.05)}
        kw = dict(num_heads=heads, scale=cfg.head_dim ** -0.5, seq_len=197,
                  eps=1e-12)
        tag = f"{variant} one layer b={b}, context passed through"
        work = _stack_work(b, 208, 197, d, mlp, heads, 1, e, kind)
        runs = {
            "encoder_stack": lambda impl, x=x, enc=enc, kw=kw:
                ops.encoder_stack(x, enc, impl=impl, **kw),
            "encoder_stack_fused": lambda impl, enc=enc, kw=kw,
                pt=patches, wemb=wemb, base=base, lnf=lnf:
                ops.encoder_stack_fused(pt, enc, wemb, base, lnf, sp=208,
                                        impl=impl, **kw),
            "encoder_stack_q": lambda impl, x=x, qenc=qenc, kw=kw:
                ops.encoder_stack_q(x, qenc, impl=impl, **kw)}
        for name, run in runs.items():
            cases.append(case(
                name, tag, run, work, check=compare, primary=False,
                faults=stack_tile_fault(torch, run, head=heads // 2,
                                        rows=32)))
    return cases


def k10_scalar_form(torch, x, ln=None):
    """K10's scalar form (``common.cuh:quantize_row``, K12's prologue) on
    the rows of ``x``, launched through the C entry point whatever
    ``quantize_rows_form`` gives: the yardstick of the row form's bits."""
    from vit_tpu_torch.ops.cuda import _build
    from vit_tpu_torch.ops.cuda.quant import QUANTIZE_ROWS_FORMS

    m, d = x.shape
    q = torch.empty((m, d), dtype=torch.int8, device=x.device)
    a = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    _build.launch("vit_quantize_rows", x, *(ln or (None, None)), q, a, m, d,
                  1e-12, QUANTIZE_ROWS_FORMS["scalar"], like=x)
    return q, a


def k10_case(ops, label: str, x, ln=None, *, primary: bool = False):
    """A K10 case on the rows of ``x`` (M, D), with LN (``ln`` = (gamma,
    beta)) or without: bit for bit with the plain version without LN, the
    flip bar with it (:func:`compare_codes`), and in both two calls bit for
    bit and, where ``quantize_rows_form`` gives the row form, bit for bit
    with the scalar form (``common.cuh:quantize_row``, K12's prologue)."""
    m, d = x.shape
    e = x.element_size()
    kw = {} if ln is None else {"ln_scale": ln[0], "ln_bias": ln[1]}

    def check(torch, got, want, dtype):
        # Imported here: tools/turns.py builds these cases against older
        # checkouts too, whose K10 has one form.
        from vit_tpu_torch.ops.cuda import quant as cuda_quant

        res = (compare_codes if ln else compare_exact)(torch, got, want,
                                                       dtype)
        if not all(torch.equal(a, b)
                   for a, b in zip(got, ops.quantize_rows(x, **kw))):
            raise AssertionError("two calls differ")
        res["two_calls_bit_for_bit"] = True
        res["form"] = cuda_quant.quantize_rows_form(d)
        if res["form"] == "row":
            scalar = k10_scalar_form(torch, x, ln)
            if not all(torch.equal(a, b) for a, b in zip(got, scalar)):
                raise AssertionError("not bit for bit with the scalar form")
            res["scalar_form_bit_for_bit"] = True
        return res

    work = ((m * d * (e + 1) + 4 * m + 2 * d * e, 10 * m * d, "fp32") if ln
            else (m * d * (e + 1) + 4 * m, 3 * m * d, "fp32"))
    return case("quantize_rows", label,
                lambda impl: ops.quantize_rows(x, impl=impl, **kw), work,
                check=check, primary=primary)


def kernel_cases_int8(torch, dtype):
    """The int8 kernels at the main paths' shapes: B/16 bs=32 (M=6656,
    D=768, MLP 3072; K11's QKV case is the one the kernels line reports,
    with ``torch._int_mm`` as its yardstick), L/16-384 bs=8 (attention at
    592 tokens through K7 with an fp32 output) and H/14 bs=2 (D=1280, MLP
    5120, fc2's K=5120); K10 (:func:`k10_case`) with LN and on an fp32
    context at each of the three widths (row form), and on B/16's model=4
    context shard (D = 192, scalar form); ``attn_block_q`` whole at B/16
    and L/16-384."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.quant import quantize_weight

    rnd = _rnd_fn(torch, dtype, 9)
    # The fp32 context and hidden rows from a generator of their own, so
    # that a process draws the same ones wherever it builds these cases
    # (tools/turns.py compares their outputs' bits across checkouts).
    gen32 = torch.Generator(device="cuda").manual_seed(10)
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
        ctx = torch.randn((m, d), generator=gen32, device="cuda")
        cq, ac = ops.quantize_rows(ctx, impl="torch")
        hq, ah = ops.quantize_rows(torch.randn((m, mlp), generator=gen32,
                                               device="cuda"),
                                   impl="torch")
        qkv = rnd(m, 3 * d)
        q, k, v = qkv.view(b, sp, 3, heads, hd).permute(2, 0, 3, 1, 4)
        x3 = x.reshape(b, sp, d)
        att_ops = attention_ops(b, heads, sp, s, hd)
        if tag != "L/16-384":
            cases += [
                k10_case(ops, f"{tag} LN ({m},{d})", x, (g, beta),
                         primary=main),
                k10_case(ops, f"{tag} fp32 context ({m},{d})", ctx),
                case("matmul_i8", f"{tag} ({m},{mlp})@({mlp},{d})"
                     "+bias+residual",
                     lambda impl, a=(hq, ah, w2, b_d, x): ops.matmul_i8(
                         a[0], a[1], a[2]["q"], a[2]["scale"], a[3],
                         residual=a[4], out_dtype=dtype, impl=impl),
                     gemm_work(m, mlp, d, 1, "int8", out_e=e, residual=True),
                     library=int_mm_layouts(torch, hq, w2["q"]),
                     check=compare_exact, primary=False),
                case("matmul_i8", f"{tag} ({m},{d})@({d},{d})+bias+residual",
                     lambda impl, a=(cq, ac, wout, b_d, x): ops.matmul_i8(
                         a[0], a[1], a[2]["q"], a[2]["scale"], a[3],
                         residual=a[4], out_dtype=dtype, impl=impl),
                     gemm_work(m, d, d, 1, "int8", out_e=e, residual=True),
                     library=int_mm_layouts(torch, cq, wout["q"]),
                     check=compare_exact, primary=False),
                case("matmul_i8", f"{tag} ({m},{d})@({d},{3 * d})+bias",
                     lambda impl, a=(xq, ax, wqkv, bqkv): ops.matmul_i8(
                         a[0], a[1], a[2]["q"], a[2]["scale"], a[3],
                         out_dtype=dtype, impl=impl),
                     gemm_work(m, d, 3 * d, 1, "int8", out_e=e),
                     library=int_mm_layouts(torch, xq, wqkv["q"]),
                     check=compare_exact, primary=main),
                # K12's bar refuses two planted faults; its second
                # yardstick is the same MLP as K10 -> K11 -> K10 -> K11.
                case("mlp_block_i8dot", f"{tag} ({m},{d}) mlp {mlp}",
                     lambda impl, a=(x, g, beta, w1, b_m, w2, b_d):
                     ops.mlp_block_i8dot(
                         a[0], a[1], a[2], a[3]["q"], a[3]["scale"], a[4],
                         a[5]["q"], a[5]["scale"], a[6], impl=impl),
                     ((2 * m * d + mlp + 3 * d) * e + 2 * d * mlp
                      + 4 * (mlp + d), 4 * m * d * mlp, "int8"),
                     check=compare_i8, primary=main,
                     faults=mlp_faults(
                         torch, lambda w, p, a=(x, g, beta, w1, b_m, w2, b_d):
                         ops.mlp_block_i8dot(
                             a[0], a[1], a[2], a[3]["q"], a[3]["scale"],
                             a[4], w, a[5]["scale"], a[6], partial_out=p),
                         x, b_d, w2["q"], partial=False,
                         width=ops.reference.MLP_GROUP),
                     composed=lambda a=(x, g, beta, w1, b_m, w2, b_d):
                     mlp_chain_i8(ops, a[0], a[1], a[2], a[3]["q"],
                                  a[3]["scale"], a[4], a[5]["q"],
                                  a[5]["scale"], a[6])),
            ]
        if tag == "L/16-384":
            cases += [k10_case(ops, f"{tag} LN ({m},{d})", x, (g, beta)),
                      k10_case(ops, f"{tag} fp32 context ({m},{d})", ctx)]
        if main:
            # The context rows of a model=4 shard (dl = 192): the scalar
            # form.
            cases.append(k10_case(
                ops, f"{tag} model=4 context shard ({m},192)",
                ctx[:, :192].contiguous()))
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
                     check=compare_bf16, primary=False,
                     faults=flash_faults(
                         lambda n, a=(q, k, v, hd): ops.flash_attention(
                             a[0], a[1], a[2], scale=a[3] ** -0.5, seq_len=n,
                             out_dtype=torch.float32), s)),
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
            check=check, primary=variant == "B/16",
            faults=stack_faults(
                torch, lambda enc, impl=None, x=x, kw=kw:
                ops.encoder_stack_q(x, enc, impl=impl, **kw), qenc,
                quantized=True)))
    return cases


def kernel_cases_chain(torch, dtype):
    """The reference op chain's kernels at B/16 bs=32's unfused shapes (197
    real tokens, no padding): K14 on the (6304, 768) residual, bit for bit;
    K15 on the 384*197 score rows of 197; K16 on the scores (384, 197, 64)
    @ (384, 64, 197) * 1/8, the case the kernels line reports, the context
    (384, 197, 197) @ (384, 197, 64), and the scores at 200 tokens (rows
    16-byte aligned); K17 at the int8 per-layer route's B/16 bs=32 MLP
    (6656 x 768, MLP 3072), at L/16-384 bs=8 (4736 x 1024, 4096) and
    H/14 bs=2 (544 x 1280, 5120), and in fp32 also its shard form at B/16
    bs=32 over model=2 (MLP 1536): in fp32 on the tensor cores, two TF32
    passes a product (bound at "tf32x2"), each case's bar holding a third
    planted fault (one 32-row K step of fc2 left out); the B/16 bs=32
    whole and shard forms are the cases the kernels line reports.
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
    q200, kt200 = rnd(bh, 200, hd), rnd(bh, hd, 200)

    def bmm_work(b, mm, k, n):
        return ((b * mm * k + b * k * n + b * mm * n) * e, 2 * b * mm * n * k,
                _split_kind(torch, dtype))

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
        # Each K16 case's bar refuses two planted faults: the output x
        # 0.85, and one K step of the mma.sync tile left out (the
        # context's second 64-deep step; the scores' K = 64 is one step,
        # so a k16 slice of it).
        case("matmul3", f"context ({bh},{s},{s})@({bh},{s},{hd})",
             lambda impl: ops.matmul3(probs, v, impl=impl),
             bmm_work(bh, s, s, hd), library=baddbmm(probs, v, 1.0),
             primary=False, check=twice_bit_for_bit(
                 lambda: ops.matmul3(probs, v)),
             faults=gemm_faults(
                 torch, lambda a: ops.matmul3(a, v), probs, 2, 64, 64)),
        case("matmul3", f"scores ({bh},{s},{hd})@({bh},{hd},{s})*0.125",
             lambda impl: ops.matmul3(q, kt, scale=0.125, impl=impl),
             bmm_work(bh, s, hd, s), library=baddbmm(q, kt, 0.125),
             check=twice_bit_for_bit(
                 lambda: ops.matmul3(q, kt, scale=0.125)),
             faults=gemm_faults(torch, lambda a: ops.matmul3(
                 a, kt, scale=0.125), q, 2, 16, 16)),
        # The same product at 200 tokens, where every row of k^T and of
        # the output is 16-byte aligned: what the 197-token rows cost.
        case("matmul3", f"aligned ({bh},200,{hd})@({bh},{hd},200)*0.125",
             lambda impl: ops.matmul3(q200, kt200, scale=0.125, impl=impl),
             bmm_work(bh, 200, hd, 200), library=baddbmm(q200, kt200, 0.125),
             primary=False),
    ]
    if dtype == torch.float32:
        # The fp32 form past the depth one accumulator holds: K = 2304 in
        # 36 runs of 64, ragged M and N; one run left out is refused.
        # y at std 0.02 keeps the sums near 1 (as K2's x.t() @ g case
        # scales g): at unit scale fp32 sum orders alone differ by ~1e-4.
        xd, yd = rnd(4, s, 2304), rnd(4, 2304, 131, std=0.02)
        cases.append(case(
            "matmul3", f"deep (4,{s},2304)@(4,2304,131)",
            lambda impl: ops.matmul3(xd, yd, impl=impl),
            bmm_work(4, s, 2304, 131), library=baddbmm(xd, yd, 1.0),
            primary=False, check=twice_bit_for_bit(
                lambda: ops.matmul3(xd, yd)),
            faults=gemm_faults(torch, lambda a: ops.matmul3(a, yd), xd, 2,
                               1024, 64)))
    shapes = [("H/14 bs=2", 544, 1280, 5120, False),
              ("L/16-384 bs=8", 4736, 1024, 4096, False)]
    if dtype == torch.float32:
        shapes.append(("B/16 bs=32 model=2 shard", 6656, 768, 1536, True))
    for tag, mm, dd, mlp, partial in shapes + [
            ("B/16 bs=32", 6656, 768, 3072, False)]:
        w1 = quantize_weight(rnd(dd, mlp, std=0.03))
        w2 = quantize_weight(rnd(mlp, dd, std=0.03))
        args = (rnd(mm, dd, std=1.5, mean=0.2), rnd(dd, std=0.1, mean=1.0),
                rnd(dd, std=0.05), w1["q"], w1["scale"], rnd(mlp, std=0.02),
                w2["q"], w2["scale"], rnd(dd, std=0.02))
        # K17's bar refuses its planted faults (three in fp32); it is timed
        # beside K3 on the dequantized weights where K3 takes the width.
        cases.append(case(
            "mlp_block_q_partial" if partial else "mlp_block_q",
            f"{tag} ({mm},{dd}) mlp {mlp}",
            lambda impl, a=args, p=partial: ops.mlp_block_q(
                *a, partial_out=p, impl=impl),
            ((2 * mm * dd + mlp + (2 if partial else 3) * dd) * e
             + 2 * dd * mlp + 4 * (mlp + dd), 4 * mm * dd * mlp,
             _q_kind(torch, args[0], args)),
            primary=tag.startswith("B/16 bs=32"),
            check=twice_bit_for_bit(
                lambda a=args, p=partial: ops.mlp_block_q(*a, partial_out=p))
            if dtype == torch.float32 else None,
            faults=mlp_q_faults(torch, ops, args, partial=partial),
            composed=mlp_q_beside_k3(torch, ops, args, partial=partial)))
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
                a = (x, g, beta, w1, b_m, w2, b_d)
                cases.append(case(
                    "mlp_block_partial", f"{lbl} ({m_rows},{d}) mlp {ml}",
                    lambda impl, a=a: ops.mlp_block(*a, partial_out=True,
                                                    impl=impl),
                    (*mlp_work, _split_kind(torch, dtype)), primary=main,
                    faults=mlp_faults(
                        torch, lambda w, p, a=a: ops.mlp_block(
                            *a[:5], w, a[6], partial_out=p), x, b_d, w2,
                        partial=True),
                    composed=lambda a=a: mlp_chain(ops, *a, partial=True)))
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
                         (*work, "int8"), check=compare_i8, primary=main,
                         faults=mlp_faults(
                             torch, lambda w, p, a=args: ops.mlp_block_i8dot(
                                 *a[:6], w, *a[7:], partial_out=p), x, b_d,
                             q2["q"], partial=True,
                             width=ops.reference.MLP_GROUP),
                         composed=lambda a=args: mlp_chain_i8(
                             ops, *a, partial=True)),
                    case("mlp_block_q_partial",
                         f"{lbl} ({m_rows},{d}) mlp {ml}",
                         lambda impl, a=args: ops.mlp_block_q(
                             *a, partial_out=True, impl=impl),
                         (*work, kind), primary=main,
                         faults=mlp_q_faults(torch, ops, args, partial=True),
                         composed=mlp_q_beside_k3(torch, ops, args,
                                                  partial=True)),
                ]
    return cases


def kernel_cases_layer(torch, dtype):
    """Phase 15's kernels alone. K18 (``layer_tail``: the out-projection,
    LN2 and the MLP from the attention context, y kept in fp32) at B/16
    bs=32 (6656 x 768, MLP 3072), the case the kernels line reports, and
    at L/16 bs=8 (1664 x 1024, 4096); in bf16 at ragged M, in fp32 at H/14
    bs=2 (544 x 1280, 5120) and on the FFMA form; the whole
    ``layer_block`` (K1, K2, the core, K18) at B/16 bs=32, held to the
    model bars (the MLP half carries the attention half's rounding flips),
    timed as a block like K4. K19 ``patchify`` bit for bit at B/16 bs=32, H/14 bs=2 (P=14) and
    L/16-384 bs=8, against ``F.unfold`` (the port never calls it). K20 at
    the JAX test's (16, 128) over a grid of 2 with a condition no block
    meets, so that nothing prints while it is timed (phase 15 checks the
    printing). K21 at the example's (256, 384) @ (384, 512) on
    ``mma.sync`` (fp32 in three TF32 passes), two calls bit for bit,
    against ``torch.matmul`` (also on the card). No PyTorch call computes
    K18, K20 or the layer."""
    import torch.nn.functional as F

    from vit_tpu_torch import ops
    from vit_tpu_torch.examples import minimal_matmul
    from vit_tpu_torch.ops import debug, reference
    from vit_tpu_torch.ops.cuda import block as cuda_block

    rnd = _rnd_fn(torch, dtype, 15)
    e, kind = dtype.itemsize, _kind(torch, dtype)
    cases = []
    shapes = [("B/16 bs=32", 32 * 208, 768, 3072),
              ("L/16 bs=8", 8 * 208, 1024, 4096)]
    if dtype == torch.bfloat16:
        # Ragged M (one row, a cluster and one row) at D = 128 (the second
        # warpgroup owns no columns), 384 (two boxes and one), 768, 1024;
        # L/16 bs=8 takes two passes over the hidden at D = 1024.
        shapes += [("M=1", 1, 128, 128),
                   ("M=65", 65, 128, 3072), ("M=65", 65, 384, 128),
                   ("M=1", 1, 384, 3072), ("M=65", 65, 768, 128),
                   ("M=1", 1, 1024, 3072), ("M=65", 65, 1024, 128)]
    else:
        # The tf32 form at H/14's width (16 rows a block, the sums split
        # past K = 1024), and the FFMA form on a ctx whose base is 4 bytes
        # past 16-byte alignment, at B/16 bs=1.
        shapes += [("H/14 bs=2", 2 * 272, 1280, 5120),
                   ("misaligned ctx B/16 bs=1", 208, 768, 3072)]
    for tag, m, d, mlp in shapes:
        tail = (rnd(m, d), rnd(m, d, std=1.5), rnd(d, d, std=0.03),
                rnd(d, std=0.02), rnd(d, std=0.1, mean=1.0),
                rnd(d, std=0.05), rnd(d, mlp, std=0.03), rnd(mlp, std=0.02),
                rnd(mlp, d, std=0.03), rnd(d, std=0.02))
        if tag.startswith("misaligned"):
            tail = (_misaligned(torch, tail[0]), *tail[1:])
        # fp32: the products' type of the form K18 runs (mlp_f32_form).
        form = "tf32" if dtype == torch.bfloat16 else cuda_block.mlp_f32_form(
            d, mlp, tuple(tail[i].data_ptr() for i in (0, 1, 2, 6, 8)) + (0,))

        def run(impl, a=tail):
            fn = reference.layer_tail if impl == "torch" \
                else cuda_block.layer_tail
            return fn(*a)
        cases.append(case(
            "layer_block", f"K18 {tag} ({m},{d}) mlp {mlp}", run,
            ((3 * m * d + d * d + 2 * d * mlp + mlp + 5 * d) * e,
             2 * m * d * (d + 2 * mlp),
             _split_kind(torch, dtype) if form == "tf32" else kind),
            primary=tag == "B/16 bs=32",
            check=twice_bit_for_bit(lambda a=tail: cuda_block.layer_tail(*a)),
            faults=layer_faults(lambda a: cuda_block.layer_tail(*a), tail),
            composed=k18_chain(ops, tail) if m > 1000 else None))
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
         _split_kind(torch, dtype)), library=lambda: torch.matmul(x, w),
        check=twice_bit_for_bit(lambda: minimal_matmul.matmul(x, w)),
        device=True))
    return cases


def layer_faults(run, a) -> dict:
    """K18's three planted faults for the case ``run(a)`` (``a``: ctx, x,
    wout, bout, LN2's scale and bias, w1, b1, w2, b2): one 64-deep K step
    of the out-projection skipped (rows D/2 .. D/2 + 63 of wout zeroed),
    one 64-column hidden chunk skipped (rows mlp/2 .. mlp/2 + 63 of w2
    zeroed, ``mlp_faults``' way) and the output scaled by 0.85."""
    def zeroed(i):
        cut = a[i].clone()
        k0 = cut.shape[0] // 2
        cut[k0:k0 + 64].zero_()
        return run((*a[:i], cut, *a[i + 1:]))
    d, mlp = a[2].shape[0], a[8].shape[0]
    return {"output * 0.85": lambda: run(a) * 0.85,
            f"Wout K {d // 2}-{d // 2 + 63} skipped": lambda: zeroed(2),
            f"hidden {mlp // 2}-{mlp // 2 + 63} skipped": lambda: zeroed(8)}


def k18_chain(ops, a):
    """K18's yardstick on the same operands: K2 (``ctx @ wout + bout + x``,
    y rounded to the dtype) -> K3. Not the same function: it rounds y."""
    ctx, x, wout, bout, g2, bn2, w1, b1, w2, b2 = a
    return lambda: ops.mlp_block(ops.matmul(ctx, wout, bout, residual=x),
                                 g2, bn2, w1, b1, w2, b2)


def twice_bit_for_bit(run, bar=None):
    """A case's bar (``bar``, by default ``compare``) that also calls the
    kernel ``run()`` a second time and raises unless the two calls give the
    same bits."""
    def check(torch, got, want, dtype):
        res = (bar or compare)(torch, got, want, dtype)
        if not torch.equal(got, run()):
            raise AssertionError("two calls differ")
        res["two_calls_bit_for_bit"] = True
        return res
    return check


def device_ms(torch, fn, iters: int = 20) -> tuple[float, dict]:
    """Device time of ``fn``'s kernels per call, from ``torch.profiler``
    (CUPTI; ``utils.profiling.kernel_times``: a launch's time over the
    records kept, times its launches a call): the sum over kernels, and
    the time of each kernel by name. Unlike :func:`time_ms` it leaves out
    the host's time between launches."""
    from vit_tpu_torch.utils.profiling import kernel_times

    by_name = {}
    for _ in range(3):  # a window whose records were all lost is retried
        for key, (ms, n) in kernel_times(fn, iters).items():
            by_name[key[:60]] = by_name.get(key[:60], 0.0) + ms * n
        if by_name:
            break
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
        with gemm_paths() as k2_paths:
            params, opt, loss = step_fn(params, opt, px, labels)
            torch.cuda.synchronize()
        main_counts[f"{tag} train step"] = counts = launch_counts()
        check_counts(f"{tag} train step", counts,
                     expect_counts(counts, step_counts))
        if dtype == torch.bfloat16:
            check_gemm_paths(f"{tag} train step", k2_paths, counts)
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


#: Phase 16's attention geometry: B/16 at bs=32 (the JAX probe's default),
#: and its encoder geometry: B/16 with the JAX probe's cases at 12 layers.
#: The stripped variants compound over the layers (no LN, an MLP sum never
#: reset). Two have attention on that unnormalised stream: nosm's
#: unnormalised scores leave bf16's range (NaN from the fifth layer on
#: this phase's weights), and core's activations grow ~8x a layer (3e9 by
#: the twelfth), so that a sum-order difference flips the softmax's
#: winners: the kernel and the plain version part, relative 0.03 at four
#: layers, 0.28 at five, 1.2 at twelve (bf16; this phase's log on an
#: NVIDIA H100 80GB HBM3, 700 W). Those two are held to their plain
#: version at ATTN_CHECK_LAYERS layers, core's output is checked finite
#: at 12, and both are logged by depth.
PROBE_ATTN = dict(batch=32, sp=208, seq_len=197, d=768, heads=12, group=4)
ATTN_CHECK_LAYERS = 2


def probe_check_layers(variant: str) -> int:
    """The depth at which phase 16 holds a K24 variant to its plain
    version."""
    return ATTN_CHECK_LAYERS if variant in ("nosm", "core") else 12


def compare_dma(ws):
    """The bar of K24's ``dma`` on the weights ``ws``: x back bit for bit,
    and the kernel's (L, 4) weight sums within 1e-5 x each tensor's summed
    magnitudes of the plain fp32 sums
    (``encstack_minrepro.check_weight_sums``). ``got`` = (x out, the
    closure's ``weight_sums``), ``want`` = (x out, the plain sums)."""
    from vit_tpu_torch.tools import encstack_minrepro as em

    def check(torch, got, want, dtype):
        (out, sums), (x, _) = got, want
        compare_exact(torch, out, x, dtype)
        err = em.check_weight_sums(sums(), *ws)
        return {"max_abs_err": err, "mean_abs_err": err}
    return check


def compare_norm(torch, got, want, dtype) -> dict:
    """A probe's output held in relative norm: 1e-5 in fp32 (sum orders)
    and 2e-2 in bf16 (the whole-encoder bar of ``compare_rel``). K24's
    variants, and K9 as ``full``, are whole encoders on the probe's
    weights (N(0, 0.05), unit LN, zero biases), whose residual stream
    grows (|x| up to 19 after two layers): one bf16 ulp at that scale is
    past the elementwise model bar at the stream's small elements (and
    lnqkv's QKV rounds its LN output to bf16 where the JAX kernel does
    not). K23's modes whose context is not divided by the row sum
    (``attn_core_probe.UNNORMALIZED``) give outputs up to ~200 times the
    normalised block's, and an fp32 sum-order difference that flips a
    bf16 rounding of that context moves them by more than the elementwise
    bar."""
    g, w = got.float(), want.float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError("shape or non-finite values")
    diff = (g - w).abs()
    res = {"max_abs_err": float(diff.max()),
           "mean_abs_err": float(diff.mean()),
           "rel": float((g - w).norm() / w.norm())}
    if not res["rel"] <= (1e-5 if dtype == torch.float32 else 2e-2):
        raise AssertionError(f"outside the relative bar: {res}")
    return res


#: K23's planted faults: for each mode, the modes whose kernel output its
#: bar must refuse, each differing from it in one ingredient (the masked
#: modes also refuse their plain version with the last 16 real keys
#: dropped, a key fragment short). At B/16 bs=2 on the CPU the mask
#: faults come out 1.3-1.5 times their bars, the others 4-2800 times.
PROBE_FAULTS = {
    "full": {"the mask dropped": "divonly", "not divided by l": "maskonly"},
    "maskonly": {"the mask dropped": "nosm"},
    "nosm": {"the mask applied": "maskonly"},
    "mxu": {"max and exp applied": "nosm"},
    "divonly": {"the mask applied": "full"},
    "recip": {"the mask applied": "addmask"},
    "sumonly": {"divided by l": "divonly"},
    "bf16div": {"not divided by l": "nosm"},
    "alldiv": {"the mask applied": "addmask"},
    "mxudiv": {"the mask applied": "addmask"},
    "addmask": {"the mask dropped": "recip"},
    "vsum": {"the mask dropped": "divonly"},
    "qcore": {"int8 codes left out": "full"},
    "wide": {"heads not paired": "divonly"},
    "kt": {"the mask dropped": "divonly"},
    "tcore": {"the mask dropped": "recip"},
    "xcore": {"the mask dropped": "recip"},
    "projonly": {"the core run": "full"},
}
#: wide's rounding point on the core alone: the share of its bf16 context
#: equal to the plain core's (sum orders may flip a rounding) must reach
#: this, and p rounded before the division by l (full's point on paired
#: heads) must fall below it (tests/test_torch_probe_tiles.py: 1.0 and
#: 0.55 on the CPU).
WIDE_EQUAL_SHARE = 0.9


def wide_core_plain(torch, qkv, *, b, sp, d, heads, seq_len, early=False):
    """wide's plain core on the packed QKV, (B*S, D) in its dtype; early:
    with p rounded before the division by l (a planted fault)."""
    from vit_tpu_torch.tools import attn_core_probe as acp
    q, k, v = (acp._heads(qkv[:, i * d:(i + 1) * d], b, sp, heads)
               for i in range(3))
    scale = (d // heads) ** -0.5
    if early:
        qp, kp, vp = (acp._pairs(t).float() for t in (q, k, v))
        s = qp @ kp.transpose(-1, -2) * scale
        p = torch.exp(s - s.amax(-1, keepdim=True))
        ctx = ((p.to(qkv.dtype).float() @ vp) / p.sum(-1, keepdim=True)
               ).to(qkv.dtype)
        ctx = ctx.transpose(1, 2).reshape(b, sp, heads, d // heads) \
            .transpose(1, 2)
    else:
        ctx = acp._core_plain("wide", q, k, v, scale=scale, seq_len=seq_len,
                              dt=qkv.dtype)
    return ctx.transpose(1, 2).reshape(b * sp, d)


def probe_check(mode: str, step: float):
    """The bar of K23's block in ``mode``."""
    from vit_tpu_torch.tools import attn_core_probe as acp
    if mode == "qcore":
        return compare_qcore(step)
    return compare_norm if mode in acp.UNNORMALIZED else compare


def compare_qcore(step: float):
    """qcore's block against its plain version: the kernel bars plus one
    int8 step of its codes (``attn_core_probe.qcore_step``), where a code
    at a .5 boundary rounds the other way in another sum order."""
    def check(torch, got, want, dtype):
        g, w = got.float(), want.float()
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError("shape or non-finite values")
        diff = (g - w).abs()
        res = {"max_abs_err": float(diff.max()),
               "mean_abs_err": float(diff.mean()), "step": step}
        if dtype == torch.float32:
            ok = res["max_abs_err"] <= FP32_BAR + step
        else:
            ok = (bool((diff <= BF16_REL_BAR * (1 + w.abs()) + step).all())
                  and res["mean_abs_err"] <= BF16_MEAN_BAR)
        if not ok:
            raise AssertionError(f"qcore outside its bar: {res}")
        return res
    return check


def kernel_cases_probes(torch, dtype):
    """The probes' kernels alone. K22 ``dot_probe`` at the int8 probe's
    (1664, 768) @ (768, 3072): int8 bit for bit against the plain version
    (the case the kernels line reports, on K11's s8 ``wgmma`` tile;
    yardstick ``torch._int_mm``), bf16 (K2's ``wgmma`` tile) and fp32
    (K2's tf32 tile, three TF32 passes: the fp32 form the kernels line
    reports) to fp32 (yardstick ``torch.matmul``, which returns the input
    type), each bound at its products' type, two calls bit for bit, its
    bar held to ``gemm_faults`` (the output x 0.85, K 512-575 of x
    zeroed). K23: the ``full`` core alone on B/16 bs=32's packed QKV (the case
    the kernels line reports: K4's tensor-core core, its very
    instantiation, in bf16 and in fp32, three TF32 passes; yardstick SDPA;
    also timed on the card), then the whole block in every mode (in fp32
    also two calls bit for bit), and in fp32 the kt QKV GEMM alone (K2's
    tf32 walk with the split-kT epilogue; yardstick ``addmm``), two calls
    bit for bit, its bar held to ``gemm_faults`` (the output x 0.85, K
    512-575 of x zeroed). K24: ``dma`` over B/16's 12 layers at bs=1 (the
    case the kernels line reports: the weight stream; x back bit for bit,
    the weight sums it streamed held to the plain sums), each other
    variant at bs=1 and the depth of :func:`probe_check_layers`. Each
    variant's closures are made once, outside the timed calls."""
    from vit_tpu_torch.ops import reference
    from vit_tpu_torch.tools import attn_core_probe as acp
    from vit_tpu_torch.tools import encstack_minrepro as em
    from vit_tpu_torch.tools import int8_probe

    rnd = _rnd_fn(torch, dtype, 16)
    e, kind = dtype.itemsize, _kind(torch, dtype)
    cases = []
    m, k, n = int8_probe.TIMED_SHAPE
    if dtype == torch.bfloat16:
        gen = torch.Generator(device="cuda").manual_seed(16)
        xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                           dtype=torch.int8)
        cases.append(case(
            "dot_probe", f"int8 ({m},{k})@({k},{n}) -> int32",
            lambda impl: int8_probe.dot(xq, wq, impl=impl),
            ((m * k + k * n) + 4 * m * n, 2 * m * k * n, "int8"),
            library=lambda: torch._int_mm(xq, wq), check=compare_exact))
    xf, wf = rnd(m, k), rnd(k, n, std=0.05)

    def dot_f(a=xf):
        return int8_probe.dot(a, wf)
    cases.append(case(
        "dot_probe", f"{dtype} ({m},{k})@({k},{n}) -> fp32",
        lambda impl: int8_probe.dot(xf, wf, impl=impl),
        ((m * k + k * n) * e + 4 * m * n, 2 * m * k * n,
         _split_kind(torch, dtype)),
        library=lambda: torch.matmul(xf, wf),
        primary=dtype == torch.float32, check=twice_bit_for_bit(dot_f),
        faults=gemm_faults(torch, dot_f, xf, 1, start=512)))

    a = PROBE_ATTN
    b, sp, s, d, heads = a["batch"], a["sp"], a["seq_len"], a["d"], a["heads"]
    bm, hd = b * sp, d // heads
    qkv = rnd(bm, 3 * d)
    q, kk, v = qkv.view(b, sp, 3, heads, hd).permute(2, 0, 3, 1, 4)
    att_ops = attention_ops(b, heads, sp, s, hd)

    def core_full(impl):
        if impl == "torch":
            return reference.attention_core(qkv, batch=b, num_heads=heads,
                                            scale=hd ** -0.5, seq_len=s)
        out = torch.empty((bm, d), dtype=dtype, device="cuda")
        return acp.core_launch("full", qkv, None, out, b=b, sp=sp, d=d,
                         heads=heads, seq_len=s, scale=hd ** -0.5)
    cases.append(case(
        "attn_core_probe", f"core full, qkv ({bm},{3 * d}) heads {heads} "
        f"seq_len {s}", core_full,
        (4 * bm * d * e, att_ops, _split_kind(torch, dtype)),
        library=lambda: _sdpa(torch, q, kk, v, hd ** -0.5, s), device=True))
    x, *w = acp.make_inputs(b, sp, d, s, dtype, "cuda", seed=16)
    wt = (w[2].t().contiguous(), w[4].t().contiguous())
    xt = x.reshape(bm, d).t().contiguous()
    step = acp.qcore_step(x, *w[:5], num_heads=heads)
    block_work = ((2 * bm * d + 4 * d * d + 6 * d) * e,
                  2 * bm * d * 4 * d + att_ops, _split_kind(torch, dtype))
    for mode in acp.MODES:
        xin = xt if mode == "xcore" else x

        def block(impl=None, mode=mode, xin=xin):
            return acp.probe(mode, xin, *w, num_heads=heads, seq_len=s,
                             group=a["group"], shape=(b, sp, d),
                             weights_t=wt, impl=impl)
        bar = probe_check(mode, step)
        cases.append(case(
            "attn_core_probe", f"block {mode} ({b},{sp},{d})", block,
            block_work, primary=False,
            check=(twice_bit_for_bit(block, bar)
                   if dtype == torch.float32 else bar)))
    if dtype == torch.float32:
        # kt's QKV GEMM alone: x @ Wqkv + b with the k third stored
        # transposed, read back into one (M, 3D) result.
        xg, wg, bg = rnd(bm, d), rnd(d, 3 * d, std=0.05), rnd(3 * d)

        def gemm_kt(xa=xg, impl=None):
            if impl == "torch":
                return reference.matmul(xa, wg, bg)
            k_t = torch.empty((d, bm), dtype=dtype, device="cuda")
            out = acp._gemm(xa, wg, bg, acp.EP_SPLIT_KT,
                            out_shape=(bm, 3 * d), alt=k_t, d=d)
            return torch.cat([out[:, :d], k_t.t(), out[:, 2 * d:]], 1)
        cases.append(case(
            "attn_core_probe", f"gemm kt ({bm},{d})@({d},{3 * d})+bias",
            lambda impl: gemm_kt(impl=impl),
            gemm_work(bm, d, 3 * d, e, _split_kind(torch, dtype)),
            library=lambda: torch.addmm(bg, xg, wg), primary=False,
            check=twice_bit_for_bit(gemm_kt),
            faults=gemm_faults(torch, gemm_kt, xg, 1, start=512),
            device=True))

    d, mlp, sp = 768, 3072, 208
    gen = torch.Generator(device="cuda").manual_seed(17)
    for variant in em.VARIANTS:
        layers = probe_check_layers(variant)
        x = (torch.randn((sp, d), generator=gen, device="cuda") * 0.05).to(
            dtype)
        ws = [(torch.randn(sh, generator=gen, device="cuda") * 0.05).to(dtype)
              for sh in ((layers, d, 3 * d), (layers, d, d),
                         (layers, d, mlp), (layers, mlp, d))]
        fns = {impl: em.make_variant(variant, b=1, sp=sp, d=d, mlp=mlp,
                                     L=layers, cq=768, mt=512, dtype=dtype,
                                     impl=impl)
               for impl in ("cuda", "torch")}
        if variant == "dma":
            nw = layers * (4 * d * d + 2 * d * mlp)
            work = (nw * e + 2 * sp * d * e, nw, "fp32")

            def run(impl, fns=fns, x=x, ws=ws):
                # The plain version streams and sums the weights here; the
                # kernel's sums are in its sink, read by the check.
                out = fns[impl](x, *ws)
                if impl == "torch":
                    return out, fns[impl].weight_sums()
                return out, fns[impl].weight_sums
        else:
            work = _stack_work(1, sp, sp, d, mlp, 12, layers, e, kind)

            def run(impl, fns=fns, x=x, ws=ws):
                return fns[impl](x, *ws)
        cases.append(case(
            "encstack_probe", f"{variant} B/16 bs=1, {layers} layers", run,
            work, primary=variant == "dma",
            check=compare_dma(ws) if variant == "dma" else compare_norm))
    return cases


def probe_phase(torch, main_counts: dict) -> dict:
    """Phase 16: the three probes through their entry points
    (``vit_tpu_torch/tools/``), each with exact launch counts: the int8
    probe's ``run`` (K22 on the 128 x 128 int8 dot, bit for bit, K12 at
    d=128, mlp=512, the int8 and bf16 dots timed); the attention block in
    every mode at B/16 bs=32 bf16, each held to its plain version and each
    mode's planted faults (``PROBE_FAULTS``) refused by its bar; wide's
    rounding point on its core (``WIDE_EQUAL_SHARE``); in fp32 the GEMMs'
    tile (K2's tf32 walk; phase 3 held each fp32 block to its plain
    version); every mode timed in each dtype (event and pipelined ms of
    the block and of the core alone, nominal-FLOP rate, the core launch's
    profiler ms; the probe's rounds over the modes in turn, medians); K4's
    core against K23's ``full`` core (the same tensor-core instantiation)
    bit for bit in bf16 and in fp32, the two in turns; every
    variant of the encoder probe at the
    JAX probe's four cases (b = 2, 2, 3, 1; (cq, mt) change no launch), at
    12 layers (nosm and core at ATTN_CHECK_LAYERS) and held to its plain
    version (``dma``: x bit for bit and its weight sums), nosm and core by
    depth,
    then each timed at 12 layers for b = 1, 2, 3 (the probe's rounds;
    ``@flat`` is the same launch and is not timed twice)."""
    from vit_tpu_torch.ops.cuda import (KERNELS, _build, launch_counts,
                                        reset_launch_counts)
    from vit_tpu_torch.tools import attn_core_probe as acp
    from vit_tpu_torch.tools import encstack_minrepro as em
    from vit_tpu_torch.tools import int8_probe

    zero = dict.fromkeys(KERNELS, 0)
    res = {}

    def counted(tag, fn, expect):
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        main_counts[tag] = counts = launch_counts()
        check_counts(tag, counts, expect_counts(zero, expect))
        return out

    warmup, reps = 2, 10
    got = counted("int8 probe", lambda: int8_probe.run(
        "cuda", warmup=warmup, reps=reps),
        {"dot_probe": 2 + 2 * (warmup + reps), "mlp_block_i8dot": 1})
    if not (got["int8_dot"] and got["mlp_block_i8dot"]):
        raise AssertionError(f"int8 probe: {got}")
    res["int8_probe"] = got
    log(f"[probes] int8 probe: {got}")

    a = PROBE_ATTN
    b, sp, s, d, heads = a["batch"], a["sp"], a["seq_len"], a["d"], a["heads"]
    x, *w = acp.make_inputs(b, sp, d, s, torch.bfloat16, "cuda")
    wt = (w[2].t().contiguous(), w[4].t().contiguous())
    xt = x.reshape(b * sp, d).t().contiguous()
    kw = dict(num_heads=heads, seq_len=s, group=a["group"], shape=(b, sp, d))
    step = acp.qcore_step(x, *w[:5], num_heads=heads)
    outs = counted(
        "attention probe B/16 bs=32 bf16, every mode",
        lambda: {m: acp.probe(m, xt if m == "xcore" else x, *w,
                              weights_t=wt, **kw) for m in acp.MODES},
        add_counts(*(expect_counts(zero, acp.launches(m))
                     for m in acp.MODES)))
    errs, refused = {}, {}
    for mode, out in outs.items():
        xin = xt if mode == "xcore" else x
        want = acp.probe_plain(mode, xin, *w, **kw)
        check = probe_check(mode, step)
        errs[mode] = check(torch, out, want, torch.bfloat16)["max_abs_err"]
        # The planted faults: other modes' kernel outputs (in xcore's
        # layout for xcore), and for the masked modes the plain version a
        # key fragment short.
        faults = {what: (outs[other].reshape(b * sp, d).t() if mode == "xcore"
                         else outs[other])
                  for what, other in PROBE_FAULTS[mode].items()}
        if mode in acp.MASKED:
            faults["last 16 real keys dropped"] = acp.probe_plain(
                mode, xin, *w, **dict(kw, seq_len=s - 16))
        for what, fault in faults.items():
            try:
                passed = check(torch, fault, want, torch.bfloat16)
            except AssertionError as err:
                refused[f"{mode}: {what}"] = str(err)
                continue
            raise AssertionError(f"K23 {mode}: the bar passed a planted "
                                 f"fault ({what}): {passed}")
    del outs
    log(f"[probes] attention block vs plain, bf16 B/16 bs=32, max|diff| by "
        f"mode: {errs}")
    log(f"[probes] K23 planted faults refused: {refused}")
    res["attention_faults_refused"] = sorted(refused)
    # wide's rounding point (p / l rounded), on the core alone.
    call = acp.core_only("wide", x, *w, weights_t=wt, **kw)
    qkv = call.args[1]  # the packed QKV the block handed its core
    geo = dict(b=b, sp=sp, d=d, heads=heads, seq_len=s)
    plain = wide_core_plain(torch, qkv, **geo)
    shares = {tag: float((got == plain).float().mean()) for tag, got in (
        ("kernel", call()),
        ("p rounded before / l", wide_core_plain(torch, qkv, early=True,
                                                 **geo)))}
    log(f"[probes] wide's core: share of elements equal to the plain core "
        f"{shares} (bar {WIDE_EQUAL_SHARE})")
    if not (shares["kernel"] >= WIDE_EQUAL_SHARE
            > shares["p rounded before / l"]):
        raise AssertionError(f"wide's rounding point: {shares}")
    res["wide_core_equal_share"] = shares
    timed = acp.run(tuple(acp.MODES), dtype=torch.bfloat16, warmup=3,
                    reps=20, **a)
    res["attention_modes_bf16_b16_bs32"] = timed["modes"]
    # fp32: K23's GEMMs take K2's tf32 walk where K2's rule gives K2 its
    # tf32 tile (every GEMM of the block at B/16), then every mode timed
    # (phase 3 held each fp32 block to its plain version).
    x32 = x.float()
    w32 = [t.float() for t in w]
    wt32 = (w32[2].t().contiguous(), w32[4].t().contiguous())
    xt32 = x32.reshape(b * sp, d).t().contiguous()
    lib = _build.library()
    for xa, wa, n, k in ((x32, w32[2], 3 * d, d), (wt32[0], xt32, b * sp, d),
                         (wt32[1], xt32, b * sp, d)):
        ptrs = (xa.data_ptr(), wa.data_ptr())
        if (acp.gemm_tile(1, n, k, torch.float32, ptrs) != "tf32"
                or lib.vit_attn_probe_gemm_tile(*ptrs, n, k, 0) != 1):
            raise AssertionError(f"K23's fp32 GEMM ({k}, {n}) is not on the "
                                 "tf32 walk")
    del x32, w32, wt32, xt32
    timed = acp.run(tuple(acp.MODES), dtype=torch.float32, warmup=3,
                    reps=20, **a)
    res["attention_modes_fp32_b16_bs32"] = timed["modes"]
    # K23's full core against K4's on the same packed QKV, in turns (K4,
    # K23, K23, K4): event ms, pipelined ms and the profiler's ms a
    # launch, on the probe's (its K2 output) and on N(0, 1) values, in
    # bf16 and in fp32.
    from vit_tpu_torch.utils.profiling import launch_ms
    from vit_tpu_torch.utils.timing import pipelined_ms
    from vit_tpu_torch.ops import reference
    from vit_tpu_torch.ops.cuda import block as cuda_block
    turns, core_errs = {}, {}
    names = {torch.bfloat16: {"k4": "attention_kernel",
                              "k23": "attn_probe_kernel_mma"},
             torch.float32: {"k4": "attention_tf32_kernel",
                             "k23": "attn_probe_kernel_tf32"}}
    for dt in (torch.bfloat16, torch.float32):
        xd, wd = x.to(dt), [t.to(dt) for t in w]
        xn = reference.layernorm(xd.reshape(b * sp, d), wd[0], wd[1])
        qkvs = {"probe": reference.matmul(xn, wd[2], wd[3]),
                "normal": torch.randn(
                    (b * sp, 3 * d), generator=torch.Generator(
                        device="cuda").manual_seed(19), device="cuda").to(dt)}
        for tag, qkv in qkvs.items():
            tag = f"{tag} {str(dt).replace('torch.', '')}"
            out = torch.empty((b * sp, d), dtype=dt, device="cuda")
            core = dict(batch=b, num_heads=heads, scale=(d // heads) ** -0.5,
                        seq_len=s)
            runs = {"k4": lambda: cuda_block.attention_core(qkv, **core),
                    "k23": lambda: acp.core_launch(
                        "full", qkv, None, out, b=b, sp=sp, d=d, heads=heads,
                        seq_len=s, scale=core["scale"])}
            # K23's full is K4's instantiation: bit for bit.
            core_errs[tag] = compare_exact(torch, runs["k4"](), runs["k23"](),
                                           dt)
            turns[tag] = [(k, time_ms(torch, runs[k]), pipelined_ms(runs[k]),
                           launch_ms(runs[k], names[dt][k]))
                          for k in ("k4", "k23", "k23", "k4")]
    res["core_k4_vs_k23_ms_pipelined_device"] = turns
    res["core_k4_vs_k23_full_err"] = core_errs
    log(f"[probes] K4 core vs K23 full core: {core_errs}; (event ms, "
        f"pipelined ms, profiler ms) in turns: {turns}")

    cases = [tuple(map(int, c.split(","))) for c in em.DEFAULT_CASES]
    variants = em.VARIANTS + ("full",)
    d, mlp = 768, 3072
    gen = torch.Generator(device="cuda").manual_seed(18)

    def stack_inputs(b, layers):
        x = (torch.randn((b * sp, d), generator=gen, device="cuda")
             * 0.05).to(torch.bfloat16)
        return x, [(torch.randn(sh, generator=gen, device="cuda") * 0.05).to(
            torch.bfloat16) for sh in ((layers, d, 3 * d), (layers, d, d),
                                       (layers, d, mlp), (layers, mlp, d))]
    inputs = {c: stack_inputs(c[0], 12) for c in cases}

    def variant_call(c, v, impl=None):
        """The variant on case c's inputs at its check depth (the weights'
        first layers), through ``impl``; returns (x, weights, closure)."""
        L = probe_check_layers(v)
        x, ws = inputs[c][0], [w[:L] for w in inputs[c][1]]
        fn = em.make_variant(v + ("" if v == "full" else "@flat"), b=c[0],
                             sp=sp, d=d, mlp=mlp, L=L, cq=c[1], mt=c[2],
                             dtype=torch.bfloat16, impl=impl)
        return x, ws, fn

    def run_variants():
        outs = {}
        for c in cases:
            for v in variants:
                x, ws, fn = variant_call(c, v)
                outs[c, v] = fn(x, *ws), fn
        return outs
    outs = counted("encoder probe B/16 bf16, every variant and case",
                   run_variants,
                   {"encstack_probe": len(cases) * len(em.VARIANTS),
                    "encoder_stack": len(cases)})
    rels = {}
    for (c, v), (out, fn) in outs.items():
        x, ws, _ = variant_call(c, v)
        if v == "dma":
            compare_exact(torch, out, x, torch.bfloat16)
            rels[f"{c} dma sums"] = em.check_weight_sums(fn.weight_sums(),
                                                         *ws)
            continue
        want = (em.full_encoder(x, *ws, b=c[0], sp=sp, heads=12,
                                impl="torch") if v == "full"
                else em.variant_plain(v, x, *ws, b=c[0], sp=sp, heads=12))
        rels[f"{c} {v} L={len(ws[0])}"] = compare_norm(
            torch, out, want, torch.bfloat16)["max_abs_err"]
    del outs
    log(f"[probes] encoder probe vs plain, bf16 B/16, every variant at 12 "
        f"layers but nosm and core at {ATTN_CHECK_LAYERS}, max|diff|: {rels}")
    # nosm and core by depth (b=1): max|x| of the kernel's output and its
    # relative distance from the plain version; core finite at 12.
    x, ws = inputs[cases[-1]]
    by_depth = {}
    for v in ("nosm", "core"):
        for L in range(1, 13):
            fn = em.make_variant(v, b=1, sp=sp, d=d, mlp=mlp, L=L, cq=768,
                                 mt=512, dtype=torch.bfloat16)
            out = fn(x, *(w[:L] for w in ws)).float()
            plain = em.variant_plain(v, x, *(w[:L] for w in ws), b=1,
                                     sp=sp, heads=12).float()
            top = float(out.abs().max())
            rel = float((out - plain).norm() / plain.norm())
            by_depth[f"{v} L={L}"] = tuple(
                t if math.isfinite(t) else repr(t) for t in (top, rel))
            if v == "core" and L == 12 and not math.isfinite(top):
                raise AssertionError("core at 12 layers: non-finite output")
    res["nosm_core_max_abs_rel_by_layers"] = by_depth
    log(f"[probes] nosm and core at b=1, (max|x|, rel to plain) by "
        f"layers: {by_depth}")
    del inputs
    res["encoder_variants_bf16_b16"] = em.run(
        [f"{b},768,768" for b in (1, 2, 3)], variants, sp=sp, d=d, mlp=mlp,
        heads=12, L=12, dtype=torch.bfloat16, reps=10)["rows"]
    return res


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
                  kernel_cases_small_batch, kernel_cases_stack_tile,
                  kernel_cases_int8, kernel_cases_stack_q, kernel_cases_train,
                  kernel_cases_chain, kernel_cases_tp, kernel_cases_layer,
                  kernel_cases_probes):
        for dtype in (torch.float32, torch.bfloat16):
            for c in cases(torch, dtype):
                got = c["run"]("cuda")
                want = c["run"]("torch")
                torch.cuda.synchronize()
                res = c["check"](torch, got, want, dtype)
                log(f"[kernel] {c['name']} {c['label']} {dtype}: {res}")
                check_faults(torch, c, want, dtype)
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
    with gemm_paths() as k2_paths:
        answers = [pred(r) for r in requests]
        torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    main_counts = {"B/16 serving": launch_counts()}
    check_gemm_paths("B/16 serving", k2_paths, main_counts["B/16 serving"])
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
    from vit_tpu_torch.utils.timing import pipelined_ms
    timings = []
    for c, dtype in timing_cases:
        ms = time_ms(torch, lambda: c["run"]("cuda"))
        plain = time_ms(torch, lambda: c["run"]("torch"))
        library = None
        lib_fn = c["library"]
        layouts = {}
        if lib_fn is not None:
            try:
                if isinstance(lib_fn, dict):
                    # One call in several operand layouts: the faster is
                    # the yardstick.
                    layouts = {k: time_ms(torch, f) for k, f in lib_fn.items()}
                    best = min(layouts, key=layouts.get)
                    library, lib_fn = layouts[best], lib_fn[best]
                else:
                    library = time_ms(torch, lib_fn)
            except RuntimeError as err:  # a yardstick only; say why
                log(f"[timing] {c['name']} {c['label']}: library call "
                    f"failed: {err}")
                lib_fn = None
        bound_ms, bound_by = bound(c["work"])
        timings.append({"kernel": c["name"], "shape": c["label"],
                        "dtype": str(dtype).replace("torch.", ""),
                        "ms": ms, "plain_ms": plain, "library_ms": library,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "primary": c["primary"]})
        if layouts:
            timings[-1]["library_layouts_ms"] = layouts
        if c["composed"] is not None:
            # K3 beside the same MLP as three of the port's kernels.
            timings[-1]["composed_ms"] = time_ms(torch, c["composed"])
            timings[-1]["composed_device_ms"] = (
                device_ms(torch, c["composed"])[0] or None)
        on_card = c["name"] in DEVICE_TIMED or c["device"]
        if c["name"] in PIPELINED and (c["primary"] or on_card):
            # The device time of back-to-back calls, kernel and library
            # call alike.
            timings[-1]["pipelined_ms"] = pipelined_ms(
                lambda: c["run"]("cuda"))
            timings[-1]["library_pipelined_ms"] = (
                None if library is None else pipelined_ms(lib_fn))
            if on_card:
                # K2's wrapper takes longer on the host than its kernel on
                # the card at most of these shapes, so pipelined calls
                # wait on the host: the profiler's device time too.
                # None where the profiler kept no record of the kernel.
                timings[-1]["device_ms"] = device_ms(
                    torch, lambda: c["run"]("cuda"))[0] or None
                timings[-1]["library_device_ms"] = (
                    None if library is None
                    else device_ms(torch, lib_fn)[0] or None)
            log(f"[timing] {c['name']} {c['label']} {dtype}: {ms:.4f} ms "
                f"events, {timings[-1]['pipelined_ms']:.4f} pipelined, "
                f"device {timings[-1].get('device_ms')}; plain "
                f"{plain:.4f}; library {library} events, "
                f"{timings[-1]['library_pipelined_ms']} pipelined, device "
                f"{timings[-1].get('library_device_ms')}; composed "
                f"{timings[-1].get('composed_ms')} events, device "
                f"{timings[-1].get('composed_device_ms')}; bound "
                f"{bound_ms:.4f} ({bound_by})")
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
    # -- 16. the probes ------------------------------------------------------
    e2e["probes"] = probe_phase(torch, main_counts)
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
        if name in PIPELINED:
            kernels[-1].update(pipelined_ms=t["pipelined_ms"],
                               library_pipelined_ms=t["library_pipelined_ms"])
        if "device_ms" in t:
            kernels[-1].update(device_ms=t["device_ms"],
                               library_device_ms=t["library_device_ms"])
        if "composed_ms" in t:
            kernels[-1].update(composed_ms=t["composed_ms"],
                               composed_device_ms=t["composed_device_ms"])
        # The fp32 form's last primary case, where the kernel has one.
        t32 = next((t for t in reversed(timings) if t["kernel"] == name
                    and t["dtype"] == "float32" and t["primary"]), None)
        if t32 is not None:
            kernels[-1]["fp32"] = {
                key: t32.get(key) for key in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "pipelined_ms", "library_pipelined_ms",
                    "device_ms", "library_device_ms", "composed_ms",
                    "composed_device_ms")}
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
