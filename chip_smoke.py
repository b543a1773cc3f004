#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vit_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits non-zero
without printing the final ``ok`` line:

1. device: the card's name and power limit (``nvidia-smi``), CUDA, TF32 off;
2. build: compile the hand-written kernels from ``vit_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version, in fp32 and bf16, at the
   ViT-B/16 path's shapes (bs=32) and at the ViT-L/16-384 path's shapes
   (bs=8: 8 x 592 = 4736 rows, D=1024, 16 heads of 64);
4. golden: synthetic B/16 weights in fp32 through the kernels, held to the
   ``transformers`` recording ``tests/fixtures/golden_b16.npz``, with the
   exact per-forward launch counts;
5. B/16 serving: a bf16 B/16 ``Predictor`` with a 1000-class head answers
   requests of 1, 5, 32 and 37 images, with exact launch counts -- the
   first main path (every layer on the two half-block mega-kernels);
6. L/16-384 fp32 at full depth (24 layers, bs=2) through the kernels
   against ``impl="torch"``, with exact launch counts: every layer's
   attention half is composed (layernorm_stats + fused_linear ->
   flash_attention -> fused_linear), its MLP half is ``mlp_block``;
7. L/16-384 serving: a bf16 ``Predictor(buckets=(4, 8))`` with a
   1000-class head answers 3, 8 and 11 images, with exact launch counts --
   the second main path;
8. H/14 at 4 layers in bf16 (attention mega, MLP composed) and fp32
   (attention composed at head_dim 80, MLP mega) against ``impl="torch"``;
9. timings (CUDA events, median of 20 after warm-up): each kernel against
   its plain version, and the bf16 forwards (B/16 at bs=32, L/16-384 at
   bs=8) through the kernels and through ``impl="torch"``.

The last three lines of standard output are the kernels JSON line (the
launches of both serving runs, error vs the plain version, kernel and plain
times), the card's ``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``. Imports only torch, numpy and the port.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: Per-forward launches of each kernel of B/16 with a classifier head
#: (12 LN1 + final LN; patch projection + 12 QKV + 12 out-proj + head).
PER_FORWARD = {"layernorm": 13, "matmul": 26, "attention": 12, "mlp_block": 12}
#: The same for L/16-384 without a head: 24 composed attention halves
#: (layernorm_stats + fused_linear, flash_attention, fused_linear) and 24
#: mlp_block; final LN; patch projection.
PER_FORWARD_L16_384 = {"layernorm": 1, "matmul": 1, "mlp_block": 24,
                       "layernorm_stats": 24, "fused_linear": 48,
                       "flash_attention": 24}
#: H/14 at 4 layers without its head (pooling="cls"), per dtype: in bf16
#: the attention half is attn_block and the MLP half composed; in fp32 the
#: other way round.
PER_FORWARD_H14_4 = {
    "bfloat16": {"layernorm": 5, "matmul": 9, "attention": 4,
                 "layernorm_stats": 4, "fused_linear": 8},
    "float32": {"layernorm": 1, "matmul": 1, "mlp_block": 4,
                "layernorm_stats": 4, "fused_linear": 8,
                "flash_attention": 4},
}
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
}
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
    """A whole forward through the kernels against ``impl="torch"``."""
    return compare(torch, got, want, dtype, fp32_bar=GOLDEN_BAR,
                   bf16_bar=MODEL_BF16_REL_BAR, mean_bar=MODEL_BF16_MEAN_BAR)


def expect_counts(counts: dict, per_forward: dict, n: int = 1) -> dict:
    """``per_forward`` times ``n`` for every kernel, 0 where not named."""
    return {k: per_forward.get(k, 0) * n for k in counts}


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` runs (CUDA events)."""
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
    return float(np.median(times))


def _rnd_fn(torch, dtype, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        t = torch.randn(shape, generator=gen, device="cuda") * std + mean
        return t.to(dtype)
    return rnd


def kernel_cases(torch, dtype):
    """(kernel, label, run(impl)) at the B/16 path's shapes: bs=32 is
    M = 32*208 = 6656 rows (6272 = 32*196 for the patch rows)."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops import reference
    from vit_tpu_torch.ops.cuda import block as cuda_block

    rnd = _rnd_fn(torch, dtype, 0)
    b, sp, s, d, mlp, heads = 32, 208, 197, 768, 3072, 12
    m = b * sp
    x = rnd(m, d)
    g, beta = rnd(d, std=0.1, mean=1.0), rnd(d, std=0.05)
    w_dd, b_d = rnd(d, d, std=0.04), rnd(d, std=0.02)
    w_dm, b_m = rnd(d, mlp, std=0.03), rnd(mlp, std=0.02)
    w_md = rnd(mlp, d, std=0.03)
    wqkv, bqkv = rnd(d, 3 * d, std=0.04), rnd(3 * d, std=0.02)
    patches = rnd(32 * 196, d)
    qkv = rnd(m, 3 * d)
    x3 = x.reshape(b, sp, d)
    scale = (d // heads) ** -0.5

    def attn_core(impl):
        if impl == "torch":
            return reference.attention_core(qkv, batch=b, num_heads=heads,
                                            scale=scale, seq_len=s)
        return cuda_block.attention_core(qkv, batch=b, num_heads=heads,
                                         scale=scale, seq_len=s)

    return [
        ("layernorm", f"({m},{d})",
         lambda impl: ops.layernorm(x, g, beta, impl=impl)),
        ("matmul", f"({32 * 196},{d})@({d},{d})+bias",
         lambda impl: ops.matmul(patches, w_dd, b_d, impl=impl)),
        ("matmul", f"({m},{d})@({d},{3 * d})+bias",
         lambda impl: ops.matmul(x, wqkv, bqkv, impl=impl)),
        ("matmul", f"({m},{d})@({d},{mlp})+bias+gelu",
         lambda impl: ops.matmul(x, w_dm, b_m, "gelu", impl=impl)),
        ("matmul", f"({m},{d})@({d},{d})+bias+residual",
         lambda impl: ops.matmul(x, w_dd, b_d, residual=x, impl=impl)),
        ("mlp_block", f"({m},{d}) mlp {mlp}",
         lambda impl: ops.mlp_block(x, g, beta, w_dm, b_m, w_md, b_d,
                                    impl=impl)),
        ("attention", f"qkv ({m},{3 * d}) heads {heads} seq_len {s}",
         attn_core),
        ("attn_block", f"({b},{sp},{d}) seq_len {s}",
         lambda impl: ops.attn_block(x3, g, beta, wqkv, bqkv, w_dd, b_d,
                                     num_heads=heads, seq_len=s, impl=impl)),
    ]


def kernel_cases_l16_384(torch, dtype):
    """(kernel, label, run(impl)) at the L/16-384 path's shapes: bs=8 is
    M = 8*592 = 4736 rows, D=1024, MLP 4096, 16 heads of 64, 577 real
    tokens. Attention reads q, k and v as views of a packed QKV buffer."""
    from vit_tpu_torch import ops

    rnd = _rnd_fn(torch, dtype, 1)
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
        ("layernorm_stats", f"({m},{d})",
         lambda impl: ops.layernorm_stats(x, impl=impl)),
        ("fused_linear", f"({m},{d})@({d},{d})+bias+residual",
         lambda impl: ops.fused_linear(x, w_dd, b_d, residual=x, impl=impl)),
        ("fused_linear", f"LN ({m},{d})@({d},{3 * d})+bias",
         lambda impl: ops.fused_linear(x, wqkv, bqkv, ln_scale=g,
                                       ln_bias=beta, impl=impl)),
        ("flash_attention", f"packed qkv B={b} H={heads} S={sp} "
         f"seq_len {s} d={hd}",
         lambda impl: ops.flash_attention(q, k, v, scale=hd ** -0.5,
                                          seq_len=s, impl=impl)),
        ("mlp_block", f"({m},{d}) mlp {mlp}",
         lambda impl: ops.mlp_block(x, g, beta, w_dm, b_m, w_md, b_d,
                                    impl=impl)),
    ]


def main() -> int:
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

    from vit_tpu_torch.config import VARIANTS
    from vit_tpu_torch.models.vit import forward, init_params
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
    for cases in (kernel_cases, kernel_cases_l16_384):
        for dtype in (torch.float32, torch.bfloat16):
            for name, label, run in cases(torch, dtype):
                got = run("cuda")
                want = run("torch")
                torch.cuda.synchronize()
                res = compare(torch, got, want, dtype)
                log(f"[kernel] {name} {label} {dtype}: {res}")
                if dtype == torch.bfloat16:
                    errors[name] = max(errors.get(name, 0.0),
                                       res["max_abs_err"])
                timing_cases.append((name, label, dtype, run))
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
    expect = expect_counts(counts, dict(PER_FORWARD,
                                        matmul=PER_FORWARD["matmul"] - 1))
    if counts != expect:
        raise AssertionError(f"golden launch counts {counts} != {expect}")
    gdiff = float((got.float() - want).abs().max())
    plain_diff = float((forward(params32, px, cfg32, impl="torch").float()
                        - want).abs().max())
    log(f"[golden] max|diff| kernels {gdiff:.3e}, plain {plain_diff:.3e}; "
        f"launches {counts}")
    if not gdiff < GOLDEN_BAR:
        raise AssertionError(f"golden max|diff| {gdiff} >= {GOLDEN_BAR}")
    del params32, sd

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
    n_fwd = sum(len(pred._plan(n)) for n in sizes)
    expect = expect_counts(main_counts["B/16 serving"], PER_FORWARD, n_fwd)
    if main_counts["B/16 serving"] != expect:
        raise AssertionError(f"serving launch counts "
                             f"{main_counts['B/16 serving']} != {expect}")
    log(f"[serve] {sizes} in {serve_s:.3f} s (host clock, first calls); "
        f"{n_fwd} bucket forwards; launches {main_counts['B/16 serving']}")
    with torch.inference_mode():
        for n, req, ans in zip(sizes, requests, answers):
            if tuple(ans.shape) != (n, 1000):
                raise AssertionError(f"request {n}: shape {tuple(ans.shape)}")
            res = compare(torch, ans, forward(params, req.to(cfg.dtype), cfg),
                          torch.bfloat16)
            log(f"[serve] request {n} vs forward: {res}")
        padded = torch.cat([requests[1], requests[1].new_zeros(3, 3, 224, 224)])
        bucket8 = forward(params, padded.to(cfg.dtype), cfg)[:5]
        if not torch.equal(answers[1], bucket8):
            raise AssertionError("request of 5 != rows 0-4 of the bucket-8 "
                                 "forward")
        log("[serve] request of 5 == rows 0-4 of the bucket-8 forward, "
            "bit for bit")
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
        expect = expect_counts(counts, PER_FORWARD_L16_384)
        if counts != expect:
            raise AssertionError(f"L/16-384 fp32 launch counts {counts} != "
                                 f"{expect}")
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
    n_fwd = sum(len(pred_l._plan(n)) for n in sizes_l)
    expect = expect_counts(counts, dict(PER_FORWARD_L16_384, matmul=2),
                           n_fwd)
    if n_fwd != 4 or counts != expect:
        raise AssertionError(f"L/16-384 serving: {n_fwd} forwards, launch "
                             f"counts {counts} != {expect}")
    log(f"[serve l16-384] {sizes_l} in {serve_s:.3f} s (host clock, first "
        f"calls); {n_fwd} bucket forwards; launches {counts}")
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
            expect = expect_counts(counts, PER_FORWARD_H14_4[dname])
            if counts != expect:
                raise AssertionError(f"H/14 {dname} launch counts {counts} "
                                     f"!= {expect}")
            res = compare_model(torch, got,
                                forward(p_h, px, cfg_h, impl="torch"), dtype)
            log(f"[h14 {dname}] bs=2, 4 layers, kernels vs impl=torch: "
                f"{res}; launches {counts}")
            del p_h
    torch.cuda.empty_cache()

    # -- 9. timings --------------------------------------------------------
    timings = []
    for name, label, dtype, run in timing_cases:
        ms = time_ms(torch, lambda: run("cuda"))
        plain = time_ms(torch, lambda: run("torch"))
        timings.append({"kernel": name, "shape": label,
                        "dtype": str(dtype).replace("torch.", ""),
                        "ms": ms, "plain_ms": plain})
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
    log(json.dumps({"timings": timings, "end_to_end": e2e, "card": smi,
                    "torch": torch.__version__, "cuda": torch.version.cuda}))

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        # The bf16 timing of the last case that stands for the kernel.
        t = next(t for t in reversed(timings)
                 if t["kernel"] == name and t["dtype"] == "bfloat16")
        by_path = {path: c[name] for path, c in main_counts.items()}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": errors[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "shape": t["shape"],
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
