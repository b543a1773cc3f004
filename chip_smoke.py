#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vit_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits non-zero
without printing the final ``ok`` line:

1. device: the card's name and power limit (``nvidia-smi``), CUDA, TF32 off;
2. build: compile the hand-written kernels from ``vit_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version at the ViT-B/16 slice's
   shapes, in fp32 and bf16;
4. golden: synthetic B/16 weights in fp32 through the kernels, held to the
   ``transformers`` recording ``tests/fixtures/golden_b16.npz``, with the
   exact per-forward launch counts;
5. serving: a bf16 B/16 ``Predictor`` with a 1000-class head answers
   requests of 1, 5, 32 and 37 images -- the main path, whose launch counts
   go into the kernels line;
6. timings (CUDA events, median of 20 after warm-up): each kernel against
   its plain version, and the bf16 forward at bs=32 through the kernels and
   through ``impl="torch"``.

The last three lines of standard output are the kernels JSON line, the
card's ``nvidia-smi`` name and power limit, and the result line
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

#: Per-forward launches of each kernel for a model with a classifier head
#: (12 LN1 + final LN; patch projection + 12 QKV + 12 out-proj + head).
PER_FORWARD = {"layernorm": 13, "matmul": 26, "attention": 12, "mlp_block": 12}
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
}
FP32_BAR = 1e-4       # max|diff|: only the fp32 sum order differs
BF16_REL_BAR = 2e-2   # |diff| <= bar * (1 + |ref|): about two bf16 ulps
BF16_MEAN_BAR = 3e-3  # mean|diff|
GOLDEN_BAR = 1e-3     # tests/test_golden.py:58


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(torch, got, want, dtype) -> dict:
    """Hold ``got`` to ``want`` with the bar of ``dtype``; raise if off."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("non-finite values")
    diff = (g - w).abs()
    res = {"max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean())}
    if dtype == torch.float32:
        ok = res["max_abs_err"] <= FP32_BAR
    else:
        excess = float((diff - BF16_REL_BAR * (1 + w.abs())).max())
        res["max_excess"] = excess
        ok = excess <= 0 and res["mean_abs_err"] <= BF16_MEAN_BAR
    if not ok:
        raise AssertionError(f"outside the {dtype} bar: {res}")
    return res


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


def kernel_cases(torch, dtype):
    """(kernel, label, run(impl), inputs) at the slice's shapes: B/16 at
    bs=32 is M = 32*208 = 6656 rows (6272 = 32*196 for the patch rows)."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops import reference
    from vit_tpu_torch.ops.cuda import block as cuda_block

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, std=1.0, mean=0.0):
        t = torch.randn(shape, generator=gen, device="cuda") * std + mean
        return t.to(dtype)

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
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, run in kernel_cases(torch, dtype):
            got = run("cuda")
            want = run("torch")
            torch.cuda.synchronize()
            res = compare(torch, got, want, dtype)
            log(f"[kernel] {name} {label} {dtype}: {res}")
            if dtype == torch.bfloat16:
                errors[name] = max(errors.get(name, 0.0), res["max_abs_err"])
            timing_cases.append((name, label, dtype, run))
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
    expect = dict(PER_FORWARD, matmul=PER_FORWARD["matmul"] - 1)  # no head
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

    # -- 5. serving: the main path -----------------------------------------
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
    main_counts = launch_counts()
    n_fwd = sum(len(pred._plan(n)) for n in sizes)
    expect = {k: v * n_fwd for k, v in PER_FORWARD.items()}
    if main_counts != expect:
        raise AssertionError(f"serving launch counts {main_counts} != {expect}")
    log(f"[serve] {sizes} in {serve_s:.3f} s (host clock, first calls); "
        f"{n_fwd} bucket forwards; launches {main_counts}")
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

    # -- 6. timings --------------------------------------------------------
    timings = []
    for name, label, dtype, run in timing_cases:
        ms = time_ms(torch, lambda: run("cuda"))
        plain = time_ms(torch, lambda: run("torch"))
        timings.append({"kernel": name, "shape": label,
                        "dtype": str(dtype).replace("torch.", ""),
                        "ms": ms, "plain_ms": plain})
    x32 = torch.randn((32, 3, 224, 224), generator=gen,
                      device="cuda").to(cfg.dtype)
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: forward(params, x32, cfg))
        fwd_plain_ms = time_ms(torch,
                               lambda: forward(params, x32, cfg, impl="torch"))
    e2e = {"forward_bf16_bs32_ms": fwd_ms,
           "forward_bf16_bs32_images_per_s": 32e3 / fwd_ms,
           "plain_forward_bf16_bs32_ms": fwd_plain_ms,
           "plain_forward_bf16_bs32_images_per_s": 32e3 / fwd_plain_ms}
    log(json.dumps({"timings": timings, "end_to_end": e2e, "card": smi,
                    "torch": torch.__version__, "cuda": torch.version.cuda}))

    kernels = []
    for name in PER_FORWARD:
        # The bf16 timing at the case that stands for the kernel on the path.
        t = next(t for t in reversed(timings)
                 if t["kernel"] == name and t["dtype"] == "bfloat16")
        source, replaces = KERNEL_SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": main_counts[name],
                        "max_abs_err": errors[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "shape": t["shape"],
                        "dtype": "bfloat16"})
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
