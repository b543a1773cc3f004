"""Time the same kernels of two checkouts of the port in turns on one card.

A change to a kernel's source must leave the kernels that share it
compiled as before: this script times K4's attention core (B/16 bs=32,
bf16), K9 (``ops.encoder_stack``, B/16 bs=1, bf16, 12 layers), K13
(``ops.flash_attention_bwd``, B/16 bs=32, 384 heads, 197 of 208 keys, in
bf16 and fp32), the B/16 bs=32 bf16 forward and the B/16 bs=32 bf16 train
step of this checkout and of ``--other`` in turns (other, this, this,
other), each run in its own process that builds that checkout's kernels
into the checkout's own ``build/``. Each time is the median of CUDA-event
times of single calls after warm-up, beside the pipelined time (calls
queued back to back between two events: the device time where the host
keeps ahead) and the profiler's device time (each launch's time over the
records kept). It prints one line a run and a JSON line::

    git archive <parent> | tar -x -C build/parent    # a listed directory
    python -m vit_tpu_torch.tools.turns --other build/parent
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

#: Run in a fresh process with the checkout's root as argv[1]; prints one
#: JSON line. It uses only what every checkout of the port has.
WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from vit_tpu_torch import ops
from vit_tpu_torch.config import VARIANTS
from vit_tpu_torch.models.vit import forward, init_params
from vit_tpu_torch.ops.cuda import _build, block
from vit_tpu_torch.train import make_optimizer, make_train_step
from vit_tpu_torch.utils.timing import pipelined_ms

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build()
gen = torch.Generator(device="cuda").manual_seed(0)


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
    # launches a call are count / iters rounded, where that is >= 1.
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
    return dev / 1e3


cfg = VARIANTS["B/16"].replace(dtype=torch.bfloat16, num_classes=1000)
params = init_params(cfg, generator=gen, device="cuda")
qkv = torch.randn((32 * 208, 3 * 768), generator=gen,
                  device="cuda").to(torch.bfloat16)
x1 = torch.randn((1, 208, 768), generator=gen,
                 device="cuda").to(torch.bfloat16)
px = torch.randn((32, 3, 224, 224), generator=gen,
                 device="cuda").to(torch.bfloat16)
res = {}
with torch.inference_mode():
    res["core"] = times(lambda: block.attention_core(
        qkv, batch=32, num_heads=12, scale=64 ** -0.5, seq_len=197))
    res["encoder_stack"] = times(lambda: ops.encoder_stack(
        x1, params["encoder"], num_heads=12, seq_len=197))
    res["forward"] = times(lambda: forward(params, px, cfg), iters=20)
    for dt in (torch.bfloat16, torch.float32):
        buf = torch.randn((32 * 208, 3 * 768), generator=gen,
                          device="cuda").to(dt)
        q, k, v = buf.view(32, 208, 3, 12, 64).permute(2, 0, 3, 1, 4)
        g = torch.randn((32, 208, 12, 64), generator=gen,
                        device="cuda").to(dt).transpose(1, 2)
        res["attention_bwd_" + str(dt)[6:]] = times(
            lambda: ops.flash_attention_bwd(q, k, v, g, scale=64 ** -0.5,
                                            seq_len=197))
labels = torch.randint(0, 1000, (32,), generator=gen, device="cuda")
init_fn, step_fn = make_train_step(cfg, make_optimizer(1e-4, 0.05))
opt = init_fn(params)
res["train_step"] = times(lambda: step_fn(params, opt, px, labels),
                          iters=10, warmup=2)
print(json.dumps(res))
"""

HERE = Path(__file__).resolve().parents[2]


def run_tree(root: Path, timeout: int) -> dict:
    """The worker's timings for the checkout at ``root``."""
    proc = subprocess.run([sys.executable, "-c", WORKER, str(root)],
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
    args = ap.parse_args(argv)
    other = Path(args.other).resolve()
    if not (other / "vit_tpu_torch").is_dir():
        raise SystemExit(f"{other} holds no vit_tpu_torch/")
    runs = []
    for tag, root in (("other", other), ("this", HERE), ("this", HERE),
                      ("other", other)):
        got = run_tree(root, args.timeout)
        runs.append({"tree": tag, **got})
        print(f"{tag:5s} " + "  ".join(
            f"{k} {v['ms']:.4f} ms (device {v['device_ms']:.4f})"
            for k, v in got.items()), flush=True)
    from vit_tpu_torch.tools import card_line
    print(json.dumps({"turns": runs, "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
