"""Where K11's and K12's time goes on the card, by ablation.

Each variant is a copy of this checkout's package under
``build/i8_ablate/<name>/`` whose CUDA sources have one part of the int8
tiles' work taken out by a textual substitution (``VARIANTS``); the copy
builds its own kernels. The outputs of a variant other than ``base`` are
wrong by design: the time it saves against ``base`` is what the part
costs on the tile's path (where the part overlaps other work, less than
its own duration). The variants:

- ``no_transpose``: the weight boxes are not turned K-major (the
  transposers still wait and arrive, wgmma reads the slots as they are);
- ``no_k11_epilogue``: K11 stores nothing (the epilogue is skipped);
- ``no_k12_gelu``: K12's hidden is the pre-activation (no erf);
- ``no_k12_fc1`` / ``no_k12_fc2``: K12's fc1 or fc2 wgmma are not issued
  (their waits and the rings stay).

Times: K11 at B/16 bs=32's QKV (6656 x 768 @ 768 x 2304 + bias; the panel
kept) and the composed MLP's fc2 (6656 x 3072 @ 3072 x 768 + bias +
residual; the panel streamed), K12 at B/16 bs=32 (6656 x 768, mlp 3072)
and L/16-384 bs=8 (4736 x 1024, mlp 4096), bf16: the mean of 30 calls
queued back to back between two CUDA events (the device time where the
host keeps ahead), variants in turns (``base`` first and last). Prints one
line a variant and a JSON line with the card::

    python -m vit_tpu_torch.tools.i8_ablate [--variants base no_transpose]
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
OUT = HERE / "build" / "i8_ablate"

#: name -> [(file glob under csrc, pattern, replacement)], re.MULTILINE.
VARIANTS = {
    "base": [],
    "no_transpose": [("*.cu*", r"^(\s*)transpose_box\(",
                      r"\1if (0) transpose_box(")],
    "no_k11_epilogue": [("matmul_i8_wgmma.cu", r"^(\s*)(epilogue<[^>]*>\()",
                         r"\1if (ep.m < 0) \2")],
    "no_k12_gelu": [("mlp_i8_wgmma.cuh", r"const float v = gelu\(",
                     "const float v = (")],
    "no_k12_fc1": [("mlp_i8_wgmma.cuh", r"(\s)wgmma_s8<128>\(a1",
                    r"\1if (0) wgmma_s8<128>(a1")],
    "no_k12_fc2": [("mlp_i8_wgmma.cuh", r"(\s)wgmma_s8<64>\(a2",
                    r"\1if (0) wgmma_s8<64>(a2")],
}

WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from vit_tpu_torch import ops
from vit_tpu_torch.quant import quantize_weight
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
with torch.inference_mode():
    for tag, m, k, n, resid in (("k11_qkv", 6656, 768, 2304, False),
                                ("k11_fc2", 6656, 3072, 768, True)):
        xq, ax = ops.quantize_rows(rnd(m, k), impl="torch")
        w = quantize_weight(rnd(k, n, std=0.05))
        b, r = rnd(n), rnd(m, n) if resid else None
        res[tag] = queued_ms(lambda: ops.matmul_i8(
            xq, ax, w["q"], w["scale"], b, residual=r, out_dtype=bf))
    for tag, m, d, mlp in (("k12_b16", 6656, 768, 3072),
                           ("k12_l16_384", 4736, 1024, 4096)):
        w1 = quantize_weight(rnd(d, mlp, std=0.03))
        w2 = quantize_weight(rnd(mlp, d, std=0.03))
        args = (rnd(m, d, std=1.5, mean=0.2), rnd(d, std=0.1, mean=1.0),
                rnd(d, std=0.05), w1["q"], w1["scale"], rnd(mlp, std=0.02),
                w2["q"], w2["scale"], rnd(d, std=0.02))
        res[tag] = queued_ms(lambda: ops.mlp_block_i8dot(*args))
print(json.dumps(res))
"""


def make_variant(name: str, variants: dict | None = None,
                 out: Path = OUT) -> Path:
    """The variant's tree under ``out``, its sources edited by
    ``variants[name]`` (this module's ``VARIANTS`` by default); raises if a
    substitution matches nothing (the sources moved on)."""
    variants = VARIANTS if variants is None else variants
    root = out / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "vit_tpu_torch", root / "vit_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = root / "vit_tpu_torch" / "csrc"
    for glob, pattern, repl in variants[name]:
        hits = 0
        for path in csrc.glob(glob):
            text, n = re.subn(pattern, repl, path.read_text(), flags=re.M)
            hits += n
            path.write_text(text)
        if not hits:
            raise SystemExit(f"variant {name}: {pattern!r} matched nothing")
    return root


def run_variants(names: list[str], variants: dict, out: Path,
                 worker: str) -> list[dict]:
    """Build every variant's tree at once, then run ``worker`` (a script
    that prints a JSON line of times) in each, ``base`` first and last;
    prints a line a run and returns the runs."""
    names = ["base"] + [v for v in names if v != "base"]
    roots = {n: make_variant(n, variants, out) for n in names}
    # Every variant's kernels build at once, one process a tree.
    builds = {n: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         "from vit_tpu_torch.ops.cuda import _build; _build.build()",
         str(r)], cwd=r) for n, r in roots.items()}
    for n, p in builds.items():
        if p.wait() != 0:
            raise SystemExit(f"variant {n}: the build failed")
    runs = []
    for n in names + ["base"]:
        res = subprocess.run([sys.executable, "-c", worker, str(roots[n])],
                             cwd=roots[n], capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise SystemExit(f"variant {n}: {res.stderr[-3000:]}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"variant": n, **got})
        print(f"{n:16s} " + "  ".join(f"{k} {v:.4f} ms" for k, v in
                                      got.items()), flush=True)
    return runs


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
