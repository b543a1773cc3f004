"""What K10's row form (``csrc/layernorm.cu:quantize_rows_reg``) spends
its time on, by ablation on the card.

Each variant is a copy of ``layernorm.cu`` and ``common.cuh`` under
``build/quantize_rows_ablate/<name>/`` with one of the row form's choices
changed by a textual substitution (``VARIANTS``), built by ``nvcc`` alone
into a library of its own (the unit has its own C entry point,
``vit_quantize_rows``), which a process of its own loads. Every variant
computes the same function, so each output is held bit for bit to the
scalar form of the same library. The variants:

- ``fdiv``: the codes by ``quant_code`` (``__fdiv_rn``: a range check and
  a branch to its slow path a code), the scalar form's division, in place
  of ``quant_code_rcp``'s FMAs from the reciprocal;
- ``ln_one_row``: with LN too a warp a row (as many blocks as the rows
  need, no row loaded ahead), as without LN;
- ``noln_strided``: without LN too as many blocks as the SMs hold, each
  warp walking rows grid-strided with the next row's loads in flight, as
  with LN;
- ``threads256``: eight warps a block in place of four.

Times: each variant's kernel on the card (the profiler's device time over
50 calls), warm (the input read from L2, as on the int8 route, where K10
reads what the kernel before it wrote: but the fp32 context, 20 MB at
B/16, fills most of one half of the 50 MB L2, so its warm time varies
from one process to the next) and cold (200 MB written between calls,
the input read from device memory), at B/16 bs=32 with LN in bf16
(6656 x 768) and on the fp32 context (6656 x 768), L/16-384 bs=8 with LN
(4736 x 1024) and H/14 bs=2 with LN (544 x 1280), and the scalar form's
beside them; variants in turns (``base`` first and last). Prints a line a
run and a JSON line with the card::

    python -m vit_tpu_torch.tools.quantize_rows_ablate [--variants base fdiv]
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
CSRC = HERE / "vit_tpu_torch" / "csrc"
OUT = HERE / "build" / "quantize_rows_ablate"

#: name -> [(pattern, replacement)] in layernorm.cu, re.MULTILINE.
VARIANTS = {
    "base": [],
    "fdiv": [(r"quant_code_rcp\(v\[4 \* c \+ i\], a, ra\)",
              "quant_code(v[4 * c + i], a)")],
    "ln_one_row": [(r"kQrStrided = LN;", "kQrStrided = false;")],
    "noln_strided": [(r"kQrStrided = LN;", "kQrStrided = true;")],
    "threads256": [(r"kQrThreads = 128;", "kQrThreads = 256;")],
}

WORKER = r"""
import ctypes, json, sys
import torch
from torch.profiler import ProfilerActivity, profile
fn = ctypes.CDLL(sys.argv[1]).vit_quantize_rows
P, I = ctypes.c_void_p, ctypes.c_int
fn.argtypes = [P] * 5 + [I, I, ctypes.c_float] + [I] * 3 + [P]
gen = torch.Generator(device="cuda").manual_seed(0)
# Written between calls where a time is taken cold: four times L2.
flush = torch.empty(50 * 2**20, device="cuda")
res = {}
for tag, dt, m, d, ln in (("b16_ln", torch.bfloat16, 6656, 768, True),
                          ("b16_context", torch.float32, 6656, 768, False),
                          ("l16_384_ln", torch.bfloat16, 4736, 1024, True),
                          ("h14_ln", torch.bfloat16, 544, 1280, True)):
    x = (torch.randn((m, d), generator=gen, device="cuda") * 1.5
         + 0.2).to(dt)
    g = (torch.randn((d,), generator=gen, device="cuda") * 0.1
         + 1.0).to(dt) if ln else None
    b = (torch.randn((d,), generator=gen, device="cuda")
         * 0.05).to(dt) if ln else None
    stream = torch.cuda.current_stream().cuda_stream

    def call(form):
        q = torch.empty((m, d), dtype=torch.int8, device="cuda")
        a = torch.empty((m, 1), device="cuda")
        rc = fn(x.data_ptr(), None if g is None else g.data_ptr(),
                None if b is None else b.data_ptr(), q.data_ptr(),
                a.data_ptr(), m, d, 1e-12, form,
                0 if dt == torch.float32 else 1, x.device.index, stream)
        if rc:
            raise SystemExit(f"vit_quantize_rows failed: CUDA error {rc}")
        return q, a

    def device_ms(form, cold, iters=50):
        for _ in range(5):
            call(form)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if cold:
                    flush.zero_()
                call(form)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.self_device_time_total > 0 and "quantize" in e.key]
        n = sum(e.count for e in ev)
        return sum(e.self_device_time_total for e in ev) / n / 1e3 if n \
            else None

    for cold in (False, True):
        when = "_cold" if cold else ""
        res[tag + when] = device_ms(1, cold)
        res[tag + when + "_scalar"] = device_ms(0, cold)
    (q, a), (q0, a0) = call(1), call(0)
    res[tag + "_same_bits"] = bool(torch.equal(q, q0) and torch.equal(a, a0))
print(json.dumps(res))
"""


def make_variant(name: str) -> Path:
    """The variant's sources under ``OUT``, edited by ``VARIANTS[name]``;
    raises if a substitution matches nothing (the sources moved on)."""
    root = OUT / name
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for src in ("layernorm.cu", "common.cuh"):
        shutil.copy(CSRC / src, root)
    path = root / "layernorm.cu"
    text = path.read_text()
    for pattern, repl in VARIANTS[name]:
        text, n = re.subn(pattern, repl, text, flags=re.M)
        if not n:
            raise SystemExit(f"variant {name}: {pattern!r} matched nothing")
    path.write_text(text)
    return root


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args(argv)
    from vit_tpu_torch.ops.cuda import _build
    from vit_tpu_torch.tools import card_line
    names = ["base"] + [v for v in args.variants if v != "base"]
    libs, builds = {}, {}
    for n in names:
        root = make_variant(n)
        libs[n] = root / "libk10.so"
        builds[n] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(root),
             "-o", str(libs[n]), str(root / "layernorm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for n, p in builds.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"variant {n}: the build failed\n{log[-3000:]}")
    runs = []
    for n in names + ["base"]:
        res = subprocess.run([sys.executable, "-c", WORKER, str(libs[n])],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise SystemExit(f"variant {n}: {res.stderr[-3000:]}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"variant": n, **got})
        print(f"{n:16s} " + "  ".join(
            f"{k} {v:.5g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in got.items()), flush=True)
    if not all(v for r in runs for k, v in r.items()
               if k.endswith("_same_bits")):
        raise SystemExit("a variant's codes differ from the scalar form's")
    print(json.dumps({"ablation": runs, "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
