"""Does the three-pass TF32 split hold the fp32 bars on the card? The
numerics of the fp32 forms of K2 and K13 before their tiles rely on them.

Each fp32 operand splits as ``x = hi + lo``, ``hi = tf32(x)`` (round to
nearest, ties away from zero, at 10 stored mantissa bits) and ``lo = x -
hi``, which the tensor cores read truncated to tf32; a product is ``lo_a
hi_b + hi_a lo_b + hi_a hi_b`` in one fp32 accumulator
(``csrc/tf32_split.cuh``). The probe kernel
(``csrc/tf32_split_probe.cu``, ``vit_tf32_split_probe``) runs whole products
through the instruction each tile uses -- ``wgmma`` m64n128k8 tf32 (K2's)
or ``mma.sync`` m16n8k8 tf32 (K13's) -- in three modes: the split into one
accumulator (``split``), the split with each 32-deep K step summed apart
and added on the FFMA units (``split_promoted``, ``wgmma`` only: it tells
the tensor cores' accumulation from the split), and one pass (``tf32``).
It reports each mode's max|diff| against the plain fp32 product (cuBLAS
with TF32 off, the kernels' bar: 1e-4) and against float64, at:

- K2's B/16 bs=32 shapes, with ``chip_smoke.py:kernel_cases``' scales: the
  QKV ``x @ w`` (K = 768), ``g @ w.t()`` (K = 2304) and ``x.t() @ g`` (K =
  6656, g at std 0.01), on the ``wgmma`` form; and K3's fc1 at K = D =
  768, 1024, 1280 and 1536;
- K13's five products over one head of 208 tokens (197 real) at d = 64
  and 128 -- ``q k^T``, ``g v^T`` (K = d), ``p^T g``, ``ds^T q`` and ``ds
  k`` (K = 208) -- on the ``mma.sync`` form.

It prints one line a case and one JSON line ``{"cases": [...], "card":
...}``. ``--device cpu`` runs :func:`matmul_split`, the PyTorch model of
the split, in place of the kernel (no card numbers). ``--lib`` loads a
library built from ``csrc/tf32_split_probe.cu`` alone::

    python -m vit_tpu_torch.tools.tf32_probe
    python -m vit_tpu_torch.tools.tf32_probe --device cpu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from vit_tpu_torch.tools import card_line, require_device

#: The probe's modes (its C ``mode`` argument) and the paths each runs on.
MODES = {"split": 0, "split_promoted": 1, "tf32": 2}
PATHS = {"wgmma": 0, "mma": 1}
FP32_BAR = 1e-4


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to tf32 as ``cvt.rna.tf32.f32`` rounds it: to
    the nearest value with 10 stored mantissa bits, ties away from zero
    (the magnitude's bits + 0x1000, the low 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) as a tf32 product reads it: its low 13 bits ignored."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of the split as the tensor cores take it: ``hi =
    tf32(x)``, ``lo = x - hi`` (exact in fp32) read as tf32, truncated."""
    hi = tf32(x)
    return hi, truncate(x.float() - hi)


def matmul_split(a: torch.Tensor, b: torch.Tensor, *,
                 passes: int = 3) -> torch.Tensor:
    """``a @ b`` as the tensor cores take it from the split: the three
    products of tf32 values (each exact in fp32) summed in fp32, small
    terms first; ``passes=1`` is plain TF32 (``hi_a hi_b``)."""
    (ah, al), (bh, bl) = split(a), split(b)
    if passes == 1:
        return torch.matmul(ah, bh)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def _load(lib_path: str | None):
    """The entry point ``vit_tf32_split_probe``: from the kernel library,
    or from ``lib_path`` (a build of the probe's source alone)."""
    from vit_tpu_torch.ops.cuda import _build
    if lib_path is None:
        return _build.library().vit_tf32_split_probe
    fn = ctypes.CDLL(lib_path).vit_tf32_split_probe
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    fn.restype = i
    return fn


def probe(a: torch.Tensor, b: torch.Tensor, path: str, mode: str,
          fn=None) -> torch.Tensor:
    """``a @ b`` (fp32, made contiguous) through the probe kernel on
    ``path`` in ``mode``; on CPU tensors :func:`matmul_split`."""
    a, b = a.float().contiguous(), b.float().contiguous()
    if not a.is_cuda:
        return matmul_split(a, b, passes=1 if mode == "tf32" else 3)
    fn = fn or _load(None)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            PATHS[path], MODES[mode], 0, a.device.index or 0,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vit_tf32_split_probe failed: CUDA error {rc}")
    return out


def gemm_cases(device: str, gen: torch.Generator) -> list:
    """K2's three B/16 bs=32 products, each ``(name, a, b)`` with the
    scales of ``chip_smoke.py:kernel_cases`` (transposed views made
    contiguous: the numerics do not depend on the layout)."""
    m, d = 32 * 208, 768

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=device) * std
    x, w = rnd(m, d), rnd(d, 3 * d, std=0.04)
    gu, gf = rnd(m, 3 * d), rnd(m, 3 * d, std=0.01)
    cases = [("qkv x @ w (K=768)", x, w),
             ("g @ w.t() (K=2304)", gu, w.t()),
             ("x.t() @ g (K=6656, g std 0.01)", x.t(), gf)]
    # K3's fc1, LN(x) @ W1 with K = D, at every VARIANTS width and 1536
    # (mlp_plan's fp32 limit): 1024 unit rows, W1 at std 0.03 (the scale
    # of chip_smoke.py's K3 cases), 512 of its columns.
    for k in (768, 1024, 1280, 1536):
        cases.append((f"K3 fc1 LN(x) @ W1 (K={k})", rnd(1024, k),
                      rnd(k, 512, std=0.03)))
    return cases


def attention_cases(device: str, gen: torch.Generator, hd: int) -> list:
    """K13's five products over one head: 208 tokens, 197 real keys,
    unit q, k, v and g, p and ds as the plain backward forms them."""
    s, seq_len = 208, 197

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    q, k, v, g = rnd(s, hd), rnd(s, hd), rnd(s, hd), rnd(s, hd)
    sc = (q @ k.t()) * hd ** -0.5
    sc[:, seq_len:] = float("-inf")
    p = torch.softmax(sc, dim=-1)
    dp = g @ v.t()
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return [(f"d={hd} s = q k^T", q, k.t()),
            (f"d={hd} dp = g v^T", g, v.t()),
            (f"d={hd} dv = p^T g", p.t(), g),
            (f"d={hd} dk = ds^T q", ds.t(), q),
            (f"d={hd} dq = ds k", ds, k)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lib", default=None,
                    help="a library built from csrc/tf32_split_probe.cu")
    args = ap.parse_args(argv)
    require_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn = _load(args.lib) if args.device.startswith("cuda") else None
    gen = torch.Generator(device=args.device).manual_seed(19)
    groups = [("wgmma", gemm_cases(args.device, gen), list(MODES)),
              ("mma", attention_cases(args.device, gen, 64)
               + attention_cases(args.device, gen, 128), ["split", "tf32"])]
    cases = []
    for path, items, modes in groups:
        for name, a, b in items:
            plain = torch.matmul(a, b)
            exact = torch.matmul(a.double(), b.double())
            row = {"case": name, "path": path, "k": a.shape[1],
                   "max_abs_ref": float(plain.abs().max()),
                   "plain_vs_f64": float((plain.double() - exact).abs().max())}
            for mode in modes:
                got = probe(a, b, path, mode, fn)
                row[mode] = float((got - plain).abs().max())
                row[mode + "_vs_f64"] = float((got.double() - exact)
                                              .abs().max())
            row["holds_bar"] = row["split"] <= FP32_BAR
            cases.append(row)
            print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    print(json.dumps({"cases": cases, "bar": FP32_BAR,
                      "device": args.device, "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
