"""Does an s8 x s8 -> s32 dot pay over bf16 at the MLP's shape on the card?
(counterpart of ``tools/int8_probe.py``)

The JAX probe asked the TPU's matrix unit; this one asks the port's own
tiles, K22 ``dot_probe`` (``vit_tpu_torch/csrc/dot_probe.cu``: the whole
product x @ w written out raw, int8 -> int32 exact, bf16 or fp32 -> fp32).
Each dot runs on the tile the port's path runs it on (:func:`dot_tile`,
by shape and alignment alone): int8 on K11's s8 ``wgmma`` tile fed by TMA
(``csrc/matmul_i8_wgmma.cu`` with its raw epilogue) where
``ops.cuda.quant.i8_path`` gives K11 that tile, bf16 on K2's ``wgmma``
tile (``csrc/gemm_wgmma.cuh``, the fp32 sums stored unrounded) and fp32 on
K2's tf32 tile (``csrc/gemm_tf32.cuh``, three TF32 passes, the sums
stored raw) where ``ops.cuda.matmul.gemm_path`` gives K2 that tile, every
other shape on ``gemm_tile.cuh``'s loop (s8 or bf16 ``wmma``, fp32 FFMA).
Its bound at the timed shape is bytes in int8 and bf16: the 20.4 MB fp32
or int32 product, 0.0072 ms in int8 and 0.0083 in bf16 at 3.35 TB/s; in
fp32 operations, 0.0476 ms in three TF32 passes. It checks, in order:

1. a 128 x 128 int8 dot, bit for bit against numpy;
2. K12 ``mlp_block_i8dot`` at a tiny shape (d=128, m=16). JAX compile-
   checks it at mlp=256; the port's K12 takes whole 512-column quant
   groups only (``ops.mlp_q_plan``), so it runs at mlp=512 and says why;
3. int8 against bf16 at (1664, 768) @ (768, 3072), timed with
   ``utils.timing.do_bench`` (CUDA events, median of the calls).

It prints the times and rates, then one JSON line ``{"int8_dot": ...,
"int8_ms": ..., "bf16_ms": ..., "card": "<name>, <power limit>"}``.
``--device cpu`` runs the plain versions and times nothing (the times are
null)::

    python -m vit_tpu_torch.tools.int8_probe            # on the card
    python -m vit_tpu_torch.tools.int8_probe --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from vit_tpu_torch import ops
from vit_tpu_torch.ops.cuda import _build, count_launch
from vit_tpu_torch.ops.dispatch import resolve_impl
from vit_tpu_torch.tools import card_line, require_device

#: The input types K22 takes, and the type of its output for each.
OUT_DTYPES = {torch.int8: torch.int32, torch.bfloat16: torch.float32,
              torch.float32: torch.float32}
#: The timed shape: 1664 rows (8 images of 208 tokens) of fc1 at B/16.
TIMED_SHAPE = (1664, 768, 3072)
#: K12's tiny shape (the JAX probe's d and m); the JAX probe's mlp is 256.
MLP_TINY = (128, 512, 16)


def dot_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as K22 computes it: int8 sums exact in int32 (through
    float64, exact for any k below 2**37); bf16 and fp32 summed in fp32."""
    if x.dtype == torch.int8:
        return torch.matmul(x.double(), w.double()).to(torch.int32)
    return torch.matmul(x.float(), w.float())


def dot_tile(m: int, n: int, k: int, dtype: torch.dtype,
             ptrs: tuple[int, int]) -> str:
    """The tile K22 runs ``(m, k) @ (k, n)`` of contiguous operands on,
    from shape and alignment alone (``ptrs`` the bases, bytes):
    ``"wgmma"`` where TMA reads both operands by K11's rule in int8
    (:func:`vit_tpu_torch.ops.cuda.quant.i8_path`) or K2's in bf16
    (:func:`vit_tpu_torch.ops.cuda.matmul.gemm_path`), else ``"wmma"``
    (``gemm_tile.cuh``'s loop); in fp32 ``"tf32"`` (K2's tf32 tile) where
    K2's fp32 rule gives K2 that tile, else ``"ffma"``.
    ``csrc/dot_probe.cu:vit_dot_probe_tile`` applies the same rule."""
    from vit_tpu_torch.ops.cuda.matmul import gemm_path
    from vit_tpu_torch.ops.cuda.quant import i8_path

    if dtype == torch.int8:
        return i8_path(m, n, k, ptrs)
    path = gemm_path(m, n, k, dtype, False, False, ptrs, ((k, 1), (n, 1)))
    if dtype == torch.float32:
        return "tf32" if path == "wgmma" else "ffma"
    return path


def dot(x: torch.Tensor, w: torch.Tensor, *,
        impl: str | None = None) -> torch.Tensor:
    """``(M, K) @ (K, N)`` of int8, bf16 or fp32 operands of one type, the
    sums written out raw (int32 for int8, else fp32): K22 on CUDA tensors
    (counted as ``dot_probe``), the plain version on CPU tensors."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"dot shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype not in OUT_DTYPES or w.dtype != x.dtype:
        raise ValueError(f"dot takes int8, bf16 or fp32 operands of one "
                         f"type, got {x.dtype} @ {w.dtype}")
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError(f"dot of an empty operand {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if resolve_impl(impl, x) == "torch":
        return dot_plain(x, w)
    (m, k), n = x.shape, w.shape[1]
    _build.check_tensor(x, "x", x, dtype=x.dtype)
    _build.check_tensor(w, "w", x, (k, n), dtype=x.dtype)
    out = torch.empty((m, n), dtype=OUT_DTYPES[x.dtype], device=x.device)
    _build.launch("vit_dot_probe", x, w, out, m, n, k, like=x)
    count_launch("dot_probe")
    return out


def mlp_i8dot_tiny(device: str, *, d: int, mlp: int, m: int,
                   seed: int = 0) -> torch.Tensor:
    """K12 (``ops.mlp_block_i8dot``; its plain version on the CPU) on
    random weights quantized per column, at (1, m, d) with MLP width
    ``mlp``: the JAX probe's compile check. Raises ValueError where K12
    refuses the width (not whole 512-column quant groups)."""
    from vit_tpu_torch.quant import quantize_weight

    if not ops.mlp_q_plan(d, mlp):
        raise ValueError(f"K12 refuses D={d}, mlp={mlp}: it needs D a "
                         f"multiple of 128 and mlp whole "
                         f"{ops.reference.MLP_GROUP}-column quant groups")
    rng = np.random.default_rng(seed)

    def arr(*shape, sc=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * sc).astype(np.float32)).to(device)
    x = arr(1, m, d, sc=0.1)
    w1 = quantize_weight(arr(d, mlp, sc=0.05))
    w2 = quantize_weight(arr(mlp, d, sc=0.05))
    ones, zeros = torch.ones(d, device=device), torch.zeros(d, device=device)
    return ops.mlp_block_i8dot(x, ones, zeros, w1["q"], w1["scale"],
                               torch.zeros(mlp, device=device), w2["q"],
                               w2["scale"], zeros)


def run(device: str = "cuda", *, warmup: int = 10, reps: int = 30) -> dict:
    """The probe's three steps on ``device``; returns what :func:`main`
    prints. On the card, K22 launches 2 + 2 * (warmup + reps) times and K12
    once; on the CPU nothing is timed (the times are None)."""
    from vit_tpu_torch.utils.timing import do_bench

    require_device(device)
    on_card = device.startswith("cuda")
    rng = np.random.default_rng(0)

    def codes(*shape):
        return torch.from_numpy(
            rng.integers(-127, 128, shape).astype(np.int8)).to(device)

    # 1. The 128 x 128 int8 dot, bit for bit.
    xq, wq = codes(128, 128), codes(128, 128)
    want = xq.cpu().numpy().astype(np.int32) @ wq.cpu().numpy().astype(
        np.int32)
    ok = bool(np.array_equal(dot(xq, wq).cpu().numpy(), want))
    print(f"int8 dot 128x128 on {device}: {'OK' if ok else 'WRONG'}",
          file=sys.stderr)

    # 2. K12 at the tiny shape.
    d0, mlp0, m0 = MLP_TINY
    print(f"mlp_block_i8dot tiny: mlp={mlp0}, not the JAX probe's 256: "
          f"ops.mlp_q_plan({d0}, 256) is {ops.mlp_q_plan(d0, 256)} "
          "(K12 takes whole 512-column quant groups)", file=sys.stderr)
    out = mlp_i8dot_tiny(device, d=d0, mlp=mlp0, m=m0)
    ok2 = bool(torch.isfinite(out).all())
    print(f"mlp_block_i8dot d={d0} mlp={mlp0} m={m0}: "
          f"{'OK' if ok2 else 'NONFINITE'}", file=sys.stderr)

    # 3. int8 against bf16 at the MLP's shape; the int8 product checked
    # against the plain one, bit for bit.
    m, k, n = TIMED_SHAPE
    xq, wq = codes(m, k), codes(k, n)
    xb = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(device, torch.bfloat16)
    wb = torch.from_numpy(rng.standard_normal((k, n)).astype(
        np.float32)).to(device, torch.bfloat16)
    ok3 = bool(torch.equal(dot(xq, wq), dot_plain(xq, wq)))
    ms_i8 = ms_bf = None
    if on_card:
        ms_i8 = do_bench(lambda: dot(xq, wq), warmup=warmup, reps=reps)[0]
        ms_bf = do_bench(lambda: dot(xb, wb), warmup=warmup, reps=reps)[0]
        tops = 2 * m * k * n / 1e12
        print(f"int8: {ms_i8:.4f} ms = {tops / (ms_i8 / 1e3):.1f} TOP/s | "
              f"bf16: {ms_bf:.4f} ms = {tops / (ms_bf / 1e3):.1f} TFLOP/s "
              f"({m}x{k} @ {k}x{n})", file=sys.stderr)
    else:
        print("on the CPU the plain versions ran; nothing is timed",
              file=sys.stderr)
    return {"int8_dot": ok and ok3, "mlp_block_i8dot": ok2,
            "int8_ms": ms_i8, "bf16_ms": ms_bf, "device": device,
            "card": card_line() if on_card else None}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (K22, the default) or cpu (the plain "
                         "versions, not timed)")
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    res = run(args.device, warmup=args.warmup, reps=args.reps)
    print(json.dumps(res))
    return 0 if res["int8_dot"] and res["mlp_block_i8dot"] else 1


if __name__ == "__main__":
    sys.exit(main())
