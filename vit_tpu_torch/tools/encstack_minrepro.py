"""Take the whole-encoder kernel apart on the card (counterpart of
``tools/encstack_minrepro.py``).

K9 (``ops.encoder_stack``, ``csrc/encoder_stack.cu``) runs every layer in
one cooperative persistent launch, five grid-synchronised phases a layer.
At B/16 bs=1 bf16 it takes about 5 ms on an NVIDIA H100 80GB HBM3 at 700
W, against a 51 us weight-stream bound.
K24 ``encstack_probe`` (``vit_tpu_torch/csrc/encstack_probe.cu``) keeps
K9's grid, phases and tiling and strips each phase's body down to a
variant's ingredients, as the JAX probe's ``make_variant``
(``tools/encstack_minrepro.py:54-248``) does on the TPU:

=======  ================================================================
dma      every weight byte read once and summed; x comes back
         unchanged. K9's weight stream alone: the number to hold against
         the bound. JAX's sums are dead stores; here they are kept, a sum
         a layer and weight tensor (``fn.weight_sums()``), and held to
         :func:`weight_sums_plain`
scratch  x @ Wqkv into the QKV buffer; ``x += round(q * 0.001)`` over
         all rows, b times; fc1, fc2 into an fp32 sum zeroed once and
         never again (each layer's x is the running sum)
rows     scratch, each image's rows updated once
nodots   rows' GEMMs; ``x += round(LN(q) @ Wout)`` (LN without affine)
lnqkv    nodots with LN before QKV and fc1 and GELU after fc1
nosm     the attention core with the softmax deleted (``p = s``), then
         ``x += round(ctx @ Wout)``
core     nosm with the real core (no mask)
full     K9 itself, ``ops.encoder_stack`` (unit LN, zero biases)
=======  ================================================================

Each variant also takes JAX's ``@flat`` suffix (a 1-D TPU grid); a
persistent kernel walks the layers in one loop already, so ``@flat`` is the
same launch. ``(cq, mt)`` are JAX's QKV and MLP chunk widths: they change
only the order of the fp32 sums, so the port keeps K9's tiles and reports
the pair as given.

For each case and variant it prints the time (CUDA events around each
call, median, host launch cost included), the time a layer, the pipelined
time (calls queued back to back: the launch's device time) and the
launch's device time from ``torch.profiler`` (over the records kept),
each the median of ROUNDS rounds over the cases and variants in turn,
then one JSON line. ``--device cpu`` runs the plain versions once and
times nothing::

    python -m vit_tpu_torch.tools.encstack_minrepro --variants dma core full
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.dispatch import resolve_impl
from vit_tpu_torch.tools import card_line, require_device

#: The stripped variants, by their code in ``csrc/encstack_probe.cu``.
VARIANTS = ("dma", "scratch", "rows", "nodots", "lnqkv", "nosm", "core")
#: The JAX probe's default cases (b, cq, mt) and variants.
DEFAULT_CASES = ("2,768,768", "2,768,512", "3,768,768", "1,768,512")
DEFAULT_VARIANTS = ("dma", "scratch", "rows", "nodots", "full")
#: Rounds over every case and variant on the card; medians reported (a
#: launch's reading moves from one round to the next).
ROUNDS = 3


def parse_variant(variant: str) -> str:
    """The variant without JAX's ``@flat`` suffix (the same launch here)."""
    base = variant[:-len("@flat")] if variant.endswith("@flat") else variant
    if base not in VARIANTS + ("full",) or variant == "full@flat":
        raise ValueError(f"unknown variant {variant!r}; one of "
                         f"{VARIANTS + ('full',)}, each but full also with "
                         "@flat")
    return base


def make_weights(L: int, d: int, mlp: int, dtype: torch.dtype,
                 device: str = "cpu", rng=None):
    """The JAX probe's stacked weights, drawn in its order: wqkv (L, d,
    3d), wout (L, d, d), w1 (L, d, mlp), w2 (L, mlp, d), each N(0, 0.05)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    return tuple(torch.from_numpy(
        (rng.standard_normal(shape) * 0.05).astype(np.float32)).to(
            device, dtype)
        for shape in ((L, d, 3 * d), (L, d, d), (L, d, mlp), (L, mlp, d)))


def _ln(x32: torch.Tensor, eps: float) -> torch.Tensor:
    """LN without scale or bias, in fp32."""
    mu = x32.mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt((x32 - mu).square().mean(
        -1, keepdim=True) + eps)


def variant_plain(variant: str, x, wqkv, wout, w1, w2, *, b: int, sp: int,
                  heads: int, eps: float = 1e-12) -> torch.Tensor:
    """``make_variant``'s function in plain PyTorch: x (b*sp, d) in, the
    same shape out, with the JAX kernel's rounding points."""
    variant = parse_variant(variant)
    f32, dt = torch.float32, x.dtype
    m, d = x.shape
    xcur = x.clone()
    if variant == "dma":
        return xcur
    hd = d // heads
    c001 = torch.tensor(0.001, dtype=dt).to(f32)
    acc = torch.zeros((m, d), dtype=f32, device=x.device)
    for l in range(wqkv.shape[0]):
        xin = xcur.to(f32)
        if variant == "lnqkv":
            xin = _ln(xin, eps)
        qkv = torch.matmul(xin, wqkv[l].to(f32)).to(dt)
        q = qkv[:, :d]
        if variant in ("scratch", "rows"):
            dq = (q.to(f32) * c001).to(dt).to(f32)
            for _ in range(b if variant == "scratch" else 1):
                xcur = (xcur.to(f32) + dq).to(dt)
        else:
            if variant in ("nodots", "lnqkv"):
                ctx = _ln(q.to(f32), eps).to(dt)
            else:
                qh, kh, vh = (t.reshape(b, sp, heads, hd).transpose(1, 2)
                              for t in (q, qkv[:, d:2 * d], qkv[:, 2 * d:]))
                s = torch.matmul(qh.to(f32), kh.to(f32).transpose(-1, -2)) \
                    * hd ** -0.5
                if variant == "core":
                    p = torch.exp(s - s.amax(-1, keepdim=True))
                    den = p.sum(-1, keepdim=True)
                else:
                    p, den = s, 1.0
                c = torch.matmul(p.to(dt).to(f32), vh.to(f32)) / den
                ctx = c.transpose(1, 2).reshape(m, d).to(dt)
            out = torch.matmul(ctx.to(f32), wout[l].to(f32)).to(dt)
            xcur = (xcur.to(f32) + out.to(f32)).to(dt)
        xin = xcur
        if variant == "lnqkv":
            xin = _ln(xcur.to(f32), eps).to(dt)
        h = torch.matmul(xin.to(f32), w1[l].to(f32))
        if variant == "lnqkv":
            h = reference.gelu(h)
        acc = acc + torch.matmul(h.to(dt).to(f32), w2[l].to(f32))
        xcur = acc.to(dt)
    return xcur


def weight_sums_plain(wqkv, wout, w1, w2) -> torch.Tensor:
    """(L, 4) fp32: the sum of each layer's wqkv, wout, w1 and w2, what
    ``dma`` streams."""
    return torch.stack([w.float().sum((1, 2)) for w in (wqkv, wout, w1, w2)],
                       1)


def check_weight_sums(got, wqkv, wout, w1, w2, rtol: float = 1e-5) -> float:
    """Hold ``dma``'s (L, 4) sums to :func:`weight_sums_plain`: each within
    ``rtol`` of the sum of the tensor's magnitudes (fp32 sums in another
    order differ by ~1e-7 of it; a tensor or a layer skipped, or a 64th of
    a tensor, moves a sum by far more). Returns max|diff|."""
    want = weight_sums_plain(wqkv, wout, w1, w2).to(got.device)
    mags = torch.stack([w.float().abs().sum((1, 2))
                        for w in (wqkv, wout, w1, w2)], 1).to(got.device)
    diff = (got.float() - want).abs()
    if tuple(got.shape) != tuple(want.shape) or not bool(
            (diff <= rtol * mags).all()):
        raise AssertionError(f"dma's weight sums are off: max|diff| "
                             f"{float(diff.max())}, bar {rtol} x sum|w|")
    return float(diff.max())


#: Threads a block of K24 (``kMmThreads``).
STACK_THREADS = 256


class _Scratch:
    """K24's buffers for one ``make_variant`` closure, made at its first
    launch on a card and kept, so that a timed call holds the launch alone:
    the QKV, context, hidden and fp32 accumulator buffers, the LN's unit
    scale and zero bias, and ``dma``'s sink, zeroed once, (blocks, L, 4)
    block sums with a row for every block the card can hold (at most 2048
    threads an SM)."""

    def __init__(self, x, *, L: int, mlp: int):
        m, d = x.shape
        kw = dict(dtype=x.dtype, device=x.device)
        f32 = dict(dtype=torch.float32, device=x.device)
        self.device = x.device
        from vit_tpu_torch.ops.cuda.stack import qkv_buffer
        self.qkv = qkv_buffer(m, d, x)
        self.ctx = torch.empty((m, d), **kw)
        self.hid = torch.empty((m, mlp), **kw)
        self.acc = torch.empty((m, d), **f32)
        self.ones, self.zeros = torch.ones(d, **kw), torch.zeros(d, **kw)
        blocks = torch.cuda.get_device_properties(
            x.device).multi_processor_count * 2048 // STACK_THREADS
        self.sink = torch.zeros((blocks, L, 4), **f32)


def _stack_kernel(variant: str, x, wqkv, wout, w1, w2, scratch: _Scratch, *,
                  b, sp, heads, eps):
    """One K24 launch (counted as ``encstack_probe``) with the buffers of
    ``scratch``. ``dma`` leaves x alone and returns it; the others return
    a new tensor."""
    from vit_tpu_torch.ops.cuda import _build, count_launch
    from vit_tpu_torch.ops.cuda.block import MAX_SMEM, attention_smem_bytes

    m, d = x.shape
    L, mlp = w1.shape[0], w1.shape[2]
    _build.check_tensor(x, "x", x)
    for t, name, shape in ((wqkv, "wqkv", (L, d, 3 * d)),
                           (wout, "wout", (L, d, d)), (w1, "w1", (L, d, mlp)),
                           (w2, "w2", (L, mlp, d))):
        _build.check_tensor(t, name, x, shape)
    smem = attention_smem_bytes(sp, d // heads, x.element_size())
    if smem > MAX_SMEM:
        raise ValueError(f"the attention routine does not take head_dim "
                         f"{d // heads} at {sp} tokens ({smem} B)")
    # The kernel updates the activation in place; dma never writes it.
    work = x if variant == "dma" else x.clone()
    s = scratch
    _build.launch("vit_encstack_probe", work, s.qkv, s.ctx, s.hid, s.acc,
                  s.sink, s.sink.numel(), wqkv, wout, w1, w2, s.ones,
                  s.zeros, b, sp, d, mlp, heads, L,
                  float((d // heads) ** -0.5), float(eps),
                  VARIANTS.index(variant), like=x)
    count_launch("encstack_probe")
    return work


def full_encoder(x, wqkv, wout, w1, w2, *, b: int, sp: int, heads: int,
                 impl: str | None = None) -> torch.Tensor:
    """``full``: K9 (``ops.encoder_stack``) over these weights with unit LN
    scales and zero biases, no key masked; x (b*sp, d) in and out."""
    from vit_tpu_torch import ops

    L, d, mlp = w1.shape
    kw = dict(dtype=x.dtype, device=x.device)
    enc = {"ln1": {"scale": torch.ones((L, d), **kw),
                   "bias": torch.zeros((L, d), **kw)},
           "qkv": {"kernel": wqkv, "bias": torch.zeros((L, 3 * d), **kw)},
           "out": {"kernel": wout, "bias": torch.zeros((L, d), **kw)},
           "ln2": {"scale": torch.ones((L, d), **kw),
                   "bias": torch.zeros((L, d), **kw)},
           "fc1": {"kernel": w1, "bias": torch.zeros((L, mlp), **kw)},
           "fc2": {"kernel": w2, "bias": torch.zeros((L, d), **kw)}}
    return ops.encoder_stack(x.reshape(b, sp, d), enc, num_heads=heads,
                             seq_len=sp, impl=impl).reshape(b * sp, d)


def make_variant(variant: str, *, b: int, sp: int, d: int, mlp: int, L: int,
                 cq: int, mt: int, dtype: torch.dtype, heads: int = 12,
                 eps: float = 1e-12, impl: str | None = None):
    """``fn(x, wqkv, wout, w1, w2) -> (b*sp, d)``: ``variant`` (``full``
    included, each other with or without ``@flat``) on x (b*sp, d) and the
    stacked weights, through K24 (K9 for full) on CUDA tensors and the plain
    versions on CPU tensors. ``cq`` and ``mt`` are checked as JAX's chunk
    widths and do not change the launch. After a ``dma`` call,
    ``fn.weight_sums()`` is its (L, 4) fp32 sums of the weights (the
    kernel's sink, or :func:`weight_sums_plain` on the CPU)."""
    base = parse_variant(variant)
    if (3 * d) % cq or mlp % mt:
        raise ValueError(f"cq={cq} must divide 3d={3 * d} and mt={mt} must "
                         f"divide mlp={mlp}")
    if d % heads:
        raise ValueError(f"d={d} not divisible by {heads} heads")

    state: dict = {}

    def fn(x, wqkv, wout, w1, w2):
        if tuple(x.shape) != (b * sp, d) or x.dtype != dtype:
            raise ValueError(f"x must be ({b * sp}, {d}) {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if tuple(wqkv.shape) != (L, d, 3 * d) or tuple(w1.shape) != (
                L, d, mlp):
            raise ValueError("weights do not match (L, d, mlp)")
        if base == "full":
            return full_encoder(x, wqkv, wout, w1, w2, b=b, sp=sp,
                                heads=heads, impl=impl)
        if resolve_impl(impl, x) == "torch":
            if base == "dma":
                state["sums"] = lambda: weight_sums_plain(wqkv, wout, w1, w2)
            return variant_plain(base, x, wqkv, wout, w1, w2, b=b, sp=sp,
                                 heads=heads, eps=eps)
        scratch = state.get("scratch")
        if scratch is None or scratch.device != x.device:
            scratch = state["scratch"] = _Scratch(x, L=L, mlp=mlp)
        if base == "dma":
            state["sums"] = lambda: scratch.sink.sum(0)
        return _stack_kernel(base, x, wqkv, wout, w1, w2, scratch, b=b,
                             sp=sp, heads=heads, eps=eps)

    def weight_sums() -> torch.Tensor:
        if "sums" not in state:
            raise RuntimeError("weight_sums: no dma call yet")
        return state["sums"]()
    fn.weight_sums = weight_sums
    return fn


def run(cases=DEFAULT_CASES, variants=DEFAULT_VARIANTS, *, sp: int = 208,
        d: int = 768, mlp: int = 3072, heads: int = 12, L: int = 12,
        dtype: torch.dtype = torch.bfloat16, device: str = "cuda",
        reps: int = 10) -> dict:
    """Each variant of each ``"b,cq,mt"`` case on the JAX probe's inputs;
    on the card each is timed ROUNDS times, the variants in turn within a
    round (CUDA events, median of ``reps`` calls; pipelined; the launch's
    device ms from the profiler), and the medians over the rounds
    reported. Returns what :func:`main` prints."""
    from vit_tpu_torch.utils.profiling import launch_ms
    from vit_tpu_torch.utils.timing import do_bench, pipelined_ms

    require_device(device)
    on_card = device.startswith("cuda")
    rng = np.random.default_rng(0)
    runs = []
    for case in cases:
        b, cq, mt = map(int, case.split(","))
        x = torch.from_numpy((rng.standard_normal((b * sp, d)) * 0.05).astype(
            np.float32)).to(device, dtype)
        weights = make_weights(L, d, mlp, dtype, device, rng)
        for variant in variants:
            fn = make_variant(variant, b=b, sp=sp, d=d, mlp=mlp, L=L, cq=cq,
                              mt=mt, dtype=dtype, heads=heads)
            fn(x, *weights)
            if not on_card:
                print(f"b={b} cq={cq} mt={mt} {variant}: ran on the CPU "
                      "(plain version)", flush=True)
            runs.append(((b, cq, mt, variant),
                         lambda fn=fn, x=x, w=weights: fn(x, *w)))
    samples = {key: [] for key, _ in runs}
    for _ in range(ROUNDS if on_card else 0):
        for key, call in runs:
            kernel = ("encoder_stack_kernel" if key[3] == "full"
                      else "encstack_probe_kernel")
            samples[key].append((do_bench(call, warmup=2, reps=reps)[0],
                                 pipelined_ms(call, warmup=2, reps=reps),
                                 launch_ms(call, kernel, 5)))
    rows = []
    for (b, cq, mt, variant), got in samples.items():
        if not got:
            continue
        ms, pipe = (float(np.median(v)) for v in list(zip(*got))[:2])
        kept = [g[2] for g in got if g[2] is not None]
        dev = float(np.median(kept)) if kept else None
        rows.append({"b": b, "cq": cq, "mt": mt, "variant": variant,
                     "ms": ms, "us_per_layer": ms / L * 1e3,
                     "pipelined_ms": pipe, "device_ms": dev,
                     "ms_rounds": [g[0] for g in got]})
        shown = "none kept" if dev is None else f"{dev:.4f}"
        print(f"b={b} cq={cq} mt={mt} {variant}: {ms:.4f} ms "
              f"({ms / L * 1e3:.1f} us/layer; pipelined {pipe:.4f} ms, "
              f"profiler {shown})", flush=True)
    return {"rows": rows, "layers": L, "rounds": ROUNDS,
            "dtype": str(dtype).replace("torch.", ""), "device": device,
            "card": card_line() if on_card else None}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=list(DEFAULT_CASES),
                    help="b,cq,mt triplets")
    ap.add_argument("--variants", nargs="+", default=list(DEFAULT_VARIANTS))
    ap.add_argument("--sp", type=int, default=208)
    ap.add_argument("-d", type=int, default=768)
    ap.add_argument("--mlp", type=int, default=3072)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("-L", type=int, default=12)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (the plain "
                         "versions, not timed)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.cases, args.variants, sp=args.sp, d=args.d,
                         mlp=args.mlp, heads=args.heads, L=args.L,
                         dtype=getattr(torch, args.dtype),
                         device=args.device, reps=args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
