"""Take the attention block's core apart on the card (counterpart of
``tools/attn_core_probe.py``).

The block is the port's ``attn_block``: K1 (LN1), K2 into the packed
``(B*S, 3D)`` QKV buffer, the core, K2 with ``bout`` and the residual. The
core is K23 ``attn_core_probe`` (``vit_tpu_torch/csrc/attn_core_probe.cu``)
with the mode as a template parameter, on K4's tensor-core tile in each
dtype, ``mma.sync`` on K4's block of 128 threads: in bf16
``attention_mma.cuh``'s, where ``qcore`` runs its int8 codes on
``mma.sync`` m16n8k32; in fp32 ``attention_tf32.cuh``'s (three TF32
passes, a running max), where ``qcore``'s codes, exact in TF32, take one
pass a product. So ``full`` is K4's core bit for bit in both (its very
instantiation). The layout modes' GEMMs (kt, projonly, tcore, xcore) are
K23's too: K2's TMA tile with an epilogue form each, where TMA reads the
operands (:func:`gemm_tile`: bf16 ``gemm_wgmma.cuh``'s ``wgmma`` tile,
fp32 ``gemm_tf32.cuh``'s tf32 walk), else K2's tile loop
(``gemm_tile.cuh``). The core's bound is K4's: bytes, 0.0122 ms at B/16
bs=32 in bf16, 0.0244 in fp32. Each
mode switches one ingredient off, or lays the data out another way, as
the JAX probe's ``_core_kernel`` (``tools/attn_core_probe.py:67-290``) and
``_tcore_body`` (``:293-331``) do:

=========  ===============================================================
full       masked ``s*scale``, max, exp, ``l = sum p``; ``round(p) @ v / l``
maskonly   as full, ``l = 1``
nosm       no mask; max and exp kept; ``l = 1``
mxu        no mask, max or exp: ``p = s``, ``l = 1``
divonly    as full without the mask
recip      as divonly, ``ctx * (1 / l)``
sumonly    as divonly, ``ctx + 1e-30 * l`` (the sum live, not divided)
bf16div    as divonly, ``round(ctx) / round(l)``
alldiv     as recip (JAX defers the division past the heads' concat)
mxudiv     as recip (JAX widens ``1/l`` by a 0/1 product)
addmask    the mask as one additive row; ``ctx * (1 / l)``
vsum       masked; ``l`` the sum of the rounded p (JAX: a ones column)
qcore      int8 codes: q per row, k and v per head, p per row; exact
           integer dots; ``ctx = c32 * (ap * av) / l``
wide       heads in pairs, contraction over 2*hd (the heads mix); no
           mask; ``round(p / l) @ v2``
kt         full, with the K projection written transposed (D, B*S)
projonly   ``ctx = q``; no core launch
tcore      full's function head-major: projections transposed (3D, B*S),
           ``ctx * (1 / l)``, out-projection ``WoutT @ ctxT`` rounded, then
           transposed back with ``bout`` and ``x`` added
xcore      tcore's core on activations that arrive and leave as (D, B*S):
           a column LN, no transposes, no rounding before ``bout + x``
=========  ===============================================================

Only full, kt, addmask, vsum, tcore and xcore compute the block's function
(tcore with one more rounding); the rest are timing probes. Each mode's
launches are :func:`launches`; every launch from K23's source counts as
``attn_core_probe``. The JAX kernel runs ``group`` images a grid step; a
work item here is (image, head, 64 queries) whatever the group, which is
kept for its check (the batch must be a multiple of it). Every mode's
core fits shared memory at 208 tokens, fp32 ``wide``'s heads of 128 too
(:func:`core_smem_bytes`). In bf16, qcore and the head-major core take
heads up to 128 columns.

For each mode it prints the block's time by CUDA events around each call
(median, :func:`vit_tpu_torch.utils.timing.do_bench`, host launch cost
included), the nominal-FLOP rate of the JAX probe, the block's pipelined
time (calls queued back to back: its device time,
:func:`vit_tpu_torch.utils.timing.pipelined_ms`), and the same two for
the core launch alone on the inputs the block gives it
(:func:`core_only`), beside the core launch's device time from
``torch.profiler`` (:func:`vit_tpu_torch.utils.profiling.launch_ms`: over
the records kept), then one JSON line. The modes are timed in turn ROUNDS
times and the medians reported. ``--device cpu`` runs the plain versions
once and times nothing::

    python -m vit_tpu_torch.tools.attn_core_probe --batch 32 --group 4 \\
        --modes full nosm mxu wide projonly
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

#: Every mode of the JAX probe, and the core's mode code in
#: ``csrc/attention_core.cuh`` (None: no core launch).
MODES = {"full": 0, "maskonly": 1, "nosm": 2, "mxu": 3, "divonly": 4,
         "recip": 5, "sumonly": 6, "bf16div": 7, "alldiv": 8, "mxudiv": 9,
         "addmask": 10, "vsum": 11, "qcore": 12, "wide": 13, "kt": 14,
         "projonly": None, "tcore": 15, "xcore": 15}
#: The JAX probe's default modes.
DEFAULT_MODES = ("full", "nosm", "mxu", "wide", "projonly")
#: Rounds over every mode on the card; medians reported (one round's
#: reading of a launch moves by several per cent).
ROUNDS = 3
#: Modes whose keys at index >= seq_len are masked.
MASKED = ("full", "maskonly", "addmask", "vsum", "qcore", "kt", "tcore",
          "xcore")
#: Modes whose context is divided by the row sum, and those that multiply
#: by its reciprocal.
DIVIDE = ("full", "divonly", "kt", "vsum")
RECIPROCAL = ("recip", "alldiv", "mxudiv", "addmask", "tcore", "xcore")
#: Modes whose context is not divided by the row sum: it and the block's
#: output carry up to l (about sp) times the normalised magnitudes (B/16:
#: max |out| 106-308 against 5.7 for full), so their checks are relative
#: to the output's norm, not to each element.
UNNORMALIZED = ("maskonly", "nosm", "mxu", "sumonly")
#: The probe GEMM's epilogues (``csrc/attn_core_probe.cu:ProbeEp``).
EP_SPLIT_Q, EP_SPLIT_KT, EP_ALL_T, EP_ROW_BIAS, EP_OUT_X, EP_OUT_T = range(6)
#: Widest head (columns) of the bf16 qcore and head-major cores, whose q
#: fragments are held whole.
MMA_MAX_HEAD = 128


def launches(mode: str) -> dict[str, int]:
    """The kernel launches of one block in ``mode``, by counter."""
    if mode == "xcore":
        return {"attn_core_probe": 4}
    if mode == "tcore":
        return {"layernorm": 1, "attn_core_probe": 3}
    if mode in ("kt", "projonly"):
        return {"layernorm": 1, "attn_core_probe": 1 + (mode == "kt"),
                "matmul": 1}
    return {"layernorm": 1, "matmul": 2, "attn_core_probe": 1}


def nominal_flops(b: int, sp: int, d: int) -> int:
    """The JAX probe's nominal block FLOPs (``:481``): four D x D
    projections and the two S x S products."""
    return 8 * b * sp * d * d + 4 * b * sp * sp * d


def make_inputs(b: int, sp: int, d: int, seq_len: int, dtype: torch.dtype,
                device: str = "cpu", seed: int = 0):
    """The JAX probe's inputs, drawn in its order from
    ``np.random.default_rng(seed)``: x (B, SP, D) with the pad rows zero,
    g1, be1, wqkv, bqkv, wout, bout."""
    rng = np.random.default_rng(seed)

    def arr(*shape, sc=0.05):
        return torch.from_numpy((rng.standard_normal(shape) * sc).astype(
            np.float32)).to(device, dtype)
    x = torch.from_numpy(rng.standard_normal((b, sp, d)).astype(
        np.float32)).to(device, dtype)
    x[:, seq_len:] = 0
    g1, be1 = arr(d, sc=0.2) + 1, arr(d)
    wqkv, bqkv = arr(d, 3 * d), arr(3 * d)
    wout, bout = arr(d, d), arr(d)
    return x, g1, be1, wqkv, bqkv, wout, bout


def _check(mode, x, *, b, sp, d, num_heads, seq_len, group):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {list(MODES)}")
    if group <= 0 or b % group:
        raise ValueError(f"batch {b} is not a multiple of group {group} (the "
                         "JAX kernel's grid b // group would leave rows "
                         "unwritten)")
    if num_heads <= 0 or d % num_heads:
        raise ValueError(f"D={d} not divisible by {num_heads} heads")
    if mode == "wide" and num_heads % 2:
        raise ValueError("wide pairs the heads: num_heads must be even")
    if not 0 < seq_len <= sp:
        raise ValueError(f"seq_len {seq_len} outside (0, {sp}]")
    if mode == "xcore" and tuple(x.shape) != (d, b * sp):
        raise ValueError(f"xcore takes x of shape {(d, b * sp)}, got "
                         f"{tuple(x.shape)}")
    if mode != "xcore" and (x.shape[-1] != d or x.numel() != b * sp * d):
        raise ValueError(f"{mode} takes x of shape {(b, sp, d)}, got "
                         f"{tuple(x.shape)}")


def _heads(t: torch.Tensor, b: int, sp: int, heads: int) -> torch.Tensor:
    """(B*sp, D) -> (B, H, sp, hd)."""
    return t.reshape(b, sp, heads, -1).transpose(1, 2)


def _pairs(t: torch.Tensor) -> torch.Tensor:
    """(B, H, sp, hd) -> (B, H/2, sp, 2*hd): heads 2j and 2j+1 side by side,
    as ``q_all[:, h0*hd:(h0+2)*hd]`` slices them."""
    b, h, sp, hd = t.shape
    return t.transpose(1, 2).reshape(b, sp, h // 2, 2 * hd).transpose(1, 2)


def _core_plain(mode: str, q, k, v, *, scale: float, seq_len: int,
                dt: torch.dtype) -> torch.Tensor:
    """The context (B, H, sp, hd) in ``dt`` of q, k, v (B, H, sp, hd) in
    ``dt``, with ``_core_kernel``'s rounding points for ``mode``."""
    f32 = torch.float32
    sp = q.shape[2]
    keep = torch.arange(sp, device=q.device) < seq_len
    if mode == "wide":
        q, k, v = _pairs(q), _pairs(k), _pairs(v)
    if mode == "qcore":
        qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
        aq = reference.div_qmax(qf.abs().amax(-1, keepdim=True)
                                .clamp_min(1e-12))
        ak = reference.div_qmax(kf.abs().amax((-2, -1), keepdim=True)
                                .clamp_min(1e-12))
        av = reference.div_qmax(vf.abs().amax((-2, -1), keepdim=True)
                                .clamp_min(1e-12))
        qq, kq, vq = (torch.round(t / a) for t, a in ((qf, aq), (kf, ak),
                                                      (vf, av)))
        s32 = torch.matmul(qq.double(), kq.double().transpose(-1, -2))
        s = s32.to(f32) * (aq * (ak * scale))
    else:
        s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale
    if mode == "addmask":
        s = s + torch.where(keep, 0.0, float("-inf"))
    elif mode in MASKED:
        s = torch.where(keep, s, float("-inf"))
    if mode == "mxu":
        p = s
    else:
        p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if mode == "qcore":
        ap = reference.div_qmax(p.amax(-1, keepdim=True).clamp_min(1e-12))
        c32 = torch.matmul(torch.round(p / ap).double(), vq.double())
        return ((c32.to(f32) * (ap * av)) / l).to(dt)
    if mode == "wide":
        ctx = torch.matmul((p / l).to(dt).to(f32), v.to(f32))
        b, hp, _, hd2 = ctx.shape
        return ctx.to(dt).transpose(1, 2).reshape(
            b, sp, 2 * hp, hd2 // 2).transpose(1, 2)
    pd = p.to(dt)
    ctx = torch.matmul(pd.to(f32), v.to(f32))
    if mode == "vsum":
        l = pd.to(f32).sum(-1, keepdim=True)
    if mode in DIVIDE:
        ctx = ctx / l
    elif mode in RECIPROCAL:
        ctx = ctx * (1.0 / l)
    elif mode == "sumonly":
        ctx = ctx + 1e-30 * l
    elif mode == "bf16div":
        ctx = ctx.to(dt).to(f32) / l.to(dt).to(f32)
    return ctx.to(dt)


def probe_plain(mode: str, x, g1, be1, wqkv, bqkv, wout, bout, *,
                num_heads: int, seq_len: int, group: int = 1, shape=None,
                eps: float = 1e-12) -> torch.Tensor:
    """The block in ``mode`` in plain PyTorch, with the JAX probe's rounding
    points: ``xn = LN(x)`` in the dtype, q, k, v ``xn @ w + b`` in fp32,
    rounded; the core (:func:`_core_plain`); ``ctx @ wout + bout + x`` in
    fp32, rounded once (tcore rounds ``ctx @ wout`` first). x is (B, SP, D),
    or (D, B*SP) for xcore, which returns that layout too."""
    b, sp, d = shape if shape is not None else x.shape
    _check(mode, x, b=b, sp=sp, d=d, num_heads=num_heads, seq_len=seq_len,
           group=group)
    dt = x.dtype
    scale = (d // num_heads) ** -0.5
    xr = x.t() if mode == "xcore" else x.reshape(b * sp, d)
    xn = reference.layernorm(xr, g1, be1, eps=eps)
    qkv = reference.matmul(xn, wqkv, bqkv)
    if mode == "projonly":
        ctx = qkv[:, :d]
    else:
        q, k, v = (_heads(qkv[:, i * d:(i + 1) * d], b, sp, num_heads)
                   for i in range(3))
        ctx = _core_plain(mode, q, k, v, scale=scale, seq_len=seq_len,
                          dt=dt).transpose(1, 2).reshape(b * sp, d)
    if mode == "tcore":
        out = (reference.matmul(ctx, wout).float() + bout.float()
               + xr.float()).to(dt)
    else:
        out = reference.matmul(ctx, wout, bout, residual=xr)
    return out.t().contiguous() if mode == "xcore" else out.reshape(b, sp, d)


def qcore_step(x, g1, be1, wqkv, bqkv, wout, *, num_heads: int,
               eps: float = 1e-12) -> float:
    """How far one int8 step moves qcore's block output: a code at a .5
    boundary may round the other way in another sum order. One p code
    moves a head's context row by at most ``ap * av * |vq| / l <= av``
    (``ap = 1/127``, ``|vq| <= 127``, ``l >= 1``), and the output by that
    through ``wout``: at most ``av`` times the largest column sum of
    ``|wout|`` over the head's rows, for the worst head. x is (B, SP, D)."""
    d = x.shape[-1]
    hd = d // num_heads
    f = [t.float() for t in (x, g1, be1, wqkv, bqkv, wout)]
    v = reference.matmul(reference.layernorm(f[0].reshape(-1, d), f[1], f[2],
                                             eps=eps), f[3], f[4])[:, 2 * d:]
    return max(float(v[:, h * hd:(h + 1) * hd].abs().max()) / 127
               * float(f[5][h * hd:(h + 1) * hd].abs().sum(0).max())
               for h in range(num_heads))


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def core_smem_bytes(sp: int, head_dim: int, itemsize: int,
                    mode: str = "full") -> int:
    """Shared memory of one K23 core tile in ``mode``: K4's (K and V rows),
    kt's (K's feature-major slab beside V's rows), the head-major modes'
    (K's and V's slabs, and in bf16 q's) or qcore's. In fp32
    ``csrc/attention_tf32.cuh:attn_tf32_probe_smem`` (K and V fp32, rows
    of ceil8(S) keys and dh' + 4 floats, slabs of ceil16(S) + 8; qcore's 8
    floats more for its scales), in bf16 ``csrc/attention_mma.cuh:
    attn_mma_probe_smem`` (qcore's K and V, then their int8 codes)."""
    from vit_tpu_torch.ops.cuda.block import attention_mma_smem_bytes
    if itemsize != 2:
        kr, dhp, ldsl = _ceil(sp, 8), _ceil(head_dim, 8), _ceil(sp, 16) + 8
        floats = {"kt": dhp * ldsl + kr * (dhp + 4),
                  "tcore": 2 * dhp * ldsl, "xcore": 2 * dhp * ldsl,
                  "qcore": 2 * kr * (dhp + 4) + 8}.get(
                      mode, 2 * kr * (dhp + 4))
        return floats * 4
    kr, dhp = _ceil(sp, 16), _ceil(head_dim, 16)
    if mode == "kt":
        return (dhp * (kr + 8) + kr * (dhp + 8)) * 2
    if mode in ("tcore", "xcore"):
        return (2 * dhp * (kr + 8) + dhp * (64 + 8)) * 2
    if mode == "qcore":
        kr, dhq = _ceil(sp, 32), _ceil(head_dim, 32)
        return (2 * kr * (dhp + 8) * 2 + kr * (dhq + 16) + dhq * (kr + 16)
                + 8 * 4)
    return attention_mma_smem_bytes(sp, head_dim)


def gemm_tile(m: int, n: int, k: int, dtype: torch.dtype,
              ptrs: tuple[int, int]) -> str:
    """The tile a K23 GEMM ``(m, k) @ (k, n)`` of contiguous operands runs
    on, from shape and alignment alone (``ptrs`` the bases, bytes): K2's
    rule (:func:`vit_tpu_torch.ops.cuda.matmul.gemm_path`), where TMA reads
    both operands ``"wgmma"`` in bf16 and ``"tf32"`` (K2's tf32 walk) in
    fp32, else ``"wmma"`` in bf16 and ``"ffma"`` in fp32.
    ``csrc/attn_core_probe.cu:vit_attn_probe_gemm_tile`` applies the same
    rule."""
    from vit_tpu_torch.ops.cuda.matmul import gemm_path
    path = gemm_path(m, n, k, dtype, False, False, ptrs, ((k, 1), (n, 1)))
    if dtype == torch.float32:
        return "tf32" if path == "wgmma" else "ffma"
    return path


def core_launch(mode: str, qkv, tbuf, out, *, b, sp, d, heads, seq_len,
                scale):
    """One K23 core launch in ``mode`` into ``out`` (B*S, D), or (D, B*S)
    head-major: ``qkv`` the packed (B*S, 3D) buffer (None head-major),
    ``tbuf`` kT (D, B*S) for kt or [qT|kT|vT] (3D, B*S) head-major."""
    from vit_tpu_torch.ops.cuda import _build, count_launch
    from vit_tpu_torch.ops.cuda.block import MAX_SMEM

    like = qkv if qkv is not None else tbuf
    work_heads = heads // 2 if mode == "wide" else heads
    hd = d // work_heads
    if (like.dtype == torch.bfloat16 and mode in ("qcore", "tcore", "xcore")
            and hd > MMA_MAX_HEAD):
        raise ValueError(f"{mode}: the bf16 core holds q's {hd} columns "
                         f"whole; at most {MMA_MAX_HEAD}")
    smem = core_smem_bytes(sp, hd, like.element_size(), mode)
    if smem > MAX_SMEM:
        raise ValueError(f"{mode}: a core tile needs {smem} B of shared "
                         f"memory at {sp} tokens, head width "
                         f"{d // work_heads}, {like.dtype}; more than "
                         f"{MAX_SMEM}: run it at a shorter length")
    _build.launch("vit_attn_probe_core", qkv, tbuf, out, b, sp, d,
                  work_heads, seq_len, b * sp, float(scale), MODES[mode],
                  like=like)
    count_launch("attn_core_probe")
    return out


def _gemm(x, w, bias, ep: int, *, out_shape, res=None, alt=None, d: int):
    """One probe GEMM launch: x (m, k) @ w (k, n) with epilogue ``ep``."""
    from vit_tpu_torch.ops.cuda import _build, count_launch

    (m, k), n = x.shape, w.shape[1]
    for t, name in ((x, "x"), (w, "w"), (bias, "bias")):
        _build.check_tensor(t, name, x)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    _build.launch("vit_attn_probe_gemm", x, w, bias, res, out, alt, m, n, k,
                  d, ep, like=x)
    count_launch("attn_core_probe")
    return out


def probe(mode: str, x, g1, be1, wqkv, bqkv, wout, bout, *, num_heads: int,
          seq_len: int, group: int = 1, shape=None, eps: float = 1e-12,
          weights_t=None, impl: str | None = None,
          launch_core=None) -> torch.Tensor:
    """The block in ``mode``: on CUDA tensors through the kernels (K1, K2
    and K23, :func:`launches`), on CPU tensors :func:`probe_plain`. x is
    (B, SP, D), or (D, B*SP) for xcore. ``weights_t`` = ``(wqkv.T, wout.T)``
    contiguous, for tcore and xcore (made here if not given: the JAX probe
    transposes them on the host). ``launch_core`` stands in for
    :func:`core_launch` (:func:`core_only` records the core's inputs
    through it)."""
    b, sp, d = shape if shape is not None else x.shape
    if resolve_impl(impl, x) == "torch":
        return probe_plain(mode, x, g1, be1, wqkv, bqkv, wout, bout,
                           num_heads=num_heads, seq_len=seq_len, group=group,
                           shape=(b, sp, d), eps=eps)
    from vit_tpu_torch.ops.cuda import _build, count_launch
    from vit_tpu_torch.ops.cuda.layernorm import layernorm
    from vit_tpu_torch.ops.cuda.matmul import matmul

    launch_core = launch_core or core_launch

    _check(mode, x, b=b, sp=sp, d=d, num_heads=num_heads, seq_len=seq_len,
           group=group)
    _build.check_tensor(x, "x", x)
    for t, name, sh in ((g1, "g1", (d,)), (be1, "be1", (d,)),
                        (wqkv, "wqkv", (d, 3 * d)), (bqkv, "bqkv", (3 * d,)),
                        (wout, "wout", (d, d)), (bout, "bout", (d,))):
        _build.check_tensor(t, name, x, sh)
    m, scale = b * sp, (d // num_heads) ** -0.5
    core = dict(b=b, sp=sp, d=d, heads=num_heads, seq_len=seq_len,
                scale=scale)
    kw = dict(dtype=x.dtype, device=x.device)
    if mode in ("tcore", "xcore"):
        wqkv_t, wout_t = weights_t if weights_t is not None else (
            wqkv.t().contiguous(), wout.t().contiguous())
        _build.check_tensor(wqkv_t, "wqkv.T", x, (3 * d, d))
        _build.check_tensor(wout_t, "wout.T", x, (d, d))
        if mode == "xcore":
            xn_t = torch.empty((d, m), **kw)
            _build.launch("vit_attn_probe_colln", x, g1, be1, xn_t, d, m,
                          float(eps), like=x)
            count_launch("attn_core_probe")
            qkv_t = _gemm(wqkv_t, xn_t, bqkv, EP_ROW_BIAS,
                          out_shape=(3 * d, m), d=d)
        else:
            xf = x.reshape(m, d)
            qkv_t = _gemm(layernorm(xf, g1, be1, eps=eps), wqkv, bqkv,
                          EP_ALL_T, out_shape=(3 * d, m), d=d)
        ctx_t = launch_core(mode, None, qkv_t, torch.empty((d, m), **kw),
                            **core)
        if mode == "xcore":
            return _gemm(wout_t, ctx_t, bout, EP_OUT_X, out_shape=(d, m),
                         res=x, d=d)
        return _gemm(wout_t, ctx_t, bout, EP_OUT_T, out_shape=(m, d),
                     res=xf, d=d).reshape(b, sp, d)
    xf = x.reshape(m, d)
    xn = layernorm(xf, g1, be1, eps=eps)
    if mode == "projonly":
        ctx = torch.empty((m, d), **kw)
        _gemm(xn, wqkv, bqkv, EP_SPLIT_Q, out_shape=(m, 3 * d), alt=ctx, d=d)
    elif mode == "kt":
        k_t = torch.empty((d, m), **kw)
        qkv = _gemm(xn, wqkv, bqkv, EP_SPLIT_KT, out_shape=(m, 3 * d),
                    alt=k_t, d=d)
        ctx = launch_core(mode, qkv, k_t, torch.empty((m, d), **kw),
                          **core)
    else:
        qkv = matmul(xn, wqkv, bqkv)
        ctx = launch_core(mode, qkv, None, torch.empty((m, d), **kw),
                          **core)
    return matmul(ctx, wout, bout, residual=xf).reshape(b, sp, d)


def core_only(mode: str, x, *weights, **kw):
    """A call of the K23 core launch alone, ``fn() -> ctx``, on the inputs
    the block in ``mode`` gives it (the block runs once here to make them);
    None for projonly, which launches no core. ``weights`` and ``kw`` are
    :func:`probe`'s."""
    from functools import partial

    got = {}

    def record(*args, **kwargs):
        got["call"] = partial(core_launch, *args, **kwargs)
        return got["call"]()
    probe(mode, x, *weights, launch_core=record, **kw)
    return got.get("call")


def run(modes=DEFAULT_MODES, *, batch: int = 32, sp: int = 208,
        seq_len: int = 197, d: int = 768, heads: int = 12, group: int = 4,
        dtype: torch.dtype = torch.bfloat16, device: str = "cuda",
        warmup: int = 5, reps: int = 20) -> dict:
    """The block in each of ``modes`` on the JAX probe's inputs; on the
    card each is timed ROUNDS times, the modes in turn within a round (the
    block's event ms, its nominal-FLOP rate and its pipelined ms; the core
    launch alone by events and pipelined, and its device ms from the
    profiler), and each number is the median over the rounds. Returns what
    :func:`main` prints."""
    from vit_tpu_torch.utils.profiling import launch_ms
    from vit_tpu_torch.utils.timing import do_bench, pipelined_ms

    require_device(device)
    on_card = device.startswith("cuda")
    inputs = make_inputs(batch, sp, d, seq_len, dtype, device)
    x, weights = inputs[0], inputs[1:]
    weights_t = (weights[2].t().contiguous(), weights[4].t().contiguous())
    xt = x.reshape(batch * sp, d).t().contiguous()
    tflop = nominal_flops(batch, sp, d) / 1e12
    kw = dict(num_heads=heads, seq_len=seq_len, group=group,
              shape=(batch, sp, d), weights_t=weights_t)
    blocks = {}
    for mode in modes:
        xin = xt if mode == "xcore" else x

        def block(mode=mode, xin=xin):
            return probe(mode, xin, *weights, **kw)
        if not bool(torch.isfinite(block().float()).all()):
            raise RuntimeError(f"{mode}: non-finite output")
        if not on_card:
            print(f"{mode:10s} ran on the CPU (plain version)", flush=True)
            continue
        blocks[mode] = (block, core_only(mode, xin, *weights, **kw))
    samples = {mode: [] for mode in blocks}
    for _ in range(ROUNDS):
        for mode, (block, core) in blocks.items():
            samples[mode].append((
                do_bench(block, warmup=warmup, reps=reps)[0],
                pipelined_ms(block, warmup=warmup, reps=reps),
                *((do_bench(core, warmup=warmup, reps=reps)[0],
                   pipelined_ms(core, warmup=warmup, reps=reps),
                   launch_ms(block, "attn_probe_kernel"))
                  if core is not None else (None, None, None))))
    rows = {}
    for mode, got in samples.items():
        ms, pipe, core_ms, core_pipe, core_dev = (
            float(np.median(kept)) if kept else None
            for kept in ([t for t in v if t is not None]
                         for v in zip(*got)))
        rows[mode] = {"ms": ms, "tflops": tflop / (ms / 1e3),
                      "pipelined_ms": pipe, "core_ms": core_ms,
                      "core_pipelined_ms": core_pipe,
                      "core_device_ms": core_dev,
                      "core_pipelined_ms_rounds": [g[3] for g in got]}
        shown = ("no core launch" if core_ms is None else
                 f"{core_ms:.4f} (pipelined {core_pipe:.4f}, profiler "
                 + ("none kept" if core_dev is None else f"{core_dev:.4f}")
                 + ")")
        print(f"{mode:10s} {ms:.4f} ms (pipelined {pipe:.4f})  "
              f"{tflop / (ms / 1e3):6.1f} TF/s (nominal-FLOP rate)   core "
              f"ms {shown}", flush=True)
    return {"modes": rows, "shape": [batch, sp, d], "rounds": ROUNDS,
            "dtype": str(dtype).replace("torch.", ""), "device": device,
            "card": card_line() if on_card else None}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--sp", type=int, default=208)
    ap.add_argument("--seq-len", type=int, default=197)
    ap.add_argument("-D", type=int, default=768)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--group", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--modes", nargs="+", default=list(DEFAULT_MODES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (the plain "
                         "versions, not timed)")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.modes, batch=args.batch, sp=args.sp,
                         seq_len=args.seq_len, d=args.D, heads=args.heads,
                         group=args.group, dtype=getattr(torch, args.dtype),
                         device=args.device, warmup=args.warmup,
                         reps=args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
