"""The tile algorithms of the two bf16 attention kernels on the tensor
cores, written out in plain torch and held to the JAX package.

CUDA kernels do not run here, so each kernel's walk over its tiles is
modelled in this file (not in the package) with the kernel's rounding
points, and held to the JAX function its plain version is held to:

- K4's core (``csrc/attention_mma.cuh``): the head width and the keys
  zero-padded to multiples of 16, two passes over 64-key chunks (the row
  max, then ``p = exp(s - max)``, ``l`` of the unrounded p and ``(p in
  dtype) @ v``), the context divided by ``l`` once; against
  ``vit_tpu.ops.reference.attention``, as ``tests/test_torch_ops.py``
  holds ``reference.attention_core``.
- K13 (``csrc/flash_attention_bwd.cu``): launch (a)'s pass 1 runs m and l
  online over 64-key tiles and accumulates ``o = sum exp(s - m) v`` with p
  split into two dtype parts, then ``delta = g . o / l``; its pass 2 forms
  ds and dq; launch (b) walks every query tile of a key tile for dk and
  dv. Against ``jax.vjp`` of ``vit_tpu/ops/pallas/vjp.py:attention`` in
  interpret mode (the Pallas kernel ``_flash_bwd_group_kernel``), as
  ``tests/test_torch_train.py`` runs it.

The lengths end inside a 16-key fragment and inside a 64-key chunk, and
the head widths are 16 and 80 (80 is five fragments: not a power of two).

Bars: fp32 max|diff| <= 1e-5 (K13: 1e-5 + 1e-5 |ref|): the models differ
from JAX by sum order only, K13's also by its online softmax and by delta
taken as g . o / l, equal to ``rowsum(dp * p)`` in exact arithmetic.
bf16 |diff| <= 2e-2 * (1 + |ref|), the kernel bar of ``test_torch_ops.py``
(about two bf16 ulps): JAX rounds the normalised p to bf16 where K4 rounds
the unnormalised one, and one rounding of p or ds may flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops import reference as jax_ref
from vit_tpu.ops.pallas import vjp as jax_vjp

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CHUNK = 64  # keys a chunk (K4) or a tile (K13)
GEOMETRIES = [(80, 71), (48, 40)]  # (S, seq_len): in a fragment, a chunk


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(got: torch.Tensor, want, dtype: str, rtol: float = 0.0) -> None:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert (diff <= 1e-5 + rtol * np.abs(want)).all(), diff.max()
    else:
        assert (diff <= 2e-2 * (1 + np.abs(want))).all(), diff.max()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


# ------------------------------------------------------------------ K4 --

def k4_tiles(q, k, v, *, scale: float, seq_len: int) -> torch.Tensor:
    """K4's bf16 core on (B, H, S, d) q, k, v as ``attention_tile_mma``
    walks them: keys past ``seq_len`` masked, the keys (zero rows) and head
    width (zero columns) padded to multiples of 16, two passes over 64-key
    chunks. Returns the context in q's dtype."""
    dt = q.dtype
    d, kend = q.shape[-1], _ceil16(seq_len)
    pad_d = _ceil16(d) - d
    qp = _f32(torch.nn.functional.pad(q, (0, pad_d)))
    kp, vp = (_f32(torch.nn.functional.pad(t[:, :, :seq_len],
                                           (0, pad_d, 0, kend - seq_len)))
              for t in (k, v))

    def scores(k0):
        kc = kp[:, :, k0:k0 + CHUNK]
        s = (qp @ kc.transpose(-1, -2)) * scale
        keep = torch.arange(k0, k0 + kc.shape[2]) < seq_len
        return s.masked_fill(~keep, float("-inf"))

    mx = torch.full(q.shape[:3] + (1,), float("-inf"))
    for k0 in range(0, kend, CHUNK):
        mx = torch.maximum(mx, scores(k0).amax(-1, keepdim=True))
    l = torch.zeros_like(mx)
    ctx = torch.zeros(q.shape[:3] + (qp.shape[-1],))
    for k0 in range(0, kend, CHUNK):
        p = torch.exp(scores(k0) - mx)
        l = l + p.sum(-1, keepdim=True)
        ctx = ctx + _f32(p.to(dt)) @ vp[:, :, k0:k0 + CHUNK]
    return (ctx / l)[..., :d].to(dt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd", [16, 80])
@pytest.mark.parametrize("s,seq_len", GEOMETRIES)
def test_k4_tiles_match_jax_attention(dtype, hd, s, seq_len):
    rng = np.random.default_rng(10 + hd + s)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal((2, 3, s, hd)), dtype) for _ in range(3))
    got = k4_tiles(tq, tk, tv, scale=hd ** -0.5, seq_len=seq_len)
    want = jax_ref.attention(jq, jk, jv, scale=hd ** -0.5, seq_len=seq_len)
    _close(got, want, dtype)


def _running_max_tiles(q, k, v, *, scale: float, seq_len: int):
    """The same 64-key chunks with an online softmax (K7's rounding point):
    p rounded relative to the running max, the context rescaled."""
    dt = q.dtype
    qf, kf, vf = (_f32(t) for t in (q, k, v))
    m = torch.full(q.shape[:3] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    ctx = torch.zeros(qf.shape)
    for k0 in range(0, seq_len, CHUNK):
        kc, vc = kf[:, :, k0:k0 + CHUNK], vf[:, :, k0:k0 + CHUNK]
        s = (qf @ kc.transpose(-1, -2)) * scale
        keep = torch.arange(k0, k0 + kc.shape[2]) < seq_len
        s = s.masked_fill(~keep, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        ctx = ctx * alpha + _f32(p.to(dt)) @ vc
        m = m_new
    return (ctx / l).to(dt)


def test_k4_tiles_round_p_relative_to_the_row_max():
    """Two passes round p relative to the final row max, as the plain core
    (``reference.attention_core``, K4's yardstick on the card) does. On
    scores that rise along the keys, so that a running max moves at every
    chunk, the model's bf16 context equals the plain core's in at least
    99% of its elements (fp32 sum orders may flip a rounding), a
    running-max walk of the same chunks in under 95% (83% at this seed)."""
    from vit_tpu_torch.ops import reference

    rng = np.random.default_rng(7)
    s, hd, seq_len, heads = 150, 16, 141, 2
    q, k, v = (torch.from_numpy(rng.standard_normal((1, heads, s, hd)))
               .float() for _ in range(3))
    k = k + torch.linspace(0, 3, s)[:, None]  # later keys score higher
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    qkv = torch.stack([q, k, v], 2).permute(0, 3, 2, 1, 4).reshape(
        s, 3 * heads * hd)
    want = reference.attention_core(qkv, batch=1, num_heads=heads,
                                    scale=hd ** -0.5, seq_len=seq_len)
    want = want.reshape(1, s, heads, hd).transpose(1, 2)
    kw = dict(scale=hd ** -0.5, seq_len=seq_len)
    same = (k4_tiles(q, k, v, **kw) == want).float().mean()
    online = (_running_max_tiles(q, k, v, **kw) == want).float().mean()
    assert same >= 0.99 and online < 0.95, (same, online)


# ----------------------------------------------------------------- K13 --

def k13_stats(q, k, v, g, *, scale: float, seq_len: int):
    """Launch (a)'s pass 1 over the (B, H, S, d) operands: m and l online
    over 64-key tiles, o = sum exp(s - m) v with p split into two parts
    of the operands' dtype (exact in fp32), and delta = g . o / l. Returns
    (m, l, delta), each (B, H, S, 1) fp32."""
    dt = q.dtype
    qf, kf, vf, gf = (_f32(t) for t in (q, k, v, g))
    m = torch.full(q.shape[:3] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(qf.shape)
    for k0 in range(0, seq_len, CHUNK):
        kc, vc = kf[:, :, k0:k0 + CHUNK], vf[:, :, k0:k0 + CHUNK]
        s = (qf @ kc.transpose(-1, -2)) * scale
        keep = torch.arange(k0, k0 + kc.shape[2]) < seq_len
        s = s.masked_fill(~keep, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = _f32(p.to(dt))
        lo = _f32((p - hi).to(dt))
        o = o * alpha + hi @ vc + lo @ vc
        m = m_new
    delta = (gf * o).sum(-1, keepdim=True) / l
    return m, l, delta


def k13_tiles(q, k, v, g, *, scale: float, seq_len: int) -> torch.Tensor:
    """K13's two launches on (B, H, S, d) operands: the stats pass, then
    dq over the key tiles (query-major) and dk, dv over the query tiles of
    each key tile (key-major). Returns the packed (B, S, 3, H, d) buffer
    ``[dq | dk | dv]`` in q's dtype, as ``reference.flash_attention_bwd``
    does."""
    dt = q.dtype
    s_len = q.shape[2]
    m, l, delta = k13_stats(q, k, v, g, scale=scale, seq_len=seq_len)
    qf, kf, vf, gf = (_f32(t) for t in (q, k, v, g))

    def tile(q0, k0):
        """p and ds of query rows [q0, q0+64) against keys [k0, k0+64)."""
        qs, gs = qf[:, :, q0:q0 + CHUNK], gf[:, :, q0:q0 + CHUNK]
        kc, vc = kf[:, :, k0:k0 + CHUNK], vf[:, :, k0:k0 + CHUNK]
        rows = slice(q0, q0 + CHUNK)
        s = _f32(qs @ kc.transpose(-1, -2)) * scale
        keep = torch.arange(k0, k0 + kc.shape[2]) < seq_len
        p = torch.where(keep, torch.exp(s - m[:, :, rows]) / l[:, :, rows],
                        torch.zeros(()))
        dp = gs @ vc.transpose(-1, -2)
        return p, p * (dp - delta[:, :, rows])

    dq = torch.zeros(qf.shape)
    for q0 in range(0, s_len, CHUNK):
        for k0 in range(0, seq_len, CHUNK):
            _, ds = tile(q0, k0)
            dq[:, :, q0:q0 + CHUNK] += _f32(ds.to(dt)) @ kf[:, :, k0:k0 + CHUNK]
    dk, dv = torch.zeros(qf.shape), torch.zeros(qf.shape)
    for k0 in range(0, seq_len, CHUNK):
        for q0 in range(0, s_len, CHUNK):
            p, ds = tile(q0, k0)
            rows = slice(q0, q0 + CHUNK)
            dv[:, :, k0:k0 + CHUNK] += _f32(p.to(dt)).transpose(-1, -2) @ \
                gf[:, :, rows]
            dk[:, :, k0:k0 + CHUNK] += _f32(ds.to(dt)).transpose(-1, -2) @ \
                qf[:, :, rows]
    out = (dq * scale, dk * scale, dv)
    return torch.stack([t.to(dt).transpose(1, 2) for t in out], 2)


def _bwd_inputs(rng, s, hd, dtype):
    return [_pair(rng.standard_normal((1, 2, s, hd)), dtype)
            for _ in range(4)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd", [16, 80])
@pytest.mark.parametrize("s,seq_len", GEOMETRIES)
def test_k13_tiles_match_pallas_backward(dtype, hd, s, seq_len):
    from vit_tpu_torch.ops import reference

    rng = np.random.default_rng(20 + hd + s)
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = _bwd_inputs(rng, s, hd, dtype)
    _, vjp_fn = jax.vjp(
        lambda *a: jax_vjp.attention(*a, None, seq_len, True), jq, jk, jv)
    want = vjp_fn(jg)
    got = k13_tiles(tq, tk, tv, tg, scale=hd ** -0.5, seq_len=seq_len)
    assert got.shape == (1, s, 3, 2, hd) and got.dtype == tq.dtype
    for gt, w in zip(reference.split_qkv(got), want):
        _close(gt, w, dtype, rtol=1e-5)
    _, dk, dv = reference.split_qkv(got)
    assert not dk[:, :, seq_len:].any() and not dv[:, :, seq_len:].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,seq_len", GEOMETRIES)
def test_k13_delta_is_rowsum_dp_p(dtype, s, seq_len):
    """delta = g . o / l from the online pass against JAX's rowsum(dp * p)
    over the whole row, both from the same (dtype-rounded) operands in
    float64: within 1e-5 relative to sum |dp * p| (fp32 sum orders and, in
    bf16, the lo part's rounding, about 2^-17 of p)."""
    rng = np.random.default_rng(30 + s)
    hd = 16
    q, k, v, g = (t for _, t in _bwd_inputs(rng, s, hd, dtype))
    _, _, delta = k13_stats(q, k, v, g, scale=hd ** -0.5, seq_len=seq_len)
    q64, k64, v64, g64 = (t.to(torch.float64) for t in (q, k, v, g))
    sc = (q64 @ k64.transpose(-1, -2)) * hd ** -0.5
    sc[..., seq_len:] = float("-inf")
    p = torch.softmax(sc, -1)
    dp = g64 @ v64.transpose(-1, -2)
    want = (dp * p).sum(-1, keepdim=True)
    scale = (dp * p).abs().sum(-1, keepdim=True)
    assert ((delta.double() - want).abs() <= 1e-5 * scale).all()


def test_k4_bf16_tile_takes_every_geometry_the_gate_admits():
    """``ops.attn_plan`` still sizes the FFMA tile (K, V, q and the fp32
    score rows); the bf16 tile on the tensor cores (K and V only, rows
    rounded up to 16 keys and 16 + 8 columns) fits in shared memory at
    every (S, head width) the gate admits in bf16, so no route moves."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda.block import (MAX_SMEM,
                                              attention_mma_smem_bytes)

    admitted = 0
    for hd in list(range(1, 257)) + [384, 385, 512, 1024, 1757]:
        for s in range(1, 1200):
            if not ops.attn_plan(1, s, hd, 1, torch.bfloat16):
                break  # the FFMA tile grows with S
            admitted += 1
            assert attention_mma_smem_bytes(s, hd) <= MAX_SMEM, (s, hd)
    assert admitted > 80000  # the loop met the gate
