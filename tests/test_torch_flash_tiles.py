"""The tile walks of K7's and K16's bf16 kernels on the tensor cores,
written out in plain torch and held to the JAX package.

CUDA kernels do not run here, so each kernel's walk is modelled in this
file (not in the package) with the kernel's rounding points, and held to
the JAX function its plain version stands for, run in interpret mode:

- K7 (``csrc/flash_attention.cu``, bf16 on ``mma.sync``): 64-key tiles up
  to the last that holds a real key; per tile ``s = (q . k) * scale`` in
  fp32 with keys >= ``seq_len`` at -inf, the running max ``m' = max(m,
  rowmax(s))``, ``alpha = exp(m - m')``, ``p = exp(s - m')``, ``l`` the
  sum of the unrounded p, ``acc = acc * alpha + (p in dtype) @ v``; one
  division and one cast at the end. Against
  ``vit_tpu/ops/pallas/attention.py:flash_attention``: its online kernel
  (``_flash_kernel``, the same recurrence) with ``block_q = block_k = 64``
  and ``force_online=True`` at a padded length above 768, the only regime
  in which JAX runs it; and its single-tile kernels (p relative to the row
  max) at 208 and 197 tokens.
- K16 (``csrc/matmul3.cu``, bf16 on ``mma.sync``): K in 16-deep slices in
  order, zeros past a ragged K, fp32 sums, ``acc * scale`` and one cast.
  Against ``vit_tpu/ops/pallas/matmul3.py:matmul3``.

Bars: fp32 max|diff| <= 1e-5 (sum order only). bf16: the kernel bar of
``tests/test_torch_ops.py``, |diff| <= 2e-2 * (1 + |ref|), where the
rounding points differ (K7 against the single-tile regime, which rounds p
relative to the row max); where they are the same (K7 against the online
kernel, K16 against ``matmul3``) at least 99.5% of the elements equal
bit for bit and every one within an ulp, |diff| <= 2^-7 |ref| + 1e-5: an
fp32 sum order may flip a rounding of the result, or of a p, which moves
an output whose terms cancel by a few of its own ulps (2 ulps at |ref| =
7e-4 in the online case here, 6 of its 25,120 elements differing).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops.pallas.attention import flash_attention as jax_flash
from vit_tpu.ops.pallas.matmul3 import matmul3 as jax_matmul3

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TILE = 64  # K7's keys a tile; K16's tile and K step
CSRC = Path(__file__).resolve().parents[1] / "vit_tpu_torch" / "csrc"


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype: str, *, same_rounding: bool) -> float:
    """Assert the file's bar; returns max|diff|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-5, diff.max()
    elif same_rounding:
        assert (diff <= 2.0 ** -7 * np.abs(want) + 1e-5).all(), diff.max()
        assert (diff == 0).mean() >= 0.995, (diff == 0).mean()
    else:
        assert (diff <= 2e-2 * (1 + np.abs(want))).all(), diff.max()
    return float(diff.max())


# ------------------------------------------------------------------ K7 --

def k7_tiles(q, k, v, *, scale: float, seq_len: int,
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K7's bf16 (or fp32) walk on (B, H, S, d) q, k, v: the key tiles
    that hold a real key, an online softmax over them with p relative to
    the running max. (The kernel also skips the products of 16-key groups
    past ``seq_len`` in the last tile; their p is 0, so nothing moves.)"""
    dt = q.dtype
    qf, kf, vf = (t.float() for t in (q, k, v))
    m = torch.full(q.shape[:3] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape)
    for k0 in range(0, seq_len, TILE):
        kc, vc = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        s = (qf @ kc.transpose(-1, -2)) * scale
        keep = torch.arange(k0, k0 + kc.shape[2]) < seq_len
        s = s.masked_fill(~keep, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        # A row whose keys so far are all masked subtracts 0: p = alpha = 0.
        base = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(s - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(dt).float() @ vc
        m = m_new
    return (acc / l).to(out_dtype or dt)


def _row_max_tiles(q, k, v, *, scale: float, seq_len: int) -> torch.Tensor:
    """The same tiles with p relative to the row max (the single-tile
    regimes' rounding point): two walks, the max first."""
    dt = q.dtype
    qf, kf, vf = (t.float() for t in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * scale
    s = s.masked_fill(~(torch.arange(k.shape[2]) < seq_len), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    return ((p.to(dt).float() @ vf) / l).to(dt)


def _qkv(rng, b, h, s, hd, dtype):
    return [_pair(rng.standard_normal((b, h, s, hd)), dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k7_tiles_match_jax_online_kernel(dtype):
    """785 tokens (800 padded, over JAX's 768-row single-tile limit), 777
    real, b*h = 2, d = 16: 13 key tiles, the last holding 9 real keys; the
    model and JAX's ``_flash_kernel`` share every rounding point."""
    rng = np.random.default_rng(3)
    s, seq_len, hd = 785, 777, 16
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 2, s, hd, dtype)
    got = k7_tiles(tq, tk, tv, scale=hd ** -0.5, seq_len=seq_len)
    want = jax_flash(jq, jk, jv, scale=hd ** -0.5, seq_len=seq_len,
                     block_q=TILE, block_k=TILE, force_online=True,
                     interpret=True)
    _close(got, want, dtype, same_rounding=True)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd", [16, 80])
@pytest.mark.parametrize("s,seq_len", [(208, 197), (197, 197)])
def test_k7_tiles_match_jax_single_tile(dtype, hd, s, seq_len):
    """B/16's 208 padded tokens (197 real: the last tile holds 5 real keys,
    one 16-key group of four) and 197 unpadded, against the single-tile
    kernels (p relative to the row max): fp32 within sum order, bf16
    within the kernel bar."""
    rng = np.random.default_rng(11 + hd + s)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 1, s, hd, dtype)
    got = k7_tiles(tq, tk, tv, scale=hd ** -0.5, seq_len=seq_len)
    want = jax_flash(jq, jk, jv, scale=hd ** -0.5, seq_len=seq_len,
                     interpret=True)
    _close(got[:, :, :seq_len], want[:, :, :seq_len], dtype,
           same_rounding=False)


def test_k7_tiles_round_p_relative_to_the_running_max():
    """On keys whose scores rise along the sequence, so that the running
    max moves at every tile, the model's bf16 context equals JAX's online
    kernel in at least 99% of its elements (fp32 sum orders may flip a
    rounding), a walk with p relative to the row max in under 95%: the
    model keeps the running max's rounding point."""
    rng = np.random.default_rng(7)
    s, seq_len, hd = 785, 780, 16
    q, k, v = (rng.standard_normal((1, 2, s, hd)).astype(np.float32)
               for _ in range(3))
    k = k + np.linspace(0, 3, s, dtype=np.float32)[:, None]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(t, "bfloat16") for t in (q, k, v))
    kw = dict(scale=hd ** -0.5, seq_len=seq_len)
    want = torch.from_numpy(_np(jax_flash(
        jq, jk, jv, block_q=TILE, block_k=TILE, force_online=True,
        interpret=True, **kw))).to(torch.bfloat16)
    same = (k7_tiles(tq, tk, tv, **kw) == want).float().mean()
    row_max = (_row_max_tiles(tq, tk, tv, **kw) == want).float().mean()
    assert same >= 0.99 and row_max < 0.95, (same, row_max)


def test_k7_tiles_fp32_output_rounds_once():
    """The int8 tier's fp32 context of bf16 inputs is the same walk cast
    to fp32: its bf16 rounding is the bf16 output."""
    rng = np.random.default_rng(5)
    (_, tq), (_, tk), (_, tv) = _qkv(rng, 1, 2, 150, 32, "bfloat16")
    kw = dict(scale=32 ** -0.5, seq_len=141)
    f32 = k7_tiles(tq, tk, tv, out_dtype=torch.float32, **kw)
    assert f32.dtype == torch.float32
    assert torch.equal(f32.to(torch.bfloat16), k7_tiles(tq, tk, tv, **kw))


# ----------------------------------------------------------------- K16 --

def k16_tiles(x, y, *, scale: float | None = None) -> torch.Tensor:
    """K16's bf16 walk of ``(B, M, K) @ (B, K, N)``: 64-deep K steps of
    k16 slices, in order, summed in fp32 (zeros past a ragged K), then
    ``acc * scale`` and one cast."""
    xf, yf = x.float(), y.float()
    kk = -(-x.shape[2] // 16) * 16
    xf = torch.nn.functional.pad(xf, (0, kk - x.shape[2]))
    yf = torch.nn.functional.pad(yf, (0, 0, 0, kk - x.shape[2]))
    acc = torch.zeros(x.shape[0], x.shape[1], y.shape[2])
    for k0 in range(0, kk, TILE):
        for k1 in range(k0, min(k0 + TILE, kk), 16):
            acc = acc + xf[:, :, k1:k1 + 16] @ yf[:, k1:k1 + 16]
    if scale is not None:
        acc = acc * scale
    return acc.to(x.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,m,k,n,scale", [
    (3, 37, 16, 37, 0.125),   # the scores' shape: K one k16 slice
    (3, 37, 37, 16, None),    # the context's: ragged K, N one fragment pair
    (2, 70, 130, 66, 0.5),    # three K steps, the last ragged; two N tiles
    (1, 1, 5, 1, None)])      # K < 16
def test_k16_tiles_match_jax_matmul3(dtype, b, m, k, n, scale):
    rng = np.random.default_rng(b * 1000 + m + k + n)
    jx, tx = _pair(rng.standard_normal((b, m, k)), dtype)
    jy, ty = _pair(rng.standard_normal((b, k, n)) * 0.3, dtype)
    got = k16_tiles(tx, ty, scale=scale)
    want = jax_matmul3(jx, jy, scale=scale, interpret=True)
    _close(got, want, dtype, same_rounding=True)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k16_tiles_match_the_plain_version_at_197_tokens(dtype):
    """At the unfused attention's 197 tokens (rows only 2-byte aligned on
    the card), the walk agrees with ``reference.matmul3``, the plain
    version the kernel is held to on the card, for the scores (scaled)
    and the context (no scale)."""
    from vit_tpu_torch.ops import reference

    rng = np.random.default_rng(197)
    _, q = _pair(rng.standard_normal((2, 197, 64)), dtype)
    _, kt = _pair(rng.standard_normal((2, 64, 197)), dtype)
    _, p = _pair(rng.dirichlet(np.ones(197), (2, 197)), dtype)
    _, v = _pair(rng.standard_normal((2, 197, 64)), dtype)
    _close(k16_tiles(q, kt, scale=0.125),
           reference.matmul3(q, kt, scale=0.125), dtype, same_rounding=True)
    _close(k16_tiles(p, v), reference.matmul3(p, v), dtype,
           same_rounding=True)


# -------------------------------------------------------- shared memory --

def test_new_tiles_fit_shared_memory_at_every_admitted_width():
    """K7's bf16 tile (a ring of three [k | v] buffers of 64-row tiles with
    rows of hd + 8, the query tile staged once in the last) and its fp32
    tiles on the tensor cores (``mma.sync``: the query tile and two [k |
    v] buffers, rows of hd + 4 floats; ``wgmma`` at d = 32 and 64: two
    query tiles and four 64 x hd split operand boxes past 1 KB of
    alignment) fit a block's 227 KB at every head width the wrapper
    admits; K16's bf16 tile (two buffers of the 64 x 64 x and y tiles,
    rows of 72) is static shared memory, under 48 KB. The sizes are the
    kernels' own (``csrc/flash_attention.cu``,
    ``csrc/flash_attention_tf32.cu``, ``csrc/matmul3.cu``)."""
    from vit_tpu_torch.ops.cuda.attention import MAX_HEAD_DIM
    from vit_tpu_torch.ops.cuda.block import MAX_SMEM

    fa = (CSRC / "flash_attention.cu").read_text()
    assert "kFaStages = 3;" in fa
    assert "return 2 * kFaStages * kFaBK * (HD + 8) * sizeof(bf16);" in fa
    f32 = (CSRC / "flash_attention_tf32.cu").read_text()
    assert "return 5 * kFaBQ * (HD + 4) * sizeof(float);" in f32
    assert ("return 1024 + 2 * kFaBQ * (HD + 4) * sizeof(float) + "
            "4 * kWgBox<HD>;") in f32
    for hd in range(16, MAX_HEAD_DIM + 1, 16):
        bf16 = 2 * 3 * TILE * (hd + 8) * 2
        fp32 = 5 * TILE * (hd + 4) * 4
        if hd in (32, 64):
            fp32 = max(fp32, 1024 + 2 * TILE * (hd + 4) * 4
                       + 4 * TILE * hd * 4)
        assert max(bf16, fp32) <= MAX_SMEM, hd
    m3 = (CSRC / "matmul3.cu").read_text()
    assert "bf16 x[2][kM3Elems];\n  bf16 y[2][kM3Elems];" in m3
    assert "kM3Tile = 64" in m3 and "kM3Ld = kM3Tile + 8" in m3
    assert 2 * 2 * TILE * (TILE + 8) * 2 <= 48 * 1024
