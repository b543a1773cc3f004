"""The fp32 forms of K4's attention core (``csrc/attention_tf32.cu``) and of
K7 (``csrc/flash_attention_tf32.cu``) on the tensor cores, on the CPU.

CUDA kernels do not run here, so the two tiles are modelled in PyTorch with
the three-pass TF32 split of ``vit_tpu_torch/tools/tf32_probe.py`` (hi
rounded to tf32, lo = x - hi read truncated, ``lo_a hi_b + hi_a lo_b +
hi_a hi_b``) in their sum order: every product in 8-deep slices, the
three passes of each slice added to one fp32 accumulator in turn; the keys
walked in tiles of 64 with a running max in base 2 (``flash_tf32.cuh:
online_step``); p split where its C fragment left it. The ``mma.sync``
forms (K4's core, and K7 at head widths other than 32 and 64) multiply
only the 8-key C tiles below the last real key; K7's ``wgmma`` form (d =
32 and 64) multiplies whole 64-key tiles, its masked keys at p = 0, which
adds exact zeros where the keys are finite (``whole_tiles``). The model
is held at the fp32 bar, 1e-4, to JAX's Pallas
``attn_block`` (whose ``_attn_core`` is K4's function) and ``flash_attention``
in each of its three regimes, in interpret mode at fp32 (``Precision.
HIGHEST``), and to the plain versions. The core's shared memory is held
under the FFMA tile's at every fp32 geometry ``ops.attn_plan`` admits, and
the gate and the routes are pinned as they were.
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops.pallas import block as pallas_block
from vit_tpu.ops.pallas.attention import flash_attention as jax_flash
from vit_tpu_torch import ops
from vit_tpu_torch.config import VARIANTS
from vit_tpu_torch.models.vit import _padded_seq
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.cuda.block import (MAX_SMEM, attention_smem_bytes,
                                          attention_tf32_smem_bytes)
from vit_tpu_torch.tools.tf32_probe import split

BAR = 1e-4     # the fp32 kernels' bar against their plain versions
TILE = 64      # keys a tile of the walk
SLICE = 8      # the depth of one mma.sync m16n8k8 tf32
LOG2E = 1.4426950408889634


def _max_diff(got: torch.Tensor, want) -> float:
    want = want.float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max())


def sliced_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the tiles sum it: each 8-deep slice of the contraction
    in order, its three passes (``lo_a hi_b``, ``hi_a lo_b``, ``hi_a
    hi_b``) added to one fp32 accumulator in turn."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], SLICE):
        (ah, al), (bh, bl) = split(a[..., k0:k0 + SLICE]), \
            split(b[..., k0:k0 + SLICE, :])
        acc = acc + al @ bh
        acc = acc + ah @ bl
        acc = acc + ah @ bh
    return acc


def tf32_walk(q, k, v, *, scale: float, seq_len: int,
              whole_tiles: bool = False) -> torch.Tensor:
    """K4's fp32 core and K7's fp32 form on (B, H, S, d) fp32 operands:
    q, k and v zero-padded to 8 columns; the keys below ceil8(seq_len) in
    tiles of 64, each tile's 8-key C tiles (``whole_tiles``: every key of
    the tiles that hold a real one, those past S zero, as K7's ``wgmma``
    form); s2 = (q k^T) * scale * log2(e), the keys at or past seq_len at
    -inf; m2' = max(m2, rowmax(s2)), alpha = 2^(m2 - m2'), p = 2^(s2 -
    m2'), l = l alpha + rowsum(p), o = o alpha + p v (sliced_split over the
    tile's 8-key slices); ctx = o / l."""
    d = q.shape[-1]
    kend = -(-seq_len // (TILE if whole_tiles else SLICE)) \
        * (TILE if whole_tiles else SLICE)
    pad = (0, -d % SLICE)
    q = torch.nn.functional.pad(q.float(), pad)
    k, v = (torch.nn.functional.pad(t.float(), pad + (0, max(
        kend - t.shape[-2], 0))) for t in (k, v))
    m2 = torch.full(q.shape[:-1] + (1,), float("-inf"))
    l_ = torch.zeros_like(m2)
    o = torch.zeros(q.shape)
    for k0 in range(0, kend, TILE):
        keys = slice(k0, min(k0 + TILE, kend))
        s2 = sliced_split(q, k[:, :, keys].transpose(-1, -2)) * (scale * LOG2E)
        real = torch.arange(keys.start, keys.stop) < seq_len
        s2 = s2.masked_fill(~real, float("-inf"))
        mt = torch.maximum(m2, s2.amax(-1, keepdim=True))
        alpha = torch.exp2(m2 - mt)
        p = torch.exp2(s2 - mt)
        l_ = l_ * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + sliced_split(p, v[:, :, keys])
        m2 = mt
    return (o / l_)[..., :d]


def _qkv(rng, b, h, s, hd):
    return [torch.from_numpy(rng.standard_normal((b, h, s, hd))
                             .astype(np.float32)) for _ in range(3)]


# ---------------------------------------------------------- K4's core --

@pytest.mark.parametrize("hd", [20, 64, 80])
@pytest.mark.parametrize("s,seq_len", [(16, 16), (80, 71), (208, 197)])
def test_k4_tf32_core_matches_pallas_attn_block(hd, s, seq_len, monkeypatch):
    """The modelled core against the plain version on the packed QKV
    buffer, and inside the block: ``reference.attn_block`` with its core
    the model against JAX's Pallas ``attn_block`` in interpret mode (fp32,
    ``Precision.HIGHEST``; D a multiple of 128, which it needs: 32 heads
    of 20, 2 of 64, 8 of 80); both within 1e-4."""
    rng = np.random.default_rng(hd + s)
    b, heads = 2, 128 // math.gcd(hd, 128)
    d = heads * hd
    qkv = torch.from_numpy(rng.standard_normal((b * s, 3 * d))
                           .astype(np.float32))
    scale = hd ** -0.5

    def model_core(qkv, *, batch, num_heads, scale, seq_len):
        rows = qkv.shape[0]
        q, k, v = qkv.reshape(batch, rows // batch, 3, num_heads, -1) \
            .permute(2, 0, 3, 1, 4)
        ctx = tf32_walk(q, k, v, scale=scale, seq_len=seq_len)
        return ctx.permute(0, 2, 1, 3).reshape(rows, -1)

    kw = dict(batch=b, num_heads=heads, scale=scale, seq_len=seq_len)
    got = model_core(qkv, **kw)
    assert _max_diff(got, reference.attention_core(qkv, **kw)) <= BAR

    x = rng.standard_normal((b, s, d))
    x[:, seq_len:] = 0
    arrays = [a.astype(np.float32) for a in (
        x, 1 + 0.1 * rng.standard_normal(d), 0.05 * rng.standard_normal(d),
        3 / math.sqrt(d) * rng.standard_normal((d, 3 * d)),
        0.02 * rng.standard_normal(3 * d),
        rng.standard_normal((d, d)) / math.sqrt(d),
        0.02 * rng.standard_normal(d))]
    want = pallas_block.attn_block(*(jnp.asarray(a) for a in arrays),
                                   num_heads=heads, seq_len=seq_len,
                                   eps=1e-12, interpret=True)
    monkeypatch.setattr(reference, "attention_core", model_core)
    got = reference.attn_block(*(torch.from_numpy(a) for a in arrays),
                               num_heads=heads, seq_len=seq_len, eps=1e-12)
    assert _max_diff(got[:, :seq_len], np.asarray(want)[:, :seq_len]) <= BAR


def test_k4_tf32_core_walks_the_running_max():
    """The model's sum order is the one chosen (a running max): on scores
    that rise along the keys, so that the max moves at every tile, it
    differs from a walk relative to the row max only in fp32 rounding,
    within the bar, and the two are not the same bits everywhere."""
    rng = np.random.default_rng(7)
    s, hd = 208, 64
    q, k, v = _qkv(rng, 1, 2, s, hd)
    k = k + torch.linspace(0, 3, s)[:, None] * q.mean(2, keepdim=True)
    got = tf32_walk(q, k, v, scale=hd ** -0.5, seq_len=197)
    want = reference.attention(q, k, v, scale=hd ** -0.5, seq_len=197)
    assert _max_diff(got, want) <= BAR
    assert not torch.equal(got, want)


# ------------------------------------------------------------------ K7 --

@pytest.mark.parametrize("hd", [16, 64, 80])
@pytest.mark.parametrize("regime", ["single_tile", "qtile", "online"])
def test_k7_tf32_walk_matches_jax_flash_attention(hd, regime):
    """The modelled walk against JAX's Pallas ``flash_attention`` in each
    of its three regimes, interpret mode, fp32: the single-tile kernels
    (``pallas_call`` at attention.py:246; B/16's 208 tokens, 197 real),
    the q-tiled one with whole K and V (:277; 785 tokens, 777 real, over
    its 768-row single-tile limit) and the online one (:311; the same with
    ``block_q = block_k = 64``, ``force_online``); and against the plain
    version, within 1e-4."""
    s, seq_len = (208, 197) if regime == "single_tile" else (785, 777)
    rng = np.random.default_rng(hd + s)
    q, k, v = _qkv(rng, 1, 2, s, hd)
    scale = hd ** -0.5
    got = tf32_walk(q, k, v, scale=scale, seq_len=seq_len)
    kw = dict(scale=scale, seq_len=seq_len, interpret=True)
    if regime == "online":
        kw.update(block_q=TILE, block_k=TILE, force_online=True)
    want = jax_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)), **kw)
    assert _max_diff(got[:, :, :seq_len],
                     np.asarray(want)[:, :, :seq_len]) <= BAR
    plain = reference.flash_attention(q, k, v, scale=scale, seq_len=seq_len)
    assert _max_diff(got, plain) <= BAR


def test_k7_tf32_walk_skips_the_masked_c_tiles():
    """In the ``mma.sync`` forms (K4's core, K7 at widths other than 32
    and 64) the last tile's 8-key C tiles past seq_len are not multiplied:
    the keys past ceil8(seq_len) may hold anything (here NaN) without
    reaching the context. K7's ``wgmma`` form does not have this property
    (``test_k7_tf32_wgmma_walk_multiplies_whole_tiles``)."""
    rng = np.random.default_rng(5)
    s, seq_len, hd = 208, 197, 64
    q, k, v = _qkv(rng, 1, 1, s, hd)
    k[:, :, 200:], v[:, :, 200:] = float("nan"), float("nan")
    got = tf32_walk(q, k, v, scale=hd ** -0.5, seq_len=seq_len)
    want = reference.attention(q[:, :, :, :], k[:, :, :seq_len],
                               v[:, :, :seq_len], scale=hd ** -0.5)
    assert _max_diff(got, want) <= BAR


# ----------------------------------------------------- shared memory --

def test_k4_tf32_core_fits_every_geometry_the_gate_admits():
    """``ops.attn_plan`` still sizes the FFMA tile (K, V, q and the fp32
    score rows) in fp32; the tensor-core core (K and V only, keys rounded
    up to 8, rows of ceil8(d) + 4 floats) needs at most 232,448 B and at
    most the FFMA tile's at every (S, head width) the gate admits, widths
    up to 878 at S = 1, 593 at S = 16 and 280 at S = 64 among them; at
    S = 208, d = 64 it is 113,152 B."""
    admitted, widest = 0, 0
    for hd in range(1, 900):
        for s in range(1, 2000):
            if not ops.attn_plan(1, s, hd, 1, torch.float32):
                break  # the FFMA tile grows with S
            admitted += 1
            widest = max(widest, hd)
            tf32 = attention_tf32_smem_bytes(s, hd)
            assert tf32 <= MAX_SMEM == 232448, (s, hd)
            assert tf32 <= attention_smem_bytes(s, hd, 4), (s, hd)
    assert admitted > 60000 and widest < 900  # the loops met the gate
    for s, widest in ((1, 878), (16, 593), (64, 280)):
        assert ops.attn_plan(1, s, widest, 1, torch.float32)
        assert not ops.attn_plan(1, s, widest + 1, 1, torch.float32)
    assert ops.attn_plan(1, 279, 64, 1, torch.float32)
    assert not ops.attn_plan(1, 280, 64, 1, torch.float32)
    assert attention_tf32_smem_bytes(208, 64) == 113152


# ------------------------------------------------------------- routes --

#: ``ops.attn_plan`` of each variant's padded sequence at batch 1, 2, 32
#: in fp32 and bf16, as before the core moved to the tensor cores.
ATTN_PLAN = {"B/16": (True, True), "B/32": (True, True),
             "L/16": (True, True), "L/16-384": (False, False),
             "H/14": (False, True), "DeiT-B/16": (True, True)}


@pytest.mark.parametrize("variant", list(ATTN_PLAN))
def test_attn_plan_is_unchanged(variant):
    cfg = VARIANTS[variant]
    for dtype, want in zip((torch.float32, torch.bfloat16),
                           ATTN_PLAN[variant]):
        for b in (1, 2, 32):
            assert ops.attn_plan(b, _padded_seq(cfg), cfg.hidden_dim,
                                 cfg.num_heads, dtype) is want


def test_route_counts_are_unchanged():
    """``chip_smoke.py``'s launch counts of the default route and of the
    composed flash route, which its phases hold the forwards to: K4's core
    12 times a B/16 forward, K7 once a layer on the composed route."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.PER_FORWARD == {"layernorm": 13, "matmul": 26,
                                 "attention": 12, "mlp_block": 12}
    assert smoke.route_counts("flash", True) == {
        "layernorm": 1, "matmul": 2, "layernorm_stats": 24,
        "fused_linear": 48, "flash_attention": 12}
    assert smoke.route_counts("flash", False, 24) == {
        "layernorm": 49, "matmul": 98, "add": 48, "flash_attention": 24}
    assert math.isclose(smoke.PEAK_OPS_PER_S["tf32x3"], 495e12 / 3)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("s,seq_len", [(208, 197), (592, 577)])
def test_k7_tf32_wgmma_walk_multiplies_whole_tiles(hd, s, seq_len):
    """K7's ``wgmma`` form (d = 32 and 64; B/16's 197 of 208 tokens,
    L/16-384's 577 of 592) multiplies whole 64-key tiles, the masked keys
    at p = 0: with finite padding keys (here large) that adds exact zeros,
    so it gives the ``mma.sync`` walk's bits and holds the bar against the
    plain version; NaN in the padding keys reaches the context, as it
    does in the plain version."""
    rng = np.random.default_rng(hd + s)
    q, k, v = _qkv(rng, 1, 2, s, hd)
    k[:, :, seq_len:], v[:, :, seq_len:] = 1e4, -1e4
    kw = dict(scale=hd ** -0.5, seq_len=seq_len)
    got = tf32_walk(q, k, v, whole_tiles=True, **kw)
    assert torch.equal(got, tf32_walk(q, k, v, **kw))
    assert _max_diff(got, reference.flash_attention(q, k, v, **kw)) <= BAR
    v[:, :, s - 1] = float("nan")
    assert tf32_walk(q, k, v, whole_tiles=True, **kw).isnan().all()
    assert reference.flash_attention(q, k, v, **kw).isnan().all()
