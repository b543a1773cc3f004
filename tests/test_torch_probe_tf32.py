"""K23's fp32 core on K4's tensor-core tile and K21 on ``mma.sync``, written
out in plain torch and held to the JAX package.

CUDA kernels do not run here, so the walks are modelled in this file, each
with its kernel's sum order and rounding points:

- K23's fp32 core (``csrc/attention_tf32.cuh``,
  ``attention_tile_tf32<NK, MODE>``) in every mode: the keys staged
  (ceil8(seq_len) for the masked modes, ceil8(S) for the modes that score
  every key, zero past what is read), both products in the three-pass
  TF32 split (``vit_tpu_torch/tools/tf32_probe.py:split``, 8-deep slices
  into one accumulator), 64-key tiles with a running max in base 2, and
  each mode's change: mxu splits the raw scores (no max, no exp), addmask
  adds the mask to each raw score, vsum sums the p the products read (hi
  + lo truncated), wide takes its max and l in a pass of their own and
  walks p / l, qcore's codes exact in one TF32 pass after a pass for the
  row max; the context combined as ``attn_combine`` does. ``full`` is
  ``tests/test_torch_fp32_attention.py:tf32_walk`` (K4's fp32 core) bit
  for bit. The block around it is the plain version's
  (``attn_core_probe.probe_plain`` with its core replaced), held to the
  JAX probe (``tools/attn_core_probe.py:probe``) in interpret mode at
  ``test_torch_probe_tiles.GEOMETRIES`` with ``chip_smoke.py``'s fp32 bars
  (1e-4; relative norm 1e-5 where the context is not divided by l; qcore
  one int8 step more). The JAX outputs are made once for the module.
- The fragment maps the layout modes add (the kt and head-major slabs'
  B fragments, 32 banks a load) and the core's shared memory in every
  mode at B/16 (wide's heads of 128 included).
- K21 (``csrc/minimal_matmul.cu``): bf16 sums in 16-deep ``mma.sync``
  slices, fp32 in the three-pass split, one accumulator, held to
  ``examples/minimal_pallas_matmul.py:matmul`` in interpret mode; its
  tiles, its two stages' copies and its fragment banks.
"""

import numpy as np
import pytest
import torch

from test_torch_fp32_attention import LOG2E, sliced_split, tf32_walk
from test_torch_probe_tiles import GEOMETRIES, _combine
from test_torch_probes import _jax_tool
from vit_tpu_torch.ops import reference
from vit_tpu_torch.tools import attn_core_probe as acp
from vit_tpu_torch.tools.tf32_probe import split, truncate

TILE = 64       # keys a tile of the walk
MAX_SMEM = 232448
FP32_BAR = 1e-4  # chip_smoke.py's FP32_BAR
CORE_MODES = [m for m in acp.MODES if m != "projonly"]
UNIT_SUM = ("maskonly", "nosm", "mxu", "wide")


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


# ------------------------------------------------------ the core's walk --

def _qcore_tf32(q, k, v, *, scale: float, seq_len: int):
    """qcore on the fp32 tile: the head's k and v scales over all S rows,
    q's per row, each code exact in TF32 (|code| <= 127), so one TF32 pass
    gives the exact integer sums; a pass for the row max, then p = exp(s -
    max), its codes with scale 1/127 and ``c32 * (ap * av) / l``."""
    f = torch.float64
    sp = q.shape[2]
    aq = reference.div_qmax(q.abs().amax(-1, keepdim=True).clamp_min(1e-12))
    ak = reference.div_qmax(k.abs().amax((-2, -1), keepdim=True)
                            .clamp_min(1e-12))
    av = reference.div_qmax(v.abs().amax((-2, -1), keepdim=True)
                            .clamp_min(1e-12))
    qq, kq, vq = (torch.round(t / a) for t, a in ((q, aq), (k, ak), (v, av)))
    for t in (qq, kq, vq):  # the codes are tf32 values: one pass is exact
        assert torch.equal(split(t)[1], torch.zeros_like(t))
    s32 = qq.to(f) @ kq.to(f).transpose(-1, -2)
    keep = torch.arange(sp) < seq_len
    s = torch.where(keep, s32.float() * (aq * (ak * scale)), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    ap = reference.div_qmax(torch.ones(()))
    c32 = torch.round(p / ap).to(f) @ vq.to(f)
    return (c32.float() * (ap * av)) / l


def k23_tf32(mode: str, q, k, v, *, scale: float, seq_len: int, dt):
    """K23's fp32 core in ``mode`` on (B, H, S, hd) fp32 q, k, v as
    ``attention_tile_tf32`` walks them; the signature of
    ``attn_core_probe._core_plain``, whose place it takes."""
    assert dt == torch.float32
    sp = q.shape[2]
    if mode == "wide":
        q, k, v = acp._pairs(q), acp._pairs(k), acp._pairs(v)
    q, k, v = q.float(), k.float(), v.float()
    if mode == "qcore":
        out = _qcore_tf32(q, k, v, scale=scale, seq_len=seq_len)
    else:
        out = _walk(mode, q, k, v, scale=scale, seq_len=seq_len)
    if mode == "wide":
        b, hp, _, hd2 = out.shape
        out = out.transpose(1, 2).reshape(b, sp, 2 * hp, hd2 // 2) \
            .transpose(1, 2)
    return out


def _walk(mode, q, k, v, *, scale: float, seq_len: int):
    sp, hd = q.shape[2], q.shape[3]
    all_keys = mode not in acp.MASKED or mode == "addmask"
    kvalid = sp if all_keys else seq_len
    kend = _ceil(kvalid, 8)
    pad = (0, -hd % 8)
    q = torch.nn.functional.pad(q, pad)
    k, v = (torch.nn.functional.pad(t[:, :, :kvalid],
                                    pad + (0, kend - kvalid)) for t in (k, v))
    scale2 = scale * LOG2E
    tiles = [slice(k0, min(k0 + TILE, kend)) for k0 in range(0, kend, TILE)]

    def raw(keys):
        return sliced_split(q, k[:, :, keys].transpose(-1, -2))

    def real(keys, n=kvalid):
        return torch.arange(keys.start, keys.stop) < n

    m2 = torch.full(q.shape[:-1] + (1,), float("-inf"))
    if mode == "wide":  # the row max and l in a pass of their own
        lw = torch.zeros_like(m2)
        for keys in tiles:
            s2 = (raw(keys) * scale2).masked_fill(~real(keys), float("-inf"))
            mt = torch.maximum(m2, s2.amax(-1, keepdim=True))
            lw = lw * torch.exp2(m2 - mt) + torch.exp2(s2 - mt).sum(
                -1, keepdim=True)
            m2 = mt
    l_ = torch.zeros_like(m2)
    o = torch.zeros(q.shape)
    for keys in tiles:
        if mode == "mxu":  # p = s, the keys past S zero
            p = torch.where(real(keys, sp), raw(keys) * scale, 0.0)
        elif mode == "wide":
            p = torch.where(real(keys), torch.exp2(raw(keys) * scale2 - m2)
                            / lw, 0.0)
        else:
            r = raw(keys)
            if mode == "addmask":
                r = r + torch.where(real(keys, seq_len), 0.0, float("-inf"))
            s2 = (r * scale2).masked_fill(~real(keys), float("-inf"))
            mt = torch.maximum(m2, s2.amax(-1, keepdim=True))
            alpha = torch.exp2(m2 - mt)
            p = torch.exp2(s2 - mt)
            if mode != "vsum":
                l_ = l_ * alpha + p.sum(-1, keepdim=True)
            else:
                l_ = l_ * alpha
            o = o * alpha
            m2 = mt
        if mode == "vsum":  # l of the p the products read
            hi, lo = split(p)
            l_ = l_ + (hi + lo).sum(-1, keepdim=True)
        o = o + sliced_split(p, v[:, :, keys])
    if mode == "full":
        return (o / l_)[..., :hd]
    if mode in UNIT_SUM:
        l_ = torch.ones_like(l_)
    return _combine(mode, o, l_, torch.float32)[..., :hd]


def _qkv(seed, b, h, s, hd):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, s, hd))
                             .astype(np.float32)) for _ in range(3)]


@pytest.mark.parametrize("hd,s,seq_len", [(64, 208, 197), (20, 80, 71),
                                          (80, 16, 16), (136, 40, 33)])
def test_k23_tf32_full_is_k4s_walk_bit_for_bit(hd, s, seq_len):
    """``full`` is K4's fp32 core's walk, the same operations in the same
    order: bit for bit with ``tf32_walk``."""
    q, k, v = _qkv(hd + s, 2, 2, s, hd)
    kw = dict(scale=hd ** -0.5, seq_len=seq_len)
    assert torch.equal(k23_tf32("full", q, k, v, dt=torch.float32, **kw),
                       tf32_walk(q, k, v, **kw))


@pytest.mark.parametrize("mode", CORE_MODES)
def test_k23_tf32_core_against_the_plain_core(mode):
    """Each mode's modelled core against the plain core
    (``attn_core_probe._core_plain``) at a ragged geometry: 1e-4 (relative
    norm 1e-5 where the context is not divided by l); qcore's integer sums
    exact, so a code that flips at a .5 boundary moves one element by at
    most av."""
    b, h, s, hd, seq = 2, 4, 80, 32, 71
    q, k, v = _qkv(3, b, h, s, hd)
    kw = dict(scale=hd ** -0.5, seq_len=seq, dt=torch.float32)
    got = k23_tf32(mode, q, k, v, **kw)
    want = acp._core_plain(mode, q, k, v, **kw)
    assert got.shape == want.shape and torch.isfinite(got).all()
    if mode in acp.UNNORMALIZED:
        assert (got - want).norm() / want.norm() <= 1e-5
    elif mode == "qcore":
        av = float(v.abs().amax()) / 127
        assert (got - want).abs().max() <= FP32_BAR + av
    else:
        assert (got - want).abs().max() <= FP32_BAR


def test_k23_tf32_vsum_sums_what_the_products_read():
    """vsum's l is the sum of hi + lo truncated (what a tf32 product reads
    of the split p): within 2^-21 relative of full's l, and not its bits."""
    p = torch.rand(4, 64) * 0.999 + 1e-3
    hi, lo = split(p)
    assert torch.equal(lo, truncate(p - hi))
    read = (hi.double() + lo.double()).sum(-1)
    exact = p.double().sum(-1)
    rel = float(((read - exact).abs() / exact).max())
    assert 0 < rel <= 2.0 ** -21


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX probe's fp32 block in interpret mode, ``get(mode, geom)``,
    each computed once for the module."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    cache = {}
    with pytest.MonkeyPatch.context() as mp:
        real = pl.pallas_call
        mp.setattr(pl, "pallas_call",
                   lambda *a, **kw: real(*a, **{**kw, "interpret": True}))
        jt = _jax_tool("attn_core_probe", mp)

        def get(mode, geom):
            if (mode, geom) not in cache:
                b, sp, seq, d, heads = geom
                inputs = acp.make_inputs(b, sp, d, seq, torch.float32,
                                         seed=11)
                jx, *jw = (jnp.asarray(t.numpy()) for t in inputs)
                if mode == "xcore":
                    jx = jx.reshape(b * sp, d).T
                cache[mode, geom] = np.asarray(jt.probe(
                    mode, jx, *jw, num_heads=heads, seq_len=seq, group=1,
                    shape=(b, sp, d)))
            return cache[mode, geom]
        yield get


@pytest.mark.parametrize("geom", GEOMETRIES, ids=["frag16", "chunk64"])
@pytest.mark.parametrize("mode", CORE_MODES)
def test_k23_tf32_block_matches_the_jax_probe(mode, geom, jax_probe,
                                              monkeypatch):
    b, sp, seq, d, heads = geom
    want = jax_probe(mode, geom)
    x, *w = acp.make_inputs(b, sp, d, seq, torch.float32, seed=11)
    step = (acp.qcore_step(x, *w[:5], num_heads=heads)
            if mode == "qcore" else 0.0)
    if mode == "xcore":
        x = x.reshape(b * sp, d).t().contiguous()
    monkeypatch.setattr(acp, "_core_plain", k23_tf32)
    got = acp.probe_plain(mode, x, *w, num_heads=heads, seq_len=seq,
                          shape=(b, sp, d)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    if mode in acp.UNNORMALIZED:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-5, rel
    else:
        assert np.abs(got - want).max() <= FP32_BAR + step


# ------------------------------------------------------- fragment maps --

def _banks(words) -> int:
    return len({w % 32 for w in words})


@pytest.mark.parametrize("s", [16, 40, 80, 197, 208, 592])
def test_k23_tf32_slab_fragments_touch_32_banks(s):
    """kt's and head-major's K slab (rows of ceil16(S) + 8 floats): the
    scores' B fragment b0 = K^T(t, g) of a warp is 32 words in 32 banks;
    head-major's V slab: b0, b1 = V^T(g, 2t), V^T(g, 2t + 1) as one 8-byte
    load, 16 lanes a phase in 32 banks."""
    ldsl = _ceil(s, 16) + 8
    assert ldsl % 32 in (8, 24) and ldsl % 4 == 0
    for kk, n, k0 in ((0, 0, 0), (3, 5, 64), (7, 7, 128)):
        words = [(8 * kk + lane % 4) * ldsl + k0 + 8 * n + lane // 4
                 for lane in range(32)]
        assert _banks(words) == 32
        for half in (0, 16):
            words = [w for lane in range(half, half + 16)
                     for w in ((8 * n + lane // 4) * ldsl + k0
                               + 2 * (lane % 4) + e for e in (0, 1))]
            assert _banks(words) == 32


@pytest.mark.parametrize("mode", CORE_MODES)
def test_k23_tf32_core_fits_at_b16(mode):
    """Every fp32 mode's core fits a block at B/16 (208 tokens, heads of
    64; wide's pairs 128, K and V 219,648 bytes), ``full``'s in K4's fp32
    shared memory."""
    from vit_tpu_torch.ops.cuda.block import attention_tf32_smem_bytes
    hd = 128 if mode == "wide" else 64
    got = acp.core_smem_bytes(208, hd, 4, mode)
    assert got <= MAX_SMEM
    if mode not in ("kt", "tcore", "xcore", "qcore"):
        assert got == attention_tf32_smem_bytes(208, hd)
    assert acp.core_smem_bytes(208, 128, 4, "wide") == 2 * 208 * 132 * 4


# ------------------------------------------------------------ K21 -------

def k21_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K21 in bf16: exact bf16 products summed in fp32, 16-deep mma.sync
    slices in order into one accumulator, cast once."""
    acc = torch.zeros(x.shape[0], w.shape[1])
    for k0 in range(0, x.shape[1], 16):
        acc = acc + x[:, k0:k0 + 16].float() @ w[k0:k0 + 16].float()
    return acc.to(torch.bfloat16)


def k21_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K21 in fp32: the three-pass TF32 split, 8-deep slices, one
    accumulator."""
    return sliced_split(x.float(), w.float())


@pytest.fixture(scope="module")
def jax_minimal():
    """``examples/minimal_pallas_matmul.py:matmul`` (interpret mode off
    the TPU) on the example's inputs, by (shape, dtype)."""
    import importlib.util
    from pathlib import Path

    import jax.numpy as jnp
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "minimal_pallas_matmul.py"
    spec = importlib.util.spec_from_file_location("minimal_pallas", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cache = {}

    def get(m, k, n, dtype):
        key = (m, k, n, dtype)
        if key not in cache:
            rng = np.random.default_rng(m + k + n)
            x = (rng.standard_normal((m, k)) * 0.1).astype(np.float32)
            w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
            jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
            xt, wt = (torch.from_numpy(a).to(getattr(torch, dtype))
                      for a in (x, w))
            out = mod.matmul(jnp.asarray(xt.float().numpy(), jdt),
                             jnp.asarray(wt.float().numpy(), jdt))
            cache[key] = (xt, wt, np.asarray(jnp.asarray(out, jnp.float32)))
        return cache[key]
    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(256, 384, 512), (128, 1024, 384)])
def test_k21_matches_the_pallas_example(m, k, n, dtype, jax_minimal):
    """K21's sums against the Pallas example: fp32 within 1e-4 (the split's
    one accumulator at K = 384 and 1024), bf16 within the kernel bar; and
    within 1e-4 of float64 in fp32, where one TF32 pass is not."""
    x, w, want = jax_minimal(m, k, n, dtype)
    got = (k21_fp32 if dtype == "float32" else k21_bf16)(x, w).float()
    diff = np.abs(got.numpy() - want)
    if dtype == "float32":
        assert diff.max() <= FP32_BAR, diff.max()
        exact = x.double() @ w.double()
        assert (got.double() - exact).abs().max() <= FP32_BAR
        one = split(x)[0] @ split(w)[0]
        assert (one.double() - exact).abs().max() > FP32_BAR
    else:
        assert (diff <= 2e-2 * (1 + np.abs(want))).all(), diff.max()
        assert diff.mean() <= 3e-3


def test_k21_tiles_cover_the_output_once():
    """64 x 64 tiles, four warps of 32 x 32, each warp's two 16-row by four
    8-column mma tiles: every output element of (256, 512) once, from one
    lane's accumulator."""
    m, n = 256, 512
    seen = np.zeros((m, n), dtype=int)
    for by in range(m // 64):
        for bx in range(n // 64):
            for warp in range(4):
                wr, wc = warp // 2, warp % 2
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for i in range(2):
                        for j in range(4):
                            for h in range(2):
                                r = 64 * by + 32 * wr + 16 * i + g + 8 * h
                                c = 64 * bx + 32 * wc + 8 * j + 2 * t
                                seen[r, c:c + 2] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("itemsize", [4, 2])
def test_k21_copies_and_fragment_banks(itemsize):
    """A step's cp.async copies write each element of x's 64 x 32 slice and
    w's 32 x 64 slice once, 16 bytes each into 16-byte-aligned rows (x's
    rows padded by 16 bytes, w's by 8 values); the fp32 fragment loads (x
    rows of 36 floats, w rows of 72) touch 32 banks; the bf16 rows (40 and
    72 elements) are an odd number of 16-byte units, so the eight rows of
    an ldmatrix matrix fall in distinct banks; two stages fit the 48 KB of
    static shared memory in either dtype."""
    per = 16 // itemsize
    ldx, ldw = 32 + per, 64 + 8
    assert 2 * (64 * ldx + 32 * ldw) * itemsize <= 48 * 1024
    for rows, cols, ld in ((64, 32, ldx), (32, 64, ldw)):
        hit = np.zeros((rows, cols), dtype=int)
        for c in range(rows * cols // per):
            r, e = c // (cols // per), c % (cols // per) * per
            assert (r * ld + e) * itemsize % 16 == 0
            hit[r, e:e + per] += 1
        assert (hit == 1).all()
    if itemsize == 4:
        for wr, kk in ((0, 0), (1, 24)):
            for e in range(4):  # x's A fragment, element e of each lane
                words = [(32 * wr + (lane // 4) + 8 * (e & 1)) * ldx + kk
                         + lane % 4 + 4 * (e >> 1) for lane in range(32)]
                assert _banks(words) == 32
            for e in range(2):  # w's B fragment
                words = [(kk + lane % 4 + 4 * e) * ldw + 32 * wr + lane // 4
                         for lane in range(32)]
                assert _banks(words) == 32
    else:
        assert (ldx * 2 // 16) % 2 == 1 and (ldw * 2 // 16) % 2 == 1
