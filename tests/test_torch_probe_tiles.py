"""The bf16 tiles of the two probes, K23 ``attn_core_probe`` and K22
``dot_probe``, written out in plain torch and held to the JAX probes.

CUDA kernels do not run here, so the walks are modelled in this file (not
in the package), each with its kernel's rounding points:

- K23's core on K4's tensor-core tile (``csrc/attention_mma.cuh``,
  ``attention_tile_mma<NK, 1, 128, MODE>``) in every mode: the keys
  staged (ceil16(seq_len) for the masked modes, ceil16(S) for the modes
  that score every key, zero past what is read), the two passes over
  64-key chunks, each mode's max, l and combine (``attn_combine``),
  ``wide``'s l in a pass of its own before p / l is rounded, ``qcore``'s
  exact int8 sums in 32-key steps with the keys of its context contraction
  permuted (``attn_qcore_key``). The block around it is the plain
  version's (``attn_core_probe.probe_plain`` with its core replaced), held
  to the JAX probe (``tools/attn_core_probe.py:probe``) in interpret mode,
  as ``tests/test_torch_probes.py`` holds ``probe_plain``. The geometries
  end inside a 16-key fragment and inside a 64-key chunk.
- The fragment maps the layout modes add: ``ldmatrix`` (with and without
  ``.trans``) modelled on a flat shared memory, the kt and head-major slabs
  staged from the transposed buffers, q's A fragments from its slab, V's B
  fragments from its slab, qcore's s8 fragments from the score C
  fragments and the permuted V codes, and the probe GEMMs' transposed
  staging tile (``gemm_wgmma.cuh:probe_epilogue``).
- The tile each probe's GEMM runs on (``int8_probe.dot_tile``,
  ``attn_core_probe.gemm_tile``), a pure function of shape and alignment.

Bars: bf16 |diff| <= 2e-2 (1 + |ref|), mean <= 3e-3 (the kernel bar);
fp32 1e-5; qcore within one int8 step of its codes (``qcore_step``) on top.
"""

import numpy as np
import pytest
import torch

from test_torch_probes import _jax_tool, interpret  # noqa: F401 (fixture)
from vit_tpu_torch.ops import reference
from vit_tpu_torch.tools import attn_core_probe as acp
from vit_tpu_torch.tools import int8_probe

CHUNK = 64  # keys a chunk of the two passes
#: (B, SP, seq_len, D, heads): seq_len and S end inside a 16-key fragment,
#: the first inside the first 64-key chunk, the second in the second.
GEOMETRIES = [(2, 40, 33, 64, 4), (1, 80, 71, 64, 2)]
CORE_MODES = [m for m in acp.MODES if m != "projonly"]
#: Modes whose context is not divided by l (attention_core.cuh:
#: attn_unit_sum; wide divides p first).
UNIT_SUM = ("maskonly", "nosm", "mxu", "wide")


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


# ------------------------------------------------------- the core's walk --

def _combine(mode: str, ctx, l, dt):
    """``attention_core.cuh:attn_combine`` of fp32 ctx and l (l = 1 for the
    unit-sum modes)."""
    if mode in ("recip", "alldiv", "mxudiv", "addmask", "tcore", "xcore"):
        return ctx * (1.0 / l)
    if mode == "sumonly":
        return ctx + 1e-30 * l
    if mode == "bf16div":
        return _f32(ctx.to(dt)) / _f32(l.to(dt))
    return ctx / l


def qcore_key(pos: int) -> int:
    """``attention_mma.cuh:attn_qcore_key``: the key at position ``pos`` of
    qcore's context contraction."""
    w = pos & 31
    i, t = w & 3, (w >> 2) & 3
    return (pos & ~31) + (w & 16) + 2 * t + (i & 1) + 8 * (i >> 1)


def _qcore_tiles(q, k, v, *, scale: float, seq_len: int, dt):
    """qcore on the tensor cores: the head's k and v scales over all S rows,
    q's per row; exact int32 scores in 32-key steps; p's codes with scale
    1/127 (the row max of p is exp(0) = 1); the context's exact sums taken
    over the keys in ``qcore_key``'s order; ``c32 * (ap * av) / l``."""
    f = torch.float64
    sp = q.shape[2]
    qf, kf, vf = _f32(q), _f32(k), _f32(v)
    aq = reference.div_qmax(qf.abs().amax(-1, keepdim=True).clamp_min(1e-12))
    ak = reference.div_qmax(kf.abs().amax((-2, -1), keepdim=True)
                            .clamp_min(1e-12))
    av = reference.div_qmax(vf.abs().amax((-2, -1), keepdim=True)
                            .clamp_min(1e-12))
    qq, kq, vq = (torch.round(t / a) for t, a in ((qf, aq), (kf, ak),
                                                  (vf, av)))
    kend = _ceil(seq_len, 32)
    kq = torch.nn.functional.pad(kq, (0, 0, 0, _ceil(sp, 32) - sp))
    vq = torch.nn.functional.pad(vq, (0, 0, 0, _ceil(sp, 32) - sp))
    s32 = torch.cat([qq.to(f) @ kq[:, :, k0:k0 + 32].to(f).transpose(-1, -2)
                     for k0 in range(0, kend, 32)], -1)
    keep = torch.arange(kend) < seq_len
    s = torch.where(keep, s32.float() * (aq * (ak * scale)), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    ap = reference.div_qmax(torch.ones(()))
    assert torch.equal(p.amax(-1), torch.ones_like(p.amax(-1)))
    pq = torch.round(p / ap)
    perm = torch.tensor([qcore_key(i) for i in range(kend)])
    c32 = pq[..., perm].to(f) @ vq[:, :, perm].to(f)
    return ((c32.float() * (ap * av)) / l).to(dt)


def k23_tiles(mode: str, q, k, v, *, scale: float, seq_len: int, dt):
    """K23's core in ``mode`` on (B, H, S, hd) q, k, v in ``dt`` as
    ``attention_tile_mma`` walks them; returns the context in ``dt``. The
    signature of ``attn_core_probe._core_plain``, whose place it takes."""
    sp = q.shape[2]
    if mode == "wide":
        q, k, v = acp._pairs(q), acp._pairs(k), acp._pairs(v)
    if mode == "qcore":
        return _qcore_tiles(q, k, v, scale=scale, seq_len=seq_len, dt=dt)
    all_keys = mode not in acp.MASKED or mode == "addmask"
    kvalid = sp if all_keys else seq_len
    kend = _ceil(kvalid, 16)
    hd = q.shape[-1]
    pad_d = _ceil(hd, 16) - hd
    qp = _f32(torch.nn.functional.pad(q, (0, pad_d)))
    kp, vp = (_f32(torch.nn.functional.pad(t[:, :, :kvalid],
                                           (0, pad_d, 0, kend - kvalid)))
              for t in (k, v))

    def scores(k0):
        kc = kp[:, :, k0:k0 + CHUNK]
        raw = qp @ kc.transpose(-1, -2)
        key = torch.arange(k0, k0 + kc.shape[2])
        if mode == "mxu":
            return torch.where(key < sp, raw * scale, 0.0)
        if mode == "addmask":
            row = torch.where(key < seq_len, 0.0, float("-inf"))
            return torch.where(key < sp, raw * scale + row, float("-inf"))
        return torch.where(key < kvalid, raw * scale, float("-inf"))

    chunks = range(0, kend, CHUNK)
    mx = torch.full(qp.shape[:3] + (1,), float("-inf"))
    if mode != "mxu":
        for k0 in chunks:
            mx = torch.maximum(mx, scores(k0).amax(-1, keepdim=True))
    lw = torch.ones_like(mx)
    if mode == "wide":
        lw = sum(torch.exp(scores(k0) - mx).sum(-1, keepdim=True)
                 for k0 in chunks)
    l = torch.zeros_like(mx)
    ctx = torch.zeros(qp.shape)
    for k0 in chunks:
        p = scores(k0) if mode == "mxu" else torch.exp(scores(k0) - mx)
        l = l + (_f32(p.to(dt)) if mode == "vsum" else p).sum(-1, keepdim=True)
        if mode == "wide":
            p = p / lw
        ctx = ctx + _f32(p.to(dt)) @ vp[:, :, k0:k0 + CHUNK]
    if mode in UNIT_SUM:
        l = torch.ones_like(l)
    out = _combine(mode, ctx, l, dt)[..., :hd].to(dt)
    if mode == "wide":
        b, hp, _, hd2 = out.shape
        out = out.transpose(1, 2).reshape(b, sp, 2 * hp, hd2 // 2) \
            .transpose(1, 2)
    return out


def _np(a) -> np.ndarray:
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("geom", GEOMETRIES, ids=["frag16", "chunk64"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", CORE_MODES)
def test_k23_tiles_match_the_jax_probe(mode, dtype, geom, interpret,
                                       monkeypatch):
    import jax.numpy as jnp

    b, sp, seq, d, heads = geom
    jt = _jax_tool("attn_core_probe", interpret)
    inputs = acp.make_inputs(b, sp, d, seq, getattr(torch, dtype), seed=11)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jx, *jw = (jnp.asarray(t.float().numpy(), jdt) for t in inputs)
    x, *w = inputs
    if mode == "xcore":
        jx = jx.reshape(b * sp, d).T
        x = x.reshape(b * sp, d).t().contiguous()
    want = _np(jt.probe(mode, jx, *jw, num_heads=heads, seq_len=seq,
                        group=1, shape=(b, sp, d)))
    monkeypatch.setattr(acp, "_core_plain", k23_tiles)
    got = acp.probe_plain(mode, x, *w, num_heads=heads, seq_len=seq,
                          shape=(b, sp, d)).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    step = (acp.qcore_step(*inputs[:6], num_heads=heads)
            if mode == "qcore" else 0.0)
    if mode in acp.UNNORMALIZED:
        # The context carries l (about S) times the normalised magnitudes:
        # held in relative norm, as chip_smoke.py's compare_norm holds it.
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= (1e-5 if dtype == "float32" else 2e-2), rel
    elif dtype == "float32":
        assert (diff <= 1e-5 + step).all(), (diff.max(), step)
    else:
        assert (diff <= 2e-2 * (1 + np.abs(want)) + step).all(), diff.max()
        assert diff.mean() <= 3e-3, diff.mean()


def test_k23_tiles_wide_takes_l_before_rounding():
    """wide rounds p / l, with l the sum of the unrounded p from its own
    pass: the model's bf16 context equals the plain core's in at least 99%
    of its elements, where rounding p before dividing by l (full's point,
    on paired heads) equals it in under 90% (sum orders may flip a
    rounding either way)."""
    rng = np.random.default_rng(5)
    b, heads, sp, hd, seq = 1, 4, 80, 16, 71
    q, k, v = (torch.from_numpy(rng.standard_normal((b, heads, sp, hd)))
               .to(torch.bfloat16) for _ in range(3))
    kw = dict(scale=hd ** -0.5, seq_len=seq, dt=torch.bfloat16)
    want = acp._core_plain("wide", q, k, v, **kw)
    same = (k23_tiles("wide", q, k, v, **kw) == want).float().mean()
    qp, kp, vp = acp._pairs(q), acp._pairs(k), acp._pairs(v)
    s = _f32(qp) @ _f32(kp).transpose(-1, -2) * hd ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    early = (_f32(p.to(torch.bfloat16)) @ _f32(vp)) / p.sum(-1, keepdim=True)
    early = early.to(torch.bfloat16).transpose(1, 2).reshape(
        b, sp, heads, hd).transpose(1, 2)
    late = (early == want).float().mean()
    assert same >= 0.99 and late < 0.9, (same, late)


def test_k23_qcore_sums_are_the_same_in_the_permuted_order():
    """The permutation is one of each 32-key step, and the exact int32
    context sums do not depend on it."""
    for base in (0, 32, 192):
        keys = sorted(qcore_key(base + i) for i in range(32))
        assert keys == list(range(base, base + 32))
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.integers(0, 128, (16, 96))).double()
    v = torch.from_numpy(rng.integers(-127, 128, (96, 24))).double()
    perm = torch.tensor([qcore_key(i) for i in range(96)])
    assert torch.equal(p[:, perm] @ v[perm], p @ v)


# ------------------------------------------------------- fragment maps --

def _ldmatrix(mem: np.ndarray, rows: list[int], trans: bool) -> np.ndarray:
    """``ldmatrix.x4`` on a flat shared memory of 16-bit elements (any
    numpy values): ``rows[l]`` the element offset lane l gives (lanes
    8i..8i+7 the rows of matrix i). Returns (32 lanes, 4 registers, 2
    elements): lane l gets row l/4, elements 2(l%4), +1 of each matrix, or
    of its transpose."""
    out = np.empty((32, 4, 2), dtype=mem.dtype)
    for i in range(4):
        m = np.stack([mem[rows[8 * i + r]:rows[8 * i + r] + 8]
                      for r in range(8)])
        if trans:
            m = m.T
        for lane in range(32):
            out[lane, i] = m[lane // 4, 2 * (lane % 4):2 * (lane % 4) + 2]
    return out


def _frag_a(a: np.ndarray) -> np.ndarray:
    """mma m16n8k16's A fragment of a 16 x 16 matrix, (32, 4, 2)."""
    out = np.empty((32, 4, 2), dtype=a.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            out[lane, i] = a[g + 8 * (i & 1), 2 * t + 8 * (i >> 1) +
                             np.arange(2)]
    return out


def _frag_b2(bm: np.ndarray) -> np.ndarray:
    """The B fragments of two neighbouring 8-column tiles of a 16 x 16 B
    (k rows, n columns), (32, 4, 2): b[0], b[1] for columns 0-7, b[2], b[3]
    for 8-15 (mma_frag.cuh's order)."""
    out = np.empty((32, 4, 2), dtype=bm.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            out[lane, i] = bm[2 * t + 8 * (i & 1) + np.arange(2),
                              g + 8 * (i >> 1)]
    return out


def _stage_slab(src: np.ndarray, rows: int, nvalid: int, cols: int,
                padded: int, ld: int) -> np.ndarray:
    """``attention_mma.cuh:stage_slab`` into a flat buffer of ``rows``
    rows of ``ld``: source row r < nvalid at columns < cols, zeros to
    ``padded``; the padding past it left as NaN (never read)."""
    dst = np.full(rows * ld, np.nan, dtype=np.float32)
    for r in range(rows):
        for c in range(padded):
            dst[r * ld + c] = src[r, c] if r < nvalid and c < cols else 0.0
    return dst


@pytest.mark.parametrize("sp,seq,hd", [(40, 33, 32), (80, 71, 16),
                                       (208, 197, 64)])
def test_k23_kt_and_head_major_slabs(sp, seq, hd):
    """kt and head-major: the slabs staged from the (D, B*S) buffers hold
    head h's k (and v, q) feature-major, zero past what is read; the
    scores' B fragments (ldmatrix.trans), V's B fragments (ldmatrix) and
    q's A fragments (ldmatrix.trans of its slab) are those of K, V and q as
    the mma tile multiplies them. The buffers' columns are tokens img*S+j,
    as the probe GEMMs' kEpSplitKT and kEpAllT write them."""
    rng = np.random.default_rng(sp + hd)
    b, heads = 2, 3
    d = heads * hd
    qkv = rng.standard_normal((b * sp, 3 * d)).astype(np.float32)
    tbuf = qkv.T.copy()  # [qT|kT|vT] (3D, B*S); kt's kT is its middle third
    ldt = b * sp
    img, h, q0 = 1, 2, 0
    kr, dhp = _ceil(sp, 16), _ceil(hd, 16)
    ldsl = kr + 8
    for masked in (True, False):
        kvalid = seq if masked else sp
        kend = _ceil(kvalid, 16)
        kslab = _stage_slab(
            tbuf[d + h * hd:d + (h + 1) * hd, img * sp:(img + 1) * sp],
            dhp, hd, kvalid, kend, ldsl)
        kh = qkv[img * sp:(img + 1) * sp, d + h * hd:d + (h + 1) * hd]
        for k0 in range(0, kend, CHUNK):
            for g in range(min(kend - k0, CHUNK) // 16):
                for c0 in range(0, dhp, 16):
                    # ldmatrix_b_rowmajor(bk, ks + k0, ldsl, c0, 16 g)
                    lanes = [c0 + (ln & 7) + (((ln >> 3) & 1) << 3)
                             for ln in range(32)]
                    got = _ldmatrix(kslab, [r * ldsl + k0 + 16 * g +
                                            ((ln >> 4) << 3)
                                            for r, ln in zip(lanes,
                                                             range(32))],
                                    True)
                    keys = k0 + 16 * g + np.arange(16)
                    bm = np.zeros((16, 16), np.float32)  # B(feature, key)
                    for n, key in enumerate(keys):
                        for kk in range(16):
                            c = c0 + kk
                            bm[kk, n] = (kh[key, c] if key < kvalid and c < hd
                                         else 0.0)
                    np.testing.assert_array_equal(got, _frag_b2(bm))
    # V's slab (head-major): B(key, feature) by ldmatrix as it lies.
    vslab = _stage_slab(
        tbuf[2 * d + h * hd:2 * d + (h + 1) * hd, img * sp:(img + 1) * sp],
        dhp, hd, seq, _ceil(seq, 16), ldsl)
    vh = qkv[img * sp:(img + 1) * sp, 2 * d + h * hd:2 * d + (h + 1) * hd]
    for k0 in range(0, _ceil(seq, 16), 16):
        for n0 in range(0, dhp, 16):
            rows = [(n0 + (ln & 7) + ((ln >> 4) << 3)) * ldsl + k0 +
                    (((ln >> 3) & 1) << 3) for ln in range(32)]
            bm = np.zeros((16, 16), np.float32)  # B(key, feature)
            for kk in range(16):
                for n in range(16):
                    key, c = k0 + kk, n0 + n
                    bm[kk, n] = vh[key, c] if key < seq and c < hd else 0.0
            np.testing.assert_array_equal(_ldmatrix(vslab, rows, False),
                                          _frag_b2(bm))
    # q's slab: the 64-token tile's A fragments by ldmatrix.trans.
    ldq = 64 + 8
    for q0 in range(0, sp, 64):
        qslab = _stage_slab(tbuf[h * hd:(h + 1) * hd,
                                 img * sp + q0:img * sp + q0 + 64],
                            dhp, hd, min(sp - q0, 64), 64, ldq)
        qh = qkv[img * sp:(img + 1) * sp, h * hd:(h + 1) * hd]
        for w in range(4):
            r0 = 16 * w
            for c0 in range(0, dhp, 16):
                rows = [(c0 + (ln & 7) + ((ln >> 4) << 3)) * ldq + r0 +
                        (((ln >> 3) & 1) << 3) for ln in range(32)]
                a = np.zeros((16, 16), np.float32)
                for i in range(16):
                    for c in range(16):
                        row, col = q0 + r0 + i, c0 + c
                        a[i, c] = qh[row, col] if row < sp and col < hd \
                            else 0.0
                np.testing.assert_array_equal(_ldmatrix(qslab, rows, True),
                                              _frag_a(a))


def test_k23_qcore_fragments():
    """qcore's s8 fragments: the codes of p packed from the score C
    fragments (tiles 0-3 of a 32-key step, columns 2t and 2t+1) are A's
    columns 4t..4t+3 and 16+4t.. at the keys ``qcore_key`` gives, and V's
    codes staged feature-major in that key order give, through ldmatrix on
    bytes, B(position, feature) = V[qcore_key(position), feature]; K's
    codes key-major give the scores' B(feature, key)."""
    rng = np.random.default_rng(9)
    kend, dhq = 64, 32
    v = rng.integers(-127, 128, (kend, dhq)).astype(np.int8)
    ldvq = kend + 16
    vq = np.zeros((dhq, ldvq), np.int8)
    for c in range(dhq):
        for pos in range(kend):
            vq[c, pos] = v[qcore_key(pos), c]
    mem = vq.reshape(-1).view(np.int16)  # 2-byte elements, as ldmatrix sees
    for k0 in range(0, kend, 32):
        # The lane's C fragments hold keys k0 + 8j + 2t + e: its A bytes.
        for lane in range(32):
            t = lane % 4
            for i in range(4):
                hb = i >> 1  # a[2], a[3] are positions 16 + 4t + u
                keys = [k0 + 16 * hb + 2 * t + (u & 1) + 8 * (u >> 1)
                        for u in range(4)]
                pos = [k0 + 16 * hb + 4 * t + u for u in range(4)]
                assert [qcore_key(p) for p in pos] == keys
        for n0 in range(0, dhq, 16):
            rows = [((n0 + (ln & 7) + ((ln >> 4) << 3)) * ldvq + k0 +
                     (((ln >> 3) & 1) << 4)) // 2 for ln in range(32)]
            got = _ldmatrix(mem, rows, False).view(np.int8).reshape(32, 4, 4)
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for i in range(4):
                    n = n0 + g + 8 * (i >> 1)
                    pos = k0 + 16 * (i & 1) + 4 * t + np.arange(4)
                    want = [v[qcore_key(p), n] for p in pos]
                    np.testing.assert_array_equal(got[lane, i], want)
    # K's codes key-major: B(feature, key) for the scores.
    k = rng.integers(-127, 128, (kend, dhq)).astype(np.int8)
    ldkq = dhq + 16
    kq = np.zeros((kend, ldkq), np.int8)
    kq[:, :dhq] = k
    mem = kq.reshape(-1).view(np.int16)
    for k0 in range(0, kend, 16):
        rows = [((k0 + (ln & 7) + ((ln >> 4) << 3)) * ldkq +
                 (((ln >> 3) & 1) << 4)) // 2 for ln in range(32)]
        got = _ldmatrix(mem, rows, False).view(np.int8).reshape(32, 4, 4)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for i in range(4):
                key = k0 + g + 8 * (i >> 1)
                feats = 16 * (i & 1) + 4 * t + np.arange(4)
                np.testing.assert_array_equal(got[lane, i], k[key, feats])


def _tidx(c: int, r: int) -> int:
    """``gemm_wgmma.cuh:probe_epilogue``'s transposed staging element."""
    return c * 64 + ((((r >> 3) ^ (c & 7))) << 3) + (r & 7)


def test_k23_probe_gemm_transposed_staging():
    """The transposed staging tile: a bijection of the warpgroup's 64 rows
    by 128 columns onto the first 8192 of its 64 x 136 elements; each
    warp's 2-byte writes (one accumulator pair element for every lane)
    touch distinct 4-byte words on distinct banks or share a word, and a
    warp's 16-byte reads (8 lanes a phase) cover 32 banks once."""
    idx = {_tidx(c, r) for c in range(128) for r in range(64)}
    assert idx == set(range(8192)) and 8192 <= 64 * 136
    for warp in range(4):
        for j in range(16):
            for h in range(2):
                for e in range(2):
                    words = {}
                    for lane in range(32):
                        c = 8 * j + 2 * (lane % 4) + e
                        r = 16 * warp + lane // 4 + 8 * h
                        word = _tidx(c, r) // 2
                        words.setdefault(word % 32, set()).add(word)
                    assert all(len(s) == 1 for s in words.values())
    for ch0 in range(0, 128 * 8, 8):  # a phase: 8 lanes, 16 bytes each
        banks = set()
        for ch in range(ch0, ch0 + 8):
            c, rc = ch // 8, ch % 8
            start = _tidx(c, 8 * rc) * 2 // 4
            banks |= {(start + w) % 32 for w in range(4)}
        assert len(banks) == 32


# ------------------------------------------------------------ the tiles --

@pytest.mark.parametrize("m,n,k,dtype,ptrs,want", [
    (1664, 3072, 768, torch.int8, (0, 4096), "wgmma"),
    (128, 128, 128, torch.int8, (0, 0), "wgmma"),
    (37, 72, 200, torch.int8, (0, 0), "wmma"),      # K not a multiple of 16
    (37, 72, 192, torch.int8, (0, 8), "wmma"),      # w 8-byte aligned only
    (1664, 3072, 768, torch.bfloat16, (0, 4096), "wgmma"),
    (37, 72, 200, torch.bfloat16, (0, 0), "wgmma"),  # multiples of 8
    (33, 70, 100, torch.bfloat16, (0, 0), "wmma"),
    (128, 128, 128, torch.float32, (0, 0), "tf32"),
    (1664, 3072, 768, torch.float32, (0, 4096), "tf32"),
    (37, 72, 200, torch.float32, (0, 0), "tf32"),     # multiples of 4
    (33, 70, 100, torch.float32, (0, 0), "ffma"),     # N not a multiple of 4
    (33, 72, 102, torch.float32, (0, 0), "ffma"),     # K not a multiple of 4
    (1664, 3072, 768, torch.float32, (0, 8), "ffma"),  # w 8-byte aligned
])
def test_k22_dot_tile(m, n, k, dtype, ptrs, want):
    assert int8_probe.dot_tile(m, n, k, dtype, ptrs) == want


@pytest.mark.parametrize("m,n,k,ptrs", [
    (1664, 3072, 768, (0, 4096)), (37, 72, 200, (16, 0)),
    (33, 70, 100, (0, 0)), (33, 72, 102, (0, 0)), (128, 128, 128, (4, 0)),
])
def test_k22_fp32_dot_takes_k2s_fp32_rule(m, n, k, ptrs):
    """K22's fp32 dot runs on K2's tf32 tile exactly where ``gemm_path``
    gives K2 in fp32 its ``wgmma`` (tf32) tile for the same contiguous
    operands, and on ``gemm_tile.cuh``'s FFMA loop where it gives
    ``"ffma"``."""
    from vit_tpu_torch.ops.cuda.matmul import gemm_path
    k2 = gemm_path(m, n, k, torch.float32, False, False, ptrs,
                   ((k, 1), (n, 1)))
    assert int8_probe.dot_tile(m, n, k, torch.float32, ptrs) == \
        {"wgmma": "tf32", "ffma": "ffma"}[k2]


@pytest.mark.parametrize("m,n,k,ptrs,want", [
    (6656, 2304, 768, (0, 0), "wgmma"),   # B/16 bs=32's QKV, kt, projonly
    (2304, 6656, 768, (0, 0), "wgmma"),   # xcore's WqkvT @ xnT
    (768, 6656, 768, (0, 0), "wgmma"),    # tcore's, xcore's WoutT @ ctxT
    (192, 120, 64, (0, 0), "wgmma"),      # D=64 at 3 x 40 tokens
    (192, 54, 64, (0, 0), "wmma"),        # 2 x 27 tokens
    (300, 100, 100, (0, 0), "wmma"),      # D=100
    (6656, 2304, 768, (0, 2), "wmma"),    # w not 16-byte aligned
])
def test_k23_gemm_tile(m, n, k, ptrs, want):
    assert acp.gemm_tile(m, n, k, torch.bfloat16, ptrs) == want
    assert acp.gemm_tile(m, n, k, torch.float32, ptrs) == "ffma"


def test_k23_core_shapes():
    """Every bf16 mode's core fits a block at B/16 (208 tokens, heads of
    64; wide's pairs 128), full's in K4's shared memory; qcore and
    head-major take heads up to 128 columns."""
    from vit_tpu_torch.ops.cuda.block import MAX_SMEM, attention_mma_smem_bytes

    for mode in CORE_MODES:
        hd = 128 if mode == "wide" else 64
        assert acp.core_smem_bytes(208, hd, 2, mode) <= MAX_SMEM, mode
    assert acp.core_smem_bytes(208, 64, 2) == attention_mma_smem_bytes(208, 64)
    assert acp.MMA_MAX_HEAD == 128
