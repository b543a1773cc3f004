"""The fp32 forms of K2 and K13 on the tensor cores: the three-pass TF32
split (``vit_tpu_torch/csrc/tf32_split.cuh``), K2's tf32 ``wgmma`` tile
(``csrc/gemm_tf32.cuh``) and K13's ``mma.sync`` tf32 form
(``csrc/flash_attention_bwd.cu``), on the CPU.

CUDA kernels do not run here, so the split is modelled in PyTorch
(``vit_tpu_torch/tools/tf32_probe.py``: hi rounded to tf32 to nearest with
ties away from zero, lo = x - hi read truncated to tf32, ``lo_a hi_b +
hi_a lo_b + hi_a hi_b`` summed in fp32) and held to JAX's Pallas
``matmul`` at fp32 (``Precision.HIGHEST``) in interpret mode and to
``reference.flash_attention_bwd``, at the kernels' fp32 bar, 1e-4. K2's
tile is modelled through its shared-memory layouts (TMA's 128-byte swizzle
of fp32 boxes, the B transposition's index map, the A fragments' loads)
and its sum order (a fresh accumulator each 32-deep K step, added to the
tile's total); the model is held to the same functions, and the map to
be a bijection without bank conflicts. What the card's accumulation does
is measured on the card (``tools/tf32_probe.py``; PERF.md section 6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops.pallas import matmul as pallas_matmul
from vit_tpu.ops.pallas import vjp as jax_vjp
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.cuda import matmul as cuda_matmul
from vit_tpu_torch.ops.cuda.embed import embed_tile
from vit_tpu_torch.tools import attn_core_probe, int8_probe
from vit_tpu_torch.tools.tf32_probe import matmul_split, split, tf32

BAR = 1e-4  # the fp32 kernels' bar against their plain versions
BM = BN = 128  # gemm_tf32.cuh: kBM, kBN
BK = 32  # kBK: one 128-byte swizzle row of fp32
CHUNK = 64  # K13's tiles


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def _max_diff(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32)) \
        if not isinstance(want, torch.Tensor) else want.float().numpy()
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max())


# ------------------------------------------------------------- rounding --

@pytest.mark.parametrize("x,want", [
    (1 + 2 ** -11, 1 + 2 ** -10),             # a tie: away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),          # a tie, odd: away
    (1 + 2 ** -11 - 2 ** -23, 1.0),           # below the tie
    (1 + 2 ** -11 + 2 ** -23, 1 + 2 ** -10),  # above it
    (3.0, 3.0), (0.0, 0.0), (2 ** -30 * 1.2, 2 ** -30 * 1.2001953125)])
def test_tf32_rounds_to_nearest_ties_away(x, want):
    """``tf32`` is ``cvt.rna.tf32.f32``: 10 stored mantissa bits, to
    nearest, ties away from zero."""
    got = tf32(torch.tensor([x], dtype=torch.float32))
    assert float(got) == np.float32(want)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.5])
def test_split_carries_21_bits(scale):
    """hi and lo as the tensor cores read them are tf32 values (low 13 bits
    zero), hi + lo is within 2^-21 |x| of x with no bias in sign (lo is
    truncated, and x - hi takes either sign), and each product of two tf32
    values is exact in fp32."""
    x = _t(scale * np.random.default_rng(3).standard_normal(4096))
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = x.double() - hi.double() - lo.double()
    assert (err.abs() <= 2 ** -21 * x.double().abs()).all()
    rel = err / x.double()
    assert abs(float(rel.mean())) < 0.1 * float(rel.abs().mean())
    assert ((x.double() - hi.double()).abs()
            <= 2 ** -11 * x.double().abs()).all()
    y_hi, y_lo = split(x.flip(0))
    for a, b in ((hi, y_hi), (hi, y_lo), (lo, y_hi)):
        exact = a.double() * b.double()
        assert torch.equal((a * b).double(), exact)


@pytest.mark.parametrize("m,k,n", [(64, 128, 136), (200, 72, 136),
                                   (37, 588, 100), (130, 260, 9),
                                   (16, 768, 64)])
def test_split_matmul_holds_the_fp32_bar_against_pallas(m, k, n):
    """The three passes against JAX's Pallas ``matmul`` at fp32 (HIGHEST)
    in interpret mode and against float64 within the fp32 bar; one TF32
    pass misses it, which is why the forms split."""
    rng = np.random.default_rng(m + k + n)
    xa, wa = rng.standard_normal((m, k)), 0.05 * rng.standard_normal((k, n))
    want = pallas_matmul.matmul(jnp.asarray(xa, jnp.float32),
                                jnp.asarray(wa, jnp.float32), interpret=True)
    got = matmul_split(_t(xa), _t(wa))
    assert _max_diff(got, want) <= BAR
    assert float((got.double() - torch.from_numpy(xa @ wa)).abs().max()) \
        <= BAR
    one = matmul_split(_t(xa), _t(wa), passes=1)
    assert _max_diff(one, want) > BAR


# ------------------------------------------------------- K2's tf32 tile --

def sw(r, c):
    """fp32 index of element (r, c) of a 128-byte-swizzled box of rows of
    32 floats: ``tf32_split.cuh:sw128_f32`` in float units."""
    r, c = np.asarray(r), np.asarray(c)
    return r * 32 + ((((c >> 2) ^ r) & 7) << 2) + (c & 3)


def convert_b_map(tb: bool):
    """The converters' map of one stage (``gemm_tf32.cuh:convert_b``): for
    each of the 96 threads' steps, (thread, step, read index in the raw B
    box, write index in hi / lo), float units; the 16-byte accesses as
    the index of their first float."""
    rows = []
    for j in range(96):
        if tb:
            for it, c in enumerate(range(j, 1024, 96)):
                rows.append((j, it, "load", 4 * c, 4 * c))
                rows.append((j, it, "store", 4 * c, 4 * c))
            continue
        for it, blk in enumerate(range(j, 256, 96)):
            grp, u = blk >> 3, blk & 7
            k4, n4 = u, 8 * (grp >> 3) + (u ^ (grp & 7))
            for i in range(4):
                rows.append((j, it, f"load{i}",
                             (n4 >> 3) * 1024 + int(sw(4 * k4 + i,
                                                       4 * (n4 & 7))),
                             (4 * k4 + i, 4 * n4)))
            for jj in range(4):
                rows.append((j, it, f"store{jj}",
                             int(sw(4 * n4 + jj, 4 * k4)),
                             (4 * n4 + jj, 4 * k4)))
    return rows


def raw_b_element(tb: bool, idx: int) -> tuple[int, int]:
    """(k, n) of the raw B box's float ``idx``: TB one 128 x 32 box of the
    (N, K) matrix, else four 32 x 32 boxes of w (K, N)."""
    if tb:
        n, within = divmod(idx, 32)
        return (((within >> 2) ^ n) & 7) * 4 + (within & 3), n
    box, rest = divmod(idx, 1024)
    k, within = divmod(rest, 32)
    return k, 32 * box + ((((within >> 2) ^ k) & 7) * 4 + (within & 3))


@pytest.mark.parametrize("tb", [False, True])
def test_k2_b_conversion_is_a_bijection(tb):
    """Every raw B float is read once and every (n, k) of the K-major hi
    and lo boxes written once, with the value of (k, n): the descriptor
    reads B(k, n) at ``sw(n, k)``."""
    reads, writes = [], {}
    for j, it, what, idx, _ in convert_b_map(tb):
        if what.startswith("load"):
            reads += range(idx, idx + 4)
    assert sorted(reads) == list(range(4096))
    if tb:
        for j, it, what, idx, _ in convert_b_map(tb):
            if what == "store":
                for e in range(4):
                    writes[idx + e] = raw_b_element(tb, idx + e)
    else:
        for j, it, what, idx, (n, k0) in convert_b_map(tb):
            if what.startswith("store"):
                for e in range(4):
                    # store jj holds v[0..3][jj]: K rows k0 .. k0 + 3 of n
                    assert idx + e not in writes
                    writes[idx + e] = (k0 + e, n)
        for j, it, what, idx, (k, n0) in convert_b_map(tb):
            if what.startswith("load"):
                got = [raw_b_element(tb, idx + e) for e in range(4)]
                assert got == [(k, n0 + e) for e in range(4)]
    assert sorted(writes) == list(range(4096))
    for idx, (k, n) in writes.items():
        assert int(sw(n, k)) == idx


@pytest.mark.parametrize("tb", [False, True])
def test_k2_b_conversion_has_no_bank_conflict(tb):
    """Each 16-byte shared access of a warp is served in four phases of
    eight lanes: in every phase the eight lanes' chunks lie in eight
    distinct 16-byte bank groups of a 128-byte row."""
    phases = {}
    for j, it, what, idx, _ in convert_b_map(tb):
        phases.setdefault((j // 8, it, what), []).append(idx)
    for key, idxs in phases.items():
        groups = [(i // 4) % 8 for i in idxs]
        assert len(idxs) <= 8 and len(set(groups)) == len(groups), key


def a_fragment_index(ta: bool, r: int, c: int) -> int:
    """Float index in the raw A box of A's element (row r, K column c), as
    ``gemm_tf32.cuh:load_a`` reads it: TA four 32 x 32 boxes of x (K, M),
    else one 128 x 32 box of x (M, K)."""
    if ta:
        return (r >> 5) * 1024 + int(sw(c, r & 31))
    return int(sw(r, c))


def test_k2_a_fragments_have_few_bank_conflicts():
    """A warp's A fragment loads (32 lanes, 4-byte words): 32 distinct
    banks on x as it lies, at most two lanes a bank on the x.t() view."""
    for ta, most in ((False, 1), (True, 2)):
        for warp in range(8):
            for s in range(BK // 8):
                for i in range(4):
                    banks = []
                    for lane in range(32):
                        g, q = lane // 4, lane % 4
                        r = 16 * warp + g + 8 * (i & 1)
                        c = 8 * s + q + 4 * (i >> 1)
                        banks.append(a_fragment_index(ta, r, c) % 32)
                    assert max(banks.count(b) for b in banks) <= most


def k2_tf32_tile(x, w, bias, act, res):
    """K2's fp32 tile on the CPU: each 128 x 128 output tile, K in steps of
    32 through the raw boxes as TMA lays them out (zeros past M, N and K),
    B converted to hi and lo by ``convert_b``'s map and read K-major, A's
    fragments loaded from the raw box and split, each step summed into a
    fresh fp32 accumulator (three passes) and added to the tile's total,
    then the epilogue in fp32. x and w may be ``.t()`` views, read where
    they lie."""
    ta, tb = cuda_matmul._transposed(x), cuda_matmul._transposed(w)
    m, k = x.shape
    n = w.shape[1]
    xs = x.t() if ta else x  # the storage: (k, m) or (m, k)
    ws = w.t() if tb else w  # (n, k) or (k, n)
    conv = convert_b_map(tb)
    loads = [r for r in conv if r[2].startswith("load")]
    stores = [r for r in conv if r[2].startswith("store")]
    out = torch.zeros(m, n)
    for m0 in range(0, m, BM):
        for n0 in range(0, n, BN):
            total = torch.zeros(BM, BN)
            for k0 in range(0, k, BK):
                raw_a = torch.zeros(4096)
                raw_b = torch.zeros(4096)
                for idx in range(4096):
                    if ta:
                        kk, mm = raw_b_element(False, idx)  # same boxes
                        if k0 + kk < k and m0 + mm < m:
                            raw_a[idx] = xs[k0 + kk, m0 + mm]
                    else:
                        mm, within = divmod(idx, 32)
                        kk = (((within >> 2) ^ mm) & 7) * 4 + (within & 3)
                        if m0 + mm < m and k0 + kk < k:
                            raw_a[idx] = xs[m0 + mm, k0 + kk]
                    kk, nn = raw_b_element(tb, idx)
                    if k0 + kk < k and n0 + nn < n:
                        raw_b[idx] = ws[n0 + nn, k0 + kk] if tb \
                            else ws[k0 + kk, n0 + nn]
                hi, lo = torch.zeros(4096), torch.zeros(4096)
                vals = {}
                for j, it, what, idx, _ in loads:
                    vals[(j, it, what)] = raw_b[idx:idx + 4]
                for j, it, what, idx, _ in stores:
                    if tb:
                        v = vals[(j, it, "load")]
                    else:
                        jj = int(what[-1])
                        v = torch.stack([vals[(j, it, f"load{i}")][jj]
                                         for i in range(4)])
                    h, l_ = split(v)
                    hi[idx:idx + 4], lo[idx:idx + 4] = h, l_
                rr, cc = np.meshgrid(np.arange(BN), np.arange(BK),
                                     indexing="ij")
                bh = hi[torch.from_numpy(sw(rr, cc))].t()  # (BK, BN)
                bl = lo[torch.from_numpy(sw(rr, cc))].t()
                ai = torch.tensor([[a_fragment_index(ta, r, c)
                                    for c in range(BK)] for r in range(BM)])
                ah, al = split(raw_a[ai])
                part = (torch.matmul(al, bh) + torch.matmul(ah, bl)) \
                    + torch.matmul(ah, bh)
                total = total + part
            rows, cols = min(BM, m - m0), min(BN, n - n0)
            out[m0:m0 + rows, n0:n0 + cols] = total[:rows, :cols]
    if bias is not None:
        out = out + bias
    if act == "gelu":
        out = torch.nn.functional.gelu(out)
    if res is not None:
        out = out + res
    return out


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
@pytest.mark.parametrize("m,k,n", [(136, 72, 140), (20, 40, 8)])
def test_k2_tf32_tile_model_matches_reference_and_pallas(ta, tb, m, k, n):
    """The tile model on every operand layout, ragged against the 128 x
    128 tile and the 32-deep K step, every epilogue, against
    ``reference.matmul`` and JAX's Pallas ``matmul`` in interpret mode, at
    the fp32 bar."""
    rng = np.random.default_rng(7 * m + n)
    xa, wa = rng.standard_normal((m, k)), 0.05 * rng.standard_normal((k, n))
    ba, ra = 0.1 * rng.standard_normal(n), rng.standard_normal((m, n))
    x = _t(xa.T).contiguous().t() if ta else _t(xa)
    w = _t(wa.T).contiguous().t() if tb else _t(wa)
    assert cuda_matmul._transposed(x) == ta
    assert cuda_matmul._transposed(w) == tb
    bias = _t(ba)
    for act, res in ((None, None), ("gelu", None), (None, _t(ra))):
        got = k2_tf32_tile(x, w, bias, act, res)
        assert _max_diff(got, reference.matmul(x, w, bias, act, res)) <= BAR
        if res is None:
            want = pallas_matmul.matmul(
                jnp.asarray(xa, jnp.float32), jnp.asarray(wa, jnp.float32),
                jnp.asarray(ba, jnp.float32), act, interpret=True)
            assert _max_diff(got, want) <= BAR


# ---------------------------------------------------------- gemm_path --

@pytest.mark.parametrize("m,k,n,ta,tb", [
    (6656, 768, 2304, False, False),  # the QKV
    (6656, 2304, 768, False, True),   # g @ w.t()
    (768, 6656, 2304, True, False),   # x.t() @ g
    (588, 512, 1280, True, False),    # H/14's patch rows: 588 floats
    (1, 768, 1000, False, True),
    (768, 1, 1000, True, False)])     # x.t() of a one-row x
def test_gemm_path_sends_fp32_views_to_the_tf32_tile(m, k, n, ta, tb):
    """fp32 operands given as ``.t()`` views of contiguous matrices go to
    the tf32 ``wgmma`` tile as they lie: no copy, the storage's own
    pointer, the transpose flag set."""
    x = torch.zeros((k, m)).t() if ta else torch.zeros((m, k))
    w = torch.zeros((n, k)).t() if tb else torch.zeros((k, n))
    xs, ws, got_ta, got_tb, path = cuda_matmul.k2_operands(x, w, m, k)
    assert path == "wgmma"
    assert (got_ta, got_tb) == (cuda_matmul._transposed(x),
                                cuda_matmul._transposed(w))
    assert xs.data_ptr() == x.data_ptr() and ws.data_ptr() == w.data_ptr()


@pytest.mark.parametrize("ptrs,strides,trans,path", [
    ((0, 0), ((768, 1), (2304, 1)), (False, False), "wgmma"),
    ((4, 0), ((768, 1), (2304, 1)), (False, False), "ffma"),   # x + 4 B
    ((0, 48), ((768, 1), (2304, 1)), (False, False), "wgmma"),
    ((0, 0), ((588, 1), (2304, 1)), (False, False), "wgmma"),  # lda 588
    ((0, 0), ((590, 1), (2304, 1)), (False, False), "ffma"),   # lda 590
    ((0, 0), ((768, 1), (1, 100)), (False, True), "wgmma"),
    ((0, 0), ((1, 102), (1, 768)), (True, True), "ffma"),      # lda 102
    ((0, 8), ((1, 104), (1, 768)), (True, True), "ffma")])
def test_gemm_path_fp32_by_alignment(ptrs, strides, trans, path):
    """The tf32 tile needs both bases 16-byte aligned and both storage row
    strides multiples of 4 floats (16 bytes); anything else takes the
    FFMA tile, whose operands the wrapper copies contiguous."""
    assert cuda_matmul.gemm_path(104, 2304, 768, torch.float32, *trans,
                                 ptrs, strides) == path


def test_unaligned_fp32_views_are_copied_for_the_ffma_tile():
    x = torch.zeros((64, 37)).t()  # rows of 37 floats
    w = torch.zeros((64, 40))
    xs, ws, ta, tb, path = cuda_matmul.k2_operands(x, w, 37, 64)
    assert path == "ffma" and (ta, tb) == (False, False)
    assert xs.is_contiguous() and xs.data_ptr() != x.data_ptr()


def test_the_other_fp32_forms_stay_on_gemm_tile():
    """K23's fp32 GEMMs keep ``gemm_tile.cuh``'s FFMA tile in this form of
    the port; its tile helper says so where K2's rule would give K2 the
    tf32 tile. K8's and K22's fp32 forms left it: they take K2's rule, the
    tf32 tile on aligned operands, FFMA only on a misaligned base."""
    p = torch.zeros((2, 196, 768))
    w = torch.zeros((768, 768))
    assert embed_tile(p, w) == "wgmma"
    assert embed_tile(p.bfloat16(), w.bfloat16()) == "wgmma"
    off = torch.zeros(2 * 196 * 768 + 1)[1:].view(2, 196, 768)
    assert embed_tile(off, w) == "ffma"
    assert attn_core_probe.gemm_tile(6656, 2304, 768, torch.float32,
                                     (0, 0)) == "ffma"
    assert int8_probe.dot_tile(1664, 3072, 768, torch.float32,
                               (0, 0)) == "tf32"
    assert int8_probe.dot_tile(1664, 3072, 768, torch.float32,
                               (0, 4)) == "ffma"
    assert cuda_matmul.gemm_path(1664, 3072, 768, torch.float32, False,
                                 False, (0, 0), ((768, 1), (3072, 1))) \
        == "wgmma"


# --------------------------------------------------- K13's tf32 form --

def k13_split_tiles(q, k, v, g, *, scale: float, seq_len: int):
    """K13's fp32 form on the CPU: the bf16 form's two launches and 64-row
    tiles (``tests/test_torch_attention_tiles.py:k13_tiles``) with every
    product through the split: pass 1's s = q k^T and o += p v online,
    delta = g . o / l; then p, dp = g v^T, ds and dq += ds k over the key
    tiles, and dv += p^T g, dk += ds^T q over the query tiles."""
    s_len = q.shape[2]
    m = torch.full(q.shape[:3] + (1,), float("-inf"))
    l_ = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0 in range(0, seq_len, CHUNK):
        kc, vc = k[:, :, k0:k0 + CHUNK], v[:, :, k0:k0 + CHUNK]
        s = matmul_split(q, kc.transpose(-1, -2)) * scale
        keep = torch.arange(k0, k0 + kc.shape[2]) < seq_len
        s = s.masked_fill(~keep, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_ = l_ * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + matmul_split(p, vc)
        m = m_new
    delta = (g * o).sum(-1, keepdim=True) / l_

    def tile(q0, k0):
        rows = slice(q0, q0 + CHUNK)
        kc, vc = k[:, :, k0:k0 + CHUNK], v[:, :, k0:k0 + CHUNK]
        s = matmul_split(q[:, :, rows], kc.transpose(-1, -2)) * scale
        keep = torch.arange(k0, k0 + kc.shape[2]) < seq_len
        p = torch.where(keep, torch.exp(s - m[:, :, rows]) / l_[:, :, rows],
                        torch.zeros(()))
        dp = matmul_split(g[:, :, rows], vc.transpose(-1, -2))
        return p, p * (dp - delta[:, :, rows])

    dq, dk, dv = (torch.zeros(q.shape) for _ in range(3))
    for q0 in range(0, s_len, CHUNK):
        for k0 in range(0, seq_len, CHUNK):
            p, ds = tile(q0, k0)
            keys = slice(k0, k0 + CHUNK)
            dq[:, :, q0:q0 + CHUNK] += matmul_split(ds, k[:, :, keys])
            dk[:, :, keys] += matmul_split(ds.transpose(-1, -2),
                                           q[:, :, q0:q0 + CHUNK])
            dv[:, :, keys] += matmul_split(p.transpose(-1, -2),
                                           g[:, :, q0:q0 + CHUNK])
    return torch.stack([t.transpose(1, 2) for t in
                        (dq * scale, dk * scale, dv)], 2)


@pytest.mark.parametrize("hd", [16, 64, 80])
@pytest.mark.parametrize("s,seq_len", [(80, 71), (130, 64), (208, 197)])
def test_k13_split_matches_reference_and_pallas(hd, s, seq_len):
    """K13's fp32 form modelled with the split against
    ``reference.flash_attention_bwd`` and ``jax.vjp`` of
    ``vjp.py:attention`` in interpret mode, within the fp32 bar; the
    masked keys' dk and dv are zero."""
    rng = np.random.default_rng(hd + s)
    q, k, v, g = (rng.standard_normal((1, 2, s, hd)).astype(np.float32)
                  for _ in range(4))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    scale = hd ** -0.5
    got = k13_split_tiles(tq, tk, tv, tg, scale=scale, seq_len=seq_len)
    want = reference.flash_attention_bwd(tq, tk, tv, tg, scale=scale,
                                         seq_len=seq_len)
    assert _max_diff(got, want) <= BAR
    _, vjp_fn = jax.vjp(
        lambda *a: jax_vjp.attention(*a, None, seq_len, True),
        *(jnp.asarray(a) for a in (q, k, v)))
    for gt, w in zip(reference.split_qkv(got), vjp_fn(jnp.asarray(g))):
        assert _max_diff(gt, w) <= BAR
    _, dk, dv = reference.split_qkv(got)
    assert not dk[:, :, seq_len:].any() and not dv[:, :, seq_len:].any()


# ---------------------------------------- K13's operands for tf32 wgmma --

def k13_wg_block(e: int, hd: int):
    """(q, c, par) of block e of a streamed tile (``flash_attention_bwd.cu:
    wg_block``): tile rows 8c + par + {0, 2, 4, 6}, columns 4q .. 4q + 3."""
    nq = hd // 4
    qb = nq.bit_length() - 1
    u0, u1, u2, w = e & 1, (e >> 1) & 1, (e >> 2) & 1, e >> 3
    q = u0 + 2 * (u1 ^ (w & 1)) + 4 * (u2 ^ ((w >> 1) & 1)) \
        + 8 * ((w >> 2) & (nq // 8 - 1))
    return q, u2 + 2 * (w >> (qb - 1)), u1


def k13_wg_stores(e: int, hd: int):
    """Block e's 16-byte stores, (kind, index, byte offset in its box,
    the tile elements (row, column) it holds)."""
    q, c, par = k13_wg_block(e, hd)
    out = []
    for i in range(4):
        row = 8 * c + par + 2 * i
        off = (q >> 3) * 64 * 128 + 4 * int(sw(row, 4 * (q & 7)))
        out.append(("nat", i, off, [(row, 4 * q + j) for j in range(4)]))
    col = (8 * c + 4 * par) & 31
    for j in range(4):
        off = (c >> 2) * hd * 128 + 4 * int(sw(4 * q + j, col))
        out.append(("tr", j, off, [(8 * c + par + 2 * i, 4 * q + j)
                                   for i in range(4)]))
    return out


@pytest.mark.parametrize("hd", [32, 64])
def test_k13_wg_operand_maps(hd):
    """The blocks cover the 64 x hd tile once; the box as it lies holds
    (r, k) where the K-major descriptor reads it, (k / 32) 64 * 128 +
    sw(r, k % 32); the transposed box holds tile row 8c + 2i + par at K
    position 8c + i + 4 par of row k, so that a C tile's A fragment in the
    permuted order (k positions t, t + 4 = columns 2t, 2t + 1) meets the
    rows it multiplies."""
    blocks = [k13_wg_block(e, hd) for e in range(16 * hd // 4)]
    assert len(set(blocks)) == len(blocks) == 4 * hd
    nat, tr = {}, {}
    for e in range(len(blocks)):
        for kind, _, off, elems in k13_wg_stores(e, hd):
            box = nat if kind == "nat" else tr
            for x, el in enumerate(elems):
                assert off + 4 * x not in box
                box[off + 4 * x] = el
    assert len(nat) == len(tr) == 64 * hd
    for (r, k) in [(r, k) for r in range(64) for k in range(hd)]:
        assert nat[(k // 32) * 64 * 128 + 4 * int(sw(r, k % 32))] == (r, k)
    for k in range(hd):
        for p in range(64):
            c, rest = divmod(p, 8)
            i, par = rest % 4, rest // 4
            got = tr[(p // 32) * hd * 128 + 4 * int(sw(k, p % 32))]
            assert got == (8 * c + 2 * i + par, k)
    # The permuted order is the one tf32_a_of_c gives its A fragment: K
    # position 8c + t holds C column 8c + 2t, 8c + t + 4 column 8c + 2t + 1;
    # the transposed box's position p holds that same tile row.
    for p in range(64):
        c, rest = divmod(p, 8)
        col = 8 * c + 2 * (rest % 4) + rest // 4
        got = tr[(p // 32) * hd * 128 + 4 * int(sw(0, p % 32))]
        assert got[0] == col


@pytest.mark.parametrize("hd", [32, 64])
def test_k13_wg_stores_have_no_bank_conflict(hd):
    """Each 16-byte store of a warp runs in four phases of eight lanes; in
    every phase the eight chunks lie in distinct 16-byte bank groups."""
    nblocks = 16 * hd // 4
    for p0 in range(0, nblocks, 8):
        stores = [k13_wg_stores(e, hd) for e in range(p0, p0 + 8)]
        for s_ in range(8):
            groups = [(st[s_][2] // 16) % 8 for st in stores]
            assert len(set(groups)) == 8, (hd, p0, s_)


# ------------------------------------------------------ the SASS check --

def test_sass_count_compares_instructions_not_padding():
    """``tools/sass_count.py``'s comparison, which holds every kernel but
    the two fp32 forms to the parent's build: cuobjdump pads a unit's
    columns to its widest line, so padding is ignored; ``--exact`` keeps
    the encodings, the default masks kernel-parameter offsets."""
    from vit_tpu_torch.tools.sass_count import _norm

    a = ["        /*0000*/    LDC R1, c[0x0][0x28] ;      "
         "/* 0x00000a00ff017b82 */ "]
    b = ["        /*0000*/    LDC R1, c[0x0][0x28] ;   "
         "/* 0x00000a00ff017b82 */"]
    assert _norm(a, True) == _norm(b, True)
    c = ["  /*1230*/ @P0 LDC.64 R4, c[0x0][0x390] ; /* 0x0000e400ff040b82 */"]
    d = ["  /*1230*/ @P0 LDC.64 R4, c[0x0][0x398] ; /* 0x0000e600ff040b82 */"]
    assert _norm(c, False) == _norm(d, False)
    assert _norm(c, True) != _norm(d, True)
    e = ["  /*1230*/ @P0 LDC.64 R6, c[0x0][0x390] ; /* 0x0000e400ff060b82 */"]
    assert _norm(c, False) != _norm(e, False)
