"""K3's fp32 tile on the tensor cores (``csrc/mlp_tf32.cuh``) modelled on
the CPU: its sums in PyTorch (the three-pass TF32 split of
``tools/tf32_probe.py``; fc1 over K = D in one accumulator, or in
accumulators of K = 128 past D = 1024; fc2's 128-column hidden chunks
each in a fresh accumulator added in order; h unrounded; LN(x) in fp32)
against ``reference.mlp_block`` and JAX's Pallas ``mlp_block`` in
interpret mode at the fp32 bar; its shared-memory maps (the weight
fragments, the permuted K slots of LN(x) and h, the fc2 sums' columns)
byte for byte, with the banks each warp instruction touches; the form
helper and the budgets of every geometry ``mlp_plan`` admits in fp32.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops.pallas import block as pallas_block
from vit_tpu_torch import ops
from vit_tpu_torch.config import VARIANTS
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.cuda import block as cuda_block
from vit_tpu_torch.tools.tf32_probe import matmul_split

BAR = 1e-4
CT = 128  # hidden columns a chunk
#: The tile's forms (``csrc/mlp_block_tf32.cu``'s launches): rows a block
#: and the 128-column output groups its consumers hold in registers.
FORMS = ((32, 2), (32, 4), (32, 6), (16, 8), (16, 12))


def tile_for(d):
    """``(BM, G)`` the launcher takes at width ``d``: the first form whose
    G holds the ``ceil(d / 128)`` groups."""
    groups = -(-d // 128)
    for bm, g in FORMS:
        if groups <= g:
            return bm, g
    raise ValueError(f"the tf32 tile takes D <= 1536, got {d}")


def smem_for(bm):
    """``(bytes, weight stages)`` of the tile's shared memory at ``bm``
    rows a block (``mlp_tf32.cuh:Cfg``): four x stages (raw, hi, lo), two h
    buffers, LN's parameters at the largest width, the row statistics and
    the barriers, then as many 16 KB weight stages as fit (at most 8), and
    1024 bytes to align the base."""
    x_box = bm * 128
    fixed = 4 * 3 * x_box + 2 * 8 * x_box + 2 * 1536 * 4 + 2 * bm * 4 + 256
    stages = min(8, (cuda_block.MAX_SMEM - 1024 - fixed) // 16384)
    return stages * 16384 + fixed + 1024, stages


def perm8(u):
    """``mlp_tf32.cuh:perm8``: slot u of a k8 slice holds k = perm8(u)."""
    return ((u & 3) << 1) | (u >> 2)


def slot8(k):
    return (k >> 1) | ((k & 1) << 2)


def sw(r, c):
    """fp32 index of (r, c) in a 128-byte-swizzled box of rows of 32
    floats (``tf32_split.cuh:sw128_f32`` in float units)."""
    r, c = np.asarray(r), np.asarray(c)
    return r * 32 + ((((c >> 2) ^ r) & 7) << 2) + (c & 3)


# ------------------------------------------------------------- the sums --

def k3_tf32_model(x, g, b, w1, b1, w2, b2, *, eps=1e-12, partial=False):
    """The tile's arithmetic on (M, D) fp32 rows: row statistics in two
    passes, LN(x) in fp32; per 128-column hidden chunk, fc1 over K = D, a
    three-pass split product in one accumulator up to D = 1024 (the forms
    of G <= 8 groups), past it in accumulators of K = 128 each added to
    the chunk's total (the first starts it); GELU(h + b1) unrounded; then
    fc2 over the chunk (K = 128) in one accumulator, added to the totals,
    which start at x + b2 (zero for the partial form)."""
    x, g, b, w1, b1, w2, b2 = (t.float() for t in (x, g, b, w1, b1, w2, b2))
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps)
    xn = (x - mean) * rstd * g + b
    d, mlp = w1.shape
    step = CT if tile_for(d)[1] > 8 else d
    tot = torch.zeros_like(x) if partial else x + b2
    for c0 in range(0, mlp, CT):
        hacc = None
        for k0 in range(0, d, step):
            part = matmul_split(xn[:, k0:k0 + step],
                                w1[k0:k0 + step, c0:c0 + CT])
            hacc = part if hacc is None else hacc + part
        h = reference.gelu(hacc + b1[c0:c0 + CT])
        tot = tot + matmul_split(h, w2[c0:c0 + CT])
    return tot


def _arrays(seed, m, d, mlp):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)) * 1.5 + 0.2,
            1 + 0.1 * rng.standard_normal(d), 0.05 * rng.standard_normal(d),
            0.03 * rng.standard_normal((d, mlp)),
            0.02 * rng.standard_normal(mlp),
            0.03 * rng.standard_normal((mlp, d)),
            0.02 * rng.standard_normal(d))


def _torch(arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


@pytest.mark.parametrize("m,d,mlp,partial", [
    (37, 200, 300, False),    # ragged: D and mlp past their last step
    (70, 128, 256, True),     # the partial form, two row tiles
    (33, 1280, 384, False),   # H/14's width (16-row form)
    (40, 768, 1536, True),    # the TP shard of B/16 over model=2
])
def test_model_matches_the_plain_version(m, d, mlp, partial):
    t = _torch(_arrays(m + d + mlp, m, d, mlp))
    got = k3_tf32_model(*t, partial=partial)
    want = reference.mlp_block(*t, eps=1e-12, partial_out=partial)
    assert float((got - want).abs().max()) <= BAR
    # One TF32 pass is what the split exists to avoid: it misses the bar.
    one = _one_pass(*t, partial=partial)
    assert float((one - want).abs().max()) > BAR


def _one_pass(x, g, b, w1, b1, w2, b2, *, partial):
    def mm(a, w):
        return matmul_split(a, w, passes=1)
    xn = reference.layernorm(x, g, b, eps=1e-12)
    h = reference.gelu(mm(xn, w1) + b1)
    return mm(h, w2) + (0 if partial else x + b2)


@pytest.mark.parametrize("partial", [False, True])
def test_model_matches_pallas_with_the_plan_pinned(monkeypatch, partial):
    """JAX's fp32 kernel at B/16's widths with ``VIT_TPU_MLP_PLAN``
    pinned (its tuned entry drops hidden columns at bs=1, ROADMAP C1;
    ``tests/test_torch_mlp_pin.py``)."""
    monkeypatch.setenv("VIT_TPU_MLP_PLAN", "0,1,512")
    arrays = _arrays(7, 208, 768, 3072)
    want = np.asarray(pallas_block.mlp_block(
        *(jnp.asarray(a, jnp.float32) for a in arrays), eps=1e-12,
        partial_out=partial, interpret=True))
    got = k3_tf32_model(*_torch(arrays), partial=partial).numpy()
    assert np.abs(got - want).max() <= BAR


# ------------------------------------------------- shared-memory maps --

def load_w_index(wgi, warp, lane, s, second):
    """Float index, in a weight stage (four 32 x 32 boxes), of the 8-byte
    load ``load_w`` issues for slice s (``second``: slots t + 4), and the
    (k, i) it reads first (i + 1 is the second float)."""
    g, q = lane // 4, lane % 4
    col = 64 * wgi + 16 * warp + 2 * g
    k = 8 * s + perm8(q + 4 * second)
    return (col >> 5) * 1024 + int(sw(k, col & 31)), k, col


@pytest.mark.parametrize("wgi", [0, 1])
def test_weight_fragments_read_the_permuted_rows_and_slots(wgi):
    """A fragment value a[i] of warp w's lane (g, t) in slice s is
    W(k = 8 s + perm8(t + 4 (i // 2)), column 64 wgi + 16 w + 2 g + i % 2)
    -- row g (i even) or g + 8 of the warp's 16 is column 2 g or 2 g + 1,
    as the accumulator's rows are read back -- so that the warpgroup's
    64 x 8 A is W[slice, the rows' columns] with both orders permuted."""
    stage = np.arange(4 * 1024, dtype=np.int64)  # index = value
    seen = set()
    for warp in range(4):
        for lane in range(32):
            g, q = lane // 4, lane % 4
            for s in range(4):
                for second in (0, 1):
                    idx, k, col = load_w_index(wgi, warp, lane, s, second)
                    assert idx % 2 == 0  # 8-byte aligned
                    for half in (0, 1):
                        want = (col + half) // 32 * 1024 + int(
                            sw(k, (col + half) % 32))
                        assert stage[idx + half] == want
                        seen.add((k, col + half))
                    assert k == 8 * s + perm8(q + 4 * second)
    # Every (k, column) of the warpgroup's half of the stage, once.
    assert seen == {(k, c) for k in range(32)
                    for c in range(64 * wgi, 64 * wgi + 64)}


def wavefronts(addrs, width):
    """Shared-memory wavefronts of one warp instruction whose lanes access
    ``width`` bytes at byte addresses ``addrs``: 8-byte accesses go in
    two half-warp phases, 16-byte ones in four quarter-warp phases; a
    phase takes as many wavefronts as the most distinct 4-byte words it
    asks of one bank."""
    per = {4: 32, 8: 16, 16: 8}[width]
    total = 0
    for p0 in range(0, 32, per):
        banks: dict[int, set[int]] = {}
        for a in addrs[p0:p0 + per]:
            for w in range(a // 4, (a + width) // 4):
                banks.setdefault(w % 32, set()).add(w)
        total += max(len(v) for v in banks.values())
    return total


def test_weight_fragment_loads_take_two_wavefronts():
    """Each 8-byte load instruction of ``load_w`` reads 256 bytes in two
    wavefronts, the least there can be: in each half-warp phase the four
    rows' swizzles spread the 128 bytes over all 32 banks."""
    for wgi in (0, 1):
        for warp in range(4):
            for s in range(4):
                for second in (0, 1):
                    addrs = [4 * load_w_index(wgi, warp, lane, s, second)[0]
                             for lane in range(32)]
                    assert wavefronts(addrs, 8) == 2


def test_ln_boxes_hold_the_permuted_slots_without_bank_conflicts():
    """``normalize_box``: unit u (row u / 4, slice u % 4) writes LN(x)'s
    columns 8 s + (0 2 4 6) and 8 s + (1 3 5 7) into the 16-byte chunks at
    slots 8 s .. + 3 and 8 s + 4 .. + 7, so that B's slot p of row n is
    LN(x)[n, 8 (p // 8) + perm8(p % 8)]; every (row, slot) once; the eight
    lanes of each quarter-warp phase of its loads and stores hit eight
    distinct chunks."""
    for bm in (32, 16):
        box = {}
        for u in range(4 * bm):
            n, s = u // 4, u % 4
            for half, ks in ((0, (0, 2, 4, 6)), (1, (1, 3, 5, 7))):
                for e, k in enumerate(ks):
                    idx = int(sw(n, 8 * s + 4 * half + e))
                    assert idx not in box
                    box[idx] = (n, 8 * s + k)
        assert len(box) == bm * 32
        for n in range(bm):
            for p in range(32):
                assert box[int(sw(n, p))] == (n, 8 * (p // 8) + perm8(p % 8))
        # Helper j's units are j, j + 96: a warp's lanes take 32
        # consecutive units from a multiple of 32.
        for j0 in range(0, 96, 32):
            for it in range(0, 4 * bm, 96):
                for chunk in (0, 4):
                    addrs = []
                    for lane in range(32):
                        u = j0 + lane + it
                        u = u if u < 4 * bm else 0
                        addrs.append(4 * int(sw(u // 4, 8 * (u % 4) + chunk)))
                    assert wavefronts(addrs, 16) == 4


def h_store_index(wgi, warp, lane, j, i2, i1):
    """(box, float index in the box, row n, hidden column kh of the
    chunk) of the h value a consumer stores for accumulator value
    4 j + 2 i2 + i1."""
    g, q = lane // 4, lane % 4
    kh = 64 * wgi + 16 * warp + 2 * g + i2
    n = 8 * j + 2 * q + i1
    p = (kh & 24) + slot8(kh & 7)
    return kh >> 5, int(sw(n, p)), n, kh


@pytest.mark.parametrize("bm", [32, 16])
def test_h_slots_match_fc2s_reads(bm):
    """Every (row, hidden column) of a chunk's h is stored once, and fc2's
    step st reads B slot 8 s + u of row n as h[n, 32 st + 8 s +
    perm8(u)] -- the hidden row its A fragment's slot u holds (W2's row
    32 st + 8 s + perm8(u), ``load_w``)."""
    where = {}
    for wgi in (0, 1):
        for warp in range(4):
            for lane in range(32):
                for j in range(bm // 8):
                    for i2 in (0, 1):
                        for i1 in (0, 1):
                            box, idx, n, kh = h_store_index(
                                wgi, warp, lane, j, i2, i1)
                            assert (box, idx) not in where
                            where[(box, idx)] = (n, kh)
    assert len(where) == bm * CT
    for st in range(4):
        for n in range(bm):
            for s in range(4):
                for u in range(8):
                    assert where[(st, int(sw(n, 8 * s + u)))] == \
                        (n, 32 * st + 8 * s + perm8(u))


def test_h_stores_take_at_most_two_wavefronts():
    """The consumers' h stores (4 bytes a lane): four rows of eight lanes
    meet in 16 banks, two wavefronts an instruction (32 of them a thread
    a chunk, against fc2's 16 G fragment loads)."""
    for wgi in (0, 1):
        for warp in range(4):
            for j in range(4):
                for i2 in (0, 1):
                    for i1 in (0, 1):
                        addrs = [4 * h_store_index(wgi, warp, lane, j, i2,
                                                   i1)[1]
                                 for lane in range(32)]
                        assert wavefronts(addrs, 4) <= 2


@pytest.mark.parametrize("bm,groups", FORMS)
def test_fc2_sums_cover_the_block_once(bm, groups):
    """Group q's value 4 j + 2 i2 + i1 of consumer (wgi, warp, lane) is
    row 8 j + 2 q + i1, column 128 q + 64 wgi + 16 warp + 2 g + i2 (the
    seed's and the epilogue's 8-byte pairs): every (row, column) of the
    block's BM x 128 G sums once."""
    seen = set()
    for q in range(groups):
        for wgi in (0, 1):
            for warp in range(4):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for j in range(bm // 8):
                        for i2 in (0, 1):
                            for i1 in (0, 1):
                                cell = (8 * j + 2 * t + i1,
                                        128 * q + 64 * wgi + 16 * warp
                                        + 2 * g + i2)
                                assert cell not in seen
                                seen.add(cell)
    assert len(seen) == bm * 128 * groups


def test_mapped_step_is_the_transposed_product():
    """One fc1 step through the maps: the warpgroup's A (its fragments
    from a random W1 stage) times B (LN(x)'s box through its slots) gives
    accumulator row r of warp w as hidden column 64 wgi + 16 w + 2 (r % 8)
    + r // 8, column n as row n: h^T's block, summed over the step."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((32, 128))
    xn = rng.standard_normal((32, 32))  # BM = 32 rows x the step's 32 K
    stage = np.zeros(4 * 1024)
    for k in range(32):
        for i in range(128):
            stage[(i // 32) * 1024 + int(sw(k, i % 32))] = w[k, i]
    bbox = np.zeros(32 * 32)
    for n in range(32):
        for p in range(32):
            bbox[int(sw(n, p))] = xn[n, 8 * (p // 8) + perm8(p % 8)]
    for wgi in (0, 1):
        acc = np.zeros((64, 32))
        for s in range(4):
            a = np.zeros((64, 8))
            for warp in range(4):
                for lane in range(32):
                    g, q = lane // 4, lane % 4
                    for second in (0, 1):
                        idx = load_w_index(wgi, warp, lane, s, second)[0]
                        a[16 * warp + g, q + 4 * second] = stage[idx]
                        a[16 * warp + g + 8, q + 4 * second] = stage[idx + 1]
            b = np.array([[bbox[int(sw(n, 8 * s + u))] for n in range(32)]
                          for u in range(8)])
            acc += a @ b
        rows = [64 * wgi + 16 * (r // 16) + 2 * (r % 8) + (r % 16) // 8
                for r in range(64)]
        np.testing.assert_allclose(acc, (xn @ w[:, rows]).T, atol=1e-12)


# ------------------------------------------------ forms and budgets --

def _fp32_geometries():
    """Every (D, mlp) the port runs K3 on in fp32: each variant's width
    and its TP shards over model=2 and 4 where ``mlp_plan`` admits them,
    and the tests' narrow widths."""
    out = set()
    for cfg in VARIANTS.values():
        for model in (1, 2, 4):
            d, mlp = cfg.hidden_dim, cfg.mlp_dim // model
            if ops.mlp_plan(d, mlp, torch.float32):
                out.add((d, mlp))
    return sorted(out | {(64, 128), (128, 256), (200, 300), (1536, 6144)})


@pytest.mark.parametrize("d,mlp", _fp32_geometries())
def test_every_admitted_geometry_has_a_tf32_form_that_fits(d, mlp):
    assert cuda_block.mlp_f32_form(d, mlp, (0, 256, 1024, 4096)) == "tf32"
    bm, groups = tile_for(d)
    assert -(-d // 128) <= groups
    # fc2's sums a consumer thread holds: with fc1's or fc2's step sums
    # (BM / 2 each) and the split fragments (32) they stay inside the 168
    # registers ptxas gives a thread of a 384-thread block.
    assert groups * bm // 2 <= 96
    smem, stages = smem_for(bm)
    assert smem <= cuda_block.MAX_SMEM and stages >= 4


def test_form_helper_falls_back_where_tma_cannot_read():
    assert cuda_block.mlp_f32_form(768, 3072, (0, 16, 32, 48)) == "tf32"
    assert cuda_block.mlp_f32_form(768, 3072, (0, 8, 32, 48)) == "ffma"
    assert cuda_block.mlp_f32_form(770, 3072, (0, 16, 32, 48)) == "ffma"
    assert cuda_block.mlp_f32_form(768, 3070, (0, 16, 32, 48)) == "ffma"
    with pytest.raises(ValueError):
        cuda_block.mlp_f32_form(1540, 3072, (0, 0, 0, 0))
    assert [tile_for(d) for d in (256, 512, 768, 1024, 1152, 1536)] == \
        [(32, 2), (32, 4), (32, 6), (16, 8), (16, 12), (16, 12)]
    with pytest.raises(ValueError):
        tile_for(1664)


def test_tile_forms_match_the_launcher():
    """This module's mirror of ``mlp_block_tf32.cu``'s dispatch and of
    ``mlp_tf32.cuh:Cfg`` reads the same constants as the source."""
    from pathlib import Path
    src = Path(cuda_block.__file__).resolve().parents[2] / "csrc"
    launch = (src / "mlp_block_tf32.cu").read_text()
    for bm, g in FORMS:
        assert f"launch_mlp_tf32_tile<{bm}, {g}>" in launch
    tile = (src / "mlp_tf32.cuh").read_text()
    for const in ("constexpr int kSX = 4;", "constexpr int kBarBytes = 256;",
                  "constexpr int kMaxD = 1536;",
                  "static constexpr int kHBuf = 8 * kXBox;",
                  "static constexpr int kXStage = 3 * kXBox;",
                  "static constexpr int kSW = kSWraw < 8 ? kSWraw : 8;"):
        assert const in tile


@pytest.mark.parametrize("name", ["no_mma", "no_fc1_mma", "no_fc2_mma",
                                  "threads352"])
def test_ablation_variants_edit_the_current_sources(monkeypatch, tmp_path,
                                                    name):
    """``tools/mlp_tf32_ablate.py``: each variant's substitutions match
    the tile's sources as they are (a variant whose pattern matches
    nothing raises), and the copy differs from them."""
    from vit_tpu_torch.tools import mlp_tf32_ablate as abl
    monkeypatch.setattr(abl, "OUT", tmp_path)
    root = abl.make_variant(name)
    changed = [f for f in ("mlp_tf32.cuh", "mlp_block_tf32.cu")
               if (root / f).read_text() != (abl.CSRC / f).read_text()]
    assert changed
    assert (root / "harness.cu").exists()
