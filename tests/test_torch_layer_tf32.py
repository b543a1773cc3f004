"""K18's fp32 form on the tensor cores (``csrc/mlp_tf32.cuh`` with its
LAYER flag, launched by ``csrc/layer_block_tf32.cu``) modelled on the CPU.

The model follows the kernel's sum order: the out-projection ``y^T =
Wout^T @ ctx^T`` group by group (128 output columns), each group's sums
over K = D in one three-pass TF32 accumulator up to D = 1024 and in
accumulators of K = 128 added in fp32 past it; ``y = (sums + bout) + x``
written unrounded into the output's rows and read back; then K3's tile
(``tests/test_torch_mlp_tf32.py:k3_tf32_model``) on y, its totals seeded
with ``y + b2`` and LN2 from y's row statistics. It is held to
``reference.layer_tail`` and, behind the port's plain attention half, to
JAX's Pallas ``layer_block`` in interpret mode, within 1e-4; a one-pass
TF32 version misses that bar. The out-projection's operand maps (Wout's
fragments through the weight ring, ctx's boxes through the helpers'
copy-and-split, the sums into the fc2 totals' layout that y is stored
from) are walked element by element, and the form rule and the launcher's
forms are pinned.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mlp_tf32 import (BAR, FORMS, k3_tf32_model, load_w_index,
                                 perm8, smem_for, sw, tile_for, wavefronts,
                                 _one_pass)
from vit_tpu.ops.pallas import block as pallas_block
from vit_tpu_torch import ops
from vit_tpu_torch.config import VARIANTS
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.cuda import block as cuda_block
from vit_tpu_torch.tools.tf32_probe import matmul_split

EPS = 1e-12
CT = 128  # output columns a group; hidden columns a chunk


def out_projection(ctx, wout, *, passes=3):
    """The kernel's ``ctx @ wout`` (fp32): per 128-column group, K = D in
    one accumulator where the launcher's form holds G <= 8 groups, else in
    accumulators of K = 128 added in order (the first starts the
    group's total)."""
    d = wout.shape[0]
    step = CT if tile_for(d)[1] > 8 else d
    groups = []
    for c0 in range(0, d, CT):
        tot = None
        for k0 in range(0, d, step):
            part = matmul_split(ctx[:, k0:k0 + step],
                                wout[k0:k0 + step, c0:c0 + CT], passes=passes)
            tot = part if tot is None else tot + part
        groups.append(tot)
    return torch.cat(groups, dim=1)


def k18_tf32_model(ctx, x, wout, bout, g2, bn2, w1, b1, w2, b2, *, eps=EPS):
    """The tile's arithmetic on (M, D) fp32 rows: y = (ctx @ Wout + bout) +
    x, stored into the output and read back as it was written, then K3's
    walk on y (LN2's statistics in two passes, the totals seeded y + b2)."""
    ctx, x, wout, bout = (t.float() for t in (ctx, x, wout, bout))
    out = torch.empty_like(x)
    out.copy_((out_projection(ctx, wout) + bout) + x)
    y = out.clone()
    assert torch.equal(y, out)  # fp32 in, fp32 out: nothing rounded
    return k3_tf32_model(y, g2, bn2, w1, b1, w2, b2, eps=eps)


def _tail(seed, m, d, mlp):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((m, d)),
              1.5 * rng.standard_normal((m, d)) + 0.2,
              0.03 * rng.standard_normal((d, d)),
              0.02 * rng.standard_normal(d),
              1 + 0.1 * rng.standard_normal(d), 0.05 * rng.standard_normal(d),
              0.03 * rng.standard_normal((d, mlp)),
              0.02 * rng.standard_normal(mlp),
              0.03 * rng.standard_normal((mlp, d)),
              0.02 * rng.standard_normal(d))
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


@pytest.mark.parametrize("m,d,mlp", [
    (37, 200, 300),    # ragged: D and mlp past their last step and group
    (70, 768, 512),    # B/16's width, two row tiles
    (33, 1024, 256),   # the last form with one accumulator over K = D
    (33, 1280, 384),   # H/14's width: 16 rows a block, sums split
    (20, 1536, 128)])  # the widest form
def test_model_matches_the_plain_version(m, d, mlp):
    t = _tail(m + d + mlp, m, d, mlp)
    want = reference.layer_tail(*t, eps=EPS)
    got = k18_tf32_model(*t)
    assert float((got - want).abs().max()) <= BAR
    # One TF32 pass, in both halves, misses the bar.
    ctx, x, wout, bout, g2, bn2, w1, b1, w2, b2 = t
    y = (out_projection(ctx, wout, passes=1) + bout) + x
    one = _one_pass(y, g2, bn2, w1, b1, w2, b2, partial=False)
    assert float((one - want).abs().max()) > BAR


def test_model_keeps_y_unrounded():
    """The output of a tail whose MLP weights are zero is y + b2 (the
    totals' seed, y never rounded), bit for bit with the model's y."""
    m, d, mlp = 37, 256, 128
    t = _tail(5, m, d, mlp)
    t[6] = torch.zeros_like(t[6])
    t[7] = torch.zeros_like(t[7])  # gelu(0) = 0: h is zero
    got = k18_tf32_model(*t)
    y = (out_projection(t[0], t[2]) + t[3]) + t[1]
    assert torch.equal(got, y + t[9])


def _layer_inputs(seed, b, s, d, mlp, seq_len):
    """``tests/test_torch_layer.py``'s layer arrays: x, then the twelve
    weights, rows from ``seq_len`` on zeroed. Its scale 0.1 is for D = 256;
    a wider layer's weights keep their products' scale (0.1 sqrt(256 /
    D)): at 0.1 and D = 1280 the outputs reach 57, where the absolute bar
    is some 30 fp32 ulps and the plain version itself sits 1.3e-4 from
    Pallas."""
    rng = np.random.default_rng(seed)
    w = 0.1 * (256 / d) ** 0.5
    arr = lambda *sh, sc=w: (  # noqa: E731
        rng.standard_normal(sh) * sc).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    x[:, seq_len:] = 0
    return [x, arr(d, sc=0.5) + 1, arr(d), arr(d, 3 * d), arr(3 * d),
            arr(d, d), arr(d), arr(d, sc=0.5) + 1, arr(d), arr(d, mlp),
            arr(mlp), arr(mlp, d), arr(d)]


@pytest.mark.parametrize("seed,b,s,d,mlp,heads,seq_len", [
    (6, 2, 32, 256, 512, 4, 27),
    (131, 1, 16, 1280, 256, 10, 13)])
def test_layer_matches_pallas(seed, b, s, d, mlp, heads, seq_len):
    """The whole fp32 layer: the port's plain attention half up to the
    context (``reference._attn_ctx``), then the model, against JAX's Pallas
    ``layer_block`` in interpret mode and the port's
    ``reference.layer_block``, within 1e-4; at D = 1280 the out-projection
    and fc1 sum K in four accumulators."""
    arrays = _layer_inputs(seed, b, s, d, mlp, seq_len)
    t = [torch.from_numpy(a) for a in arrays]
    xf, ctx = reference._attn_ctx(t[0], *t[1:5], num_heads=heads,
                                  scale=None, seq_len=seq_len, eps=EPS)
    got = k18_tf32_model(ctx, xf, *t[5:]).reshape(t[0].shape).numpy()
    want = np.asarray(pallas_block.layer_block(
        *(jnp.asarray(a, jnp.float32) for a in arrays), num_heads=heads,
        seq_len=seq_len, interpret=True))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= BAR
    plain = reference.layer_block(*t, num_heads=heads, seq_len=seq_len)
    assert np.abs(got - plain.numpy()).max() <= BAR


# ------------------------------------------------- the operand maps --

def helper_writes(bm):
    """Where ``normalize_box`` (either mode) writes each element of a
    BM x 32 box: unit u (row u / 4, slice u % 4) stores columns 8 s + (0 2
    4 6) at the chunk of slots 8 s .. + 3 and 8 s + (1 3 5 7) at 8 s + 4
    .. + 7. Returns {float index: (row, column)}."""
    box = {}
    for u in range(4 * bm):
        n, s = u // 4, u % 4
        for half, ks in ((0, (0, 2, 4, 6)), (1, (1, 3, 5, 7))):
            for e, k in enumerate(ks):
                idx = int(sw(n, 8 * s + 4 * half + e))
                assert idx not in box
                box[idx] = (n, 8 * s + k)
    return box


@pytest.mark.parametrize("bm", [32, 16])
def test_ctx_boxes_hold_the_permuted_slots(bm):
    """The copy-and-split writes every (row, column) of ctx's box once, at
    the slot fc1's LN(x) takes: slot p of row n holds column 8 (p // 8) +
    perm8(p % 8), the K order of the A fragments' slots."""
    box = helper_writes(bm)
    assert len(box) == bm * 32
    for n in range(bm):
        for p in range(32):
            assert box[int(sw(n, p))] == (n, 8 * (p // 8) + perm8(p % 8))


@pytest.mark.parametrize("bm", [32, 16])
def test_ctx_copy_and_split_has_no_bank_conflict(bm):
    """The copy mode's units are LN(x)'s: helper j takes units j, j + 96,
    ...; each quarter-warp phase of its 16-byte loads from the raw box and
    of its stores into the hi and lo boxes hits eight distinct chunks (four
    wavefronts an instruction, the least for 16-byte accesses)."""
    for j0 in range(0, 96, 32):
        for it in range(0, 4 * bm, 96):
            for chunk in (0, 4):
                addrs = []
                for lane in range(32):
                    u = j0 + lane + it
                    u = u if u < 4 * bm else 0
                    addrs.append(4 * int(sw(u // 4, 8 * (u % 4) + chunk)))
                assert wavefronts(addrs, 16) == 4


def test_copy_and_split_is_normalize_boxs_store_map():
    """In the source, the copy mode stores the same slots as LN(x): the
    even columns at chunk 8 s, the odd ones at 8 s + 4, before any use of
    the row statistics."""
    src = (Path(cuda_block.__file__).resolve().parents[2] / "csrc"
           / "mlp_tf32.cuh").read_text()
    body = src[src.index("if constexpr (!LN) {"):]
    body = body[:body.index("const float mu = mean[n]")]
    assert "sw128_f32(n, 8 * s), e[0], e[2], e[4], e[6]" in body
    assert "sw128_f32(n, 8 * s + 4), e[1], e[3], e[5], e[7]" in body
    assert "continue;" in body


@pytest.mark.parametrize("bm,d", [(32, 256), (16, 1280)])
def test_out_projection_through_the_maps(bm, d):
    """One block's out-projection element by element through the maps:
    for each group and K step, the A fragments read from a Wout stage (32
    rows x 128 columns, four swizzled 32 x 32 boxes) by ``load_w``, the B
    slots from ctx's box as the helpers wrote it, the products summed into
    accumulator value 4 j + 2 i2 + i1 of warp w's lane (g, q) (A row 16 w
    + g + 8 i2, B column 8 j + 2 q + i1), which the consumers store as y
    at row 8 j + 2 q + i1, column 128 q + 64 wgi + 16 w + 2 g + i2: every
    element of the block's y once, equal to ctx @ Wout."""
    rng = np.random.default_rng(d)
    ctx = rng.standard_normal((bm, d))
    wout = rng.standard_normal((d, d))
    y = np.full((bm, d), np.nan)
    box = helper_writes(bm)
    for q0 in range(0, d, CT):
        acc = {wgi: np.zeros((64, bm)) for wgi in (0, 1)}
        for k0 in range(0, d, 32):
            stage = np.zeros(4 * 1024)
            for k in range(32):
                for i in range(CT):
                    if k0 + k < d and q0 + i < d:
                        stage[(i // 32) * 1024 + int(sw(k, i % 32))] = \
                            wout[k0 + k, q0 + i]
            bbox = np.zeros(bm * 32)
            for idx, (n, c) in box.items():
                bbox[idx] = ctx[n, k0 + c] if k0 + c < d else 0.0
            for wgi in (0, 1):
                for s in range(4):
                    a = np.zeros((64, 8))
                    for warp in range(4):
                        for lane in range(32):
                            g, q = lane // 4, lane % 4
                            for second in (0, 1):
                                idx = load_w_index(wgi, warp, lane, s,
                                                   second)[0]
                                a[16 * warp + g, q + 4 * second] = stage[idx]
                                a[16 * warp + g + 8, q + 4 * second] = \
                                    stage[idx + 1]
                    b = np.array([[bbox[int(sw(n, 8 * s + u))]
                                   for n in range(bm)] for u in range(8)])
                    acc[wgi] += a @ b
        for wgi in (0, 1):
            for warp in range(4):
                for lane in range(32):
                    g, q = lane // 4, lane % 4
                    for j in range(bm // 8):
                        for i2 in (0, 1):
                            for i1 in (0, 1):
                                row = 8 * j + 2 * q + i1
                                col = q0 + 64 * wgi + 16 * warp + 2 * g + i2
                                v = acc[wgi][16 * warp + g + 8 * i2,
                                             8 * j + 2 * q + i1]
                                if col < d:
                                    assert np.isnan(y[row, col])
                                    y[row, col] = v
    np.testing.assert_allclose(y, ctx @ wout, rtol=0, atol=1e-9)


# ------------------------------------------------ forms and budgets --

def _layer_geometries():
    """Every (D, mlp) the port runs K18 on in fp32 (``layer_plan`` at each
    variant's width) and the tests' narrow widths."""
    out = set()
    for cfg in VARIANTS.values():
        d, mlp = cfg.hidden_dim, cfg.mlp_dim
        if ops.layer_plan(1, 208, d, mlp, cfg.num_heads, torch.float32):
            out.add((d, mlp))
    return sorted(out | {(128, 256), (256, 512), (1536, 6144)})


@pytest.mark.parametrize("d,mlp", _layer_geometries())
def test_every_layer_geometry_takes_the_tf32_form(d, mlp):
    """The form ``layer_tail`` passes for six aligned operands is "tf32";
    the tile's form at that width fits shared memory with room for one
    more barrier (ydone) beside K3's."""
    assert cuda_block.mlp_f32_form(d, mlp, (0, 16, 32, 48, 64, 1024)) \
        == "tf32"
    bm, groups = tile_for(d)
    smem, stages = smem_for(bm)
    assert smem <= cuda_block.MAX_SMEM and stages >= 4
    assert (2 * stages + 3 * 4 + 1) * 8 <= 256


@pytest.mark.parametrize("ptrs,form", [
    ((0, 16, 32, 48, 64, 80), "tf32"),
    ((4, 16, 32, 48, 64, 80), "ffma"),   # ctx
    ((0, 16, 40, 48, 64, 80), "ffma"),   # the output
    ((0, 16, 32, 52, 64, 80), "ffma")])  # wout
def test_layer_form_falls_back_where_tma_cannot_read(ptrs, form):
    assert cuda_block.mlp_f32_form(768, 3072, ptrs) == form
    assert cuda_block.mlp_f32_form(770, 3072, ptrs[:1] * 6) == "ffma"


def test_launcher_forms_are_k3s():
    """``layer_block_tf32.cu`` launches the five (BM, G) forms K3's
    launcher does, chosen by the same group counts, and ``layer_tail``
    passes the form to the entry point as ``mlp_block`` does."""
    src = Path(cuda_block.__file__).resolve().parents[2] / "csrc"
    launch = (src / "layer_block_tf32.cu").read_text()
    k3 = (src / "mlp_block_tf32.cu").read_text()
    for bm, g in FORMS:
        assert f"VIT_LT({bm}, {g})" in launch
        assert f"launch_mlp_tf32_tile<{bm}, {g}>" in k3
    for cond in ("ng <= 2", "ng <= 4", "ng <= 6", "ng <= 8",
                 "ng <= 6 ? 32 : 16"):
        assert cond in launch and cond in k3
    from vit_tpu_torch.ops.cuda import _build
    assert _build._SIGNATURES["vit_layer_block"][-1] is _build._I
