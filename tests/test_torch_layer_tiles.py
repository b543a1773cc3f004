"""K18's bf16 ``wgmma`` cluster tile (``vit_tpu_torch/csrc/mlp_wgmma.cuh``
with its ``L`` flag, launched by ``csrc/layer_block.cu``) and K8's bf16
form on K2's ``wgmma`` tile (``csrc/gemm_wgmma.cuh`` with ``EMB``,
``csrc/embed.cu``) on the CPU.

CUDA kernels do not run here, so the tiles' walks are modelled in this file
(not in the package), through the byte-addressed model of shared memory
with the 128-byte swizzle of ``tests/test_torch_mlp_tiles.py`` (K3's tile,
whose helpers this file reuses), and held to the functions their plain
versions are held to. K18's model follows the kernel's phases:

- ctx's 64 rows arrive as TMA boxes in the region that later holds LN2(y);
- each block's two consumer warpgroups compute ``ctx @ Wout`` for their
  columns (the block's half, pass by pass at D >= 896) from KS2-row
  stages of Wout read through the N-major descriptor, then
  ``(acc + bout) + x`` in fp32;
- LN2's statistics in the kernel's order: a thread's columns pass by pass,
  j by j, the pair in order, then the quad ``(s0 + s1) + (s2 + s3)``, the
  two warpgroups, the two blocks; the mean first, then the mean of the
  squared centred values;
- LN2(y) of the block's columns stored from the fragments into its A boxes
  and copied into the other block's; at two passes the second pass's y
  kept in the output's bytes (``y_stash``) and read back;
- the seed ``y + b2`` and K3's chunk loop, one cast.

It is held in fp32 and bf16 to ``reference.layer_tail`` and, with the
port's plain attention half in front, to JAX's Pallas ``layer_block`` in
interpret mode (``vit_tpu/ops/pallas/block.py:1805``). The file also checks
the shared-memory and register budgets of every width ``ops.layer_plan``
admits in bf16, the LN2 store map (a bijection onto both blocks' A boxes
once copied), the second-pass stash map, the barrier and cluster protocol
with the ctx phase, the statistics exchange and the LN2 copy, and K8's
walk: every token row written once, the embedding's rounding, and the tile
``gemm_path`` gives it.

Bars: fp32 |diff| <= 2e-5 * (1 + |ref|) (the sum order only); bf16
|diff| <= 2e-2 * (1 + |ref|), mean <= 3e-3, the kernel bars.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mlp_tiles import (BAR_BYTES, BM, BOX, CONSUMER_REGS, CT, HC,
                                  K16, SMEM_MAX, Smem, _Barrier, _gelu_round,
                                  a_desc, b_desc, cfg, frag, h_store_addr,
                                  ln_store_addr, pass_boxes, real_boxes,
                                  tma_box)
from vit_tpu.ops.pallas import block as pallas_block
from vit_tpu.ops.pallas import patch_embed as pallas_embed
from vit_tpu_torch import ops
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.cuda.embed import embed_tile

CSRC = Path(__file__).resolve().parents[1] / "vit_tpu_torch" / "csrc"
HEADER = (CSRC / "mlp_wgmma.cuh").read_text()
GEMM = (CSRC / "gemm_wgmma.cuh").read_text()
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EPS = 1e-12
#: K18's barriers beyond K3's: ctx, st[2], lnfull, lnready.
K18_BARS = 5


def _const(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# ------------------------------------------------------------ K18 model --

def col_of(c: dict, rank: int, q: int, wg: int) -> int:
    """The warpgroup's first output column in pass q (``col_of``)."""
    return rank * c["T"] * 64 + 64 * (q * c["BP"] + c["NB"] * wg)


def ln2_store_addr(c: dict, rank: int, q: int, wg: int):
    """Byte offsets in the A-box region that warpgroup ``wg`` of block
    ``rank`` stores LN2(y) value 4j + i of thread t to in pass q, as the
    kernel computes them (``ln2_store``): the pair of box j at (col_of /
    64 + j / 8) * 8 KB + r * 128 + ((j % 8) ^ (lane / 4)) * 16 +
    4 (lane % 4), + 2 (i % 2); -1 past the warpgroup's real boxes."""
    nb = c["NB"]
    t = torch.arange(128)[:, None]
    v = torch.arange(32 * nb)[None, :]
    warp, lane, j, i = t // 32, t % 32, v // 4, v % 4
    r = 16 * warp + lane // 4 + 8 * (i // 2)
    box0 = col_of(c, rank, q, wg) // 64
    addr = ((box0 + j // 8) * BOX + r * 128 + (((j % 8) ^ (lane // 4)) * 16)
            + 4 * (lane % 4) + 2 * (i % 2))
    return torch.where(j < 8 * real_boxes(c, q, wg), addr, -1)


def stash_offset(c: dict, d: int, r: int, cc, wg: int, rank: int):
    """``y_stash``: the bf16 slot index in the (M, D) output of the fp32
    pair at (row r, columns cc, cc + 1) of the warpgroup's second-pass y:
    its first-pass columns' 64 real_a slots, then its second-pass ones."""
    real_a = real_boxes(c, 0, wg)
    slot = 2 * cc
    col_a, col_b = col_of(c, rank, 0, wg), col_of(c, rank, 1, wg)
    return r * d + torch.where(slot < 64 * real_a, col_a + slot,
                               col_b + slot - 64 * real_a)


def _thread_sums(vals: list, sq_mean=None):
    """A warpgroup's row partials (64,) in the kernel's order: each thread
    (quad lane ql of a row) sums its values pass by pass, j by j, the pair
    in order, starting from 0; then the quad, (s0 + s1) + (s2 + s3).
    ``vals`` holds each pass's (64, 64 real) fp32 sums; with ``sq_mean``
    each value enters as (v - mean)^2."""
    s = torch.zeros((BM, 4), dtype=torch.float32)
    for v in vals:
        for j in range(v.shape[1] // 8):
            for e in range(2):
                x = v[:, 8 * j + 2 * torch.arange(4) + e]
                if sq_mean is not None:
                    x = x - sq_mean[:, None]
                    x = x * x
                s = s + x
    return (s[:, 0] + s[:, 1]) + (s[:, 2] + s[:, 3])


def k18_tiles(ctx, x, wout, bout, g2, bn2, w1, b1, w2, b2, *, eps=EPS,
              check_stash: bool = True):
    """``mlp_bf16_wgmma<T, true>``'s walk: returns (M, D) in x.dtype."""
    m, d = x.shape
    mlp = w1.shape[1]
    dtype = x.dtype
    c = cfg(d)
    assert d % 128 == 0 and mlp % CT == 0
    nb, t_boxes = c["NB"], c["T"]
    nchunks = mlp // CT
    out = torch.empty((m, d), dtype=dtype)
    written = torch.zeros((m, d), dtype=torch.int32)
    # The kernel's bf16 output, whose bytes hold the second-pass y (fp32)
    # at two passes; modelled apart from ``out`` so that fp32 runs keep it.
    out_bytes = torch.zeros(m * d, dtype=torch.bfloat16)
    h_addr = [h_store_addr(wg) for wg in range(2)]
    fr, fc = frag(32)
    ctx_box, w1_box, w2_box = tma_box(64), tma_box(64), tma_box(c["KS2"])
    for m0 in range(0, m, BM):
        rows = min(BM, m - m0)
        blocks = [Smem(c["smem"], dtype) for _ in range(2)]
        ring2 = [0, 0]  # W2 stages taken by each block
        # (1) ctx's rows, zeros past m, as K-major boxes in both blocks.
        ctx_t = torch.zeros((BM, d), dtype=dtype)
        ctx_t[:rows] = ctx[m0:m0 + rows]
        for blk in blocks:
            for kb in range(d // 64):
                blk.write(kb * BOX + ctx_box, ctx_t[:, kb * 64:kb * 64 + 64])

        def w2_stage(rank, src, r0, q):
            """The next W2-ring stage of block ``rank``: KS2 rows from r0
            of ``src`` (Wout or W2), pass q's boxes of its columns; a
            padding box keeps what the stage held."""
            blk = blocks[rank]
            stage = c["w2_off"] + (ring2[rank] % c["S2"]) * c["stage2"]
            ring2[rank] += 1
            for p in range(pass_boxes(c, q)):
                cb = rank * d // 2 + 64 * (q * c["BP"] + p)
                blk.write(stage + p * c["box2"] + w2_box,
                          src[r0:r0 + c["KS2"], cb:cb + 64])
            return stage

        def fc2_stage(blk, acc, stage, wg, a_base, ks):
            for kk in range(c["KS2"] // K16):
                kg = ks * (c["KS2"] // K16) + kk
                a = blk.read(a_desc(a_base + (kg // 4) * BOX
                                    + (kg % 4) * 32)).float()
                bm = blk.read(b_desc(stage + nb * wg * c["box2"] + kk * 2048,
                                     c["box2"], 64 * nb)).float()
                acc += a @ bm

        # (2)-(3) y for every pass's columns: the out-projection through
        # the W2 ring, then (y + bout) + x; zero past the columns and m.
        ys = {}
        for rank, blk in enumerate(blocks):
            for q in range(c["NP"]):
                accs = [torch.zeros((BM, 64 * nb)) for _ in range(2)]
                for ks in range(d // c["KS2"]):
                    stage = w2_stage(rank, wout, ks * c["KS2"], q)
                    for wg in range(2):
                        fc2_stage(blk, accs[wg], stage, wg, 0, ks)
                for wg in range(2):
                    real, col0 = real_boxes(c, q, wg), col_of(c, rank, q, wg)
                    y = torch.zeros((BM, 64 * nb))
                    cols = slice(col0, col0 + 64 * real)
                    y[:rows, :64 * real] = ((accs[wg][:rows, :64 * real]
                                             + bout[cols].float())
                                            + x[m0:m0 + rows, cols].float())
                    ys[rank, wg, q] = y
        # (4) LN2's statistics, each round over the two blocks.
        def total(sq_mean=None):
            block = []
            for rank in range(2):
                part = [_thread_sums(
                    [ys[rank, wg, q][:, :64 * real_boxes(c, q, wg)]
                     for q in range(c["NP"])], sq_mean) for wg in range(2)]
                block.append(part[0] + part[1])
            assert torch.equal(block[0] + block[1], block[1] + block[0])
            return block[0] + block[1]
        mean = total() / d
        rstd = torch.rsqrt(total(mean) / d + eps)
        # (5) LN2(y) of each block's columns into its A boxes (zeros past
        # m), then each block's boxes copied into the other's.
        for rank, blk in enumerate(blocks):
            for q in range(c["NP"]):
                for wg in range(2):
                    y = ys[rank, wg, q]
                    col0 = col_of(c, rank, q, wg)
                    ncol = 64 * nb
                    gcols = torch.arange(col0, col0 + ncol).clamp(max=d - 1)
                    ln = (((y - mean[:, None]) * rstd[:, None])
                          * g2[gcols].float() + bn2[gcols].float())
                    ln[rows:] = 0
                    addr = ln2_store_addr(c, rank, q, wg)
                    keep = addr >= 0
                    vals = ln.to(dtype)[fr2(nb)]
                    blk.write(addr[keep], vals[keep])
        for rank in range(2):
            half = slice(rank * t_boxes * BOX // 2,
                         (rank + 1) * t_boxes * BOX // 2)
            blocks[rank ^ 1].mem[half] = blocks[rank].mem[half]
        # At two passes, the second pass's y into the output's bytes.
        if c["NP"] == 2:
            stash = out_bytes.view(torch.float32)
            for rank in range(2):
                for wg in range(2):
                    real_b = real_boxes(c, 1, wg)
                    cc = torch.arange(0, 64 * real_b, 2)
                    for r in range(rows):
                        off = stash_offset(c, d, m0 + r, cc, wg, rank)
                        assert (off % 4 == 0).all()
                        stash[off // 2] = ys[rank, wg, 1][r, cc]
                        stash[off // 2 + 1] = ys[rank, wg, 1][r, cc + 1]
        # (6) K3's chunk loop from y + b2, pass by pass.
        for q in range(c["NP"]):
            accs = {}
            for rank in range(2):
                for wg in range(2):
                    real, col0 = real_boxes(c, q, wg), col_of(c, rank, q, wg)
                    acc = torch.zeros((BM, 64 * nb))
                    acc[:rows, :64 * real] = (
                        ys[rank, wg, q][:rows, :64 * real]
                        + b2[col0:col0 + 64 * real].float())
                    accs[rank, wg] = (col0, real, acc)
            for ci in range(nchunks):
                gi = q * nchunks + ci
                h_base = c["xn"] + (gi % 2) * 2 * BOX
                for rank, blk in enumerate(blocks):
                    h0 = ci * CT + rank * HC
                    pre = [torch.zeros((BM, 32)) for _ in range(2)]
                    for kb in range(d // 64):
                        qs = gi * (d // 64) + kb
                        stage = c["w1_off"] + (qs % c["S1"]) * BOX
                        blk.write(stage + w1_box,
                                  w1[kb * 64:kb * 64 + 64, h0:h0 + HC])
                        for wg in range(2):
                            for kk in range(4):
                                a = blk.read(a_desc(kb * BOX + kk * 32))
                                bm = blk.read(b_desc(
                                    stage + 64 * wg + kk * 2048, BOX, 32))
                                pre[wg] += a.float() @ bm.float()
                    for wg in range(2):
                        cols = slice(h0 + 32 * wg, h0 + 32 * wg + 32)
                        hv = _gelu_round(pre[wg] + b1[cols].float(), dtype)
                        blk.write(h_base + rank * BOX + h_addr[wg],
                                  hv[fr, fc])
                for rank in range(2):
                    box = slice((h_base + rank * BOX) // 2,
                                (h_base + rank * BOX + BOX) // 2)
                    blocks[rank ^ 1].mem[box] = blocks[rank].mem[box]
                for rank, blk in enumerate(blocks):
                    for ks in range(CT // c["KS2"]):
                        stage = w2_stage(rank, w2, ci * CT + ks * c["KS2"], q)
                        for wg in range(2):
                            fc2_stage(blk, accs[rank, wg][2], stage, wg,
                                      h_base, ks)
            for (rank, wg), (col0, real, acc) in accs.items():
                cols = 64 * real
                if q == 0 and c["NP"] == 2:
                    # The second pass's y comes back from the output's
                    # bytes, unrounded, before this pass's stores.
                    stash = out_bytes.view(torch.float32)
                    real_b = real_boxes(c, 1, wg)
                    cc = torch.arange(0, 64 * real_b, 2)
                    for r in range(rows):
                        off = stash_offset(c, d, m0 + r, cc, wg, rank)
                        back = torch.stack([stash[off // 2],
                                            stash[off // 2 + 1]], 1)
                        want = ys[rank, wg, 1][r].reshape(-1, 2)[:len(cc)]
                        if check_stash:
                            assert torch.equal(back, want)
                for r in range(rows):
                    out_bytes[(m0 + r) * d + col0:(m0 + r) * d + col0 + cols] \
                        = acc[r, :cols].to(torch.bfloat16)
                out[m0:m0 + rows, col0:col0 + cols] = acc[:rows, :cols].to(
                    dtype)
                written[m0:m0 + rows, col0:col0 + cols] += 1
    assert (written == 1).all()
    return out


def fr2(nb: int):
    """(rows, columns) of a warpgroup's m64n(64 nb) fragment values."""
    return frag(64 * nb)


# -------------------------------------------------------------- inputs --

def _tail_inputs(rng, m, d, mlp, dtype):
    arrays = (rng.standard_normal((m, d)),
              1.5 * rng.standard_normal((m, d)) + 0.2,
              0.03 * rng.standard_normal((d, d)),
              0.02 * rng.standard_normal(d),
              1 + 0.1 * rng.standard_normal(d), 0.05 * rng.standard_normal(d),
              0.03 * rng.standard_normal((d, mlp)),
              0.02 * rng.standard_normal(mlp),
              0.03 * rng.standard_normal((mlp, d)),
              0.02 * rng.standard_normal(d))
    td = DTYPES[dtype][1]
    return [torch.from_numpy(np.asarray(a, np.float32)).to(td)
            for a in arrays]


def _close(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy()
    want = (want.float().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(jnp.asarray(want, jnp.float32)))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert (diff <= 2e-5 * (1 + np.abs(want))).all(), diff.max()
    else:
        assert (diff <= 2e-2 * (1 + np.abs(want))).all(), diff.max()
        assert diff.mean() <= 3e-3, diff.mean()


# ------------------------------------------------------------ K18 tests --

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,d,mlp", [(63, 128, 256), (65, 384, 256),
                                     (130, 256, 512), (1, 384, 128)])
def test_k18_tiles_match_reference(dtype, m, d, mlp):
    """One pass: D = 128 (the second warpgroup owns no columns), 384 (two
    boxes and one), 256; ragged M (one row, a cluster and one row)."""
    t = _tail_inputs(np.random.default_rng(m + d + mlp), m, d, mlp, dtype)
    _close(k18_tiles(*t), reference.layer_tail(*t, eps=EPS), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,d,mlp", [(65, 896, 128), (1, 1024, 128),
                                     (63, 1024, 256)])
def test_k18_tiles_two_passes(dtype, m, d, mlp):
    """D >= 896: two passes over the hidden, the second pass's y kept
    unrounded in the output's bytes (the model asserts it comes back bit
    for bit) and the LN2 statistics over both passes' columns."""
    t = _tail_inputs(np.random.default_rng(m + d), m, d, mlp, dtype)
    _close(k18_tiles(*t), reference.layer_tail(*t, eps=EPS), dtype)


def _layer_inputs(seed, b, s, d, mlp, seq_len):
    """``tests/test_torch_layer.py``'s layer arrays: x, then the twelve
    weights, keys from ``seq_len`` on zeroed."""
    rng = np.random.default_rng(seed)
    arr = lambda *sh, sc=0.1: (rng.standard_normal(sh) * sc).astype(
        np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    x[:, seq_len:] = 0
    return [x, arr(d, sc=0.5) + 1, arr(d), arr(d, 3 * d), arr(3 * d),
            arr(d, d), arr(d), arr(d, sc=0.5) + 1, arr(d), arr(d, mlp),
            arr(mlp), arr(mlp, d), arr(d)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed,b,s,d,mlp,seq_len", [(6, 2, 32, 256, 512, 27),
                                                     (131, 3, 48, 128, 256,
                                                      40)])
def test_k18_layer_matches_pallas(dtype, seed, b, s, d, mlp, seq_len):
    """The whole layer: the port's plain attention half up to the context
    (``reference._attn_ctx``, the three launches in front of K18), then the
    tile model, against JAX's Pallas ``layer_block`` in interpret mode
    (one cluster at 64 rows; three clusters, the last ragged, at 144) and
    the port's ``reference.layer_block``. The first geometry takes
    ``tests/test_torch_layer.py``'s inputs (seed 6): in bf16 the attention
    half alone can put an element past the elementwise bar from Pallas (a
    rounding flip carried through the MLP half; at seed 258 the plain
    ``reference.layer_block`` sits at 1.23 times the bar), which says
    nothing of this tile; the model is held to ``reference.layer_block``
    on the same context as well."""
    arrays = _layer_inputs(seed, b, s, d, mlp, seq_len)
    jd, td = DTYPES[dtype]
    j = [jnp.asarray(a, jd) for a in arrays]
    t = [torch.from_numpy(a).to(td) for a in arrays]
    xf, ctx = reference._attn_ctx(t[0], *t[1:5], num_heads=4, scale=None,
                                  seq_len=seq_len, eps=EPS)
    got = k18_tiles(ctx, xf, *t[5:]).reshape(t[0].shape)
    want = pallas_block.layer_block(*j, num_heads=4, seq_len=seq_len,
                                    interpret=True)
    _close(got, want, dtype)
    _close(got, reference.layer_block(*t, num_heads=4, seq_len=seq_len),
           dtype)


def test_k18_tiles_rows_do_not_depend_on_m():
    """A row's result is the same bits at M = 33 and M = 130: no sum runs
    over rows, and the rows past M are zeros."""
    t = _tail_inputs(np.random.default_rng(7), 130, 256, 256, "bfloat16")
    whole = k18_tiles(*t)
    assert torch.equal(k18_tiles(t[0][:33], t[1][:33], *t[2:]), whole[:33])


def test_k18_statistics_order_and_rounding_point():
    """The statistics in the kernel's order sit within fp32 rounding of
    ``reference.layernorm``'s on y; y is not rounded before LN2: rounding it
    to bf16 first moves LN2(y) by more than the kernel's own order does."""
    rng = np.random.default_rng(3)
    t = _tail_inputs(rng, 64, 384, 128, "bfloat16")
    c = cfg(384)
    y = (torch.matmul(t[0].float(), t[2].float()) + t[3].float()
         + t[1].float())
    parts = []
    for rank in range(2):
        for wg in range(2):
            real = real_boxes(c, 0, wg)
            col0 = col_of(c, rank, 0, wg)
            parts.append(y[:, col0:col0 + 64 * real])
    mean = ((_thread_sums(parts[0:1]) + _thread_sums(parts[1:2]))
            + (_thread_sums(parts[2:3]) + _thread_sums(parts[3:4]))) / 384
    var = ((_thread_sums(parts[0:1], mean) + _thread_sums(parts[1:2], mean))
           + (_thread_sums(parts[2:3], mean)
              + _thread_sums(parts[3:4], mean))) / 384
    assert torch.allclose(mean, y.mean(1), rtol=0, atol=1e-5)
    assert torch.allclose(var, y.var(1, unbiased=False), rtol=1e-4, atol=0)
    ln = reference.layernorm(y, t[4], t[5], eps=EPS)
    ln_kernel = ((y - mean[:, None]) * torch.rsqrt(var + EPS)[:, None]
                 * t[4].float() + t[5].float())
    ln_rounded = reference.layernorm(y.to(torch.bfloat16).float(), t[4], t[5],
                                     eps=EPS)
    assert (ln_kernel - ln).abs().max() < 1e-4
    assert (ln_rounded - ln).abs().max() > 10 * (ln_kernel - ln).abs().max()


@pytest.mark.parametrize("d", range(128, 1025, 128))
def test_ln2_store_map_is_a_bijection_onto_both_blocks_a_boxes(d):
    """Every LN2 pair the two warpgroups of a block store (all passes) lands
    once in the block's own T boxes, where fc1's K-major A descriptor reads
    its (row, column) (``ln_rows``' layout, K3's); the two blocks' halves,
    each copied into the other block, cover all D/64 boxes once."""
    c = cfg(d)
    want = ln_store_addr(d)
    covered = []
    for rank in range(2):
        own = []
        for q in range(c["NP"]):
            for wg in range(2):
                addr = ln2_store_addr(c, rank, q, wg)
                fr, fcol = fr2(c["NB"])
                keep = addr >= 0
                col = col_of(c, rank, q, wg) + fcol
                assert torch.equal(addr[keep], want[fr, col.clamp(
                    max=d - 1)][keep])
                own.append(addr[keep])
        own = torch.cat(own)
        lo = rank * c["T"] * BOX
        assert sorted(own.tolist()) == list(range(lo, lo + c["T"] * BOX, 2))
        covered.append(own)
    assert sorted(torch.cat(covered).tolist()) == list(
        range(0, d // 64 * BOX, 2))


@pytest.mark.parametrize("d", [896, 1024])
def test_second_pass_stash_stays_in_the_warpgroups_own_bytes(d):
    """At two passes each warpgroup's second-pass y (64 rows x its real
    columns, fp32 pairs) goes to distinct 8-byte-aligned places inside its
    own output columns (both passes') of its rows: no other warpgroup or
    block stores there before it reads them back."""
    c = cfg(d)
    owner = {}
    for rank in range(2):
        for wg in range(2):
            mine = set()
            for q in range(2):
                col0 = col_of(c, rank, q, wg)
                for r in range(BM):
                    mine.update(r * d + col0 + k
                                for k in range(64 * real_boxes(c, q, wg)))
            for s in mine:
                assert s not in owner
                owner[s] = (rank, wg)
            cc = torch.arange(0, 64 * real_boxes(c, 1, wg), 2)
            slots = []
            for r in range(BM):
                off = stash_offset(c, d, r, cc, wg, rank)
                assert (off % 4 == 0).all()  # 8 bytes: a float2
                for o in off.tolist():
                    slots += [o, o + 1, o + 2, o + 3]
            assert len(slots) == len(set(slots))
            assert set(slots) <= mine


@pytest.mark.parametrize("d", range(128, 1025, 128))
def test_k18_budgets_fit_every_admitted_width(d):
    """Every bf16 width ``ops.layer_plan`` admits: K3's layout with K18's
    five barriers in the barrier bytes, the statistics slots inside h
    buffer 1, the ctx boxes in the LN(x) region, the LN2 copy of T boxes
    inside it, and the consumer's live sums in the y phase (two passes' at
    D >= 896, 128 a thread, with no fc1 sums beside them) inside its
    setmaxnreg share."""
    assert ops.layer_plan(8, 208, d, 4 * d, d // 64, torch.bfloat16)
    c = cfg(d)
    assert c["smem"] <= SMEM_MAX
    assert (2 * c["S1"] + 2 * c["S2"] + 8 + K18_BARS) * 8 <= BAR_BYTES
    assert BAR_BYTES == _const(HEADER, "kBarBytes")
    stats = 2 * 2 * BM * 4 + 2 * BM * 4
    assert stats <= 2 * BOX
    assert c["xn"] == d // 64 * BOX and 2 * c["T"] * BOX == c["xn"]
    assert d % c["KS2"] == 0
    live_y = 32 * c["NB"] * c["NP"]
    assert live_y <= 128 and live_y + 16 <= CONSUMER_REGS - 48


class _Named:
    """A named barrier of ``count`` participants, used in generations."""

    def __init__(self, count: int):
        self.count, self.arrived, self.gen = count, 0, 0

    def arrive(self) -> int:
        self.arrived += 1
        gen = self.gen
        if self.arrived == self.count:
            self.arrived, self.gen = 0, self.gen + 1
        return gen


def _protocol_k18(d: int, chunks: int, order_seed: int) -> None:
    """K18's barrier protocol up to the chunk loop, and the loop's first
    two h buffers, under a seeded random interleaving: the ctx TMA, the
    Wout stages through the W2 ring, the two statistics rounds (a named
    barrier of both warpgroups, 64 remote stores and arrivals a block),
    LN2's own half, the copy of it into the other block (lnready, lnfull),
    then fc1 and the h exchange. Every A box and statistics slot carries a
    tag; a consumer asserts ctx in every box while it reads ctx, both
    blocks' LN2 halves before fc1, the other block's partials when its wait
    passes, and that h buffer 1 (the statistics slots) is not written
    before both blocks are past the statistics."""
    c = cfg(d)
    s2, kd = c["S2"], d // c["KS2"]
    nbox = d // 64
    blocks = []
    for rank in range(2):
        blocks.append({
            "w2f": [_Barrier(1) for _ in range(s2)],
            "w2e": [_Barrier(2) for _ in range(s2)],
            "ctx": _Barrier(1), "st": [_Barrier(BM) for _ in range(2)],
            "lnfull": _Barrier(256 + 1), "lnready": _Barrier(256),
            "hfull": _Barrier(256 + 1), "hready": _Barrier(256),
            "named": _Named(2), "xn": ["none"] * nbox, "w2": [None] * s2,
            "peer": [None, None], "h1": [], "h0": [], "stats_done": 0})

    def producer_ctx(blk):
        yield
        blk["xn"] = ["ctx"] * nbox
        blk["ctx"].arrive(tx=1)
        blk["ctx"].complete_tx(1)

    def producer_w2(blk):
        for q in range(c["NP"] * kd):
            st = q % s2
            while not blk["w2e"][st].passed((q // s2) % 2 ^ 1):
                yield
            blk["w2"][st] = ("wout", q)
            blk["w2f"][st].arrive(tx=1)
            blk["w2f"][st].complete_tx(1)

    def consumer(rank, wg):
        blk, peer = blocks[rank], blocks[rank ^ 1]
        while not blk["ctx"].passed(0):
            yield
        for q in range(c["NP"] * kd):
            st = q % s2
            while not blk["w2f"][st].passed((q // s2) % 2):
                yield
            assert blk["w2"][st] == ("wout", q)
            assert blk["xn"] == ["ctx"] * nbox, "ctx overwritten while read"
            yield  # the group runs
            assert blk["xn"] == ["ctx"] * nbox
            blk["w2e"][st].arrive()
        for rd in range(2):
            gen = blk["named"].arrive()
            while blk["named"].gen == gen:
                yield
            if wg == 0:  # threads 0-63: the block's sums to the other
                assert peer["h1"] == [], "a statistics slot overwritten"
                peer["peer"][rd] = (rank, rd)
                peer["st"][rd].arrive(BM)
            while not blk["st"][rd].passed(0):
                yield
            assert blk["peer"][rd] == (rank ^ 1, rd)
            assert blk["h1"] == [], "a statistics slot overwritten"
        blk["stats_done"] += 1
        # LN2 of the block's half: both warpgroups are past the first
        # round's named barrier, so no one reads ctx here any more.
        for k in range(rank * nbox // 2, (rank + 1) * nbox // 2):
            blk["xn"][k] = ("ln", rank)
        blk["lnfull"].arrive(128)
        blk["lnready"].arrive(128)
        while not blk["lnfull"].passed(0):
            yield
        assert blk["xn"] == [("ln", k * 2 // nbox) for k in range(nbox)]
        # fc1(0), then h(0) and, with a second chunk, h(1): the first
        # writes into the h buffers (h(1)'s over the statistics slots).
        for g in range(min(chunks, 2)):
            yield
            blk["h1" if g else "h0"].append((rank, wg))
            if g == 0:
                blk["hfull"].arrive(128)
                blk["hready"].arrive(128)

    def copier(rank):
        blk, peer = blocks[rank], blocks[rank ^ 1]
        while not blk["lnready"].passed(0):
            yield
        assert blk["stats_done"] == 2
        peer["lnfull"].arrive(tx=1)
        yield  # the copy is in flight (a ctx reader there fails its check)
        for k in range(rank * nbox // 2, (rank + 1) * nbox // 2):
            peer["xn"][k] = ("ln", rank)
        peer["lnfull"].complete_tx(1)
        # h(0)'s copy: over the other block's buffer 0, not its slots.
        while not blk["hready"].passed(0):
            yield
        peer["hfull"].arrive(tx=1)
        peer["h0"].append(("copy", rank))
        peer["hfull"].complete_tx(1)

    agents = []
    for rank, blk in enumerate(blocks):
        agents += [producer_ctx(blk), producer_w2(blk), copier(rank)]
        agents += [consumer(rank, wg) for wg in range(2)]
    rng = np.random.default_rng(order_seed)
    idle = 0
    while agents:
        a = agents[rng.integers(len(agents))]
        try:
            next(a)
            idle += 1
        except StopIteration:
            agents.remove(a)
            idle = 0
        assert idle < 20000, "deadlock"


@pytest.mark.parametrize("d", [128, 384, 768, 896, 1024])
@pytest.mark.parametrize("chunks", [1, 2])
def test_k18_protocol_has_no_deadlock_or_early_reuse(d, chunks):
    """The ctx phase, the statistics exchange and the LN2 copy at one and
    two passes, over one and two chunks (the second writes h buffer 1, the
    statistics slots), in four interleavings each; the chunk loop's own
    protocol is K3's (``test_torch_mlp_tiles.py``)."""
    for seed in range(4):
        _protocol_k18(d, chunks, seed)


def test_k18_header_names_the_phases():
    """The tile's header and barrier set name K18's phases, and the
    kernel keeps K3's launch shape: a cluster of two, 384 threads."""
    assert "__cluster_dims__(2, 1, 1)" in HEADER
    assert _const(HEADER, "kThreads") == 384
    for word in ("map_ctx", "map_wout", "lnfull", "lnready", "y_stash",
                 "st_cluster", "consumers_sync"):
        assert word in HEADER, word
    layer = (CSRC / "layer_block.cu").read_text()
    assert "mlp_bf16_wgmma<T, true>" in layer
    assert "mlp_chunks_bf16" not in layer


# ------------------------------------------------------------- K8 tests --

BM8, BN8 = _const(GEMM, "kBM"), _const(GEMM, "kBN")
SMS = 132


def k8_walk(b: int, n: int, d: int, sp: int, sms: int = SMS):
    """Writes of each (B * sp, D) token element by the persistent walk of
    ``gemm_bf16_wgmma<0, 0, false, true>``: block i takes tiles i, i +
    grid, ... of tiles_m x tiles_n (tile t at row tile t % tiles_m); each
    tile's rows below B*N go to token rows g*sp + 1 + i, and the block
    that walks a column tile's first row tile writes that column's row 0
    and pad rows of every image. Returns (counts, tiles a block)."""
    m = b * n
    tm, tn = -(-m // BM8), -(-d // BN8)
    tiles = tm * tn
    grid = min(tiles, sms)
    counts = torch.zeros((b * sp, d), dtype=torch.int32)
    per_block = []
    for blk in range(grid):
        walked = 0
        for t in range(blk, tiles, grid):
            walked += 1
            m0, n0 = (t % tm) * BM8, (t // tm) * BN8
            r = torch.arange(m0, min(m0 + BM8, m))
            rows = r // n * sp + 1 + r % n
            counts[rows[:, None], torch.arange(n0, min(n0 + BN8, d))] += 1
            if m0 == 0:
                fixed = torch.tensor([g * sp + j for g in range(b)
                                      for j in [0, *range(n + 1, sp)]])
                counts[fixed[:, None], torch.arange(n0, min(n0 + BN8, d))] += 1
        per_block.append(walked)
    return counts, per_block


@pytest.mark.parametrize("case", [
    ("B/16 bs=1", 1, 196, 768, 208), ("B/16 bs=2", 2, 196, 768, 208),
    ("B/16 bs=3", 3, 196, 768, 208), ("B/16 bs=4", 4, 196, 768, 208),
    ("B/32 bs=4", 4, 49, 768, 64), ("L/16-384 bs=4", 4, 576, 1024, 592)])
def test_k8_walk_writes_every_token_row_once(case):
    """Every element of (B, sp, D) is written exactly once: the patch rows
    by their tiles, row 0 and the pad rows by the first row tile's block of
    each column tile."""
    _, b, n, d, sp = case
    counts, per_block = k8_walk(b, n, d, sp)
    assert (counts == 1).all()
    assert sum(per_block) == -(-b * n // BM8) * -(-d // BN8)


def test_k8_tile_counts_at_small_batch():
    """The small-batch grids: 12, 42 and 144 tiles of 128 x 128 at B/16
    bs=1, bs=4 and L/16-384 bs=4 (more tiles than SMs only at the last)."""
    for (b, n, d, sp), tiles in (((1, 196, 768, 208), 12),
                                 ((4, 196, 768, 208), 42),
                                 ((4, 576, 1024, 592), 144)):
        _, per_block = k8_walk(b, n, d, sp)
        assert sum(per_block) == tiles
        assert max(per_block) == (2 if tiles > SMS else 1)


def k8_epilogue(patches, w, bias, cls_row, pos, sp):
    """K8's EMB epilogue on K2's sums (here the fp32 product): z =
    bf16(acc + bias), then bf16(z + pos[i]) at token row g*sp + 1 + i;
    row 0 cls_row, pad rows zero."""
    b, n, k = patches.shape
    d = w.shape[1]
    acc = torch.matmul(patches.float(), w.float())
    z = (acc + bias.float()).to(patches.dtype)
    tok = (z.float() + pos.float()).to(patches.dtype)
    out = torch.full((b, sp, d), float("nan"), dtype=patches.dtype)
    out[:, 1:n + 1] = tok
    out[:, 0] = cls_row
    out[:, n + 1:] = 0
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,n,k,d,sp", [(1, 196, 768, 256, 208),
                                        (2, 49, 3072, 128, 64),
                                        (3, 20, 96, 128, 24)])
def test_k8_epilogue_matches_reference_and_pallas(dtype, b, n, k, d, sp):
    """The epilogue's rounding and row map on K2's sums are
    ``reference.embed_fused`` bit for bit (the same fp32 product), and sit
    within the kernel bars of JAX's Pallas ``embed_fused`` in interpret
    mode."""
    rng = np.random.default_rng(b + n + k)
    arrays = [rng.standard_normal((b, n, k)),
              0.03 * rng.standard_normal((k, d)),
              0.1 * rng.standard_normal(d), rng.standard_normal(d),
              rng.standard_normal((n, d))]
    jd, td = DTYPES[dtype]
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(td) for a in arrays]
    got = k8_epilogue(*t, sp)
    want = reference.embed_fused(*t, sp)
    assert torch.equal(got, want)
    j = [jnp.asarray(np.asarray(a, np.float32), jd) for a in arrays]
    pallas = pallas_embed.embed_fused(*j, sp, interpret=True)
    _close(got, pallas, dtype)


@pytest.mark.parametrize("variant,tile", [("B/16", "wgmma"), ("B/32", "wgmma"),
                                          ("L/16-384", "wgmma"),
                                          ("H/14", "wmma")])
def test_k8_tile_is_gemm_paths(variant, tile):
    """``embed_tile`` asks ``gemm_path`` itself for K2's tile on the same
    contiguous operands: the ``wgmma`` form wherever K is a multiple of 8
    (B/16's and L/16-384's 768, B/32's 3072); H/14's K = 588 keeps
    ``gemm_tile.cuh`` (``wmma``) in bf16; in fp32 every variant's K is a
    multiple of 4, so all take the tf32 tile."""
    from vit_tpu_torch.config import VARIANTS
    cfg_v = VARIANTS[variant]
    p, ch = cfg_v.patch_size, 3
    k, d = p * p * ch, cfg_v.hidden_dim
    n = (cfg_v.image_size // p) ** 2
    for dt in (torch.bfloat16, torch.float32):
        patches = torch.zeros((2, n, k), dtype=dt)
        w = torch.zeros((k, d), dtype=dt)
        want = tile if dt == torch.bfloat16 else "wgmma"
        assert embed_tile(patches, w) == want
    assert (k % 8 == 0) == (tile == "wgmma")
