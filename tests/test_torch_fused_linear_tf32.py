"""K6's fp32 form on the tensor cores (``csrc/gemm_tf32.cuh`` with its LN
prologue, ``gemm_tf32_ln_wgmma``, launched by ``csrc/matmul_tf32.cu``)
modelled on the CPU.

The model walks K2's tf32 tile (``tests/test_torch_fp32_split.py``'s
``k2_tf32_tile``): 128 x 128 output tiles, K in steps of 32 through x's
raw box as TMA lays it out (zeros past M and K), each consumer thread's A
fragments read from the box at ``load_a``'s addresses and normalised there
with the statistics and parameters its indices select (``load_a_ln``: the
rows' mu and rstd once a tile, each slice's gamma and beta, zero past K),
then split; each 32-deep step summed into a fresh three-pass accumulator
and added to the tile's total; bias, GELU and residual in fp32. It is held
to ``reference.fused_linear`` and to JAX's Pallas ``fused_linear`` in
interpret mode within 1e-4 at ragged shapes (K = 200 and 520 end inside a
step); a one-pass TF32 version misses the bar. The tile rule, now
``gemm_path``'s for K6 in fp32, is pinned on every composed-route call.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fp32_split import BAR, BK, BM, BN, _max_diff, _t, sw
from vit_tpu.ops.pallas import matmul as pallas_matmul
from vit_tpu_torch.config import VARIANTS
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.cuda import matmul as cuda_matmul
from vit_tpu_torch.ops.cuda.embed import embed_tile
from vit_tpu_torch.tools.tf32_probe import split

EPS = 1e-12


def _thread_indices():
    """For every consumer thread value (warpgroup wgi, warp w, lane (g, q),
    slice s, fragment value i): the A element's row r = 64 wgi + 16 w + g
    + 8 (i & 1) and column c = 8 s + q + 4 (i >> 1) in the step, as
    ``load_a`` reads it; the statistics' row offset 64 wgi + 16 w + g + 8 h
    (st[h], which ``gemm_tf32_walk`` loads once a tile) and the parameters'
    column offset 8 s + q + 4 u (``load_a_ln``'s gamma and beta), where
    ``load_a_ln`` fills fragment value i = 2 u + h."""
    wgi, warp, lane, s, i = np.meshgrid(np.arange(2), np.arange(4),
                                        np.arange(32), np.arange(BK // 8),
                                        np.arange(4), indexing="ij")
    g, q = lane // 4, lane % 4
    r = 64 * wgi + 16 * warp + g + 8 * (i & 1)
    c = 8 * s + q + 4 * (i >> 1)
    u, h = i // 2, i % 2
    st_row = 64 * wgi + 16 * warp + g + 8 * h
    gb_col = 8 * s + q + 4 * u
    return (r.ravel(), c.ravel(), st_row.ravel(), gb_col.ravel())


THREADS = _thread_indices()


def ln_fragments(raw, mu, rstd, gamma, beta, m0, k0, m, k):
    """The A operand (128 x 32) of one step as the consumers form it from
    the raw box (``load_a_ln``): each value read at ``sw128_f32(r, c)``,
    normalised with the thread's statistics (row m0 + its offset; zero past
    M) and parameters (column k0 + its offset; past K the value is zero).
    Every element written once."""
    r, c, st_row, gb_col = THREADS
    rows = m0 + st_row
    cols = k0 + gb_col
    in_m, in_k = rows < m, cols < k
    mu_t = torch.where(torch.from_numpy(in_m), mu[np.minimum(rows, m - 1)],
                       torch.tensor(0.0))
    rs_t = torch.where(torch.from_numpy(in_m), rstd[np.minimum(rows, m - 1)],
                       torch.tensor(0.0))
    ga = torch.where(torch.from_numpy(in_k), gamma[np.minimum(cols, k - 1)],
                     torch.tensor(0.0))
    be = torch.where(torch.from_numpy(in_k), beta[np.minimum(cols, k - 1)],
                     torch.tensor(0.0))
    v = raw[torch.from_numpy(sw(r, c).astype(np.int64))]
    val = torch.where(torch.from_numpy(in_k), (v - mu_t) * rs_t * ga + be,
                      torch.tensor(0.0))
    a = torch.full((BM, BK), float("nan"))
    flat = torch.from_numpy(r * BK + c)
    assert len(set(flat.tolist())) == BM * BK  # each element once
    a.view(-1)[flat] = val
    return a


def k6_tf32_tile(x, w, bias, act, res, g, beta, *, eps=EPS, passes=3):
    """K6's fp32 tile on the CPU (contiguous x (m, k) and w (k, n)): K5's
    statistics, then each tile and step as the module docstring says."""
    m, k = x.shape
    n = w.shape[1]
    mu, rstd = reference.layernorm_stats(x, eps=eps)
    mu, rstd = mu.reshape(-1), rstd.reshape(-1)
    rr, cc = np.meshgrid(np.arange(BM), np.arange(BK), indexing="ij")
    raw_idx = torch.from_numpy(sw(rr, cc))  # (r, c) -> index in the box
    out = torch.zeros(m, n)
    for m0 in range(0, m, BM):
        for n0 in range(0, n, BN):
            total = torch.zeros(BM, BN)
            for k0 in range(0, k, BK):
                box = torch.zeros(BM, BK)
                rows, cols = min(BM, m - m0), min(BK, k - k0)
                box[:rows, :cols] = x[m0:m0 + rows, k0:k0 + cols]
                raw = torch.zeros(BM * BK)
                raw[raw_idx.reshape(-1)] = box.reshape(-1)
                a = ln_fragments(raw, mu, rstd, g, beta, m0, k0, m, k)
                assert not torch.isnan(a).any()
                assert (a[:, cols:] == 0).all()  # past K: exact zeros
                b = torch.zeros(BK, BN)
                nc = min(BN, n - n0)
                b[:cols, :nc] = w[k0:k0 + cols, n0:n0 + nc]
                (ah, al), (bh, bl) = split(a), split(b)
                if passes == 1:
                    part = torch.matmul(ah, bh)
                else:
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


def _inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)) * 1.5 + 0.3,
            0.05 * rng.standard_normal((k, n)), 0.1 * rng.standard_normal(n),
            1 + 0.1 * rng.standard_normal(k), 0.2 * rng.standard_normal(k),
            rng.standard_normal((m, n)))


@pytest.mark.parametrize("m,k,n", [(37, 200, 100), (136, 520, 132),
                                   (20, 64, 8)])
@pytest.mark.parametrize("act,with_res", [(None, False), ("gelu", False),
                                          (None, True), ("gelu", True)])
def test_k6_tf32_model_matches_reference_and_pallas(m, k, n, act, with_res):
    """Ragged M, N and K against the 128 x 128 tile and the 32-deep step
    (K = 200 and 520 end inside a step: the columns past K are zeros, not
    beta), every epilogue, within 1e-4 of ``reference.fused_linear`` and
    of JAX's Pallas ``fused_linear`` in interpret mode."""
    xa, wa, ba, ga, bea, ra = _inputs(m + 3 * k + n, m, k, n)
    x, w, bias, g, beta, r = (_t(a) for a in (xa, wa, ba, ga, bea, ra))
    res = r if with_res else None
    got = k6_tf32_tile(x, w, bias, act, res, g, beta)
    want = reference.fused_linear(x, w, bias, act, ln_scale=g, ln_bias=beta,
                                  residual=res)
    assert _max_diff(got, want) <= BAR
    jx = [jnp.asarray(a, jnp.float32) for a in (xa, wa, ba, ga, bea, ra)]
    pallas = pallas_matmul.fused_linear(
        jx[0], jx[1], jx[2], act, ln_scale=jx[3], ln_bias=jx[4],
        residual=jx[5] if with_res else None, interpret=True)
    assert _max_diff(got, pallas) <= BAR


def test_k6_one_pass_misses_the_bar():
    xa, wa, ba, ga, bea, _ = _inputs(3, 64, 768, 64)
    x, w, bias, g, beta = (_t(a) for a in (xa, wa, ba, ga, bea))
    want = reference.fused_linear(x, w, bias, ln_scale=g, ln_bias=beta)
    assert _max_diff(k6_tf32_tile(x, w, bias, None, None, g, beta),
                     want) <= BAR
    one = k6_tf32_tile(x, w, bias, None, None, g, beta, passes=1)
    assert _max_diff(one, want) > BAR


def test_k6_fragments_cover_the_step_once_past_k_zero():
    """``load_a_ln``'s indices: every (row, column) of the 128 x 32 step
    once; a row's statistics and a column's parameters are the ones its
    element is read at (rows past M keep zero statistics, the element
    unused; columns past K are zeros whatever gamma and beta hold)."""
    m, k = 70, 40
    x = torch.arange(m * k, dtype=torch.float32).reshape(m, k)
    mu = torch.arange(m, dtype=torch.float32) * 0.5
    rs = 1 + torch.arange(m, dtype=torch.float32)
    gamma = torch.full((k,), 2.0)
    beta = torch.arange(k, dtype=torch.float32)
    rr, cc = np.meshgrid(np.arange(BM), np.arange(BK), indexing="ij")
    for k0 in (0, 32):
        box = torch.zeros(BM, BK)
        cols = min(BK, k - k0)
        box[:m, :cols] = x[:, k0:k0 + cols]
        raw = torch.zeros(BM * BK)
        raw[torch.from_numpy(sw(rr, cc)).reshape(-1)] = box.reshape(-1)
        a = ln_fragments(raw, mu, rs, gamma, beta, 0, k0, m, k)
        want = torch.zeros(BM, BK)
        want[:m, :cols] = ((x[:, k0:k0 + cols] - mu[:, None]) * rs[:, None]
                           * 2.0 + beta[k0:k0 + cols])
        want[m:, :cols] = beta[k0:k0 + cols]  # zero statistics past M
        assert torch.equal(a, want)


def test_k6_fragment_loads_hit_32_banks():
    """Each shared-memory load instruction of ``load_a_ln`` (slice s,
    column half u, row half h: lane (g, q) reads row 16 w + g + 8 h,
    column 8 s + q + 4 u of the raw box) puts its 32 words in 32 distinct
    banks, as ``load_a``'s do: the swizzle spreads the eight rows."""
    for wgi in (0, 1):
        for warp in range(4):
            for s_ in range(BK // 8):
                for u in (0, 1):
                    for h in (0, 1):
                        words = [int(sw(64 * wgi + 16 * warp + lane // 4
                                        + 8 * h, 8 * s_ + lane % 4 + 4 * u))
                                 for lane in range(32)]
                        assert len({w % 32 for w in words}) == 32


# ------------------------------------------------------ the tile rule --

BATCHES = (1, 2, 3, 4, 8, 32, 256)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_k6_fp32_takes_the_tf32_tile_on_every_composed_route_call(variant):
    """Every fp32 K6 call of the composed route (LN1 + QKV, LN2 + fc1,
    contiguous whole allocations) has 16-byte aligned bases and rows of a
    multiple of 4 floats: ``gemm_path`` gives it the wgmma tile, which
    ``vit_fused_linear_tile`` now picks in fp32 too."""
    cfg = VARIANTS[variant]
    d, mlp = cfg.hidden_dim, cfg.mlp_dim
    sp = -(-cfg.seq_len // 16) * 16
    for b in BATCHES:
        for n in (3 * d, mlp):
            assert cuda_matmul.gemm_path(
                b * sp, n, d, torch.float32, False, False, (0, 256),
                ((d, 1), (n, 1))) == "wgmma"


@pytest.mark.parametrize("offset,k,n,path", [
    (0, 768, 2304, "wgmma"), (4, 768, 2304, "ffma"), (0, 200, 100, "wgmma"),
    (0, 198, 100, "ffma"), (0, 768, 102, "ffma")])
def test_k6_fp32_tile_by_alignment(offset, k, n, path):
    """The fp32 rule on contiguous x (at ``offset`` bytes into its storage)
    and w: bases 16-byte aligned, K and N multiples of 4; K8 takes the same
    rule in fp32 (FFMA on the misaligned base, the ragged K and N)."""
    buf = torch.zeros(37 * k + 4)
    x = buf[offset // 4:offset // 4 + 37 * k].view(37, k)
    w = torch.zeros((k, n))
    assert cuda_matmul.gemm_path(37, n, k, torch.float32, False, False,
                                 (x.data_ptr(), w.data_ptr()),
                                 ((k, 1), (n, 1))) == path
    assert embed_tile(x.view(1, 37, k), w) == path
