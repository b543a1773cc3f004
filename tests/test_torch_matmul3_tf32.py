"""K16's fp32 form on the tensor cores (``csrc/matmul3.cu``,
``matmul3_tf32_kernel``) modelled on the CPU: its sums in PyTorch (every
operand split once into tf32 hi and lo as it is staged, three passes a k8
slice into one accumulator up to K = 208, 64-deep runs added in K order
past it, then the scale)
against ``reference.matmul3`` and JAX's Pallas ``matmul3`` in interpret
mode at the fp32 bar, at ragged shapes and the unaligned 197-token rows;
its shared-memory maps (the staged runs, the ldmatrix A fragments, the B
fragments, the output tile) with the banks each warp instruction touches,
and its shared memory.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops.pallas.matmul3 import matmul3 as jax_matmul3
from vit_tpu_torch.ops import reference
from vit_tpu_torch.tools.tf32_probe import matmul_split

BAR = 1e-4
KS = 16  # K a step
ONE, RUN = 208, 64  # K one accumulator takes; past it, K an accumulator
LDX = KS + 4  # x's shared rows, in floats
TILES = [(64, 64), (128, 64), (64, 128), (128, 128)]  # (TM, TN)


def tile_for(b, m, n):
    """``launch_matmul3_tf32``'s tile: 128 rows or columns where the
    product has more than 64 and the grid keeps 264 blocks, two an SM."""
    tm, tn = (128 if m > 64 else 64), (128 if n > 64 else 64)
    if -(-m // tm) * -(-n // tn) * b < 264:
        return 64, 64
    return tm, tn


def k16_tf32_model(x, y, *, scale=None):
    """``(B, M, K) @ (B, K, N)`` as the fp32 form sums it: the three-pass
    split product in one accumulator up to K = 208; past it each 64-deep
    run of K a split product of its own, the runs added in order (the
    first starts the sum); then ``__fmul_rn(acc, scale)``."""
    x, y = x.float(), y.float()
    run = x.shape[2] if x.shape[2] <= ONE else RUN
    acc = None
    for k0 in range(0, x.shape[2], run):
        part = matmul_split(x[:, :, k0:k0 + run], y[:, k0:k0 + run])
        acc = part if acc is None else acc + part
    return acc if scale is None else acc * scale


@pytest.mark.parametrize("b,m,k,n,scale", [
    (3, 37, 16, 37, 0.125),   # the scores' shape, narrow
    (3, 37, 37, 16, None),    # the context's: ragged K
    (2, 70, 130, 66, 0.5),    # nine K steps, the last ragged; two N tiles
    (1, 1, 5, 1, None),       # K < 8
    (2, 33, 300, 45, None),   # past 208: five runs, the last ragged
])
def test_model_matches_jax_matmul3(b, m, k, n, scale):
    rng = np.random.default_rng(b * 1000 + m + k + n)
    xa = rng.standard_normal((b, m, k)).astype(np.float32)
    ya = (rng.standard_normal((b, k, n)) * 0.3).astype(np.float32)
    got = k16_tf32_model(torch.from_numpy(xa), torch.from_numpy(ya),
                         scale=scale)
    want = np.asarray(jax_matmul3(jnp.asarray(xa), jnp.asarray(ya),
                                  scale=scale, interpret=True))
    assert np.abs(got.numpy() - want).max() <= BAR


def test_model_matches_the_plain_version_at_197_tokens_and_deep_k():
    """The scores (scaled) and the context at 197 tokens, and a K = 2304
    product with ragged M and N: 36 runs, each inside the depth one
    accumulator holds (K 64-208 within 6.5e-5 on the card, PERF.md
    section 6), where
    one accumulator over all of K = 2304 missed the bar there."""
    rng = np.random.default_rng(197)

    def t(a):
        return torch.from_numpy(a.astype(np.float32))
    q, kt = t(rng.standard_normal((2, 197, 64))), t(
        rng.standard_normal((2, 64, 197)))
    p = t(rng.dirichlet(np.ones(197), (2, 197)))
    v = t(rng.standard_normal((2, 197, 64)))
    for got, want in (
            (k16_tf32_model(q, kt, scale=0.125),
             reference.matmul3(q, kt, scale=0.125)),
            (k16_tf32_model(p, v), reference.matmul3(p, v))):
        assert float((got - want).abs().max()) <= BAR
    a, bm = t(rng.standard_normal((1, 97, 2304))), t(
        rng.standard_normal((1, 2304, 45)))
    got = k16_tf32_model(a, bm)
    assert float((got - reference.matmul3(a, bm)).abs().max()) <= BAR
    one = matmul_split(a, bm, passes=1)
    assert float((one - reference.matmul3(a, bm)).abs().max()) > BAR


# ------------------------------------------------- shared-memory maps --

def wavefronts(addrs, width):
    """Wavefronts of one warp instruction whose lanes access ``width``
    bytes at byte ``addrs`` (8-byte accesses in half-warp phases, 16-byte
    ones in quarter-warp phases; ``tests/test_torch_mlp_tf32.py``)."""
    per = {4: 32, 8: 16, 16: 8}[width]
    total = 0
    for p0 in range(0, 32, per):
        banks: dict[int, set[int]] = {}
        for a in addrs[p0:p0 + per]:
            for w in range(a // 4, (a + width) // 4):
                banks.setdefault(w % 32, set()).add(w)
        total += max(len(v) for v in banks.values())
    return total


def ldmatrix_words(rows_addr):
    """What ``ldmatrix.x4`` of 16-bit pairs gives each lane: lane l's row
    address is row l % 8 of matrix l // 8; lane l receives the 32-bit word
    l % 4 of row l // 4 of each matrix, as the float index it holds."""
    out = np.zeros((32, 4), np.int64)
    for mat in range(4):
        for lane in range(32):
            out[lane, mat] = rows_addr[8 * mat + lane // 4] + lane % 4
    return out


@pytest.mark.parametrize("i,kk", [(0, 0), (1, 8)])
def test_a_fragments_by_ldmatrix(i, kk):
    """Lane l's row address ``(wr + 16 i + l % 16) * 20 + kk + 4 (l // 16)``
    hands lane (g, t) the m16n8k8 tf32 A fragment: x(g, t), x(g + 8, t),
    x(g, t + 4), x(g + 8, t + 4) of the warp's 16-row tile; each matrix's
    eight 16-byte rows fall in eight distinct chunks."""
    for wr in (0, 32):
        addr = [(wr + 16 * i + lane % 16) * LDX + kk + 4 * (lane // 16)
                for lane in range(32)]
        words = ldmatrix_words(addr)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            r0 = wr + 16 * i
            want = [(r0 + g) * LDX + kk + t, (r0 + g + 8) * LDX + kk + t,
                    (r0 + g) * LDX + kk + t + 4,
                    (r0 + g + 8) * LDX + kk + t + 4]
            assert list(words[lane]) == want
        for mat in range(4):
            chunks = {(4 * a // 16) % 8 for a in addr[8 * mat:8 * mat + 8]}
            assert len(chunks) == 8


@pytest.mark.parametrize("tn", [64, 128])
def test_b_fragment_loads_have_no_bank_conflict(tn):
    """b0 = y(kk + t, wc + 8 j + g), b1 = y(kk + t + 4, ...) read as floats
    from rows of TN + 8: 32 lanes in 32 banks."""
    ldy = tn + 8
    for kk in (0, 8):
        for wc in range(0, tn, 32):
            for j in range(4):
                for d in (0, 4):
                    addrs = [4 * ((kk + lane % 4 + d) * ldy + wc + 8 * j
                                  + lane // 4) for lane in range(32)]
                    assert wavefronts(addrs, 4) == 1


@pytest.mark.parametrize("tm,tn", TILES)
def test_staged_runs_cover_each_tile_once(tm, tn):
    """A block of (TM / 32)(TN / 32) warps; thread tid's runs u = tid +
    threads i: x's (row u // 4, K 4 (u % 4)) and y's (K row u // (TN / 4),
    columns 4 (u % (TN / 4))), four floats each, cover the TM x 16 and
    16 x TN tiles once; y's 16-byte stores take one wavefront a
    quarter-warp, x's at most two."""
    threads = 32 * (tm // 32) * (tn // 32)
    q = tn // 4
    xs, ys = set(), set()
    for tid in range(threads):
        for i in range(4 * tm // threads):
            u = tid + threads * i
            xs.update((u // 4, 4 * (u % 4) + e) for e in range(4))
        for i in range(4 * tn // threads):
            u = tid + threads * i
            ys.update((u // q, 4 * (u % q) + e) for e in range(4))
    assert xs == {(r, c) for r in range(tm) for c in range(KS)}
    assert ys == {(r, c) for r in range(KS) for c in range(tn)}
    for u0 in range(0, 4 * tm, 32):
        us = range(u0, u0 + 32)
        x_addr = [4 * ((u // 4) * LDX + 4 * (u % 4)) for u in us]
        assert wavefronts(x_addr, 16) <= 8
    for u0 in range(0, 4 * tn, 32):
        us = range(u0, u0 + 32)
        y_addr = [4 * ((u // q) * (tn + 8) + 4 * (u % q)) for u in us]
        assert wavefronts(y_addr, 16) == 4


@pytest.mark.parametrize("tm,tn", TILES)
def test_output_tile_stores_are_conflict_free_and_fit(tm, tn):
    """The output tile (rows of TN + 8 floats) takes each warp's 8-byte
    pairs (row g + 8 r, columns 8 j + 2 t) in two wavefronts and fits the
    operand buffers it reuses (``M3F::kSmem``: 38,912 B at 64 x 64,
    75,776 at 128 x 128)."""
    ldo = tn + 8
    for wr in range(0, tm, 32):
        for wc in range(0, tn, 32):
            for i in (0, 1):
                for j in range(4):
                    for r in (0, 1):
                        addrs = [4 * ((wr + 16 * i + lane // 4 + 8 * r) * ldo
                                      + wc + 8 * j + 2 * (lane % 4))
                                 for lane in range(32)]
                        assert wavefronts(addrs, 8) == 2
    smem = 4 * (4 * tm * LDX + 4 * KS * (tn + 8))
    assert tm * ldo * 4 <= smem <= 232448
    assert {(64, 64): 38912, (128, 128): 75776}.get((tm, tn), smem) == smem


def test_tile_choice():
    """ViT's products at B/16 bs=32: the scores and the 200-token scores
    on 128 x 128 tiles, the context (N = 64) on 128 x 64; 197 rows pad to
    256 as with 64-row tiles; a small grid stays on 64 x 64."""
    assert tile_for(384, 197, 197) == (128, 128)
    assert tile_for(384, 200, 200) == (128, 128)
    assert tile_for(384, 197, 64) == (128, 64)
    assert tile_for(3, 37, 16) == (64, 64)
    assert tile_for(4, 197, 131) == (64, 64)  # K = 2304: 16 wide blocks
