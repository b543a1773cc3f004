"""K8 ``embed_fused``'s fp32 form on K2's tf32 tile (``csrc/gemm_tf32.cuh``
with the ``Tf32Embed`` epilogue, launched by ``csrc/matmul_tf32.cu:
launch_tf32_embed``), on the CPU.

CUDA kernels do not run here, so the walk is modelled in PyTorch: the
persistent blocks' 128 x 128 tiles in the kernel's order, K in 32-deep
steps through zero-filled boxes, each step's three TF32 passes
(``vit_tpu_torch/tools/tf32_probe.py:split``, lo_a hi_b + hi_a lo_b + hi_a
hi_b) summed into a fresh accumulator and added to the tile's total, then
the embedding epilogue: (total + bias) + pos[i] in fp32 at token row g*sp +
1 + i, and each image's CLS row and zero pad rows from the block that walks
a column tile's first row tile. The model is held bit for bit to
``tests/test_torch_fp32_split.py``'s model of K2's tile + pos, within the
fp32 bar (1e-4) to JAX's Pallas ``embed_fused`` in interpret mode and to
``reference.embed_fused`` (one TF32 pass misses it), and it writes every
token element once. ``embed_tile``'s fp32 rule is ``gemm_path``'s.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fp32_split import k2_tf32_tile
from vit_tpu.ops.pallas import patch_embed as pallas_embed
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.cuda import matmul as cuda_matmul
from vit_tpu_torch.ops.cuda.embed import embed_tile
from vit_tpu_torch.tools.tf32_probe import split

SRC = (Path(__file__).resolve().parents[1] / "vit_tpu_torch" / "csrc"
       / "gemm_tf32.cuh").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


BM, BN, BK = _const("kBM"), _const("kBN"), _const("kBK")
SMS = 132
BAR = 1e-4  # the fp32 kernels' bar against their plain versions


def walk(m: int, d: int, sms: int = SMS):
    """The tiles of the persistent walk in each block's order: (block, m0,
    n0), block i taking tiles i, i + grid, ... (tile t at row tile t %
    tiles_m), grid = min(tiles, SMs)."""
    tm, tn = -(-m // BM), -(-d // BN)
    tiles = tm * tn
    grid = min(tiles, sms)
    for blk in range(grid):
        for t in range(blk, tiles, grid):
            yield blk, (t % tm) * BM, (t // tm) * BN


def fixed_rows(b: int, n: int, sp: int) -> torch.Tensor:
    """Each image's row 0 and pad rows n+1 .. sp-1, as token rows."""
    return torch.tensor([g * sp + j for g in range(b)
                         for j in [0, *range(n + 1, sp)]], dtype=torch.long)


def k8_tf32_walk(patches, w, bias, cls_row, pos, sp, *, passes: int = 3):
    """K8's fp32 form on the CPU: returns the (B, sp, D) tokens and how
    often each element was written."""
    b, n, k = patches.shape
    d = w.shape[1]
    m = b * n
    x = patches.reshape(m, k)
    out = torch.full((b * sp, d), float("nan"))
    writes = torch.zeros((b * sp, d), dtype=torch.int32)
    for _, m0, n0 in walk(m, d):
        rows, cols = min(BM, m - m0), min(BN, d - n0)
        total = torch.zeros(BM, BN)
        for k0 in range(0, k, BK):
            kk = min(BK, k - k0)
            a = torch.zeros(BM, BK)
            a[:rows, :kk] = x[m0:m0 + rows, k0:k0 + kk]
            bb = torch.zeros(BK, BN)
            bb[:kk, :cols] = w[k0:k0 + kk, n0:n0 + cols]
            (ah, al), (bh, bl) = split(a), split(bb)
            if passes == 3:
                part = (torch.matmul(al, bh) + torch.matmul(ah, bl)) \
                    + torch.matmul(ah, bh)
            else:
                part = torch.matmul(ah, bh)
            total = total + part
        r = torch.arange(m0, m0 + rows)
        c = torch.arange(n0, n0 + cols)
        z = total[:rows, :cols] + bias[c]
        orow = r // n * sp + 1 + r % n
        out[orow[:, None], c] = z + pos[r % n][:, c]
        writes[orow[:, None], c] += 1
        if m0 == 0:
            fixed = fixed_rows(b, n, sp)
            vals = torch.zeros(len(fixed), cols)
            vals[torch.arange(0, len(fixed), sp - n)] = cls_row[c]
            out[fixed[:, None], c] = vals
            writes[fixed[:, None], c] += 1
    return out.view(b, sp, d), writes


def _inputs(b, n, k, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, k)), 0.03 * rng.standard_normal((k, d)),
            0.1 * rng.standard_normal(d), rng.standard_normal(d),
            rng.standard_normal((n, d))]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("b,n,k,d,sp", [(2, 20, 72, 136, 24),
                                        (3, 50, 40, 128, 56)])
def test_k8_tf32_walk_is_k2_tile_plus_pos(b, n, k, d, sp):
    """Each token row is bit for bit K2's fp32 tile on the same operands
    with the bias (the element-level model of ``gemm_tf32.cuh``'s tile),
    + pos in fp32; row 0 is cls_row and the pad rows are zero."""
    t = [_t(a) for a in _inputs(b, n, k, d, 11 * b + k)]
    got, writes = k8_tf32_walk(*t, sp)
    assert (writes == 1).all()
    k2 = k2_tf32_tile(t[0].reshape(b * n, k), t[1], t[2], None, None)
    assert torch.equal(got[:, 1:n + 1], k2.reshape(b, n, d) + t[4])
    assert torch.equal(got[:, 0], t[3].expand(b, d))
    assert not got[:, n + 1:].any()


@pytest.mark.parametrize("b,n,k,d,sp", [(2, 20, 72, 128, 24),
                                        (3, 50, 100, 256, 64),
                                        (2, 49, 588, 128, 64)])
def test_k8_tf32_walk_matches_pallas_and_reference(b, n, k, d, sp):
    """The walk within the fp32 bar of JAX's Pallas ``embed_fused`` (fp32
    at ``Precision.HIGHEST``) in interpret mode and of
    ``reference.embed_fused``, at K ending on a ragged 32-deep step (72,
    100 and H/14's 588), B >= 2 and sp > N + 1; one TF32 pass misses the
    bar, which is why the form splits."""
    arrays = _inputs(b, n, k, d, 7 * n + k)
    t = [_t(a) for a in arrays]
    assert k % BK
    got, writes = k8_tf32_walk(*t, sp)
    assert (writes == 1).all()
    pallas = np.asarray(pallas_embed.embed_fused(
        *[jnp.asarray(np.asarray(a, np.float32)) for a in arrays], sp,
        interpret=True))
    assert np.isfinite(got.numpy()).all()
    assert float(np.abs(got.numpy() - pallas).max()) <= BAR
    assert float((got - reference.embed_fused(*t, sp)).abs().max()) <= BAR
    one, _ = k8_tf32_walk(*t, sp, passes=1)
    assert float(np.abs(one.numpy() - pallas).max()) > BAR


@pytest.mark.parametrize("case", [
    ("B/16 bs=1", 1, 196, 768, 208), ("B/16 bs=2", 2, 196, 768, 208),
    ("B/16 bs=3", 3, 196, 768, 208), ("B/16 bs=4", 4, 196, 768, 208),
    ("B/32 bs=3", 3, 49, 768, 64), ("L/16-384 bs=4", 4, 576, 1024, 592),
    ("H/14 bs=1", 1, 256, 1280, 272), ("H/14 bs=2", 2, 256, 1280, 272)])
def test_k8_tf32_walk_writes_every_token_element_once(case):
    """At the small-batch route's geometries every element of (B, sp, D)
    is written exactly once: the patch rows by their tiles' epilogues, row
    0 and the pad rows by the first row tile's block of each column tile;
    and the grid takes two rounds only where the tiles outnumber the SMs
    (L/16-384 bs=4: 144)."""
    _, b, n, d, sp = case
    m = b * n
    writes = torch.zeros((b * sp, d), dtype=torch.int32)
    per_block = {}
    for blk, m0, n0 in walk(m, d):
        per_block[blk] = per_block.get(blk, 0) + 1
        r = torch.arange(m0, min(m0 + BM, m))
        c = torch.arange(n0, min(n0 + BN, d))
        writes[(r // n * sp + 1 + r % n)[:, None], c] += 1
        if m0 == 0:
            writes[fixed_rows(b, n, sp)[:, None], c] += 1
    assert (writes == 1).all()
    tiles = -(-m // BM) * -(-d // BN)
    assert sum(per_block.values()) == tiles
    assert max(per_block.values()) == (2 if tiles > SMS else 1)


@pytest.mark.parametrize("off_x,off_w,k,d,tile", [
    (0, 0, 768, 768, "wgmma"), (0, 0, 588, 1280, "wgmma"),
    (0, 0, 72, 256, "wgmma"), (4, 0, 768, 768, "wgmma"),
    (1, 0, 768, 768, "ffma"), (2, 0, 588, 1280, "ffma"),
    (0, 1, 768, 768, "ffma"), (0, 0, 590, 768, "ffma"),
    (0, 0, 768, 770, "ffma")])
def test_embed_tile_fp32_rule(off_x, off_w, k, d, tile):
    """``embed_tile`` in fp32 is ``gemm_path``'s rule for K2 on the same
    (B*N, K) @ (K, D) operands: the tf32 tile where both bases are 16-byte
    aligned (``off_x``, ``off_w``: floats past an aligned start) and K and
    D are multiples of 4 floats (H/14's K = 588 included), FFMA
    elsewhere."""
    b, n = 2, 3
    x = torch.zeros(b * n * k + off_x)[off_x:].view(b, n, k)
    w = torch.zeros(k * d + off_w)[off_w:].view(k, d)
    assert embed_tile(x, w) == tile
    assert cuda_matmul.gemm_path(b * n, d, k, torch.float32, False, False,
                                 (x.data_ptr(), w.data_ptr()),
                                 ((k, 1), (d, 1))) == tile


def test_k8_tf32_epilogue_order_in_the_source():
    """The kernel's epilogue adds the bias to the sums, then pos, in fp32
    (``_embed_kernel``'s order, the cast a no-op), at token row g*sp + 1 +
    i, and the fixed rows come from the first row tile."""
    body = SRC[SRC.index("const Tf32Embed& ep, int m0"):]
    body = body[:body.index("\n}\n")]
    assert "orow[h] = (static_cast<size_t>(g) * ep.sp + 1 + i) * ep.n;" \
        in body
    assert "d[4 * j + 2 * h] + b0" in body and "v0 + pv.x" in body
    assert "if (m0 == 0) embed_fixed_rows(ep, n0);" in SRC
