"""JAX's Pallas ``mlp_block`` at a real width, with its plan pinned and
on the live tuned table, against the port's plain version.

Some tuned ``mlpblock`` entries of ``vit_tpu/ops/pallas/tuning``'s table
give a chunk ``ct`` that does not divide the tile ``mt = mlp // nt``; the
kernel then walks ``mt // ct`` chunks and never computes the hidden columns
past them (ROADMAP queue C, C1). At (208, 768, 3072) fp32, B/16 at bs=1,
the tuned plan is nt 4, ct 512: columns 512-767 of every 768-column tile
are dropped. Parity at real widths therefore pins the plan
(``VIT_TPU_MLP_PLAN="0,1,512"``: the whole hidden in six chunks), and this
file shows what the unpinned kernel computes. Both run JAX in interpret
mode on the CPU; fp32 max|diff| <= 1e-5 (sum order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops.pallas import block as pallas_block
from vit_tpu_torch.ops import reference

M, D, MLP = 208, 768, 3072  # B/16 at bs=1: 197 tokens padded to 208
TILE, CHUNK = 768, 512      # the tuned plan's mt = 3072 / 4 and ct


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(41)
    return (rng.standard_normal((M, D)), 1 + 0.1 * rng.standard_normal(D),
            0.05 * rng.standard_normal(D),
            0.03 * rng.standard_normal((D, MLP)),
            0.02 * rng.standard_normal(MLP),
            0.03 * rng.standard_normal((MLP, D)),
            0.02 * rng.standard_normal(D))


def _jax(arrays):
    out = pallas_block.mlp_block(
        *(jnp.asarray(a, jnp.float32) for a in arrays), eps=1e-12,
        interpret=True)
    return np.asarray(out)


def _plain(arrays, cols=None) -> np.ndarray:
    """``reference.mlp_block`` on the hidden columns ``cols`` (all if
    None)."""
    x, g, b, w1, b1, w2, b2 = (torch.from_numpy(np.asarray(a, np.float32))
                               for a in arrays)
    if cols is not None:
        w1, b1, w2 = w1[:, cols], b1[cols], w2[cols]
    return reference.mlp_block(x, g, b, w1, b1, w2, b2, eps=1e-12).numpy()


def test_mlp_block_pinned_plan_matches_the_plain_mlp(monkeypatch, arrays):
    monkeypatch.setenv("VIT_TPU_MLP_PLAN", "0,1,512")
    assert pallas_block.mlp_block_plan(M, D, MLP, 4) == (M, 1, 512)
    got = _jax(arrays)
    assert np.abs(got - _plain(arrays)).max() <= 1e-5


def test_mlp_block_tuned_plan_drops_hidden_columns(monkeypatch, arrays):
    """The unpinned kernel is the MLP without columns 512-767 of each
    768-column tile, within the fp32 bar, and far from the whole MLP."""
    monkeypatch.delenv("VIT_TPU_MLP_PLAN", raising=False)
    bm, nt, ct = pallas_block.mlp_block_plan(M, D, MLP, 4)
    assert (MLP // nt, ct) == (TILE, CHUNK)
    got = _jax(arrays)
    kept = [c for c in range(MLP) if c % TILE < CHUNK]
    assert np.abs(got - _plain(arrays, kept)).max() <= 1e-5
    assert np.abs(got - _plain(arrays)).max() > 0.1
