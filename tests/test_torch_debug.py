"""The port's last standalone kernels' plain versions against the JAX
package's:

- ``reference.patchify`` (the plain version of K19, and the models' layout
  copy) against the Pallas ``patchify`` in interpret mode, bit for bit, at
  the variants' geometries, a ragged W/P and one channel; ``ops.patchify``
  dispatches like every other op, and no model route calls it;
- ``ops/debug.py:pid_conds`` against ``vit_tpu/ops/pallas/debug.py:
  pid_conds`` evaluated by a Pallas kernel at every program id of a
  (3, 4, 2) grid, and the smoke kernel's plain version (K20's);
- the minimal matmul example's plain version (K21's) against
  ``examples/minimal_pallas_matmul.py`` in interpret mode.
"""

import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vit_tpu.ops.pallas import debug as jax_debug
from vit_tpu.ops.pallas import patching as jax_patching
from vit_tpu_torch import ops
from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.examples import minimal_matmul
from vit_tpu_torch.models import vit
from vit_tpu_torch.ops import debug, reference
from vit_tpu_torch.weights.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


# -------------------------------------------------------------- patchify --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c,size,p", [
    (2, 3, 224, 16), (2, 3, 224, 14), (1, 3, 384, 16), (2, 3, 80, 16),
    (2, 1, 32, 8)])
def test_torch_patchify_matches_pallas_bit_for_bit(dtype, b, c, size, p):
    """B/16 and B/32-style 224/P16, H/14's 224/P14, L/16-384's 384/P16, a
    ragged 80/P16 (5 patches a row, padded to 8 inside the Pallas kernel)
    and one channel."""
    x = np.random.default_rng(size + p).standard_normal(
        (b, c, size, size)).astype(np.float32)
    want = jax_patching.patchify(jnp.asarray(x, JDT[dtype]), p,
                                 interpret=True)
    got = ops.patchify(torch.from_numpy(x).to(getattr(torch, dtype)), p)
    assert got.dtype == getattr(torch, dtype) and got.is_contiguous()
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)))


def test_torch_patchify_dispatch():
    """``impl=None`` on a CPU tensor is the plain version; ``"cuda"``
    raises there, as every op's does; the result carries no gradient."""
    x = torch.randn(1, 3, 32, 32, requires_grad=True)
    got = ops.patchify(x, 16)
    assert torch.equal(got, reference.patchify(x, 16))
    assert not got.requires_grad
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.patchify(x, 16, impl="cuda")
    with pytest.raises(ValueError, match="not divisible"):
        ops.patchify(x, 12)


@pytest.mark.parametrize("route", ["layers", "stack_fused", "quant"])
def test_torch_no_model_route_calls_ops_patchify(route, monkeypatch):
    """The models unfold through the layout copy ``reference.patchify``,
    as JAX's leave the unfold to XLA, so K19 adds no launch to a forward."""
    from vit_tpu_torch.quant import forward_quant, quantize_params

    cfg = ViTConfig(image_size=32, patch_size=16, hidden_dim=128,
                    num_heads=4, num_layers=1, mlp_dim=512, num_classes=4)
    rng = np.random.default_rng(0)
    params = params_from_numpy(_np_params(cfg, rng), cfg, device="cpu")
    calls = []
    monkeypatch.setattr(ops, "patchify", lambda *a, **k: calls.append(1))
    if route == "stack_fused":
        monkeypatch.setattr(ops, "stack_fused_plan", lambda *a: True)
    px = torch.from_numpy(rng.standard_normal((1, 3, 32, 32)).astype(
        np.float32))
    if route == "quant":
        out = forward_quant(quantize_params(params), px, cfg)
    else:
        out = vit.forward(params, px, cfg)
    assert out.shape == (1, 4) and not calls


def _np_params(cfg, rng):
    """Random numpy params in the JAX package's layout."""
    d, m, l = cfg.hidden_dim, cfg.mlp_dim, cfg.num_layers
    w = lambda *sh: (0.05 * rng.standard_normal(sh)).astype(np.float32)
    return {
        "embeddings": {"cls_token": w(1, 1, d),
                       "position_embeddings": w(1, cfg.seq_len, d),
                       "patch_embed": {"kernel": w(cfg.patch_dim, d),
                                       "bias": w(d)}},
        "encoder": {
            "ln1": {"scale": 1 + w(l, d), "bias": w(l, d)},
            "qkv": {"kernel": w(l, d, 3 * d), "bias": w(l, 3 * d)},
            "out": {"kernel": w(l, d, d), "bias": w(l, d)},
            "ln2": {"scale": 1 + w(l, d), "bias": w(l, d)},
            "fc1": {"kernel": w(l, d, m), "bias": w(l, m)},
            "fc2": {"kernel": w(l, m, d), "bias": w(l, d)}},
        "ln_final": {"scale": 1 + w(d), "bias": w(d)},
        "classifier": {"kernel": w(d, cfg.num_classes),
                       "bias": w(cfg.num_classes)},
    }


# -------------------------------------------------------------- print_if --

CONDS = ["=0", "=0,>1", "!=1,,<=1", ">=1,<3,=1", "", "==2, , >0"]
GRID = (3, 4, 2)


def _jax_pid_table(conds: str) -> np.ndarray:
    """JAX's ``pid_conds(conds)`` at every program id of :data:`GRID`,
    written by a test-only Pallas kernel in interpret mode."""
    def kernel(o_ref):
        o_ref[...] = jnp.broadcast_to(
            jax_debug.pid_conds(conds).astype(jnp.int32), (1, 1, 1))

    out = pl.pallas_call(
        kernel, grid=GRID,
        out_specs=pl.BlockSpec((1, 1, 1), lambda i, j, k: (i, j, k)),
        out_shape=jax.ShapeDtypeStruct(GRID, jnp.int32),
        interpret=True)()
    return np.asarray(out).astype(bool)


@pytest.mark.parametrize("conds", CONDS)
def test_torch_pid_conds_match_jax_at_every_program_id(conds):
    want = _jax_pid_table(conds)
    got = np.array([[[debug.pid_matches(conds, (i, j, k))
                      for k in range(GRID[2])] for j in range(GRID[1])]
                    for i in range(GRID[0])])
    np.testing.assert_array_equal(got, want)
    assert len(debug.conds_args(conds)) == 6


@pytest.mark.parametrize("conds", ["=x", ">", "=1.5", "1", "~1", "=0,=1,=2,=3"])
def test_torch_malformed_conds_raise_in_both(conds):
    """No operator, no integer, or a fourth axis: JAX raises when it traces
    the condition (``int()``'s ValueError; a KeyError for an unknown
    operator), the port a ValueError when it parses it."""
    with pytest.raises(KeyError if conds == "~1" else ValueError):
        _jax_pid_table(conds)
    with pytest.raises(ValueError):
        debug.pid_conds(conds)


def test_torch_print_if_smoke_plain_prints_the_matching_blocks(capsys):
    """The smoke kernel's plain version on a CPU tensor: the copy, and one
    line for each block whose index satisfies the conditions, in block
    order, with its tile's fp32 sum -- the JAX test's kernel at
    ``'=0'`` over a grid of 2, and a (3, 4) grid at ``'=1,>1'``."""
    x = torch.ones(16, 128)
    out = debug.print_if_smoke(x, "=0", grid=(2,))
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    assert capsys.readouterr().out.splitlines() == [
        "block (0, 0, 0) sum = 1024"]
    y = torch.arange(24 * 512, dtype=torch.float32).reshape(24, 512) % 7 - 3
    debug.print_if_smoke(y.to(torch.bfloat16), "=1,>1", grid=(3, 4))
    lines = capsys.readouterr().out.splitlines()
    assert lines == debug.print_if_lines(y, "=1,>1", grid=(3, 4))
    assert [ln.split(" sum")[0] for ln in lines] == [
        "block (1, 2, 0)", "block (1, 3, 0)"]
    assert float(lines[0].split("= ")[1]) == float(y[8:16, 256:384].sum())
    with pytest.raises(ValueError, match="tile"):
        debug.print_if_smoke(x, grid=(3,))
    with pytest.raises(ValueError, match="CUDA tensor"):
        debug.print_if_smoke(x, impl="cuda")


# -------------------------------------------------------- minimal matmul --

def _pallas_example():
    return runpy.run_path(str(ROOT / "examples" / "minimal_pallas_matmul.py"))


def test_torch_minimal_matmul_plain_matches_the_pallas_example():
    """(256, 384) @ (384, 512) in fp32, the example's shapes and inputs,
    within 1e-5 of the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((256, 384)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((384, 512)) * 0.1).astype(np.float32)
    want = np.asarray(_pallas_example()["matmul"](jnp.asarray(x),
                                                  jnp.asarray(w)))
    got = minimal_matmul.matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (256, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    bf = minimal_matmul.matmul(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(w).bfloat16())
    assert bf.dtype == torch.bfloat16


def test_torch_minimal_matmul_refuses_what_the_example_asserts():
    x, w = np.zeros((128, 100), np.float32), np.zeros((100, 128), np.float32)
    with pytest.raises(AssertionError):
        _pallas_example()["matmul"](jnp.asarray(x), jnp.asarray(w))
    with pytest.raises(ValueError, match="multiple of 128"):
        minimal_matmul.matmul(torch.from_numpy(x), torch.from_numpy(w))
    with pytest.raises(ValueError, match="CUDA tensor"):
        minimal_matmul.matmul(torch.zeros(128, 128), torch.zeros(128, 128),
                              impl="cuda")


def test_torch_minimal_matmul_example_runs_on_the_cpu(capsys):
    assert minimal_matmul.main(["--device", "cpu"]) == 0
    assert "PASSED" in capsys.readouterr().out
