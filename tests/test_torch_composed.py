"""The port's composed encoder route against the JAX package's.

``encoder_block`` runs a half of a layer on its mega-kernel where
``ops.attn_plan`` / ``ops.mlp_plan`` say it fits, and composes it from
``fused_linear`` and ``flash_attention`` otherwise, as
``vit_tpu/models/vit.py:encoder_block`` does. Here:

- an L/16-384-shaped narrow config (384 px, P=16: 577 tokens padded to
  592; D=64) through the composed route, against JAX ``forward`` at
  ``impl="pallas"`` (interpret mode) and ``impl="xla"``. At D=64 every JAX
  plan refuses (D % 128) and the port's ``attn_plan`` refuses at S=592;
  the port's fp32 MLP kernel would take D=64, so ``mlp_plan`` is patched
  off to compose both halves in both dtypes;
- the one-sided routes at the tiny config, with the same half patched off
  on both sides;
- the route table of every variant, which shows the fault of the port
  before this route existed: L/16-384 and H/14 had a half that no port
  kernel takes.

Bars: fp32 max|diff| <= 1e-4; bf16 |diff| <= 2e-2 * (1 + |ref|) against
the Pallas tier and 5e-2 * (1 + |ref|) against the XLA tier
(``tests/test_torch_model.py`` says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.ops as jax_ops
from vit_tpu.config import ViTConfig as JaxConfig
from vit_tpu.models import vit as jax_vit
from vit_tpu_torch import ops
from vit_tpu_torch.config import VARIANTS, ViTConfig
from vit_tpu_torch.models import vit
from vit_tpu_torch.weights.convert import params_from_numpy

NARROW_L16_384 = dict(image_size=384, patch_size=16, hidden_dim=64,
                      num_heads=2, num_layers=2, mlp_dim=128)
TINY = dict(image_size=32, patch_size=8, hidden_dim=128, num_heads=2,
            num_layers=2, mlp_dim=256)
DTYPES = ["float32", "bfloat16"]


def _models(geometry, dtype):
    """JAX config and params, and the port's config and the same params,
    with non-trivial LN and biases."""
    jcfg = JaxConfig(**geometry, dtype=getattr(jnp, dtype))
    tcfg = ViTConfig(**geometry, dtype=getattr(torch, dtype))
    jparams = jax_vit.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(1)
    jparams = jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.standard_normal(a.shape), a.dtype),
        jparams)
    return jcfg, jparams, tcfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _pixels(cfg, n=2, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, cfg.image_size, cfg.image_size)).astype(np.float32)


def _close(got: torch.Tensor, want, dtype: str, bf16_bar: float) -> None:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-4, diff.max()
    else:
        assert (diff <= bf16_bar * (1 + np.abs(want))).all(), diff.max()


def _compose_all(monkeypatch):
    """Route both halves of every layer of the port through the composed
    ops, and fail if a mega-kernel op is reached."""
    monkeypatch.setattr(ops, "mlp_plan", lambda *a: False)

    def refuse(*a, **k):
        raise AssertionError("a mega-kernel op ran on the composed route")

    monkeypatch.setattr(ops, "attn_block", refuse)
    monkeypatch.setattr(ops, "mlp_block", refuse)


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_composed_forward_matches_jax_pallas(dtype, monkeypatch):
    jcfg, jparams, tcfg, tparams = _models(NARROW_L16_384, dtype)
    assert (tcfg.seq_len, vit._padded_seq(tcfg)) == (577, 592)
    assert not ops.attn_plan(2, 592, 64, 2, tcfg.dtype)
    _compose_all(monkeypatch)
    px = _pixels(tcfg)
    want = jax_vit.forward(jparams, jnp.asarray(px), jcfg, impl="pallas")
    got = vit.forward(tparams, torch.from_numpy(px), tcfg)
    assert got.dtype == tcfg.dtype
    _close(got, want, dtype, 2e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_composed_forward_matches_jax_xla(dtype, monkeypatch):
    jcfg, jparams, tcfg, tparams = _models(NARROW_L16_384, dtype)
    _compose_all(monkeypatch)
    px = _pixels(tcfg)
    want = jax_vit.forward(jparams, jnp.asarray(px), jcfg, impl="xla")
    _close(vit.forward(tparams, torch.from_numpy(px), tcfg), want, dtype,
           5e-2)


def test_torch_composed_forward_with_intermediates_per_layer(monkeypatch):
    jcfg, jparams, tcfg, tparams = _models(NARROW_L16_384, "float32")
    _compose_all(monkeypatch)
    px = _pixels(tcfg)
    jfinal, jh = jax_vit.forward_with_intermediates(
        jparams, jnp.asarray(px), jcfg, impl="pallas")
    final, hiddens = vit.forward_with_intermediates(
        tparams, torch.from_numpy(px), tcfg)
    assert len(hiddens) == len(jh) == NARROW_L16_384["num_layers"] + 1
    for i, (got, want) in enumerate(zip(hiddens, jh)):
        assert got.shape == (2, 577, 64), i
        _close(got, want, "float32", 0)
    _close(final, jfinal, "float32", 0)
    torch.testing.assert_close(
        final, vit.forward(tparams, torch.from_numpy(px), tcfg),
        rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_composed_route_op_counts(dtype, monkeypatch):
    """At the narrow L/16-384 geometry each layer composes its attention
    (fused_linear with LN, flash attention over the packed QKV buffer,
    fused_linear + residual); the MLP half is the fp32 kernel in fp32 and
    composed in bf16 (D % 128)."""
    _, _, tcfg, tparams = _models(NARROW_L16_384, dtype)
    calls = {}
    for name in ("fused_linear", "flash_attention", "flash_attention_qkv",
                 "attn_block", "mlp_block", "layernorm_stats"):
        def spy(*a, _name=name, _fn=getattr(ops, name), **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    vit.forward(tparams, torch.from_numpy(_pixels(tcfg)), tcfg)
    layers = tcfg.num_layers
    mlp_mega = dtype == "float32"
    assert calls == {"fused_linear": layers * (2 if mlp_mega else 4),
                     "flash_attention_qkv": layers,
                     **({"mlp_block": layers} if mlp_mega else {})}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("composed", ["attn", "mlp"])
def test_torch_one_sided_route_matches_jax(dtype, composed, monkeypatch):
    """One half composed, the other on its mega-kernel, on both sides."""
    jcfg, jparams, tcfg, tparams = _models(TINY, dtype)
    plan = f"{composed}_plan"
    monkeypatch.setattr(ops, plan, lambda *a: False)
    for name in (plan, "stack_plan", "stack_fused_plan"):
        monkeypatch.setattr(jax_ops, name, lambda *a: False)
    px = _pixels(tcfg)
    want = jax_vit.forward(jparams, jnp.asarray(px), jcfg, impl="pallas")
    _close(vit.forward(tparams, torch.from_numpy(px), tcfg), want, dtype,
           2e-2)


#: (attention half, MLP half) on its mega-kernel, per variant and dtype.
ROUTES = {
    ("B/16", "float32"): (True, True), ("B/16", "bfloat16"): (True, True),
    ("B/32", "float32"): (True, True), ("B/32", "bfloat16"): (True, True),
    ("L/16", "float32"): (True, True), ("L/16", "bfloat16"): (True, True),
    ("DeiT-B/16", "float32"): (True, True),
    ("DeiT-B/16", "bfloat16"): (True, True),
    ("L/16-384", "float32"): (False, True),
    ("L/16-384", "bfloat16"): (False, True),
    ("H/14", "float32"): (False, True),
    ("H/14", "bfloat16"): (True, False),
}


@pytest.mark.parametrize("variant,dtype", list(ROUTES))
def test_torch_route_table(variant, dtype):
    """Every variant has a route: a half whose mega-kernel refuses the
    geometry (L/16-384's 592 tokens overflow the attention core's shared
    memory; H/14 bf16's D=1280 is over the bf16 mlp_block's 1024; H/14
    fp32's 272 tokens at head_dim 80 overflow the fp32 core) is composed.
    The plans take no device, and B/16's route is both halves mega."""
    cfg = VARIANTS[variant]
    dt = getattr(torch, dtype)
    sp = vit._padded_seq(cfg)
    got = (ops.attn_plan(32, sp, cfg.hidden_dim, cfg.num_heads, dt),
           ops.mlp_plan(cfg.hidden_dim, cfg.mlp_dim, dt))
    assert got == ROUTES[variant, dtype]
