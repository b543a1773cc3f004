"""The port's ViT forward against the JAX package, and against the
``transformers`` recording at full B/16 size.

One set of weights (JAX ``init_params``, converted with
``params_from_numpy``) and one numpy batch feed both packages. The tiny
config has 17 tokens padded to 32, so the key mask is exercised.

Bars: fp32 max|diff| <= 1e-4. bf16 elementwise |diff| <= 5e-2 * (1 + |ref|):
looser than the op tests because JAX's XLA tier normalises the
probabilities before the PV product (``vit_tpu/ops/reference.py:196-200``)
while the port, like the Pallas kernel, divides afterwards, and the MLP
residual is added after a bf16 rounding there and before it here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.config import ViTConfig as JaxConfig
from vit_tpu.models import vit as jax_vit
from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.models import vit
from vit_tpu_torch.weights.convert import params_from_numpy

TINY = dict(image_size=32, patch_size=8, hidden_dim=128, num_heads=2,
            num_layers=2, mlp_dim=256)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_b16.npz")


def _models(dtype="float32", **kw):
    """JAX config and params, and the port's config and the same params."""
    jcfg = JaxConfig(**TINY, dtype=getattr(jnp, dtype), **kw)
    tcfg = ViTConfig(**TINY, dtype=getattr(torch, dtype), **kw)
    jparams = jax_vit.init_params(jax.random.key(0), jcfg)
    # Non-trivial LN and biases, so that every parameter matters.
    rng = np.random.default_rng(1)
    jparams = jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.standard_normal(a.shape), a.dtype),
        jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _pixels(n=2, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, 32, 32)).astype(np.float32)


def _close(got: torch.Tensor, want, dtype="float32", atol=1e-4) -> None:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= atol, diff.max()
    else:
        assert (diff <= 5e-2 * (1 + np.abs(want))).all(), diff.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_forward_matches_jax_xla(dtype):
    jcfg, jparams, tcfg, tparams = _models(dtype)
    px = _pixels()
    want = jax_vit.forward(jparams, jnp.asarray(px), jcfg, impl="xla")
    got = vit.forward(tparams, torch.from_numpy(px), tcfg)
    assert got.dtype == tcfg.dtype
    _close(got, want, dtype)


def test_torch_forward_with_intermediates_matches_jax_per_layer():
    jcfg, jparams, tcfg, tparams = _models()
    px = _pixels()
    jfinal, jh = jax_vit.forward_with_intermediates(
        jparams, jnp.asarray(px), jcfg, impl="xla")
    final, hiddens = vit.forward_with_intermediates(
        tparams, torch.from_numpy(px), tcfg)
    assert len(hiddens) == len(jh) == TINY["num_layers"] + 1
    for i, (got, want) in enumerate(zip(hiddens, jh)):
        assert got.shape == (2, tcfg.seq_len, 128), i
        _close(got, want)
    _close(final, jfinal)
    torch.testing.assert_close(
        final, vit.forward(tparams, torch.from_numpy(px), tcfg),
        rtol=0, atol=0)


@pytest.mark.parametrize("head", [dict(pooling="cls"), dict(pooling="mean"),
                                  dict(num_classes=10),
                                  dict(num_classes=10, pooling="mean")])
def test_torch_heads_match_jax(head):
    jcfg, jparams, tcfg, tparams = _models(**head)
    px = _pixels(3)
    want = jax_vit.forward(jparams, jnp.asarray(px), jcfg, impl="xla")
    got = vit.forward(tparams, torch.from_numpy(px), tcfg)
    _close(got, want)


def test_torch_forward_matches_jax_pallas_interpret():
    """The JAX Pallas tier in interpret mode, which rounds like the port."""
    jcfg, jparams, tcfg, tparams = _models()
    px = _pixels()
    want = jax_vit.forward(jparams, jnp.asarray(px), jcfg, impl="pallas")
    _close(vit.forward(tparams, torch.from_numpy(px), tcfg), want)


def test_torch_padded_rows_are_finite():
    """Query rows past the real tokens are computed and sliced off later;
    keys 0..seq_len-1 are never masked, so no row may hold a NaN."""
    _, _, tcfg, tparams = _models("bfloat16")
    x = vit.embed(tparams, torch.from_numpy(_pixels()), tcfg)
    x = torch.nn.functional.pad(x, (0, 0, 0, vit._padded_seq(tcfg) - 17))
    assert x.shape[1] == 32
    for i in range(tcfg.num_layers):
        x = vit.encoder_block(x, vit._layers(tparams["encoder"])[i], tcfg,
                              seq_len=17)
        assert torch.isfinite(x).all(), i


def test_torch_golden_b16():
    """Full-size B/16 in fp32 with the synthetic checkpoint, against the
    hidden states recorded through ``transformers`` (bar of
    tests/test_golden.py)."""
    from vit_tpu_torch.weights.hf import params_from_state_dict
    from vit_tpu_torch.weights.synthetic import (golden_pixels,
                                                 synthetic_hf_state_dict)

    fx = np.load(FIXTURE)
    cfg = ViTConfig()
    params = params_from_state_dict(
        synthetic_hf_state_dict(cfg, seed=int(fx["weights_seed"])), cfg,
        device="cpu")
    px = torch.from_numpy(golden_pixels(cfg, seed=int(fx["pixels_seed"])))
    with torch.inference_mode():
        final, hiddens = vit.forward_with_intermediates(params, px, cfg)
    diff = np.abs(final.numpy() - fx["final_hidden"]).max()
    assert diff < 1e-3, f"end-to-end max|diff| vs torch recording: {diff}"
    mid = int(fx["mid_layer"])
    diff = np.abs(hiddens[mid].numpy() - fx["mid_hidden"]).max()
    assert diff < 1e-3, f"layer {mid} max|diff| vs torch recording: {diff}"


def test_torch_vit_module_and_make_forward():
    _, _, tcfg, tparams = _models(num_classes=10)
    px = torch.from_numpy(_pixels())
    want = vit.forward(tparams, px, tcfg)
    model = vit.ViT(tparams, tcfg, device="cpu")
    assert model.device == torch.device("cpu")
    assert torch.equal(model(px), want)
    assert torch.equal(vit.make_forward(tcfg, impl="torch")(tparams, px), want)


def test_torch_init_params_layout_and_seed():
    """Same tree and shapes as the JAX package's init_params; the same
    generator seed gives the same weights; the truncated normal is cut at
    two standard deviations."""
    jcfg = JaxConfig(**TINY, num_classes=10)
    tcfg = ViTConfig(**TINY, num_classes=10, dtype=torch.bfloat16)
    jshapes = jax.tree.map(lambda a: a.shape, jax_vit.init_params(
        jax.random.key(0), jcfg))
    a = vit.init_params(tcfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    b = vit.init_params(tcfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")

    def walk(t, j, u):
        assert sorted(t) == sorted(j)
        for k in t:
            if isinstance(t[k], dict):
                walk(t[k], j[k], u[k])
            else:
                assert tuple(t[k].shape) == tuple(j[k]), k
                assert t[k].dtype == torch.bfloat16
                assert torch.equal(t[k], u[k]), k

    walk(a, jshapes, b)
    qkv = a["encoder"]["qkv"]["kernel"].float()
    assert qkv.abs().max() <= 0.04 + 1e-3
    assert 0.01 < qkv.std() < 0.02
