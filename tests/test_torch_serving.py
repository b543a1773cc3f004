"""The port's bucketed ``Predictor`` against the JAX package's."""

import jax
import numpy as np
import pytest
import torch

from vit_tpu.config import ViTConfig as JaxConfig
from vit_tpu.models import vit as jax_vit
from vit_tpu.serving import Predictor as JaxPredictor
from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.serving import Predictor
from vit_tpu_torch.weights.convert import params_from_numpy

TINY = dict(image_size=32, patch_size=8, hidden_dim=128, num_heads=2,
            num_layers=2, mlp_dim=256, num_classes=10)


@pytest.fixture(scope="module")
def predictors():
    jcfg, tcfg = JaxConfig(**TINY), ViTConfig(**TINY)
    jparams = jax_vit.init_params(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return (JaxPredictor(jparams, jcfg, buckets=(1, 2, 4)),
            Predictor(tparams, tcfg, buckets=(1, 2, 4)))


@pytest.mark.parametrize("n", [1, 3, 7])
def test_torch_predictor_matches_jax(predictors, n):
    jpred, pred = predictors
    px = np.random.default_rng(n).standard_normal(
        (n, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jpred(px))
    got = pred(px)
    assert got.shape == (n, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("buckets", [(1, 2, 4), (4, 16), (1, 8, 32), (3,)])
def test_torch_plan_decomposition_matches_jax(predictors, buckets):
    jpred, pred = predictors
    jp = JaxPredictor(jpred.params, jpred.cfg, buckets=buckets)
    p = Predictor(pred.params, pred.cfg, buckets=buckets)
    assert p.buckets == jp.buckets
    for n in range(1, 40):
        assert p._plan(n) == jp._plan(n), n


def test_torch_padding_images_do_not_leak(predictors):
    """A tail padded up to a bucket gives the rows it would alone."""
    _, pred = predictors
    p = Predictor(pred.params, pred.cfg, buckets=(4,))
    px = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (5, 3, 32, 32)).astype(np.float32))
    assert p._plan(5) == [4, 4]
    out = p(px)
    assert out.shape == (5, 10)
    assert torch.equal(out[4:], p(px[4:]))
    torch.testing.assert_close(out[:4], p(px[:4]), rtol=0, atol=0)


def test_torch_predictor_rejects_bad_input(predictors):
    _, pred = predictors
    with pytest.raises(ValueError, match="positive"):
        Predictor(pred.params, pred.cfg, buckets=(0, 2))
    with pytest.raises(ValueError, match="empty"):
        pred(np.zeros((0, 3, 32, 32), np.float32))
