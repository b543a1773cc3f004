"""Weight loading in the port against the JAX package: the synthetic
checkpoint bit for bit, the HF import exactly, and the same refusals."""

import jax
import numpy as np
import pytest
import torch

from vit_tpu.config import ViTConfig as JaxConfig
from vit_tpu.weights import hf as jax_hf
from vit_tpu.weights import synthetic as jax_synthetic
from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.weights import convert, hf, synthetic

TINY = dict(image_size=32, patch_size=8, hidden_dim=128, num_heads=2,
            num_layers=2, mlp_dim=256)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("shape", ["tiny", "b16"])
def test_torch_synthetic_state_dict_is_bit_identical(shape):
    kw = TINY if shape == "tiny" else {}
    want = jax_synthetic.synthetic_hf_state_dict(JaxConfig(**kw), seed=7)
    got = synthetic.synthetic_hf_state_dict(ViTConfig(**kw), seed=7)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        synthetic.golden_pixels(ViTConfig(**kw), seed=3),
        jax_synthetic.golden_pixels(JaxConfig(**kw), seed=3))


def _state_dict(num_classes=0):
    sd = synthetic.synthetic_hf_state_dict(ViTConfig(**TINY), seed=11)
    if num_classes:
        rng = np.random.default_rng(12)
        sd["classifier.weight"] = rng.standard_normal(
            (num_classes, 128)).astype(np.float32)
        sd["classifier.bias"] = rng.standard_normal(num_classes).astype(
            np.float32)
    return sd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_classes", [0, 10])
def test_torch_params_from_state_dict_equals_converted_jax(dtype, num_classes):
    sd = _state_dict(num_classes)
    jcfg = JaxConfig(**TINY, num_classes=num_classes,
                     dtype=getattr(jax.numpy, dtype))
    tcfg = ViTConfig(**TINY, num_classes=num_classes,
                     dtype=getattr(torch, dtype))
    want = convert.params_from_numpy(
        jax.tree.map(np.asarray, jax_hf.params_from_state_dict(sd, jcfg)),
        tcfg, device="cpu")
    got = hf.params_from_state_dict(sd, tcfg, device="cpu")
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got_leaves) == sorted(want_leaves)  # JAX sorts dict keys
    for name, w in want_leaves.items():
        g = got_leaves[name]
        assert g.dtype == tcfg.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    # Stacked (L, in, out) layout: layer 1's QKV kernel is [q|k|v]^T.
    q = sd["encoder.layer.1.attention.attention.query.weight"]
    np.testing.assert_array_equal(
        got["encoder"]["qkv"]["kernel"][1, :, :128].float().numpy(),
        torch.from_numpy(q.T.copy()).to(tcfg.dtype).float().numpy())


def test_torch_state_dict_from_torch_tensors_and_prefix():
    """Torch tensors and a ``vit.`` prefix (ViTForImageClassification)
    import like numpy arrays without it."""
    sd = _state_dict()
    cfg = ViTConfig(**TINY)
    want = hf.params_from_state_dict(sd, cfg, device="cpu")
    got = hf.params_from_state_dict(
        {f"vit.{k}": torch.from_numpy(v) for k, v in sd.items()}, cfg,
        device="cpu")
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert torch.equal(g, w), name


def test_torch_missing_tensor_raises():
    sd = _state_dict()
    del sd["encoder.layer.1.output.dense.bias"]
    with pytest.raises(KeyError, match="missing expected tensor"):
        hf.params_from_state_dict(sd, ViTConfig(**TINY), device="cpu")
    with pytest.raises(KeyError, match="missing expected tensor"):
        jax_hf.params_from_state_dict(sd, JaxConfig(**TINY))


def test_torch_extra_tensor_raises():
    sd = _state_dict()
    sd["encoder.layer.0.attention.attention.rope.weight"] = np.ones(
        (4,), np.float32)
    sd["pooler.dense.weight"] = np.ones((4,), np.float32)  # knowingly skipped
    with pytest.raises(KeyError, match="rope") as err:
        hf.params_from_state_dict(sd, ViTConfig(**TINY), device="cpu")
    assert "pooler" not in str(err.value)
    with pytest.raises(KeyError, match="rope"):
        jax_hf.params_from_state_dict(sd, JaxConfig(**TINY))


def test_torch_all_zero_layer_raises():
    sd = _state_dict()
    sd["encoder.layer.1.intermediate.dense.weight"] = np.zeros_like(
        sd["encoder.layer.1.intermediate.dense.weight"])
    with pytest.raises(ValueError, match=r"fc1.kernel layer 1 is all zeros"):
        hf.params_from_state_dict(sd, ViTConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="layer 1 is all zeros"):
        jax_hf.params_from_state_dict(sd, JaxConfig(**TINY))
    # Zero biases are legitimate (fresh models zero them).
    sd = _state_dict()
    sd["encoder.layer.1.intermediate.dense.bias"][:] = 0
    hf.params_from_state_dict(sd, ViTConfig(**TINY), device="cpu")


def test_torch_params_from_numpy_keeps_bfloat16_bits():
    """ml_dtypes bfloat16 leaves (JAX params in bf16) convert exactly."""
    import ml_dtypes

    a = np.random.default_rng(0).standard_normal((5, 7)).astype(
        ml_dtypes.bfloat16)
    cfg = ViTConfig(**TINY, dtype=torch.bfloat16)
    got = convert.params_from_numpy({"w": {"kernel": a}}, cfg,
                                    device="cpu")["w"]["kernel"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("head", [False, True])
def test_torch_params_from_hf_matches_jax(head):
    """``params_from_hf`` on a random-init ``ViTModel`` (no head: 0
    classes, though its config says 2 labels) and a
    ``ViTForImageClassification`` (5 labels) infers the config and imports
    the weights exactly as JAX's ``params_from_hf`` does."""
    import transformers

    hf_cfg = transformers.ViTConfig(
        image_size=32, patch_size=8, hidden_size=128, num_attention_heads=2,
        num_hidden_layers=2, intermediate_size=256, num_labels=5 if head else 2)
    torch.manual_seed(0)
    model = (transformers.ViTForImageClassification(hf_cfg) if head
             else transformers.ViTModel(hf_cfg, add_pooling_layer=True))
    want_tree = jax_hf.params_from_hf(model)
    got = hf.params_from_hf(model, device="cpu")
    assert ("classifier" in got) == head
    if head:
        assert got["classifier"]["kernel"].shape == (128, 5)
    cfg = hf.config_from_hf(hf_cfg, num_classes=5 if head else 0)
    want = convert.params_from_numpy(jax.tree.map(np.asarray, want_tree), cfg,
                                     device="cpu")
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got_leaves) == sorted(want_leaves)
    for name, w in want_leaves.items():
        assert torch.equal(got_leaves[name], w), name
    # An explicit config is taken as given.
    cfg_bf16 = cfg.replace(dtype=torch.bfloat16)
    got_bf16 = hf.params_from_hf(model, cfg_bf16, device="cpu")
    assert got_bf16["ln_final"]["scale"].dtype == torch.bfloat16


def test_torch_weights_import_loads_no_transformers():
    """``params_from_hf`` takes the model object: importing the weights
    package does not load ``transformers``."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys, vit_tpu_torch.weights\n"
            "from vit_tpu_torch.weights import params_from_hf\n"
            "sys.exit('transformers' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
