"""Deterministic HF-format synthetic weights (counterpart of
``vit_tpu/weights/synthetic.py``).

A numpy-only copy that draws the same numbers from the same seeds, so one
seed feeds the JAX package, the port and the committed recording
``tests/fixtures/golden_b16.npz`` (hidden states of the ``transformers``
ViTModel on this checkpoint, made by ``tools/record_golden.py``). The state
dict is laid out exactly like an HF ``ViTModel``'s (same tensor names,
(out, in) Linear convention, conv filter layout) and scaled like the real
``google/vit-base-patch16-224`` checkpoint.
"""

from __future__ import annotations

import numpy as np

from vit_tpu_torch.config import ViTConfig

# Ballpark per-tensor scales of the real google/vit-base-patch16-224
# checkpoint (weights ~N(0, 0.02-0.08), LN scales near 1, biases small).
_STD = {
    "patch_proj": 0.08,
    "pos_embed": 0.02,
    "cls": 0.02,
    "attn": 0.04,
    "mlp": 0.03,
    "bias": 0.02,
    "ln_scale_jitter": 0.15,
    "ln_bias": 0.05,
}


def synthetic_hf_state_dict(cfg: ViTConfig | None = None, *,
                            seed: int = 1234) -> dict[str, np.ndarray]:
    """An HF ``ViTModel`` (add_pooling_layer=False) state dict, fp32."""
    cfg = cfg or ViTConfig()
    rng = np.random.default_rng(seed)
    d, m = cfg.hidden_dim, cfg.mlp_dim

    def w(shape, std):
        return rng.standard_normal(shape).astype(np.float32) * std

    sd: dict[str, np.ndarray] = {
        "embeddings.cls_token": w((1, 1, d), _STD["cls"]),
        "embeddings.position_embeddings": w((1, cfg.seq_len, d),
                                            _STD["pos_embed"]),
        "embeddings.patch_embeddings.projection.weight": w(
            (d, cfg.num_channels, cfg.patch_size, cfg.patch_size),
            _STD["patch_proj"]),
        "embeddings.patch_embeddings.projection.bias": w((d,), _STD["bias"]),
        "layernorm.weight": 1.0 + w((d,), _STD["ln_scale_jitter"]),
        "layernorm.bias": w((d,), _STD["ln_bias"]),
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            sd[f"{p}.attention.attention.{proj}.weight"] = w((d, d),
                                                             _STD["attn"])
            sd[f"{p}.attention.attention.{proj}.bias"] = w((d,), _STD["bias"])
        sd[f"{p}.attention.output.dense.weight"] = w((d, d), _STD["attn"])
        sd[f"{p}.attention.output.dense.bias"] = w((d,), _STD["bias"])
        sd[f"{p}.intermediate.dense.weight"] = w((m, d), _STD["mlp"])
        sd[f"{p}.intermediate.dense.bias"] = w((m,), _STD["bias"])
        sd[f"{p}.output.dense.weight"] = w((d, m), _STD["mlp"])
        sd[f"{p}.output.dense.bias"] = w((d,), _STD["bias"])
        sd[f"{p}.layernorm_before.weight"] = 1.0 + w((d,),
                                                     _STD["ln_scale_jitter"])
        sd[f"{p}.layernorm_before.bias"] = w((d,), _STD["ln_bias"])
        sd[f"{p}.layernorm_after.weight"] = 1.0 + w((d,),
                                                    _STD["ln_scale_jitter"])
        sd[f"{p}.layernorm_after.bias"] = w((d,), _STD["ln_bias"])
    return sd


def golden_pixels(cfg: ViTConfig | None = None, *, batch: int = 2,
                  seed: int = 4321) -> np.ndarray:
    """Deterministic input images for the golden fixture, ImageNet-normalized
    scale (roughly N(0,1) after preprocessing)."""
    cfg = cfg or ViTConfig()
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.num_channels, cfg.image_size, cfg.image_size)
    return rng.standard_normal(shape).astype(np.float32)
