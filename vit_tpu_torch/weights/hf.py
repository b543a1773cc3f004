"""HuggingFace ViT -> port params import (counterpart of
``vit_tpu/weights/hf.py``).

The same mapping, coverage check and zero scan as the JAX package, into the
same layout: linear weights ``(in, out)``, q/k/v fused into one ``(D, 3D)``
projection, the conv filter flattened in (c, kh, kw) order, and the encoder
tensors stacked along a leading ``num_layers`` axis. The result is a nested
dict of tensors in ``cfg.dtype`` on ``device``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.weights.convert import Params

#: Source tensors intentionally not imported (pooler; DeiT's distillation
#: head, which HF's own DeiTForImageClassification ignores at inference).
SKIPPED_PREFIXES = ("pooler.", "distillation_classifier.")


def _to_np(t: Any) -> np.ndarray:
    """Accept torch tensors or numpy arrays."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t)


def _normalize_state_dict(sd: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Strip an optional ``vit.``/``deit.`` prefix, import DeiT's
    ``cls_classifier.`` as the classifier, convert tensors to numpy."""
    out = {}
    for k, v in sd.items():
        for prefix in ("vit.", "deit."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k.startswith("cls_classifier."):
            k = "classifier." + k[len("cls_classifier."):]
        out[k] = _to_np(v)
    return out


def config_from_hf(hf_config: Any, **overrides) -> ViTConfig:
    """Build a :class:`ViTConfig` from a ``transformers`` ViT/DeiT config."""
    overrides.setdefault(
        "num_prefix_tokens",
        2 if getattr(hf_config, "model_type", "") == "deit" else 1)
    return ViTConfig(
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        num_channels=hf_config.num_channels,
        hidden_dim=hf_config.hidden_size,
        num_heads=hf_config.num_attention_heads,
        num_layers=hf_config.num_hidden_layers,
        mlp_dim=hf_config.intermediate_size,
        layernorm_eps=hf_config.layer_norm_eps,
        **overrides,
    )


def params_from_state_dict(sd: Mapping[str, Any], cfg: ViTConfig, *,
                           device: torch.device | str = "cpu") -> Params:
    """Map an HF ``ViTModel`` (or ``ViTForImageClassification``) state dict
    to the port's params dict, with full coverage accounting.

    Raises ``KeyError`` listing any unconsumed source tensors (other than
    the knowingly skipped ones) or any missing destination, and
    ``ValueError`` if a weight (or one layer of it) is all zeros.
    """
    sd = _normalize_state_dict(sd)
    consumed: set[str] = set()

    def take(name: str) -> np.ndarray:
        if name not in sd:
            raise KeyError(f"HF state dict missing expected tensor {name!r}")
        consumed.add(name)
        return sd[name]

    def tensor(a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a, dtype=np.float32)
        return torch.from_numpy(a).to(device=device, dtype=cfg.dtype)

    def linear(prefix: str) -> dict[str, np.ndarray]:
        # HF nn.Linear stores (out, in); the port stores (in, out).
        return {"kernel": take(f"{prefix}.weight").T,
                "bias": take(f"{prefix}.bias")}

    def ln(prefix: str) -> dict[str, np.ndarray]:
        return {"scale": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}

    d = cfg.hidden_dim
    conv_w = take("embeddings.patch_embeddings.projection.weight")
    if conv_w.shape != (d, cfg.num_channels, cfg.patch_size, cfg.patch_size):
        raise ValueError(f"patch projection shape {conv_w.shape} does not "
                         f"match {cfg}")
    # (D, C, P, P) -> flatten the filter in (c, kh, kw) order -> (C*P*P, D),
    # the per-patch element order of ops.patchify.
    patch_kernel = conv_w.reshape(d, cfg.patch_dim).T

    cls = take("embeddings.cls_token")
    if "embeddings.distillation_token" in sd:
        cls = np.concatenate([cls, take("embeddings.distillation_token")],
                             axis=1)
    if cls.shape[1] != cfg.num_prefix_tokens:
        raise ValueError(f"{cls.shape[1]} prefix tokens, config wants "
                         f"{cfg.num_prefix_tokens}")
    embeddings = {
        "cls_token": tensor(cls),
        "position_embeddings": tensor(take("embeddings.position_embeddings")),
        "patch_embed": {
            "kernel": tensor(patch_kernel),
            "bias": tensor(take("embeddings.patch_embeddings.projection.bias")),
        },
    }

    layers = []
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}"
        qkv = [linear(f"{p}.attention.attention.{n}")
               for n in ("query", "key", "value")]
        layers.append({
            "ln1": ln(f"{p}.layernorm_before"),
            "qkv": {"kernel": np.concatenate([t["kernel"] for t in qkv], 1),
                    "bias": np.concatenate([t["bias"] for t in qkv])},
            "out": linear(f"{p}.attention.output.dense"),
            "ln2": ln(f"{p}.layernorm_after"),
            "fc1": linear(f"{p}.intermediate.dense"),
            "fc2": linear(f"{p}.output.dense"),
        })
    encoder = {
        group: {leaf: tensor(np.stack([layer[group][leaf] for layer in layers]))
                for leaf in layers[0][group]}
        for group in layers[0]
    } if layers else {}

    params: Params = {
        "embeddings": embeddings,
        "encoder": encoder,
        "ln_final": {k: tensor(v) for k, v in ln("layernorm").items()},
    }
    if cfg.num_classes:
        params["classifier"] = {k: tensor(v)
                                for k, v in linear("classifier").items()}

    leftover = [k for k in sd
                if k not in consumed and not k.startswith(SKIPPED_PREFIXES)
                and k not in ("classifier.weight", "classifier.bias")]
    if leftover:
        raise KeyError(f"unconsumed HF tensors (mapping incomplete): {leftover}")

    verify_params(params)
    return params


def _leaves(tree: Params, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, name + ".")
        else:
            yield name, v


def verify_params(params: Params) -> None:
    """No weight may be all zeros; biases and LN offsets are skipped since
    fresh models legitimately zero them. Encoder leaves are stacked
    (layer, ...), and each layer is scanned on its own so that one missing
    layer cannot hide behind the rest."""
    for name, leaf in _leaves(params):
        if "bias" in name:
            continue
        if name.startswith("encoder."):
            nonzero = leaf.reshape(leaf.shape[0], -1).ne(0).any(dim=1)
            zero_layers = torch.nonzero(~nonzero).flatten().tolist()
            if zero_layers:
                raise ValueError(f"imported tensor {name} layer "
                                 f"{zero_layers[0]} is all zeros (weight "
                                 "transfer incomplete?)")
        elif not bool(leaf.ne(0).any()):
            raise ValueError(f"imported tensor {name} is all zeros "
                             "(weight transfer incomplete?)")
