"""Params between the JAX package and the port.

:func:`params_from_numpy` takes the JAX package's params pytree with its
leaves converted to numpy arrays (``jax.tree.map(np.asarray, params)``)
and returns the port's dict of tensors, so one set of weights feeds both
packages. The two layouts are the same nested dict; only the array type
changes. A quantized projection's ``kernel`` (``vit_tpu/quant.py:
quantize_params``: ``{"q": int8, "scale": fp32}``) keeps both types.
Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from vit_tpu_torch.config import ViTConfig

Params = dict[str, Any]


def tree_map(fn: Callable[[Any], Any], tree: Params) -> Params:
    """Apply ``fn`` to every leaf of a nested params dict."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _from_numpy(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _is_quantized(node: Any) -> bool:
    """A quantized weight, told apart by its shape (``{"q", "scale"}``),
    not by the key name: the LayerNorm params also hold a ``"scale"``."""
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def params_from_numpy(tree: Params, cfg: ViTConfig,
                      device: torch.device | str = "cuda") -> Params:
    """The port's params from a nested dict of numpy arrays, on ``device``:
    every leaf in ``cfg.dtype``, except the int8 codes and fp32 scales of a
    quantized weight."""
    out: Params = {}
    for k, v in tree.items():
        if _is_quantized(v):
            q = _from_numpy(v["q"])
            if q.dtype != torch.int8:
                raise ValueError(f"quantized weight {k!r} holds {q.dtype}, "
                                 "not int8")
            out[k] = {"q": q.to(device),
                      "scale": _from_numpy(v["scale"]).to(
                          device=device, dtype=torch.float32)}
        elif isinstance(v, dict):
            out[k] = params_from_numpy(v, cfg, device)
        else:
            out[k] = _from_numpy(v).to(device=device, dtype=cfg.dtype)
    return out


def to_device(params: Params, device: torch.device | str) -> Params:
    """``params`` with every tensor on ``device``."""
    return tree_map(lambda t: t.to(device), params)
