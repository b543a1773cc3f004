"""Params between the JAX package and the port.

:func:`params_from_numpy` takes the JAX package's params pytree with its
leaves converted to numpy arrays (``jax.tree.map(np.asarray, params)``)
and returns the port's dict of tensors, so one set of weights feeds both
packages. The two layouts are the same nested dict; only the array type
changes. Nothing here imports JAX.
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


def params_from_numpy(tree: Params, cfg: ViTConfig,
                      device: torch.device | str = "cpu") -> Params:
    """The port's params from a nested dict of numpy arrays, in
    ``cfg.dtype`` on ``device``."""
    return tree_map(
        lambda a: _from_numpy(a).to(device=device, dtype=cfg.dtype), tree)


def to_device(params: Params, device: torch.device | str) -> Params:
    """``params`` with every tensor on ``device``."""
    return tree_map(lambda t: t.to(device), params)
