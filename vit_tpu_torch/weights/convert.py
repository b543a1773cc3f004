"""Params between the JAX package and the port.

:func:`params_from_numpy` takes the JAX package's params pytree with its
leaves converted to numpy arrays (``jax.tree.map(np.asarray, params)``)
and returns the port's dict of tensors, so one set of weights feeds both
packages. The two layouts are the same nested dict; only the array type
changes. A quantized projection's ``kernel`` (``vit_tpu/quant.py:
quantize_params``: ``{"q": int8, "scale": fp32}``) keeps both types.
:func:`adamw_state_from_numpy` does the same for an optax AdamW state.
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


def tree_leaves(tree: Params) -> list:
    """The leaves of a nested dict, keys sorted at every level (the order of
    ``jax.tree_util.tree_leaves``)."""
    return [leaf for k in sorted(tree)
            for leaf in (tree_leaves(tree[k]) if isinstance(tree[k], dict)
                         else [tree[k]])]


def adamw_state_from_numpy(opt_state: torch.optim.Optimizer, params: Params,
                           count: Any, mu: Params, nu: Params) -> None:
    """Load an optax AdamW state into the port's optimizer, so that a run
    of the JAX package continues in the port. ``count``, ``mu`` and ``nu``
    are optax's ``ScaleByAdamState`` fields as numpy (``mu`` and ``nu``
    nested like the params); ``opt_state`` is the ``torch.optim.AdamW``
    over ``params`` that ``vit_tpu_torch.train.make_train_step``'s
    ``init_fn`` made. The first moments become ``exp_avg``, the second
    ``exp_avg_sq``, each in its parameter's dtype and device; the step
    count is the same integer."""
    step = float(np.asarray(count))
    for p, m, v in zip(tree_leaves(params), tree_leaves(mu), tree_leaves(nu)):
        if tuple(np.shape(m)) != tuple(p.shape) or np.shape(v) != np.shape(m):
            raise ValueError(f"moment shapes {np.shape(m)}, {np.shape(v)} do "
                             f"not match a parameter of {tuple(p.shape)}")
        opt_state.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": _from_numpy(m).to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": _from_numpy(v).to(device=p.device, dtype=p.dtype)}
