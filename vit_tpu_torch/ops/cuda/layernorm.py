"""Row layernorm kernel K1 (``csrc/layernorm.cu``), the counterpart of
``vit_tpu/ops/pallas/layernorm.py:layernorm``."""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.cuda import _build, count_launch


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-12) -> torch.Tensor:
    """Layernorm over the last dim of a CUDA tensor ``(..., D)``; ``scale``
    and ``bias`` are ``(D,)``. Output in ``x``'s dtype."""
    _build.check_tensor(x, "x", x)
    d = x.shape[-1]
    _build.check_tensor(scale, "scale", x, (d,))
    _build.check_tensor(bias, "bias", x, (d,))
    rows = x.numel() // d
    if rows == 0:
        raise ValueError(f"layernorm of an empty tensor {tuple(x.shape)}")
    out = torch.empty_like(x)
    _build.launch("vit_layernorm", x, scale, bias, out, rows, d, float(eps),
                  like=x)
    count_launch("layernorm")
    return out
