"""Row layernorm kernel K1 and its row statistics K5 (``csrc/layernorm.cu``),
the counterparts of ``vit_tpu/ops/pallas/layernorm.py:layernorm`` and
``layernorm_stats``."""

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


def layernorm_stats(x: torch.Tensor, *,
                    eps: float = 1e-12) -> tuple[torch.Tensor, torch.Tensor]:
    """Row mean and ``rsqrt(var + eps)`` of a CUDA tensor ``(..., D)``, as
    two ``(M, 1)`` fp32 tensors (rows flattened)."""
    _build.check_tensor(x, "x", x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        raise ValueError(f"layernorm_stats of an empty tensor "
                         f"{tuple(x.shape)}")
    mu = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    _build.launch("vit_layernorm_stats", x, mu, rstd, rows, d, float(eps),
                  like=x)
    count_launch("layernorm_stats")
    return mu, rstd
