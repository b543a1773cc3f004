"""Tiled GEMM kernel K2 (``csrc/matmul.cu``), the counterpart of
``vit_tpu/ops/pallas/matmul.py:matmul``, with one extension: an optional
residual added in fp32 before the single cast, which the split
``attn_block`` needs to keep ``_attn_core``'s rounding."""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.cuda import _build, count_launch


def matmul(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
           activation: str | None = None,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """``(..., K) @ (K, N)`` on CUDA tensors, fp32 accumulation, then
    ``+ bias``, GELU and ``+ residual`` in fp32, one cast to ``x.dtype``.
    ``residual`` has the output's shape ``(..., N)``."""
    if activation not in (None, "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    _build.check_tensor(x, "x", x)
    k = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"matmul shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    n = w.shape[1]
    _build.check_tensor(w, "w", x, (k, n))
    if bias is not None:
        _build.check_tensor(bias, "bias", x, (n,))
    out_shape = (*x.shape[:-1], n)
    if residual is not None:
        _build.check_tensor(residual, "residual", x, out_shape)
    m = x.numel() // k if k else 0
    if m == 0 or n == 0 or k == 0:
        raise ValueError(f"matmul of an empty operand {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    _build.launch("vit_matmul", x, w, bias, residual, out, m, n, k,
                  int(activation == "gelu"), like=x)
    count_launch("matmul")
    return out
