"""Elementwise kernels of the reference op chain (``csrc/elementwise.cu``):
K14 ``add`` and K15 ``softmax``, the counterparts of
``vit_tpu/ops/pallas/add.py:add`` and ``vit_tpu/ops/pallas/softmax.py:
softmax``."""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.cuda import _build, count_launch


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` of two CUDA tensors of one shape and dtype, each sum in
    fp32 and rounded once."""
    _build.check_tensor(x, "x", x)
    _build.check_tensor(y, "y", x, tuple(x.shape))
    if x.numel() == 0:
        raise ValueError(f"add of an empty tensor {tuple(x.shape)}")
    out = torch.empty_like(x)
    _build.launch("vit_add", x, y, out, x.numel(), like=x)
    count_launch("add")
    return out


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim of a CUDA tensor ``(..., D)`` in fp32,
    cast once to ``x.dtype``."""
    _build.check_tensor(x, "x", x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        raise ValueError(f"softmax of an empty tensor {tuple(x.shape)}")
    out = torch.empty_like(x)
    _build.launch("vit_softmax", x, out, rows, d, like=x)
    count_launch("softmax")
    return out
