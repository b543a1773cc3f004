"""The smoke kernel K20 of the block-gated print (``csrc/debug.cu``, with
``vit::print_if`` in ``csrc/debug.cuh``), the counterpart of the Pallas
kernel that calls ``vit_tpu/ops/pallas/debug.py:print_if``
(``tests/test_ops_pallas.py:235-256``)."""

from __future__ import annotations

import torch

from vit_tpu_torch.ops import debug
from vit_tpu_torch.ops.cuda import _build, count_launch


def print_if_smoke(x: torch.Tensor, conds: str = "=0", *,
                   grid: tuple[int, ...] = (2,)) -> torch.Tensor:
    """A copy of the contiguous 2-D CUDA tensor ``x``; each block of
    ``grid`` (one or two axes over its rows and columns) whose index
    satisfies ``conds`` prints ``debug.SMOKE_FMT`` with its tile's fp32 sum
    from the device. Counted as ``print_if``."""
    _build.check_tensor(x, "x", x)
    gx, gy = debug.smoke_grid(x, grid)
    args = debug.conds_args(conds)
    out = torch.empty_like(x)
    _build.launch("vit_print_if_smoke", x, out, x.shape[0], x.shape[1], gx,
                  gy, *args, like=x)
    count_launch("print_if")
    return out
