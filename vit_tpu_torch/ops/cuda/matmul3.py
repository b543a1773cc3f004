"""Batched matmul kernel K16 (``csrc/matmul3.cu``), the counterpart of
``vit_tpu/ops/pallas/matmul3.py:matmul3``: one kernel for both of its
``pallas_call``\\ s."""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.cuda import _build, count_launch


def matmul3(x: torch.Tensor, y: torch.Tensor, *,
            scale: float | None = None) -> torch.Tensor:
    """``(B, M, K) @ (B, K, N)`` on contiguous CUDA tensors, summed in fp32,
    times ``scale``, cast once to ``x.dtype``."""
    _build.check_tensor(x, "x", x)
    if (x.dim() != 3 or y.dim() != 3 or y.shape[0] != x.shape[0]
            or y.shape[1] != x.shape[2]):
        raise ValueError(f"matmul3 shapes {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    (b, m, k), n = x.shape, y.shape[2]
    _build.check_tensor(y, "y", x, (b, k, n))
    if not (0 < b <= 65535) or m == 0 or n == 0 or k == 0:
        raise ValueError(f"matmul3 takes 1 to 65535 batches of non-empty "
                         f"operands, got {tuple(x.shape)} @ {tuple(y.shape)}")
    out = torch.empty((b, m, n), dtype=x.dtype, device=x.device)
    _build.launch("vit_matmul3", x, y, out, b, m, n, k,
                  1.0 if scale is None else float(scale), like=x)
    count_launch("matmul3")
    return out
