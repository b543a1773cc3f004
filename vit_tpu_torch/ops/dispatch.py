"""Implementation dispatch for the op library (counterpart of
``vit_tpu/ops/dispatch.py``).

Every public op in :mod:`vit_tpu_torch.ops` has two implementations:

- ``"torch"`` -- the plain PyTorch version (:mod:`vit_tpu_torch.ops.reference`);
- ``"cuda"``  -- the hand-written kernel (``vit_tpu_torch/csrc/``).

``impl=None`` picks by where the tensor lies: the kernel for a CUDA tensor,
the plain version for a CPU tensor. There is no environment variable and no
interpret mode, and nothing falls back: ``"cuda"`` with a tensor that is not
on a CUDA device raises.
"""

from __future__ import annotations

import torch

VALID_IMPLS = ("torch", "cuda")


def resolve_impl(impl: str | None, x: torch.Tensor) -> str:
    """The implementation that runs an op on ``x``."""
    if impl is None:
        return "cuda" if x.is_cuda else "torch"
    if impl not in VALID_IMPLS:
        raise ValueError(f"impl must be one of {VALID_IMPLS}, got {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got one on {x.device}")
    return impl
