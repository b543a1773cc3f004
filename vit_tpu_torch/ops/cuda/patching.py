"""The unfold kernel K19 ``patchify`` (``csrc/patching.cu``), the
counterpart of ``vit_tpu/ops/pallas/patching.py:patchify``: a gather copy
``(B, C, H, W) -> (B, (H/P)*(W/P), C*P*P)`` in (c, kh, kw) order, bit for
bit with the layout copy ``reference.patchify``. Not differentiable, as the
Pallas kernel is not."""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.cuda import _build, count_launch


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """The patch rows of a contiguous CUDA tensor ``x`` (B, C, H, W) with H
    and W multiples of ``patch_size``; a ragged W/P is fine."""
    _build.check_tensor(x, "x", x)
    if x.dim() != 4:
        raise ValueError(f"x shape {tuple(x.shape)} is not (B, C, H, W)")
    b, c, h, w = x.shape
    p = patch_size
    if p <= 0 or h % p or w % p or min(b, c, h, w) == 0:
        raise ValueError(f"image {tuple(x.shape)} not divisible by patch {p}")
    out = torch.empty((b, (h // p) * (w // p), c * p * p), dtype=x.dtype,
                      device=x.device)
    _build.launch("vit_patchify", x, out, b, c, h, w, p, like=x)
    count_launch("patchify")
    return out
