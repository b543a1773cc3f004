"""Fixed-shape batch serving on one device (counterpart of
``vit_tpu/serving.py:Predictor``).

A request of any size is decomposed onto the bucket batch sizes,
largest first; the tail is padded with zero images up to the smallest
bucket that fits and the pad rows are sliced off the result. Padding is
exact for ViT: images do not attend to each other. Each bucket runs the
model's forward, so a server only ever runs the bucket shapes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.models.vit import Params, make_forward
from vit_tpu_torch.weights.convert import to_device

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class Predictor:
    """Forward passes over a set of batch buckets on one device.

    >>> pred = Predictor(params, cfg, buckets=(1, 8, 32), device="cuda")
    >>> out = pred(images)         # any leading batch size
    """

    def __init__(self, params: Params, cfg: ViTConfig,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, *,
                 device: torch.device | str = "cpu"):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.buckets = tuple(sorted(set(buckets)))
        self.params = to_device(params, self.device)
        self._fwd = make_forward(cfg)

    def _plan(self, n: int) -> list[int]:
        """Decompose n onto buckets, largest-first; the tail rounds up to
        the smallest bucket that fits (pad)."""
        plan, rest = [], n
        for b in reversed(self.buckets):
            while rest >= b:
                plan.append(b)
                rest -= b
        if rest:
            plan.append(min(b for b in self.buckets if b >= rest))
        return plan

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor | np.ndarray) -> torch.Tensor:
        images = torch.as_tensor(images).to(self.device, self.cfg.dtype)
        n = images.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        plan = self._plan(n)
        total = sum(plan)
        if total > n:
            pad = images.new_zeros((total - n, *images.shape[1:]))
            images = torch.cat([images, pad])
        outs, off = [], 0
        for b in plan:
            outs.append(self._fwd(self.params, images[off:off + b]))
            off += b
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        return out[:n]
