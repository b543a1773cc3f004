"""Fixed-shape batch serving, on one device or over a mesh of ranks
(counterpart of ``vit_tpu/serving.py:Predictor``).

A request of any size is decomposed onto the bucket batch sizes,
largest first; the tail is padded with zero images up to the smallest
bucket that fits and the pad rows are sliced off the result. Padding is
exact for ViT: images do not attend to each other. Each bucket runs the
model's forward, so a server only ever runs the bucket shapes;
``attention=`` picks its route (``vit_tpu/serving.py:52-74``). With
``quant=True`` the params are quantized once, at construction, and every
bucket runs the int8 tier's ``forward_quant`` (``vit_tpu/serving.py:
56-71``), with ``int8_dot=False`` on the weight-only MLP kernel. The
device is the card unless the caller names another.

With ``mesh=`` (``vit_tpu_torch.parallel.make_mesh``) every rank of the
mesh builds the same ``Predictor`` and is called with the same request
(``vit_tpu/serving.py:84-117``): buckets are rounded up to multiples of
'data'; ``model > 1`` serves each bucket tensor-parallel through
``parallel.make_tp_forward`` (float or ``quant=True``, on the head-major
shard of the params), ``model == 1`` batch-parallel, each rank running the
single-device forward on its rows. Every rank returns the whole answer.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from vit_tpu_torch import parallel
from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.models.vit import Params, fold_base, make_forward
from vit_tpu_torch.quant import make_forward_quant, quantize_params
from vit_tpu_torch.weights.convert import to_device

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class Predictor:
    """Forward passes over a set of batch buckets on one device, or on
    every rank of a mesh.

    >>> pred = Predictor(params, cfg, buckets=(1, 8, 32))  # on the card
    >>> out = pred(images)         # any leading batch size

    >>> mesh = make_mesh(data=1, model=2)  # on each of two ranks
    >>> pred = Predictor(params, cfg, buckets=(8, 32), mesh=mesh)
    """

    def __init__(self, params: Params, cfg: ViTConfig,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, *,
                 device: torch.device | str | None = None,
                 quant: bool = False, attention: str = "flash",
                 int8_dot: bool = True, mesh: parallel.Mesh | None = None):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None and device is not None and (
                torch.device(device) != mesh.device):
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.device = (mesh.device if mesh is not None
                       else torch.device(device or "cuda"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Predictor serves on the card by default and "
                               "no CUDA device is available; pass "
                               "device='cpu' to serve on the CPU")
        data = 1 if mesh is None else mesh.data
        self.buckets = tuple(sorted({-(-b // data) * data for b in buckets}))
        if mesh is not None and mesh.model > 1:
            # Tensor parallelism: this rank's head-major shard of the
            # (quantized) params, one all-reduce per half-block.
            if attention != "flash":
                raise ValueError("tensor-parallel serving runs the flash "
                                 f"route only, not attention={attention!r}")
            self.params = parallel.prepare_tp_params(
                quantize_params(params) if quant else params, cfg, mesh)
            self._fwd = parallel.make_tp_forward(cfg, mesh, quant=quant,
                                                 int8_dot=int8_dot)
            return
        self.params = to_device(params, self.device)
        if quant:
            self.params = quantize_params(self.params)
            self._fwd = make_forward_quant(cfg, int8_dot=int8_dot)
        elif attention == "flash" and cfg.num_prefix_tokens == 1:
            # The fused route's base rows depend on the params only.
            self._fwd = functools.partial(make_forward(cfg),
                                          base=fold_base(self.params, cfg))
        else:
            self._fwd = make_forward(cfg, attention=attention)
        if mesh is not None and mesh.data > 1:
            # Batch parallelism: each rank runs its rows of the bucket.
            local = self._fwd
            self._fwd = lambda p, x: parallel.gather_batch(
                local(p, parallel.batch_shard(x, mesh)), mesh)

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
