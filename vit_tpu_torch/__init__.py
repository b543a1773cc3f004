"""vit_tpu_torch -- the ViT inference stack of ``vit_tpu`` ported to PyTorch
and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The module layout mirrors ``vit_tpu/``:

- :mod:`vit_tpu_torch.config`  -- ``ViTConfig`` and ``VARIANTS``;
- :mod:`vit_tpu_torch.ops`     -- the op library; each op runs its CUDA
  kernel (``vit_tpu_torch/csrc/``) on a CUDA tensor and its plain PyTorch
  version (``ops/reference.py``) on a CPU tensor;
- :mod:`vit_tpu_torch.weights` -- HF weight import, synthetic weights and
  the bridge from the JAX package's params;
- :mod:`vit_tpu_torch.models`  -- the ViT forward;
- :mod:`vit_tpu_torch.serving` -- bucketed batch serving.

It imports neither ``jax`` nor ``vit_tpu``.
"""

from vit_tpu_torch.config import VARIANTS, ViTConfig

__all__ = ["ViTConfig", "VARIANTS"]
