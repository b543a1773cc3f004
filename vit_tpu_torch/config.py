"""Model configuration (counterpart of ``vit_tpu/config.py``).

The same frozen dataclass, fields, derived properties and ``VARIANTS`` as
the JAX package, with ``dtype`` a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Hyperparameters for a ViT encoder (HF ``ViTConfig``-compatible subset).

    Defaults are ViT-B/16 at 224px: 224x224x3, P=16, hidden 768, 12 heads,
    12 layers, MLP 3072, LN eps 1e-12.
    """

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    mlp_dim: int = 3072
    layernorm_eps: float = 1e-12
    num_classes: int = 0          # 0 = no head: output is (B, seq, D) hidden states
    pooling: str = "none"         # "none" | "cls" | "mean"
    num_prefix_tokens: int = 1    # 1 = CLS (ViT), 2 = CLS + distillation (DeiT)
    dtype: torch.dtype = torch.float32  # activation/param dtype on device

    def __post_init__(self) -> None:
        if self.image_size % self.patch_size != 0:
            raise ValueError(
                f"image_size {self.image_size} not divisible by patch_size "
                f"{self.patch_size}"
            )
        if self.hidden_dim % self.num_heads != 0:
            raise ValueError(
                f"hidden_dim {self.hidden_dim} not divisible by num_heads "
                f"{self.num_heads}"
            )
        if self.pooling not in ("none", "cls", "mean"):
            raise ValueError(f"unknown pooling mode {self.pooling!r}")
        if self.num_prefix_tokens < 1:
            raise ValueError("num_prefix_tokens must be >= 1 (the CLS token)")

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def seq_len(self) -> int:
        """Patches + prefix tokens (197 for B/16 @ 224px; 198 for DeiT)."""
        return self.num_patches + self.num_prefix_tokens

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        """Flattened patch vector length P*P*C (768 for B/16)."""
        return self.patch_size * self.patch_size * self.num_channels

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


#: The model variants of the JAX package (vit_tpu/config.py:VARIANTS).
VARIANTS: dict[str, ViTConfig] = {
    "B/16": ViTConfig(),
    "B/32": ViTConfig(patch_size=32),
    "L/16": ViTConfig(hidden_dim=1024, num_heads=16, num_layers=24, mlp_dim=4096),
    "L/16-384": ViTConfig(
        image_size=384, hidden_dim=1024, num_heads=16, num_layers=24, mlp_dim=4096
    ),
    "H/14": ViTConfig(
        patch_size=14, hidden_dim=1280, num_heads=16, num_layers=32,
        mlp_dim=5120, pooling="cls",
    ),
    "DeiT-B/16": ViTConfig(num_prefix_tokens=2),
}
