"""Model graphs of the port (counterpart of ``vit_tpu/models``)."""

from vit_tpu_torch.models.vit import ViT, forward, init_params, make_forward

__all__ = ["ViT", "forward", "init_params", "make_forward"]
