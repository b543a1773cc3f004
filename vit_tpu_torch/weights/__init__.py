"""Weight import for the port (counterpart of ``vit_tpu/weights``)."""

from vit_tpu_torch.weights.convert import params_from_numpy, to_device
from vit_tpu_torch.weights.hf import (
    config_from_hf,
    params_from_hf,
    params_from_state_dict,
    verify_params,
)

__all__ = [
    "config_from_hf",
    "params_from_hf",
    "params_from_numpy",
    "params_from_state_dict",
    "to_device",
    "verify_params",
]
