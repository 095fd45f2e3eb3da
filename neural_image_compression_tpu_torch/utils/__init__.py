from neural_image_compression_tpu_torch.utils.device import resolve_device
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_state_from_jax, load_jax_params,
)

__all__ = ["resolve_device", "joint_ar_state_from_jax", "load_jax_params"]
