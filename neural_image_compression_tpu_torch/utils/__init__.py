from neural_image_compression_tpu_torch.utils import flops
from neural_image_compression_tpu_torch.utils.checkpoint import (
    checkpoint_exists, checkpoint_keys, restore_checkpoint, save_checkpoint,
)
from neural_image_compression_tpu_torch.utils.device import resolve_device
from neural_image_compression_tpu_torch.utils.profiling import StepTimer, trace
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_params_to_jax, joint_ar_state_from_jax, load_jax_params,
)

__all__ = ["flops", "checkpoint_exists", "checkpoint_keys", "restore_checkpoint",
           "save_checkpoint", "StepTimer", "trace", "resolve_device", "joint_ar_params_to_jax",
           "joint_ar_state_from_jax", "load_jax_params"]
