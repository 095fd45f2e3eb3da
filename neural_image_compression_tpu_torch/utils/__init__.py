from neural_image_compression_tpu_torch.utils import flops
from neural_image_compression_tpu_torch.utils.checkpoint import (
    checkpoint_exists, checkpoint_keys, restore_checkpoint, restore_raw, save_checkpoint,
)
from neural_image_compression_tpu_torch.utils.device import resolve_device
from neural_image_compression_tpu_torch.utils.flops import (
    factorized_prior_eval_flops, joint_ar_eval_flops, mfu, scalable_eval_flops,
)
from neural_image_compression_tpu_torch.utils.profiling import StepTimer, trace
from neural_image_compression_tpu_torch.utils.torch_import import (
    joint_ar_params_from_torch, load_reference_checkpoint, scalable_params_from_torch,
    yolo_backbone_variables_from_torch,
)
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_params_to_jax, joint_ar_state_from_jax, load_jax_params, load_jax_variables,
    variables_to_jax,
)

__all__ = ["flops", "checkpoint_exists", "checkpoint_keys", "restore_checkpoint", "restore_raw",
           "save_checkpoint", "StepTimer", "trace", "resolve_device",
           "factorized_prior_eval_flops", "joint_ar_eval_flops", "mfu", "scalable_eval_flops",
           "joint_ar_params_from_torch", "load_reference_checkpoint",
           "scalable_params_from_torch", "yolo_backbone_variables_from_torch",
           "joint_ar_params_to_jax", "joint_ar_state_from_jax", "load_jax_params",
           "load_jax_variables", "variables_to_jax"]
