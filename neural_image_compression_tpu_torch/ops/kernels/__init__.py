"""Hand-written CUDA kernels (sources in ``csrc/``) with their plain
PyTorch versions. Importing this package builds nothing."""

from neural_image_compression_tpu_torch.ops.kernels.gdn_kernel import (
    gdn, gdn_backward, gdn_backward_reference, gdn_reference,
)
from neural_image_compression_tpu_torch.ops.kernels.gmm_kernel import (
    gmm_logp, gmm_logp_backward, mixture_log_likelihood_backward_reference,
    mixture_log_likelihood_reference,
)

KERNELS = (gdn, gmm_logp, gdn_backward, gmm_logp_backward)


def reset_launch_counts() -> None:
    for wrapper in KERNELS:
        wrapper.launches = 0
    gdn_backward.param_launches = 0


def launch_counts() -> dict:
    """Each wrapper's name -> the launches it has counted, and
    ``gdn_backward_params`` -> the GDN backward launches that ran its
    dgamma/dbeta stage."""
    counts = {wrapper.__name__: wrapper.launches for wrapper in KERNELS}
    counts["gdn_backward_params"] = gdn_backward.param_launches
    return counts


__all__ = ["gdn", "gdn_reference", "gdn_backward", "gdn_backward_reference",
           "gmm_logp", "mixture_log_likelihood_reference", "gmm_logp_backward",
           "mixture_log_likelihood_backward_reference", "KERNELS", "launch_counts", "reset_launch_counts"]
