"""Hand-written CUDA kernels (sources in ``csrc/``) with their plain
PyTorch versions. Importing this package builds nothing."""

from neural_image_compression_tpu_torch.ops.kernels.gdn_kernel import gdn, gdn_reference
from neural_image_compression_tpu_torch.ops.kernels.gmm_kernel import (
    gmm_logp, mixture_log_likelihood_reference,
)

KERNELS = (gdn, gmm_logp)


def reset_launch_counts() -> None:
    for wrapper in KERNELS:
        wrapper.launches = 0


__all__ = ["gdn", "gdn_reference", "gmm_logp", "mixture_log_likelihood_reference",
           "KERNELS", "reset_launch_counts"]
