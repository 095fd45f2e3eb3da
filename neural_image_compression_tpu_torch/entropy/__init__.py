from neural_image_compression_tpu_torch.entropy.base import (
    DEFAULT_LIKELIHOOD_LOWER_BOUND, clamp_likelihood,
)
from neural_image_compression_tpu_torch.entropy.factorized import FactorizedEntropyBottleneck
from neural_image_compression_tpu_torch.entropy.gaussian import (
    discretized_gaussian_pmf, discretized_mixture_pmf, gaussian_likelihood,
    mixture_likelihood,
)

__all__ = ["DEFAULT_LIKELIHOOD_LOWER_BOUND", "clamp_likelihood",
           "FactorizedEntropyBottleneck", "discretized_gaussian_pmf",
           "discretized_mixture_pmf", "gaussian_likelihood", "mixture_likelihood"]
