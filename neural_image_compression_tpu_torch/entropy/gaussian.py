"""Discretized (mixture-of-)Gaussian conditional likelihoods, port of
entropy/gaussian.py: plain float32 functions over NHWC tensors, mixture
parameters laid out (B, H, W, K, M).

The joint model's K > 1 rate runs in the hand-written kernel
(ops/kernels/gmm_kernel.py); ``mixture_likelihood`` here is the plain form.
"""

import torch

from neural_image_compression_tpu_torch.entropy.base import (
    DEFAULT_LIKELIHOOD_LOWER_BOUND, clamp_likelihood,
)
from neural_image_compression_tpu_torch.ops.math import gaussian_cdf


def discretized_gaussian_pmf(x: torch.Tensor, mu: torch.Tensor,
                             sigma: torch.Tensor) -> torch.Tensor:
    """P(bin containing x) = Phi((x+.5-mu)/sigma) - Phi((x-.5-mu)/sigma)."""
    x, mu = x.float(), mu.float()
    inv_sigma = 1.0 / sigma.float()
    upper = gaussian_cdf((x + 0.5 - mu) * inv_sigma)
    lower = gaussian_cdf((x - 0.5 - mu) * inv_sigma)
    return upper - lower


def gaussian_likelihood(x, mu, sigma,
                        lower_bound: float = DEFAULT_LIKELIHOOD_LOWER_BOUND):
    """Mean-scale Gaussian conditional likelihood, clamped (K=1 path)."""
    return clamp_likelihood(discretized_gaussian_pmf(x, mu, sigma), lower_bound)


def discretized_mixture_pmf(x: torch.Tensor, weights: torch.Tensor,
                            mus: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, M); weights/mus/sigmas (B, H, W, K, M) -> (B, H, W, M)."""
    pmf_k = discretized_gaussian_pmf(x[..., None, :], mus, sigmas)
    return torch.sum(weights.float() * pmf_k, dim=-2)


def mixture_likelihood(x, weights, mus, sigmas,
                       lower_bound: float = DEFAULT_LIKELIHOOD_LOWER_BOUND):
    """Gaussian-mixture conditional likelihood, clamped (plain K>1 path)."""
    return clamp_likelihood(discretized_mixture_pmf(x, weights, mus, sigmas), lower_bound)
