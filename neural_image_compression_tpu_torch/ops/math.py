"""Scalar math used by the entropy models (port of ops/math.py).

Entropy math stays float32: the 1e-9 likelihood floor underflows bf16.
"""

import math

import torch

INV_SQRT2 = 1.0 / math.sqrt(2.0)
LOG2 = math.log(2.0)


def gaussian_cdf(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF via erf, computed in float32."""
    x = x.float()
    return 0.5 * (1.0 + torch.erf(x * INV_SQRT2))


def nats_to_bits(x: torch.Tensor) -> torch.Tensor:
    return x / LOG2
