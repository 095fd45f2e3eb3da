"""Entropy-model base utilities (port of entropy/base.py).

Likelihoods are clamped from below at 1e-9; entropy math is always float32
because that floor underflows bf16.
"""

import torch

DEFAULT_LIKELIHOOD_LOWER_BOUND = 1e-9


def clamp_likelihood(p: torch.Tensor,
                     lower_bound: float = DEFAULT_LIKELIHOOD_LOWER_BOUND) -> torch.Tensor:
    return torch.clamp_min(p, lower_bound)
