"""Building blocks (port of ops/blocks.py). Only the activation the 5x5
transforms use lives here so far; the residual blocks come with the res3x3
family."""

import torch
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)
