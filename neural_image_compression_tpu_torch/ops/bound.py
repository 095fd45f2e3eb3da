"""Straight-through bound operators and the non-negative reparametrization.

Port of neural_image_compression_tpu/ops/bound.py: the forward clamps; the
backward passes the gradient through whenever the input is inside the bound
OR the gradient pushes the value back toward the feasible region
(compressai's ``LowerBound`` semantics).
"""

import torch

REPARAM_OFFSET = 2.0 ** -18
PEDESTAL = REPARAM_OFFSET ** 2


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


class _UpperBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_max(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x <= ctx.bound) | (g > 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound); gradient passes iff x >= bound or it is negative."""
    return _LowerBound.apply(x, bound)


def upper_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """min(x, bound); gradient passes iff x <= bound or it is positive."""
    return _UpperBound.apply(x, bound)


def nonneg_init(value: torch.Tensor, pedestal: float = PEDESTAL) -> torch.Tensor:
    """Map an initial non-negative value to its stored (sqrt) representation."""
    return torch.sqrt(torch.clamp_min(value + pedestal, pedestal))


def nonneg(raw: torch.Tensor, minimum: float = 0.0,
           pedestal: float = PEDESTAL) -> torch.Tensor:
    """Recover the non-negative value (>= minimum) from its stored form."""
    bound = (minimum + pedestal) ** 0.5
    out = lower_bound(raw, bound)
    return out * out - pedestal
