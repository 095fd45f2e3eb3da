"""Learned factorized entropy bottleneck (Balle et al. 2018, appendix 6.1),
port of entropy/factorized.py.

Each channel's CDF is a small monotone MLP: softplus-positive matrices, free
biases, tanh-gated skip factors, TFC-style constant init
log(expm1(1/scale/out)), init_scale 10, filters (3, 3, 3). The chain is
evaluated channel-batched (a batched matmul over (C, out, in) x (C, in, N)),
and the discrete likelihood sigmoid(L(x+.5)) - sigmoid(L(x-.5)) uses the
sign-flip stabilization. Always float32.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neural_image_compression_tpu_torch.entropy.base import (
    DEFAULT_LIKELIHOOD_LOWER_BOUND, clamp_likelihood,
)
from neural_image_compression_tpu_torch.utils.device import DeviceLike, resolve_device

INIT_SCALE = 10.0
FILTERS = (3, 3, 3)


class FactorizedEntropyBottleneck(nn.Module):
    """Parameters ``matrix_i`` (C, out, in), ``bias_i`` (C, out, 1) and
    ``factor_i`` (C, out, 1), named as in the JAX package."""

    def __init__(self, channels: int, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.channels = channels
        self.num_layers = len(FILTERS) + 1
        filters_full = (1,) + FILTERS + (1,)
        scale = INIT_SCALE ** (1.0 / self.num_layers)
        for i in range(self.num_layers):
            out, inp = filters_full[i + 1], filters_full[i]
            init_val = math.log(math.expm1(1.0 / scale / out))
            self.register_parameter(f"matrix_{i}", nn.Parameter(
                torch.full((channels, out, inp), init_val, device=device)))
            bias = torch.empty(channels, out, 1).uniform_(-0.5, 0.5, generator=generator)
            self.register_parameter(f"bias_{i}", nn.Parameter(bias.to(device)))
            if i < len(FILTERS):
                self.register_parameter(f"factor_{i}", nn.Parameter(
                    torch.zeros(channels, out, 1, device=device)))

    def _logits_cumulative(self, x: torch.Tensor) -> torch.Tensor:
        """x: (C, 1, N) float32 -> logits (C, 1, N)."""
        logits = x
        for i in range(self.num_layers):
            matrix = F.softplus(getattr(self, f"matrix_{i}"))
            logits = torch.bmm(matrix, logits) + getattr(self, f"bias_{i}")
            if i < self.num_layers - 1:
                factor = torch.tanh(getattr(self, f"factor_{i}"))
                logits = logits + factor * torch.tanh(logits)
        return logits

    def likelihood(self, x: torch.Tensor) -> torch.Tensor:
        """Discrete likelihood of each element of NHWC x (float32)."""
        b, h, w, c = x.shape
        flat = x.float().reshape(-1, c).t().reshape(c, 1, -1)
        lower = self._logits_cumulative(flat - 0.5)
        upper = self._logits_cumulative(flat + 0.5)
        # sign-flip stabilization: take the sigmoid difference on the side
        # where both logits are small
        sign = -torch.sign(lower + upper).detach()
        pmf = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        return pmf.reshape(c, -1).t().reshape(b, h, w, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return clamp_likelihood(self.likelihood(x), DEFAULT_LIKELIHOOD_LOWER_BOUND)

    # --- coder / visualization hooks -------------------------------------
    def grid_logits(self, xs: torch.Tensor) -> torch.Tensor:
        """CDF logits at grid xs (N,) for all channels -> (C, N)."""
        flat = xs.float()[None, None, :].expand(self.channels, 1, xs.shape[0])
        return self._logits_cumulative(flat)[:, 0, :]

    def grid_cdf(self, xs: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.grid_logits(xs))

    def grid_pmf(self, xs: torch.Tensor) -> torch.Tensor:
        """Discrete PMF at bin centers xs for all channels -> (C, N), >= 1e-12."""
        up = torch.sigmoid(self.grid_logits(xs + 0.5))
        lo = torch.sigmoid(self.grid_logits(xs - 0.5))
        return torch.clamp_min(up - lo, 1e-12)
