"""Generalized Divisive Normalization (GDN / IGDN), port of ops/gdn.py.

    y_i = x_i / sqrt(beta_i + sum_j gamma_ji x_j^2)        (GDN)
    y_i = x_i * sqrt(beta_i + sum_j gamma_ji x_j^2)        (IGDN)

beta and gamma are stored in compressai's sqrt+pedestal form (ops/bound.py)
with gamma in the JAX orientation (C_in, C_out), so weights carry across as
a copy. The channel mix runs in the hand-written kernel
(ops/kernels/gdn_kernel.py) over the activation's (B*H*W, C) rows.
"""

import torch
from torch import nn

from neural_image_compression_tpu_torch.ops.bound import nonneg, nonneg_init
from neural_image_compression_tpu_torch.ops.kernels import gdn_kernel
from neural_image_compression_tpu_torch.utils.device import DeviceLike, resolve_device


class GDN(nn.Module):
    """GDN (inverse=False) / IGDN (inverse=True) over (B, C, H, W) tensors in
    channels_last memory. Init: beta = 1, gamma = gamma_init * I."""

    def __init__(self, channels: int, inverse: bool = False, beta_min: float = 1e-6,
                 gamma_init: float = 0.1, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.inverse = inverse
        self.beta_min = beta_min
        self.beta = nn.Parameter(nonneg_init(torch.ones(channels, device=device)))
        self.gamma = nn.Parameter(
            nonneg_init(gamma_init * torch.eye(channels, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = nonneg(self.beta, minimum=self.beta_min)
        gamma = nonneg(self.gamma)
        b, c, h, w = x.shape
        # channels_last (B, C, H, W) is NHWC in memory: this is a view.
        rows = x.permute(0, 2, 3, 1).reshape(-1, c)
        out = gdn_kernel.gdn(rows, gamma, beta, self.inverse)
        return out.view(b, h, w, c).permute(0, 3, 1, 2)
