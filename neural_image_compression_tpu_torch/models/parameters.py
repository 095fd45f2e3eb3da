"""Entropy-parameter network, port of models/parameters.py.

Three 1x1 convs (hidden 640, LeakyReLU) over the concat of context features
phi and hyper features psi. Outputs, NHWC and float32:
  * K == 1: (mu, sigma), each (B, H, W, M); sigma = softplus(raw) + 1e-6.
  * K > 1: (weights, mus, sigmas), each (B, H, W, K, M), split k-major from
    the 3KM output channels; weights softmaxed over K.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neural_image_compression_tpu_torch.ops.blocks import leaky_relu
from neural_image_compression_tpu_torch.ops.conv import Conv2d
from neural_image_compression_tpu_torch.utils.device import DeviceLike, resolve_device

SIGMA_FLOOR = 1e-6
HIDDEN = 640


class EntropyParameters(nn.Module):
    def __init__(self, latent_channels: int = 192, hyper_latent_channels: int = 192,
                 K: int = 1, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.latent_channels, self.K = latent_channels, K
        self.input_channels = 2 * latent_channels + 2 * hyper_latent_channels
        out_ch = 2 * latent_channels if K == 1 else 3 * K * latent_channels
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.Conv2d_0 = Conv2d(self.input_channels, HIDDEN, 1, **kw)
        self.Conv2d_1 = Conv2d(HIDDEN, HIDDEN, 1, **kw)
        self.Conv2d_2 = Conv2d(HIDDEN, out_ch, 1, **kw)

    def forward(self, combined: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """combined: (B, 4M, H, W) channels_last."""
        if combined.shape[1] != self.input_channels:
            raise ValueError(
                f"EntropyParameters expected {self.input_channels} input channels "
                f"(2M context + 2H hyper), got {combined.shape[1]}")
        m, k = self.latent_channels, self.K
        h = leaky_relu(self.Conv2d_0(combined))
        h = leaky_relu(self.Conv2d_1(h))
        out = self.Conv2d_2(h).float().permute(0, 2, 3, 1)  # NHWC

        if k == 1:
            mu, sigma_raw = torch.chunk(out, 2, dim=-1)
            return mu.contiguous(), F.softplus(sigma_raw) + SIGMA_FLOOR

        b, hh, ww, _ = out.shape
        w_raw, mu_raw, sigma_raw = torch.chunk(out, 3, dim=-1)
        # [B, H, W, K*M] -> [B, H, W, K, M]
        weights = torch.softmax(w_raw.reshape(b, hh, ww, k, m), dim=-2)
        mus = mu_raw.reshape(b, hh, ww, k, m).contiguous()
        sigmas = F.softplus(sigma_raw.reshape(b, hh, ww, k, m)) + SIGMA_FLOOR
        return weights, mus, sigmas
