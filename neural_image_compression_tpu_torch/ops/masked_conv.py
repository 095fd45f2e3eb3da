"""Causal (PixelCNN-style) masked convolution, port of ops/masked_conv.py.

The mask is applied functionally (``weight * mask``) at every forward, so the
stored weight is never mutated and a masked or unmasked imported weight gives
the same effective kernel. A plain masked ``F.conv2d``: the JAX package's
gather-GEMM form is a TPU lowering of the same math.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neural_image_compression_tpu_torch.ops.conv import Conv2d, cast
from neural_image_compression_tpu_torch.utils.device import DeviceLike, resolve_device


def causal_mask(kernel_size: int, mask_type: str = "A") -> np.ndarray:
    """(kh, kw, 1, 1) raster-scan causal mask."""
    if mask_type not in ("A", "B"):
        raise ValueError(f"mask_type must be 'A' or 'B', got {mask_type!r}")
    k = kernel_size
    mask = np.ones((k, k, 1, 1), np.float32)
    center = k // 2
    mask[center, center + (1 if mask_type == "B" else 0):, :, :] = 0.0
    mask[center + 1:, :, :, :] = 0.0
    return mask


def causal_positions(kernel_size: int, mask_type: str = "A"):
    """(r, c) taps the causal mask keeps, in raster order."""
    m = causal_mask(kernel_size, mask_type)[:, :, 0, 0]
    return [(r, c) for r in range(kernel_size) for c in range(kernel_size) if m[r, c] > 0]


class MaskedConv2d(Conv2d):
    """Same-padded conv whose kernel is masked to the causal taps."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 5,
                 mask_type: str = "A", dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        device = resolve_device(device)
        super().__init__(in_channels, features, kernel_size, 1, kernel_size // 2,
                         dtype=dtype, device=device, generator=generator)
        mask = torch.from_numpy(causal_mask(kernel_size, mask_type)[:, :, 0, 0])
        self.register_buffer("mask", mask[None, None].to(device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = cast(self.dtype, x, self.weight * self.mask, self.bias)
        return F.conv2d(x, weight, bias, self.stride, self.padding)


class ContextModel(nn.Module):
    """Masked 5x5 conv, M -> 2M channels."""

    def __init__(self, latent_channels: int, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m = latent_channels
        self.MaskedConv2d_0 = MaskedConv2d(m, 2 * m, 5, "A", dtype=dtype,
                                           device=device, generator=generator)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.MaskedConv2d_0(y)
