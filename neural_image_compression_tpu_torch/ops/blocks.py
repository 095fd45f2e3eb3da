"""Building blocks (port of ops/blocks.py): the leaky ReLU and the residual
blocks of the 3x3 transforms.

Modules take and return (B, C, H, W) tensors in channels_last memory and
name their submodules as the JAX package's flax tree does (creation order
within the block), so weights carry across by name:

* ``ResidualBlockWithStride``: ``Conv2d_0`` (3x3, stride s) -> leaky ReLU ->
  ``Conv2d_1`` (3x3) -> ``GDN_0``, plus the skip ``Conv2d_2`` (1x1, stride
  s) when s != 1 or the width changes (else the identity). The skip runs
  as a 1x1 conv over every s-th row and column: the same sums as the
  strided conv, and torch 2.13's CPU backward of a stride-2 1x1 conv over
  3 channels_last channels (the first block's) corrupts the heap;
* ``ResidualBlockUpsample``: ``TransposedDeconv3x3_0`` -> leaky ReLU ->
  ``Conv2d_0`` (3x3) -> ``GDN_0`` (inverse), plus the skip
  ``TransposedDeconv3x3_1``;
* ``ResidualBlock``: ``Conv2d_0`` -> leaky ReLU -> ``Conv2d_1`` -> leaky
  ReLU, plus the skip ``Conv2d_2`` (1x1) when the width changes.

Each GDN goes through ``ops.gdn.GDN``: on a CUDA tensor it launches the
GDN kernel.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neural_image_compression_tpu_torch.ops.conv import Conv2d, TransposedDeconv3x3
from neural_image_compression_tpu_torch.ops.gdn import GDN
from neural_image_compression_tpu_torch.utils.device import DeviceLike, resolve_device


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


class ResidualBlockWithStride(nn.Module):
    """Strided residual block with GDN, in_channels -> features."""

    def __init__(self, in_channels: int, features: int, stride: int = 2,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.Conv2d_0 = Conv2d(in_channels, features, 3, stride, 1, **kw)
        self.Conv2d_1 = Conv2d(features, features, 3, 1, 1, **kw)
        self.GDN_0 = GDN(features, device=device)
        self.stride = stride
        if stride != 1 or in_channels != features:
            self.Conv2d_2 = Conv2d(in_channels, features, 1, 1, 0, **kw)  # over x[::s, ::s]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.GDN_0(self.Conv2d_1(leaky_relu(self.Conv2d_0(x))))
        if not hasattr(self, "Conv2d_2"):
            return out + x
        s = self.stride
        return out + self.Conv2d_2(x[:, :, ::s, ::s])


class ResidualBlockUpsample(nn.Module):
    """Upsampling residual block with IGDN, in_channels -> features."""

    def __init__(self, in_channels: int, features: int, upsample: int = 2,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.TransposedDeconv3x3_0 = TransposedDeconv3x3(in_channels, features, upsample, **kw)
        self.Conv2d_0 = Conv2d(features, features, 3, 1, 1, **kw)
        self.GDN_0 = GDN(features, inverse=True, device=device)
        self.TransposedDeconv3x3_1 = TransposedDeconv3x3(in_channels, features, upsample, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.GDN_0(self.Conv2d_0(leaky_relu(self.TransposedDeconv3x3_0(x))))
        return out + self.TransposedDeconv3x3_1(x)


class ResidualBlock(nn.Module):
    """Residual block of two 3x3 convs, in_channels -> features."""

    def __init__(self, in_channels: int, features: int, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.Conv2d_0 = Conv2d(in_channels, features, 3, 1, 1, **kw)
        self.Conv2d_1 = Conv2d(features, features, 3, 1, 1, **kw)
        if in_channels != features:
            self.Conv2d_2 = Conv2d(in_channels, features, 1, 1, 0, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = leaky_relu(self.Conv2d_1(leaky_relu(self.Conv2d_0(x))))
        return out + (self.Conv2d_2(x) if hasattr(self, "Conv2d_2") else x)
