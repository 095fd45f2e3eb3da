"""Convolution modules with torch geometry (port of ops/conv.py).

``Conv2d`` and ``Deconv2d`` run ``F.conv2d`` / ``F.conv_transpose2d`` on
(B, C, H, W) tensors in channels_last memory; their weights are OIHW and
torch ConvTranspose2d's (in, out, kh, kw), also channels_last. The
residual transforms' upsamplers (``SubpelConv3x3``, ``TransposedDeconv3x3``)
are built on them. The functional ``conv2d`` / ``deconv2d`` and
``pixel_shuffle`` keep the JAX package's NHWC layout and HWIO direct-conv
kernels. The JAX package's TPU lowerings of the same math (subpel/phased
deconv, custom VJPs) have no counterpart here.

Init matches torch's defaults (kaiming-uniform a=sqrt(5): bound
1/sqrt(fan_in)), drawn from the caller's ``torch.Generator`` on the CPU and
then moved to the module's device, so one seed gives the same weights on
every device.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neural_image_compression_tpu_torch.utils.device import DeviceLike, resolve_device


def uniform(shape, bound: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-bound, bound) float32 on the CPU from ``generator``."""
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def cast(dtype: Optional[torch.dtype], x: torch.Tensor, weight: torch.Tensor,
         bias: Optional[torch.Tensor]):
    """x, weight and bias (if any) in the compute dtype (unchanged when it is
    None)."""
    if dtype is None:
        return x, weight, bias
    return x.to(dtype), weight.to(dtype), None if bias is None else bias.to(dtype)


def _param(t: torch.Tensor, device: torch.device) -> nn.Parameter:
    if t.dim() == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return nn.Parameter(t.to(device))


class Conv2d(nn.Module):
    """Conv with torch-default init. dtype: compute dtype (params stay f32).
    use_bias=False: no bias parameter (the backbones' convs before a
    BatchNorm)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, use_bias: bool = True):
        super().__init__()
        device = resolve_device(device)
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, padding, dtype
        bound = 1.0 / math.sqrt(k * k * in_channels)
        self.weight = _param(uniform((features, in_channels, k, k), bound, generator), device)
        self.bias = _param(uniform((features,), bound, generator), device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = cast(self.dtype, x, self.weight, self.bias)
        return F.conv2d(x, weight, bias, self.stride, self.padding)


class Deconv2d(nn.Module):
    """Transposed conv (torch ConvTranspose2d geometry and init)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 2, padding: int = 0, output_padding: int = 0,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        k = kernel_size
        self.stride, self.padding = stride, padding
        self.output_padding, self.dtype = output_padding, dtype
        # torch ConvTranspose2d: fan_in = k*k*out_ch (weight.size(1) of its
        # (in, out, kh, kw) layout) for both kernel and bias
        bound = 1.0 / math.sqrt(k * k * features)
        self.weight = _param(uniform((in_channels, features, k, k), bound, generator), device)
        self.bias = _param(uniform((features,), bound, generator), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = cast(self.dtype, x, self.weight, self.bias)
        return F.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                  self.output_padding)


def conv2d(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Plain strided conv in the JAX package's layout: x (B, H, W, Cin),
    kernel HWIO (k, k, Cin, Cout), torch-style symmetric integer padding."""
    out = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), bias, stride, padding)
    return out.permute(0, 2, 3, 1)


def deconv2d(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
             stride: int = 2, padding: int = 0, output_padding: int = 0) -> torch.Tensor:
    """Transposed conv with torch ConvTranspose2d geometry in the JAX
    package's layout: x (B, H, W, Cin) and ``kernel`` the direct-conv HWIO
    kernel (k, k, Cin, Cout) that convolves the s-dilated input, i.e.
    ConvTranspose2d's (in, out, kh, kw) weight spatially flipped."""
    weight = kernel.flip(0, 1).permute(2, 3, 0, 1)
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding,
                             output_padding)
    return out.permute(0, 2, 3, 1)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NHWC pixel shuffle: (B, H, W, C*r^2) -> (B, H*r, W*r, C); channel
    index c_out * r^2 + i * r + j goes to row offset i, column offset j
    (torch's convention)."""
    b, h, w, c = x.shape
    r = factor
    oc = c // (r * r)
    x = x.reshape(b, h, w, oc, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, oc)


class SubpelConv3x3(nn.Module):
    """3x3 conv to features * r^2 channels, then a pixel shuffle by r."""

    def __init__(self, in_channels: int, features: int, upsample: int = 2,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsample = upsample
        self.Conv2d_0 = Conv2d(in_channels, features * upsample ** 2, 3, 1, 1, dtype=dtype,
                               device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC bytes in and out: the permutes are views
        out = pixel_shuffle(self.Conv2d_0(x).permute(0, 2, 3, 1), self.upsample)
        return out.permute(0, 3, 1, 2)


class TransposedDeconv3x3(nn.Module):
    """3x3 transposed-conv upsampler: k=3, p=1, output padding upsample-1
    (upsample 1 keeps the size)."""

    def __init__(self, in_channels: int, features: int, upsample: int = 2,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Deconv2d_0 = Deconv2d(in_channels, features, 3, upsample, 1, upsample - 1,
                                   dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Deconv2d_0(x)
