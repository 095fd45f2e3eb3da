"""Analysis / synthesis / hyper transforms, port of models/components.py:
the 5x5 conv/GDN set, the 3x3 residual-block set (``Encoder3x3``,
``Decoder3x3``, ``HyperEncoder3x3``, ``HyperDecoder3x3``: the reference's
HierarchicalMixtureResidual transforms) and the scalable model's
``LatentSpaceTransform``.

Modules take and return (B, C, H, W) tensors in channels_last memory.
Submodule names follow the JAX package's parameter tree (``Conv2d_0``,
``GDN_0``, ...), so carrying weights across is a walk over matching names.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from neural_image_compression_tpu_torch.ops.blocks import (
    ResidualBlock, ResidualBlockUpsample, ResidualBlockWithStride, leaky_relu,
)
from neural_image_compression_tpu_torch.ops.conv import Conv2d, Deconv2d, TransposedDeconv3x3
from neural_image_compression_tpu_torch.ops.gdn import GDN
from neural_image_compression_tpu_torch.utils.device import DeviceLike, resolve_device


class Encoder5x5(nn.Module):
    """4x stride-2 5x5 convs with GDN between (x16 downsample), 3 -> M."""

    def __init__(self, latent_channels: int = 192, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        m = latent_channels
        for i in range(4):
            setattr(self, f"Conv2d_{i}", Conv2d(3 if i == 0 else m, m, 5, 2, 2, dtype=dtype,
                                                device=device, generator=generator))
            if i < 3:
                setattr(self, f"GDN_{i}", GDN(m, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"GDN_{i}")(getattr(self, f"Conv2d_{i}")(x))
        return self.Conv2d_3(x)  # bottleneck


class Decoder5x5(nn.Module):
    """Mirror of Encoder5x5: 4x stride-2 5x5 deconvs with IGDN, M -> 3."""

    def __init__(self, latent_channels: int = 192, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        m = latent_channels
        for i in range(4):
            setattr(self, f"Deconv2d_{i}", Deconv2d(m, 3 if i == 3 else m, 5, 2, 2, 1,
                                                    dtype=dtype, device=device,
                                                    generator=generator))
            if i < 3:
                setattr(self, f"GDN_{i}", GDN(m, inverse=True, device=device))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            y = getattr(self, f"GDN_{i}")(getattr(self, f"Deconv2d_{i}")(y))
        return self.Deconv2d_3(y)


class HyperEncoder5x5(nn.Module):
    """y -> z, x4 downsample. Operates on raw y (not |y|)."""

    def __init__(self, latent_channels: int = 192, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        m = latent_channels
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.Conv2d_0 = Conv2d(m, m, 3, 1, 1, **kw)
        self.Conv2d_1 = Conv2d(m, m, 5, 2, 2, **kw)
        self.Conv2d_2 = Conv2d(m, m, 5, 2, 2, **kw)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        y = leaky_relu(self.Conv2d_0(y))
        y = leaky_relu(self.Conv2d_1(y))
        return self.Conv2d_2(y)


class HyperDecoder5x5(nn.Module):
    """z -> psi with 2M output channels; middle width int(1.5 * M)."""

    def __init__(self, latent_channels: int = 192, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        m = latent_channels
        mid = int(1.5 * m)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.Deconv2d_0 = Deconv2d(m, m, 5, 2, 2, 1, **kw)
        self.Deconv2d_1 = Deconv2d(m, mid, 5, 2, 2, 1, **kw)
        self.Conv2d_0 = Conv2d(mid, 2 * m, 3, 1, 1, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = leaky_relu(self.Deconv2d_0(z))
        z = leaky_relu(self.Deconv2d_1(z))
        return self.Conv2d_0(z)


class Encoder3x3(nn.Module):
    """Residual-block analysis (x16 downsample), 3 -> M: three strided
    blocks with GDN, each followed by a plain block, then a stride-2 3x3
    bottleneck conv."""

    def __init__(self, latent_channels: int = 192, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        m = latent_channels
        kw = dict(dtype=dtype, device=device, generator=generator)
        for i in range(3):
            setattr(self, f"ResidualBlockWithStride_{i}",
                    ResidualBlockWithStride(3 if i == 0 else m, m, 2, **kw))
            setattr(self, f"ResidualBlock_{i}", ResidualBlock(m, m, **kw))
        self.Conv2d_0 = Conv2d(m, m, 3, 2, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"ResidualBlockWithStride_{i}")(x)
            x = getattr(self, f"ResidualBlock_{i}")(x)
        return self.Conv2d_0(x)  # bottleneck


class Decoder3x3(nn.Module):
    """Residual-block synthesis (x16 upsample), M -> 3: plain blocks around
    three upsampling blocks with IGDN, then a 3x3 transposed conv to 3."""

    def __init__(self, latent_channels: int = 192, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        m = latent_channels
        kw = dict(dtype=dtype, device=device, generator=generator)
        for i in range(3):
            setattr(self, f"ResidualBlock_{i}", ResidualBlock(m, m, **kw))
            setattr(self, f"ResidualBlockUpsample_{i}", ResidualBlockUpsample(m, m, 2, **kw))
        self.ResidualBlock_3 = ResidualBlock(m, m, **kw)
        self.TransposedDeconv3x3_0 = TransposedDeconv3x3(m, 3, 2, **kw)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            y = getattr(self, f"ResidualBlock_{i}")(y)
            y = getattr(self, f"ResidualBlockUpsample_{i}")(y)
        return self.TransposedDeconv3x3_0(self.ResidualBlock_3(y))


class HyperEncoder3x3(nn.Module):
    """y -> z with five 3x3 convs (two of stride 2, x4 downsample)."""

    def __init__(self, latent_channels: int = 192, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        m = latent_channels
        kw = dict(dtype=dtype, device=device, generator=generator)
        for i, stride in enumerate((1, 1, 2, 1, 2)):
            setattr(self, f"Conv2d_{i}", Conv2d(m, m, 3, stride, 1, **kw))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            y = leaky_relu(getattr(self, f"Conv2d_{i}")(y))
        return self.Conv2d_4(y)


class HyperDecoder3x3(nn.Module):
    """z -> psi with 2M output channels: 3x3 convs and two 3x3 transposed
    convs (x4 upsample); middle width int(1.5 * M)."""

    def __init__(self, latent_channels: int = 192, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        m = latent_channels
        mid = int(1.5 * m)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.Conv2d_0 = Conv2d(m, m, 3, 1, 1, **kw)
        self.TransposedDeconv3x3_0 = TransposedDeconv3x3(m, m, 2, **kw)
        self.Conv2d_1 = Conv2d(m, mid, 3, 1, 1, **kw)
        self.TransposedDeconv3x3_1 = TransposedDeconv3x3(mid, mid, 2, **kw)
        self.Conv2d_2 = Conv2d(mid, 2 * m, 3, 1, 1, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = leaky_relu(self.Conv2d_0(z))
        z = leaky_relu(self.TransposedDeconv3x3_0(z))
        z = leaky_relu(self.Conv2d_1(z))
        z = leaky_relu(self.TransposedDeconv3x3_1(z))
        return self.Conv2d_2(z)


class LatentSpaceTransform(nn.Module):
    """Residual and upsampling tower from the base latents y1 (M1 channels)
    toward a frozen vision backbone's feature space: three stages of a
    ``ResidualBlock`` and a ``ResidualBlockUpsample`` (by
    upsampling_factors[i]), a last ``ResidualBlock`` and a 3x3 conv. The
    width m starts at M1 and grows by each stage's factor after its
    upsampling block, so a stage's ``ResidualBlock`` bridges the previous
    width to m through its 1x1 skip; the conv maps m to
    m * upsampling_factors[3]. The default (2, 1, 1, 1) gives 2 * M1
    channels at twice y1's grid (H/8), one IGDN at M1 and two at 2 * M1.
    An upsampling factor of 1 keeps the transposed conv (stride 1)."""

    def __init__(self, latent_channels: int = 192,
                 upsampling_factors: Sequence[int] = (2, 1, 1, 1),
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        ups = tuple(upsampling_factors)
        if len(ups) != 4:
            raise ValueError(f"upsampling_factors needs 4 entries, got {ups}")
        self.upsampling_factors = ups
        c = m = latent_channels
        for i, u in enumerate(ups[:3]):
            setattr(self, f"ResidualBlock_{i}", ResidualBlock(c, m, **kw))
            setattr(self, f"ResidualBlockUpsample_{i}", ResidualBlockUpsample(m, m, u, **kw))
            c, m = m, m * u
        self.ResidualBlock_3 = ResidualBlock(c, m, **kw)
        self.Conv2d_0 = Conv2d(m, m * ups[3], 3, 1, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"ResidualBlock_{i}")(x)
            x = getattr(self, f"ResidualBlockUpsample_{i}")(x)
        return self.Conv2d_0(self.ResidualBlock_3(x))
