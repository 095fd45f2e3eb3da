"""A frozen YOLO-style vision backbone as a ``GraphBackbone``, port of
models/backbones.py: the YOLOv5 (v6) backbone and neck through the P3
feature map, for the scalable model's distillation teacher.

Conv (no bias) + BatchNorm + SiLU stems, C3 blocks (a channel split, a run
of bottlenecks, a concat and a fuse), SPPF (three stacked 5x5 max pools
padded with -inf), nearest 2x upsampling and neck concats whose ``f`` lists
reach back across the cut point. Every BatchNorm runs on its running
statistics (eps 1e-5) and never updates them, as the reference's eval()
backbone. Modules take and return (B, C, H, W) tensors in channels_last
memory and name their submodules as the flax tree does, so weights carry
across by name (``utils.weights.load_jax_variables``); ``save_backbone`` and
``load_backbone`` read and write the JAX package's npz format.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neural_image_compression_tpu_torch.models.vision import (
    FirstHalf, FrozenActivationBlock, GraphBackbone,
)
from neural_image_compression_tpu_torch.ops.conv import Conv2d
from neural_image_compression_tpu_torch.utils.device import DeviceLike, resolve_device

BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """Frozen BatchNorm over the channels of (B, C, H, W): ``scale`` and
    ``bias`` (flax's params), ``mean`` and ``var`` (flax's batch_stats,
    buffers), computed in float32 and returned in x's dtype."""

    def __init__(self, channels: int, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.mean, self.var, self.scale, self.bias,
                            training=False, eps=BN_EPS).to(x.dtype)


class ConvBNSiLU(nn.Module):
    """YOLO's 'Conv': a conv without bias, padding (kernel - 1) // 2, a
    frozen BatchNorm and SiLU."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.Conv2d_0 = Conv2d(in_channels, features, kernel, stride, (kernel - 1) // 2,
                               dtype=dtype, device=device, generator=generator, use_bias=False)
        self.BatchNorm_0 = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.BatchNorm_0(self.Conv2d_0(x)))


class Bottleneck(nn.Module):
    """1x1 then 3x3 ConvBNSiLU, plus the input when shortcut is set and the
    width does not change."""

    def __init__(self, in_channels: int, features: int, shortcut: bool = True,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.ConvBNSiLU_0 = ConvBNSiLU(in_channels, features, 1, **kw)
        self.ConvBNSiLU_1 = ConvBNSiLU(features, features, 3, **kw)
        self.add = shortcut and in_channels == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBNSiLU_1(self.ConvBNSiLU_0(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs: two 1x1 branches of features // 2
    channels, n bottlenecks on the first, concat, a 1x1 fuse."""

    def __init__(self, in_channels: int, features: int, n: int = 1, shortcut: bool = True,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        half = features // 2
        self.n = n
        self.ConvBNSiLU_0 = ConvBNSiLU(in_channels, half, 1, **kw)
        for j in range(n):
            setattr(self, f"Bottleneck_{j}", Bottleneck(half, half, shortcut, **kw))
        self.ConvBNSiLU_1 = ConvBNSiLU(in_channels, half, 1, **kw)
        self.ConvBNSiLU_2 = ConvBNSiLU(2 * half, features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.ConvBNSiLU_0(x)
        for j in range(self.n):
            a = getattr(self, f"Bottleneck_{j}")(a)
        return self.ConvBNSiLU_2(torch.cat([a, self.ConvBNSiLU_1(x)], dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): a 1x1 to features // 2, three
    stacked 5x5 stride-1 max pools (padded with -inf), the four scales
    concatenated and fused by a 1x1."""

    def __init__(self, in_channels: int, features: int, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        half = features // 2
        self.ConvBNSiLU_0 = ConvBNSiLU(in_channels, half, 1, **kw)
        self.ConvBNSiLU_1 = ConvBNSiLU(4 * half, features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [self.ConvBNSiLU_0(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.ConvBNSiLU_1(torch.cat(pools, dim=1))


class Upsample2x(nn.Module):
    """Nearest-neighbour 2x upsampling (the YOLO neck's nn.Upsample)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=2, mode="nearest")


class Concat(nn.Module):
    """Identity placeholder for the yaml's Concat layers: the graph
    concatenates a list-valued ``f`` before calling it, so layer indices
    stay 1:1 with the yolov5 yaml."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


# C3 depth multipliers per layer index (times depth): the yolov5 yaml's
# backbone / neck ladder over its depth_multiple, so depth=1 is yolov5n/s
# and depth=2 yolov5m
_C3_DEPTH = {2: 1, 4: 2, 6: 3, 8: 1, 13: 1, 17: 1}


def build_yolo_backbone(width: int = 16, depth: int = 1, dtype: Optional[torch.dtype] = None,
                        device: DeviceLike = None, seed: int = 0) -> GraphBackbone:
    """The YOLOv5-v6 backbone and neck through P3, layer indices 1:1 with
    the ultralytics yaml (``model.{i}`` checkpoint keys map onto
    ``layers_{i}_0``); w = width, d = depth:

      idx  layer                 f        grid  ch
       0   Conv(w, 6, s2)       -1        /2    w     (6x6 stem)
       1   Conv(2w, 3, s2)      -1        /4    2w
       2   C3(2w, d)            -1        /4    2w
       3   Conv(4w, 3, s2)      -1        /8    4w
       4   C3(4w, 2d)           -1        /8    4w
       5   Conv(8w, 3, s2)      -1        /16   8w
       6   C3(8w, 3d)           -1        /16   8w
       7   Conv(16w, 3, s2)     -1        /32   16w
       8   C3(16w, d)           -1        /32   16w
       9   SPPF(16w)            -1        /32   16w
      10   Conv(8w, 1)          -1        /32   8w
      11   Upsample2x           -1        /16   8w
      12   Concat               [11, 6]   /16   16w
      13   C3(8w, d, no-cut)    -1        /16   8w
      14   Conv(4w, 1)          -1        /16   4w
      15   Upsample2x           -1        /8    4w
      16   Concat               [15, 4]   /8    8w
      17   C3(4w, d, no-cut)    -1        /8    4w   <- P3

    width=16, depth=1 is yolov5n. Weights: torch's conv init from
    ``seed`` (drawn on the CPU), BatchNorm at scale 1, bias 0, mean 0, var
    1. The returned graph records ``width`` and ``depth``."""
    w, d = width, depth
    kw = dict(dtype=dtype, device=resolve_device(device),
              generator=torch.Generator().manual_seed(seed))

    def conv(cin, cout, k, s=1):
        return ConvBNSiLU(cin, cout, k, s, **kw)

    def c3(i, cin, cout, shortcut=True):
        return C3(cin, cout, _C3_DEPTH[i] * d, shortcut, **kw)

    backbone = GraphBackbone((
        (conv(3, w, 6, 2), -1),
        (conv(w, 2 * w, 3, 2), -1),
        (c3(2, 2 * w, 2 * w), -1),
        (conv(2 * w, 4 * w, 3, 2), -1),
        (c3(4, 4 * w, 4 * w), -1),
        (conv(4 * w, 8 * w, 3, 2), -1),
        (c3(6, 8 * w, 8 * w), -1),
        (conv(8 * w, 16 * w, 3, 2), -1),
        (c3(8, 16 * w, 16 * w), -1),
        (SPPF(16 * w, 16 * w, **kw), -1),
        (conv(16 * w, 8 * w, 1), -1),
        (Upsample2x(), -1),
        (Concat(), [11, 6]),
        (c3(13, 16 * w, 8 * w, shortcut=False), -1),
        (conv(8 * w, 4 * w, 1), -1),
        (Upsample2x(), -1),
        (Concat(), [15, 4]),
        (c3(17, 8 * w, 4 * w, shortcut=False), -1),
    ))
    backbone.width, backbone.depth = width, depth
    return backbone


def save_backbone(path: str, width: int, backbone: GraphBackbone, depth: int = 1) -> None:
    """Write a backbone's weights and its (width, depth) to one .npz in the
    JAX package's format (``params/...`` and ``batch_stats/...`` keys in the
    flax layouts, ``__width__``, ``__depth__``): a file either package
    writes loads in the other."""
    from neural_image_compression_tpu_torch.utils.weights import variables_to_jax

    flat = {}

    def walk(tree, prefix):
        for name, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub, prefix + (name,))
            else:
                flat["/".join(prefix + (name,))] = np.asarray(sub)

    for col, tree in variables_to_jax(backbone).items():
        walk(tree, (col,))
    np.savez(path, __width__=np.int64(width), __depth__=np.int64(depth), **flat)


def load_backbone(path: str, dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None) -> GraphBackbone:
    """``save_backbone``'s inverse (also for a file the JAX package wrote):
    the backbone of the file's width and depth, with its weights."""
    from neural_image_compression_tpu_torch.utils.weights import load_jax_variables

    fx = np.load(path)
    width = int(fx["__width__"])
    depth = int(fx["__depth__"]) if "__depth__" in fx.files else 1
    variables = {"params": {}, "batch_stats": {}}
    for key in fx.files:
        if key.startswith("__"):
            continue
        parts = key.split("/")
        node = variables[parts[0]]
        for k in parts[1:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = np.asarray(fx[key])
    backbone = build_yolo_backbone(width, depth, dtype, device)
    return load_jax_variables(backbone, variables)


def frozen_activation_from_conv(backbone: GraphBackbone, layer_idx: int,
                                eps: float = BN_EPS) -> FrozenActivationBlock:
    """Layer ``layer_idx``'s BatchNorm statistics as a FrozenActivationBlock
    (the cut layer's BN, frozen, and SiLU: the reference's distillation
    target), on the backbone's device. The layer must be a ConvBNSiLU."""
    layer = getattr(backbone, f"layers_{layer_idx}_0", None)
    if not isinstance(layer, ConvBNSiLU):
        raise ValueError(f"layer {layer_idx} has no ConvBNSiLU BatchNorm scope")
    bn = layer.BatchNorm_0
    return FrozenActivationBlock(bn.scale, bn.bias, bn.mean, bn.var, eps, bn.mean.device)


def distillation_targets(backbone: GraphBackbone, cut: int):
    """(frozen_activation, V) for ``train.vision_rd_loss``: V is the
    backbone's ``FirstHalf(cut)``, frozen (its parameters' requires_grad
    off, eval mode: gradients still reach its input), and frozen_activation
    the cut layer's frozen BatchNorm + SiLU."""
    V = FirstHalf(backbone, cut).eval().requires_grad_(False)
    return frozen_activation_from_conv(backbone, cut), V
