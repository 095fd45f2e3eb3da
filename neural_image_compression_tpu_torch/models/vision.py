"""Vision-backbone surgery for scalable-coding distillation, port of
models/vision.py.

A backbone is a sequence of (module, f) pairs, the YOLO convention: f == -1
reads the previous layer's output, an int reads layer f's output, a list
concatenates those outputs on the channel axis (-1 in a list is the running
x). ``FirstHalf`` and ``SecondHalf`` slice that graph around a cut layer;
the second half reads pre-cut outputs through ``prev_outputs``.
``FrozenActivationBlock`` is a frozen BatchNorm (captured statistics) and
SiLU, the distillation target's activation: constants, nothing trainable.

The graph's inputs and outputs (and ``prev_outputs``) are NHWC, as the
model's; its layers see (B, C, H, W) views in channels_last memory, like
every module of the port. The layer modules are named ``layers_{i}_0``, the
flax names, so weights carry across by name.
"""

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from neural_image_compression_tpu_torch.models.joint_ar import _nchw, _nhwc
from neural_image_compression_tpu_torch.utils.device import DeviceLike, resolve_device

From = Union[int, Sequence[int]]


class GraphBackbone(nn.Module):
    """Sequential graph with skip wiring: layers[i] = (module, f)."""

    def __init__(self, layers: Sequence[Tuple[nn.Module, From]]):
        super().__init__()
        self.froms = []
        for i, (module, f) in enumerate(layers):
            setattr(self, f"layers_{i}_0", module)
            self.froms.append(f if isinstance(f, int) else tuple(f))

    def run(self, x: torch.Tensor, start: int = 0, end: Optional[int] = None,
            prev_outputs: Optional[Dict[int, torch.Tensor]] = None, collect: bool = False):
        """Layers [start, end) on x (NHWC, the input of layer ``start``);
        prev_outputs: earlier layers' outputs (NHWC) that later layers read.
        Returns the last output, and with collect=True also every layer's
        output by index (prev_outputs included)."""
        outputs: Dict[int, torch.Tensor] = dict(prev_outputs or {})
        end = len(self.froms) if end is None else end
        h = _nchw(x)
        for i in range(start, end):
            f = self.froms[i]
            if f != -1:
                if isinstance(f, int):
                    h = _nchw(outputs[f])
                else:
                    h = torch.cat([h if j == -1 else _nchw(outputs[j]) for j in f], dim=1)
            h = getattr(self, f"layers_{i}_0")(h)
            outputs[i] = _nhwc(h)
        out = _nhwc(h)
        return (out, outputs) if collect else out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run(x)


class FirstHalf(nn.Module):
    """Layers [0, cut] of a backbone."""

    def __init__(self, backbone: GraphBackbone, cut: int):
        super().__init__()
        self.backbone, self.cut = backbone, cut

    def forward(self, x: torch.Tensor, collect: bool = False):
        return self.backbone.run(x, 0, self.cut + 1, collect=collect)


class SecondHalf(nn.Module):
    """Layers (cut, end) of a backbone, fed the cut layer's activation."""

    def __init__(self, backbone: GraphBackbone, cut: int):
        super().__init__()
        self.backbone, self.cut = backbone, cut

    def forward(self, x: torch.Tensor,
                prev_outputs: Optional[Dict[int, torch.Tensor]] = None) -> torch.Tensor:
        outputs = dict(prev_outputs or {})
        outputs[self.cut] = x
        return self.backbone.run(x, self.cut + 1, None, prev_outputs=outputs)


class FrozenActivationBlock(nn.Module):
    """Frozen BatchNorm + SiLU over the last (channel) axis of NHWC
    tensors: silu((x - mean) * rsqrt(var + eps) * scale + bias). The four
    (C,) statistics are buffers: nothing here trains."""

    def __init__(self, scale, bias, mean, var, eps: float = 1e-5, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        for name, value in (("scale", scale), ("bias", bias), ("mean", mean), ("var", var)):
            self.register_buffer(name, torch.as_tensor(
                value, dtype=torch.float32, device=device).detach().clone())
        self.eps = eps

    @classmethod
    def from_stats(cls, scale, bias, mean, var, eps: float = 1e-5,
                   device: DeviceLike = None) -> "FrozenActivationBlock":
        return cls(scale, bias, mean, var, eps, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = (x - self.mean) * torch.rsqrt(self.var + self.eps) * self.scale + self.bias
        return F.silu(norm)
