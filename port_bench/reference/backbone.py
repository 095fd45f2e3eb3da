"""Plain reference of the distillation teacher: the YOLOv5 (v6) backbone's
layers 0 to ``cut`` (a 6x6 stride-2 stem, a 3x3 stride-2 conv, a C3 block,
a 3x3 stride-2 conv, each conv without bias and followed by a frozen
BatchNorm, eps 1e-5, and SiLU), and the cut layer's frozen BatchNorm and
SiLU applied to the LST's output. Leaf names follow the measured
backbone's ``state_dict`` (``layers_{i}_0...``); BatchNorm's mean and var
are buffers there.
"""

from typing import List

import torch
import torch.nn.functional as F

from port_bench.reference import layers as L

BN_EPS = 1e-5


def _cbs_specs(name, cin, cout, k) -> List[L.Spec]:
    b = f"{name}.BatchNorm_0"
    return (L.conv_specs(f"{name}.Conv2d_0", cin, cout, k, 1.4, bias=False)
            + [L.Spec(f"{b}.scale", (cout,), "range", 0.5, 1.5),
               L.Spec(f"{b}.bias", (cout,), "range", -0.2, 0.2),
               L.Spec(f"{b}.mean", (cout,), "range", -0.2, 0.2),
               L.Spec(f"{b}.var", (cout,), "range", 0.5, 2.0)])


def _layers(width):
    """(index, kind, cin, cout, kernel, stride) of layers 0-3."""
    w = width
    return ((0, "cbs", 3, w, 6, 2), (1, "cbs", w, 2 * w, 3, 2), (2, "c3", 2 * w, 2 * w, 1, 1),
            (3, "cbs", 2 * w, 4 * w, 3, 2))


def specs(width: int, cut: int) -> List[L.Spec]:
    if cut != 3:
        raise ValueError(f"the reference teacher is cut at layer 3, not {cut}")
    s = []
    for i, kind, cin, cout, k, _ in _layers(width):
        name = f"layers_{i}_0"
        if kind == "cbs":
            s += _cbs_specs(name, cin, cout, k)
        else:
            half = cout // 2
            s += _cbs_specs(f"{name}.ConvBNSiLU_0", cin, half, 1)
            s += _cbs_specs(f"{name}.Bottleneck_0.ConvBNSiLU_0", half, half, 1)
            s += _cbs_specs(f"{name}.Bottleneck_0.ConvBNSiLU_1", half, half, 3)
            s += _cbs_specs(f"{name}.ConvBNSiLU_1", cin, half, 1)
            s += _cbs_specs(f"{name}.ConvBNSiLU_2", 2 * half, cout, 1)
    return s


def _bn(p, name, x):
    b = f"{name}.BatchNorm_0"
    return F.batch_norm(x, p[f"{b}.mean"], p[f"{b}.var"], p[f"{b}.scale"], p[f"{b}.bias"],
                        training=False, eps=BN_EPS)


def _cbs(p, name, x, stride, num):
    w = p[f"{name}.Conv2d_0.weight"]
    k = w.shape[-1]
    h = F.conv2d(num.round(x), num.round(w), None, stride, (k - 1) // 2)
    return F.silu(_bn(p, name, h))


def first_half(p, teacher_cfg, x, num: L.Numerics = L.F32):
    """Layers 0..3 on x (B, H, W, 3) -> (B, H/8, W/8, 4 * width) NHWC."""
    h = L.nchw(x)
    for i, kind, _, _, _, stride in _layers(teacher_cfg["width"]):
        name = f"layers_{i}_0"
        if kind == "cbs":
            h = _cbs(p, name, h, stride, num)
            continue
        a = _cbs(p, f"{name}.ConvBNSiLU_0", h, 1, num)
        a = a + _cbs(p, f"{name}.Bottleneck_0.ConvBNSiLU_1",
                     _cbs(p, f"{name}.Bottleneck_0.ConvBNSiLU_0", a, 1, num), 1, num)
        b = _cbs(p, f"{name}.ConvBNSiLU_1", h, 1, num)
        h = _cbs(p, f"{name}.ConvBNSiLU_2", torch.cat([a, b], 1), 1, num)
    return L.nhwc(h)


def frozen_activation(p, cut: int, f):
    """The cut layer's BatchNorm (frozen) and SiLU over f's last axis."""
    b = f"layers_{cut}_0.BatchNorm_0"
    norm = (f - p[f"{b}.mean"]) * torch.rsqrt(p[f"{b}.var"] + BN_EPS) * p[f"{b}.scale"] + p[f"{b}.bias"]
    return F.silu(norm)
