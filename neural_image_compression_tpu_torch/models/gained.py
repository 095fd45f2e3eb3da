"""Variable-rate ("gained") families and exact gain folding, port of
models/gained.py (asymmetric gain units, Cui et al., CVPR 2021).

One set of transform weights codes at N trained rate points, and at any
rate between them: per-level channel gains scale y and z into the coded
domain before quantization, and inverse gains scale the decoders' inputs.
Each gained family is its fixed-rate family (``models.joint_ar``,
``hyperprior``, ``checkerboard``, ``channel_cb``) with four (N, M) gain
tables, ``gain_y``, ``igain_y``, ``gain_z`` and ``igain_z`` (initialised to
ones, named as in the flax tree); the forward is the fixed-rate one
(``HierarchicalModel._forward``) given the four vectors at ``level``. The
context and entropy nets work in the coded domain.

Folding: at a fixed level the four vectors are channel scales on the four
boundary convolutions, so ``fold_gains`` turns a gained ``state_dict`` into
the fixed-rate family's (``folded_model``), which runs the codecs, serving
and the evaluator unchanged. Only the 5x5 conv transforms fold (the
res3x3 decoder opens with an identity-skip residual block).

Training: ``parallel.make_train_step(..., levels=model.levels)`` draws one
level a step and weights the loss with its lambda; the Trainer wires that
for any model with ``levels``.
"""

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from neural_image_compression_tpu_torch.models.channel_cb import ChannelCheckerboardHierarchical
from neural_image_compression_tpu_torch.models.checkerboard import CheckerboardHierarchical
from neural_image_compression_tpu_torch.models.hyperprior import MeanScaleHyperprior
from neural_image_compression_tpu_torch.models.joint_ar import JointAutoregressiveHierarchical
from neural_image_compression_tpu_torch.utils.device import DeviceLike

__all__ = ["GainedJointAR", "GainedHyperprior", "GainedCheckerboard",
           "GainedChannelCheckerboard", "fold_gains", "folded_model", "interp_gain",
           "level_for_bpp"]

DEFAULT_LEVELS = (0.0015, 0.0035, 0.0075, 0.015, 0.03)
_GAIN_KEYS = ("gain_y", "igain_y", "gain_z", "igain_z")
# the boundary convolutions fold_gains scales, and how: the four are dim 0
# of torch's layouts (Conv2d's OIHW out-channels, where the bias scales too;
# ConvTranspose2d's (in, out, kh, kw) in-channels, where it does not)
_FOLDS = (("encoder.Conv2d_3", "gain_y", True), ("decoder.Deconv2d_0", "igain_y", False),
          ("hyper_encoder.Conv2d_2", "gain_z", True),
          ("hyper_decoder.Deconv2d_0", "igain_z", False))


def interp_gain(table: torch.Tensor, level) -> torch.Tensor:
    """The gain vector (C,) at ``level`` of an (N, C) per-level table, in
    float32: a row at an integer level, the geometric interpolation of the
    two rows around a fractional one (log-domain lerp of |g|); levels
    clip to [0, N - 1]. A stack of tables (..., N, C) gives (..., C), each
    table's vector computed as alone. ``level``: an int, a float, or a
    0-dim tensor on the table's device (never read on the host)."""
    n = table.shape[-2]
    g = torch.log(table.float().abs() + 1e-12)
    if isinstance(level, torch.Tensor):
        lv = level.to(torch.float32).clamp(0, n - 1).reshape(1)
        lo = lv.floor()
        hi = torch.clamp(lo + 1, max=n - 1)
        t = lv - lo
        return torch.exp((1.0 - t) * g.index_select(-2, lo.long()).squeeze(-2)
                         + t * g.index_select(-2, hi.long()).squeeze(-2))
    # on the host, in float32 as the JAX package computes it
    lv = np.float32(min(max(np.float32(level), np.float32(0)), np.float32(n - 1)))
    lo = int(np.floor(lv))
    t = np.float32(lv - np.float32(lo))
    return torch.exp(float(np.float32(1) - t) * g[..., lo, :]
                     + float(t) * g[..., min(lo + 1, n - 1), :])


def _validate_gained(latent_channels: int, K: int, levels: Sequence[float]) -> None:
    if latent_channels < 1:
        raise ValueError(f"latent_channels must be >= 1, got {latent_channels}")
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    if len(levels) < 2:
        raise ValueError("levels needs >= 2 rate points")
    if list(levels) != sorted(levels):
        raise ValueError(f"levels must be ascending, got {tuple(levels)}")


class _Gained:
    """The gain tables and the level-taking forward, over a fixed-rate
    family (the class after this one in a gained family's bases)."""

    def _add_gains(self, levels: Sequence[float]) -> None:
        self.levels = tuple(float(v) for v in levels)
        device = self.encoder.Conv2d_0.weight.device
        shape = (len(self.levels), self.latent_channels)
        for name in _GAIN_KEYS:
            setattr(self, name, nn.Parameter(torch.ones(shape, device=device)))

    def gain_vectors(self, level) -> Tuple[torch.Tensor, ...]:
        """(g_y, ig_y, g_z, ig_z) at ``level``: the one source of the scales,
        shared with ``fold_gains`` (the four tables interpolated as one
        stack: a quarter of the launches, the same values)."""
        return interp_gain(torch.stack([getattr(self, name) for name in _GAIN_KEYS]),
                           level).unbind(0)

    _gains = gain_vectors

    def forward(self, x: torch.Tensor, training: bool = True,
                generator: Optional[torch.Generator] = None, level=0) -> Dict[str, torch.Tensor]:
        """The fixed-rate family's forward with the gains at ``level`` (an
        int, a float, or a 0-dim tensor on the model's device)."""
        return self._run(x, training, generator, level)


class GainedJointAR(_Gained, JointAutoregressiveHierarchical):
    """JointAutoregressiveHierarchical with per-level gain units. levels:
    the ascending lambda ladder; level i trains its gains for levels[i]
    (higher lambda: larger gains, finer quantization, more bits). dtype,
    device and seed as the fixed-rate family's."""

    def __init__(self, latent_channels: int = 192, K: int = 1,
                 levels: Sequence[float] = DEFAULT_LEVELS, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, seed: int = 0):
        _validate_gained(latent_channels, K, levels)
        super().__init__(latent_channels, K, "conv5x5", dtype, device, seed)
        self._add_gains(levels)


class GainedHyperprior(_Gained, MeanScaleHyperprior):
    """MeanScaleHyperprior with per-level gain units (one parallel decode
    pass at every rate). Arguments as ``GainedJointAR``'s."""

    def __init__(self, latent_channels: int = 192, K: int = 1,
                 levels: Sequence[float] = DEFAULT_LEVELS, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, seed: int = 0):
        _validate_gained(latent_channels, K, levels)
        super().__init__(latent_channels, K, "conv5x5", dtype, device, seed)
        self._add_gains(levels)


class GainedCheckerboard(_Gained, CheckerboardHierarchical):
    """CheckerboardHierarchical with per-level gain units (two decode
    passes at every rate). Arguments as ``GainedJointAR``'s."""

    def __init__(self, latent_channels: int = 192, K: int = 1,
                 levels: Sequence[float] = DEFAULT_LEVELS, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, seed: int = 0):
        _validate_gained(latent_channels, K, levels)
        super().__init__(latent_channels, K, "conv5x5", dtype, device, seed)
        self._add_gains(levels)


class GainedChannelCheckerboard(_Gained, ChannelCheckerboardHierarchical):
    """ChannelCheckerboardHierarchical with per-level gain units (2·G decode
    passes at every rate). groups as the fixed-rate family's; the other
    arguments as ``GainedJointAR``'s."""

    def __init__(self, latent_channels: int = 192, K: int = 1,
                 groups: Optional[Sequence[int]] = None,
                 levels: Sequence[float] = DEFAULT_LEVELS, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, seed: int = 0):
        _validate_gained(latent_channels, K, levels)
        super().__init__(latent_channels, K, groups, "conv5x5", dtype, device, seed)
        self._add_gains(levels)


_FIXED_RATE = {GainedJointAR: JointAutoregressiveHierarchical,
               GainedHyperprior: MeanScaleHyperprior,
               GainedCheckerboard: CheckerboardHierarchical,
               GainedChannelCheckerboard: ChannelCheckerboardHierarchical}


def folded_model(gained: nn.Module) -> nn.Module:
    """A fresh fixed-rate model of the gained model's family, M, K, groups,
    dtype and device, for ``fold_gains``' state_dict."""
    for cls, fixed in _FIXED_RATE.items():
        if isinstance(gained, cls):
            kw = dict(dtype=gained.dtype, device=gained.gain_y.device)
            if fixed is ChannelCheckerboardHierarchical:
                kw["groups"] = gained.groups
            return fixed(gained.latent_channels, gained.K, transform="conv5x5", **kw)
    raise TypeError(f"not a gained model: {type(gained).__name__}")


def fold_gains(state: Mapping[str, torch.Tensor], level) -> Dict[str, torch.Tensor]:
    """A gained model's ``state_dict`` folded at ``level`` (int or
    fractional) into the fixed-rate family's (``folded_model``):

      encoder.Conv2d_3          out-channels x g_y  (weight and bias: its output is y)
      decoder.Deconv2d_0        in-channels  x ig_y (y_in * ig_y feeds it linearly)
      hyper_encoder.Conv2d_2    out-channels x g_z
      hyper_decoder.Deconv2d_0  in-channels  x ig_z

    in float32 on the master weights; every other entry is carried as is.
    Exact up to float32 association: sum(w_i*g*x_i) and g*sum(w_i*x_i)
    differ in the last bits, so a latent on a round() tie may flip by one
    step between the gained and the folded forward (a codec encodes and
    decodes with the folded weights, so its round trip stays exact)."""
    needed = _GAIN_KEYS + tuple(f"{m}.weight" for m, _, _ in _FOLDS)
    for key in needed:
        if key not in state:
            raise ValueError(f"not a gained model's state_dict: missing {key!r}")
    out = {k: v for k, v in state.items() if k not in _GAIN_KEYS}
    for module, gain, scale_bias in _FOLDS:
        g = interp_gain(state[gain], level)
        out[f"{module}.weight"] = state[f"{module}.weight"].float() * g.view(-1, 1, 1, 1)
        if scale_bias:
            out[f"{module}.bias"] = state[f"{module}.bias"].float() * g
    return out


def level_for_bpp(model: nn.Module, x, target_bpp: float, tol: float = 0.01,
                  max_iters: int = 16) -> Tuple[float, float]:
    """Rate control: (level, bpp) with the eval forward's analytic bpp on x
    (B, H, W, 3) nearest ``target_bpp``, by bisection over [0, N - 1] (rate
    rises with the level on a trained ladder). Each probe is one eval
    forward. A target beyond the ladder's ends clamps to that end and
    returns its bpp. tol: the relative bpp error that ends the search early
    (else max_iters probes, a level resolution of (N - 1) / 2**max_iters)."""
    device = model.gain_y.device
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, 3), got shape {tuple(x.shape)}")
    if target_bpp <= 0:
        raise ValueError(f"target_bpp must be positive, got {target_bpp}")
    pixels = x.shape[0] * x.shape[1] * x.shape[2]

    def probe(level: float) -> float:
        out = model(x, training=False, level=level)
        bits = -(torch.sum(out["logp_y"]) + torch.sum(out["logp_z"])) / math.log(2.0)
        return float(bits / pixels)

    lo, hi = 0.0, float(len(model.levels) - 1)
    b_lo, b_hi = probe(lo), probe(hi)
    if target_bpp <= b_lo:
        return lo, b_lo
    if target_bpp >= b_hi:
        return hi, b_hi
    best = (lo, b_lo) if abs(b_lo - target_bpp) < abs(b_hi - target_bpp) else (hi, b_hi)
    for _ in range(max_iters):
        mid = 0.5 * (lo + hi)
        b = probe(mid)
        if abs(b - target_bpp) < abs(best[1] - target_bpp):
            best = (mid, b)
        if abs(b - target_bpp) <= tol * target_bpp:
            break
        if b < target_bpp:
            lo = mid
        else:
            hi = mid
    return best
