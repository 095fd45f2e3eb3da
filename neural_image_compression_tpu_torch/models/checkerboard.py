"""Checkerboard-context hierarchical model (He et al., CVPR 2021), port of
models/checkerboard.py: two-pass parallel decoding.

The latent grid splits into anchors ((i + j) even), coded from the
hyperprior alone, and non-anchors, coded from a plain 5x5 conv over the
decoded anchors. Decode is two parallel device passes
(``coding.CheckerboardCodec``) instead of the joint-AR model's host
wavefront.

The context conv is dense: its input carries anchors only (non-anchors
zero), and its output is zeroed at the anchors, so at a non-anchor every
live tap is an anchor. The entropy-parameter net is 1x1, so the one-pass
training forward (``entropy_params_from_latents``) gives both decode
passes' parameters at every position. The forward's contract is the
joint-AR model's (``models.joint_ar.HierarchicalModel``).
"""

from typing import Optional

import numpy as np
import torch
from torch import nn

from neural_image_compression_tpu_torch.models.joint_ar import (
    HierarchicalModel, _nchw, _nhwc,
)
from neural_image_compression_tpu_torch.models.parameters import EntropyParameters
from neural_image_compression_tpu_torch.ops.conv import Conv2d
from neural_image_compression_tpu_torch.utils.device import DeviceLike

__all__ = ["CheckerboardHierarchical", "CheckerboardContext", "checkerboard_mask",
           "CB_CTX_POSITIONS"]

# The 12 live taps of the 5x5 context conv at a non-anchor center, in kernel
# coordinates (center (2, 2)): the taps with (r + c) odd, which land on
# anchors. Row-major: the gather order of the portable coder
# (coding/portable.py _cb_gather and the card build; csrc/rans/ar_portable.cc
# kCbTaps).
CB_CTX_POSITIONS = tuple((r, c) for r in range(5) for c in range(5) if (r + c) % 2 == 1)
assert len(CB_CTX_POSITIONS) == 12


def checkerboard_mask(h: int, w: int) -> np.ndarray:
    """(h, w) bool, True at anchors ((i + j) even): the anchor convention of
    the forward, both codec passes and the stream's symbol order."""
    return ((np.arange(h)[:, None] + np.arange(w)[None, :]) % 2) == 0


def _anchor_mask(h: int, w: int, dtype: torch.dtype, device) -> torch.Tensor:
    """(1, 1, h, w) 1.0 at anchors, built on the device: ``checkerboard_mask``."""
    ii = torch.arange(h, device=device)[:, None]
    jj = torch.arange(w, device=device)[None, :]
    return (((ii + jj) % 2) == 0).to(dtype)[None, None]


class CheckerboardContext(nn.Module):
    """Plain 5x5 conv, M -> 2M, over the anchor-masked latents."""

    def __init__(self, latent_channels: int, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        m = latent_channels
        self.Conv2d_0 = Conv2d(m, 2 * m, 5, 1, 2, dtype=dtype, device=device,
                               generator=generator)

    def forward(self, y_anchor: torch.Tensor) -> torch.Tensor:
        return self.Conv2d_0(y_anchor)


class CheckerboardHierarchical(HierarchicalModel):
    """Hyperprior + checkerboard context. Arguments as
    ``MeanScaleHyperprior``'s."""

    def __init__(self, latent_channels: int = 192, K: int = 1, transform: str = "conv5x5",
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        kw = self._build_transforms(latent_channels, K, transform, dtype, device, seed)
        m = latent_channels
        self.context_model = CheckerboardContext(m, **kw)
        self.entropy_parameters = EntropyParameters(m, m, K, **kw)

    # -- the two decode passes (also composed by the training forward) -----
    def anchor_pass(self, z_q: torch.Tensor):
        """Pass 1: (psi, *entropy params) from the hyperprior alone, valid at
        the anchors (their context is zero). z_q (B, h/4, w/4, M) NHWC; psi
        (B, h, w, 2M) NHWC (a view of the channels_last output), for pass 2."""
        psi = self.hyper_decoder(_nchw(z_q))
        ctx0 = torch.zeros_like(psi)
        return (_nhwc(psi),) + tuple(self.entropy_parameters(torch.cat([ctx0, psi], dim=1)))

    def nonanchor_pass(self, psi: torch.Tensor, y_anchor: torch.Tensor):
        """Pass 2: entropy params from psi and the context conv over the
        decoded anchors, valid at the non-anchors. y_anchor (B, h, w, M):
        the anchors' values, zeros at the non-anchors."""
        ctx = self.context_model(_nchw(y_anchor))
        am = _anchor_mask(ctx.shape[2], ctx.shape[3], ctx.dtype, ctx.device)
        return tuple(self.entropy_parameters(torch.cat([ctx * (1.0 - am), _nchw(psi)], dim=1)))

    def entropy_params_from_latents(self, y_in: torch.Tensor, z_in: torch.Tensor):
        """The one-pass form: context from the anchors alone, zeroed at the
        anchors; pointwise equal to anchor_pass at the anchors and to
        nonanchor_pass at the non-anchors."""
        psi = self.hyper_decoder(_nchw(z_in))
        y = _nchw(y_in)
        am = _anchor_mask(y.shape[2], y.shape[3], y.dtype, y.device)
        ctx = self.context_model(y * am)
        ctx = ctx * (1.0 - am.to(ctx.dtype))
        return self.entropy_parameters(torch.cat([ctx, psi], dim=1))

    _entropy_params = entropy_params_from_latents
