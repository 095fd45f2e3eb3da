"""Channel-conditional + checkerboard context model ("ELIC", He et al.
2022), port of models/channel_cb.py: parallel decoding in 2·G device
passes.

The latent channels split into G uneven groups (``default_groups``: M/8,
M/8, M/4, M/2), coded group by group; within a group, positions split into
checkerboard anchors and non-anchors (``models.checkerboard``). Group i's
entropy parameters come from
  * psi, the hyper-decoder's features (every group);
  * the channel context, a conv stack over all the groups before it (they
    are decoded everywhere, so the convs are dense; group 0 has none and
    its entropy net sees exact zeros there);
  * the spatial context, a 5x5 conv over the group's anchor-masked grid,
    zeroed at the anchors (the checkerboard's single-conv form).

Decode is 2·G parallel passes (``coding.ChannelCheckerboardCodec``). The
training and eval forward is one program (``entropy_params_from_latents``):
the entropy nets are 1x1, so one pass over every position gives each
decode pass's parameters where that pass codes. The forward's contract is
the joint-AR model's (``models.joint_ar.HierarchicalModel``): the K > 1 rate
runs the mixture kernel once, over the groups' parameters concatenated back
to M channels, and the transforms run the GDN kernel.

The per-group modules carry the JAX parameter tree's names (``spatial_ctx_0``,
``channel_ctx_1``, ``entropy_parameters_3``, ...), registered one by one, so
``utils.weights`` carries the weights by name.
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from neural_image_compression_tpu_torch.models.checkerboard import _anchor_mask
from neural_image_compression_tpu_torch.models.joint_ar import (
    HierarchicalModel, _nchw, _nhwc,
)
from neural_image_compression_tpu_torch.models.parameters import EntropyParameters
from neural_image_compression_tpu_torch.ops.blocks import leaky_relu
from neural_image_compression_tpu_torch.ops.conv import Conv2d
from neural_image_compression_tpu_torch.utils.device import DeviceLike

__all__ = ["ChannelCheckerboardHierarchical", "default_groups", "grouped_entropy_params"]


def default_groups(m: int) -> Tuple[int, ...]:
    """ELIC's uneven split scaled to M: (M/8, M/8, M/4, M/2). The remainder
    of an M not divisible by 8 joins the last group; empty groups drop
    (M < 4 gives one group, the plain checkerboard)."""
    if m < 1:
        raise ValueError(f"latent_channels must be >= 1, got {m}")
    g = (m // 8, m // 8, m // 4, m - 2 * (m // 8) - m // 4)
    groups = tuple(v for v in g if v > 0)
    return groups if groups else (m,)


class ChannelContext(nn.Module):
    """Dense conv stack over the decoded groups: conv 5x5 (in -> hidden),
    leaky ReLU, conv 5x5 (hidden -> 2g)."""

    def __init__(self, in_channels: int, out_channels: int, hidden: int,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.Conv2d_0 = Conv2d(in_channels, hidden, 5, 1, 2, **kw)
        self.Conv2d_1 = Conv2d(hidden, out_channels, 5, 1, 2, **kw)

    def forward(self, y_prev: torch.Tensor) -> torch.Tensor:
        return self.Conv2d_1(leaky_relu(self.Conv2d_0(y_prev)))


def _zeros_like_rows(ref: torch.Tensor, channels: int) -> torch.Tensor:
    """(B, channels, h, w) zeros in ref's dtype, device and channels_last
    memory: group 0's channel context, a pass's absent spatial context."""
    b, _, h, w = ref.shape
    return torch.zeros((b, channels, h, w), dtype=ref.dtype,
                       device=ref.device).contiguous(memory_format=torch.channels_last)


def grouped_entropy_params(groups: Sequence[int], spatial_ctx, channel_ctx,
                           entropy_parameters, y_in: torch.Tensor, psi: torch.Tensor):
    """The one-program (training and eval) form of the 2·G decode passes:
    for each group, the channel context over the whole previous groups and
    the spatial context over the group's anchor-masked grid, zeroed at the
    anchors. y_in (B, h, w, M) NHWC; psi (B, 2M, h, w) channels_last; the
    per-group modules as lists (channel_ctx[0] unused). Returns the
    parameters concatenated back to M channels (group order is channel
    order), NHWC, for K = 1 and K > 1 alike."""
    y = _nchw(y_in)
    am = _anchor_mask(y.shape[2], y.shape[3], y.dtype, y.device)
    outs = []
    off = 0
    for i, gi in enumerate(groups):
        ch = (channel_ctx[i](y[:, :off]) if i > 0 else _zeros_like_rows(psi, 2 * gi))
        sp = spatial_ctx[i](y[:, off:off + gi] * am)
        sp = sp * (1.0 - am).to(sp.dtype)
        outs.append(entropy_parameters[i](torch.cat([sp, ch, psi], dim=1)))
        off += gi
    return tuple(torch.cat(parts, dim=-1) for parts in zip(*outs))


class ChannelCheckerboardHierarchical(HierarchicalModel):
    """Hyperprior + unevenly grouped space-channel (checkerboard) context.

    latent_channels: M (hyper channels == M). K: 1 -> mean-scale Gaussian;
    K > 1 -> K-component Gaussian mixture. groups: the channel split (must
    sum to M); None -> ``default_groups(M)``. transform: "conv5x5" ("res3x3"
    is not ported and raises NotImplementedError). dtype, device and seed as
    the joint-AR model's."""

    def __init__(self, latent_channels: int = 192, K: int = 1,
                 groups: Optional[Sequence[int]] = None, transform: str = "conv5x5",
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        kw = self._build_transforms(latent_channels, K, transform, dtype, device, seed)
        m = latent_channels
        g = tuple(int(v) for v in groups) if groups is not None else default_groups(m)
        if any(v < 1 for v in g) or sum(g) != m:
            raise ValueError(f"groups must be positive and sum to latent_channels={m}, got {g}")
        self.groups = None if groups is None else g
        self._groups = g
        off = 0
        for i, gi in enumerate(g):
            setattr(self, f"spatial_ctx_{i}", Conv2d(gi, 2 * gi, 5, 1, 2, **kw))
            if i > 0:  # group 0 has no channel context
                setattr(self, f"channel_ctx_{i}",
                        ChannelContext(off, 2 * gi, max(2 * gi, 64), **kw))
            # the entropy net's input: spatial (2g) + channel (2g, zeros for
            # group 0) + psi (2M)
            setattr(self, f"entropy_parameters_{i}",
                    EntropyParameters(gi, m, K, input_channels=4 * gi + 2 * m, **kw))
            off += gi

    @property
    def group_sizes(self) -> Tuple[int, ...]:
        return self._groups

    def _modules_of(self, name: str) -> list:
        return [getattr(self, f"{name}_{i}", None) for i in range(len(self._groups))]

    # -- the per-group decode passes (composed by the training forward) -----
    def hyper_features(self, z_q: torch.Tensor) -> torch.Tensor:
        """psi (B, h, w, 2M) NHWC (a view of the channels_last output) from
        z_q (B, h/4, w/4, M)."""
        return _nhwc(self.hyper_decoder(_nchw(z_q)))

    def group_channel_ctx(self, i: int, y_prev: Optional[torch.Tensor]):
        """Group i's channel context (B, h, w, 2g) NHWC from the decoded
        groups before it, y_prev (B, h, w, sum(groups[:i])); None for group
        0. Computed once a group: both of its passes use it."""
        if i == 0:
            return None
        return _nhwc(getattr(self, f"channel_ctx_{i}")(_nchw(y_prev)))

    def group_params(self, i: int, psi: torch.Tensor, ch_ctx: Optional[torch.Tensor],
                     y_anchor_i: Optional[torch.Tensor]):
        """Group i's entropy parameters, NHWC. y_anchor_i None: the anchor
        pass (the spatial context is zero; valid at the anchors). Otherwise
        y_anchor_i (B, h, w, g) holds the group's decoded anchors and zeros
        at the non-anchors: the non-anchor pass (valid at the non-anchors).
        psi and ch_ctx NHWC, as ``hyper_features`` / ``group_channel_ctx``
        give them."""
        gi = self._groups[i]
        psi = _nchw(psi)
        if y_anchor_i is None:
            sp = _zeros_like_rows(psi, 2 * gi)
        else:
            sp = getattr(self, f"spatial_ctx_{i}")(_nchw(y_anchor_i))
            am = _anchor_mask(sp.shape[2], sp.shape[3], sp.dtype, sp.device)
            sp = sp * (1.0 - am)
        ch = _zeros_like_rows(psi, 2 * gi) if ch_ctx is None else _nchw(ch_ctx)
        return getattr(self, f"entropy_parameters_{i}")(torch.cat([sp, ch, psi], dim=1))

    def entropy_params_from_latents(self, y_in: torch.Tensor, z_in: torch.Tensor):
        """The one-program form (``grouped_entropy_params``): pointwise equal
        to the anchor pass at the anchors and the non-anchor pass at the
        non-anchors. y_in (B, h, w, M) and z_in (B, h/4, w/4, M), NHWC."""
        return grouped_entropy_params(
            self._groups, self._modules_of("spatial_ctx"), self._modules_of("channel_ctx"),
            self._modules_of("entropy_parameters"), y_in, self.hyper_decoder(_nchw(z_in)))

    _entropy_params = entropy_params_from_latents
