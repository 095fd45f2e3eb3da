"""Scalable two-layer latent coding, port of models/scalable.py.

The latents y (M channels) split into base latents y1 (the first M1
channels) and enhancement latents y2 (the other M - M1). Each layer has its
own masked-conv context model and entropy-parameter net; both share the
hyper-decoder's psi. A ``LatentSpaceTransform`` maps y1 toward a frozen
vision backbone's feature space (``F_tilde``) for the vision distillation
loss (``train.vision_rd_loss``), so the base layer alone serves a vision
task.

Quantization as in ``models.joint_ar``: training adds U(-0.5, 0.5) noise to
z, then y (float32, from the caller's torch.Generator); eval rounds. The
output dict has the JAX model's keys, NHWC: x_hat, y, y_in, y1, y2, z, z_in,
p_z, logp_z, p_y1, logp_y1, p_y2, logp_y2, F_tilde, training, plus
mu1/sigma1/mu2/sigma2 (K=1) or weights1/mus1/sigmas1/weights2/mus2/sigmas2
(K>1: each layer's rate through the mixture kernel). y1 and y2 are
contiguous copies of y_in's channel slices, as the kernels' rows need.
"""

from typing import Dict, Optional, Sequence

import torch

from neural_image_compression_tpu_torch.models.components import LatentSpaceTransform
from neural_image_compression_tpu_torch.models.joint_ar import (
    HierarchicalModel, _nchw, _nhwc, conditional_likelihood, quantize,
)
from neural_image_compression_tpu_torch.models.parameters import EntropyParameters
from neural_image_compression_tpu_torch.ops.masked_conv import ContextModel
from neural_image_compression_tpu_torch.utils.device import DeviceLike


class ScalableImageCoding(HierarchicalModel):
    """latent_channels: M; base_channels: M1, 0 < M1 < M. K: 1 ->
    mean-scale Gaussian, K > 1 -> Gaussian mixture, for both layers.
    lst_upsampling: the LatentSpaceTransform's schedule ((2, 1, 1, 1): 2*M1
    channels on the H/8 grid). The 5x5 conv/GDN transforms; dtype and seed
    as ``HierarchicalModel``'s."""

    def __init__(self, latent_channels: int = 192, base_channels: int = 128, K: int = 1,
                 lst_upsampling: Sequence[int] = (2, 1, 1, 1),
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        if not 0 < base_channels < latent_channels:
            raise ValueError(f"base_channels must satisfy 0 < M1 < M, got M1={base_channels}, "
                             f"M={latent_channels}")
        kw = self._build_transforms(latent_channels, K, "conv5x5", dtype, device, seed)
        m, m1 = latent_channels, base_channels
        self.base_channels = m1
        self.lst_upsampling = tuple(lst_upsampling)
        self.context_model_1 = ContextModel(m1, **kw)
        self.context_model_2 = ContextModel(m - m1, **kw)
        self.entropy_parameters_1 = EntropyParameters(m1, m, K, **kw)
        self.entropy_parameters_2 = EntropyParameters(m - m1, m, K, **kw)
        self.LST = LatentSpaceTransform(m1, self.lst_upsampling, **kw)

    @property
    def M1(self) -> int:
        return self.base_channels

    @property
    def M2(self) -> int:
        return self.latent_channels - self.base_channels

    def layer_params(self, layer: int, y_layer: torch.Tensor, psi: torch.Tensor):
        """One layer's entropy parameters from its latents (B, h, w, M1 or
        M2), NHWC, and psi (B, 2M, h, w) channels_last."""
        ctx = self.context_model_1 if layer == 1 else self.context_model_2
        ep = self.entropy_parameters_1 if layer == 1 else self.entropy_parameters_2
        return ep(torch.cat([ctx(_nchw(y_layer)), psi], dim=1))

    def split(self, y_in: torch.Tensor):
        """(y1, y2): y_in's base and enhancement channels, contiguous."""
        return y_in[..., :self.M1].contiguous(), y_in[..., self.M1:].contiguous()

    def _forward(self, x: torch.Tensor, training: bool, generator: Optional[torch.Generator],
                 gains=None) -> Dict[str, torch.Tensor]:
        y = _nhwc(self.encoder(_nchw(x)))
        z = _nhwc(self.hyper_encoder(_nchw(y)))
        # z first, then y: the order of the JAX model's noise keys (rng_z, rng_y)
        z_in = quantize(z.float(), training, generator)
        y_in = quantize(y.float(), training, generator)
        y1, y2 = self.split(y_in)

        psi = self.hyper_decoder(_nchw(z_in))
        out = {}
        for layer, y_layer in (("1", y1), ("2", y2)):
            params, p_y, logp_y = conditional_likelihood(
                self.K, y_layer, self.layer_params(int(layer), y_layer, psi))
            out.update({k + layer: v for k, v in params.items()})
            out["p_y" + layer], out["logp_y" + layer] = p_y, logp_y
        p_z = self.factorized_entropy_model(z_in)

        out.update(
            x_hat=_nhwc(self.decoder(_nchw(y_in))).float(),
            y=y, y_in=y_in, y1=y1, y2=y2, z=z, z_in=z_in, p_z=p_z, logp_z=torch.log(p_z),
            F_tilde=_nhwc(self.LST(_nchw(y1))).float(), training=training)
        return out
