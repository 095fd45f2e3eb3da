"""Mean-scale hyperprior model (Balle et al. 2018 in the mean-scale form of
Minnen et al. 2018's context-free ablation), port of models/hyperprior.py.

The hyper-decoder's psi feeds the entropy-parameter net directly, with no
context model: every entropy parameter depends on z alone, so the codec
decodes y in one parallel device pass (``coding.MeanScaleHyperpriorCodec``).
The entropy-parameter net contracts over psi's 2M channels instead of the
4M context + hyper concat.

The forward's contract, quantization, transforms and K=1 / K>1 behaviour are
the joint-AR model's (``models.joint_ar.HierarchicalModel``): the K>1 rate
comes from the mixture kernel, the transforms run the GDN kernel.
"""

from typing import Optional

import torch

from neural_image_compression_tpu_torch.models.joint_ar import HierarchicalModel, _nchw
from neural_image_compression_tpu_torch.models.parameters import EntropyParameters
from neural_image_compression_tpu_torch.utils.device import DeviceLike

__all__ = ["MeanScaleHyperprior"]


class MeanScaleHyperprior(HierarchicalModel):
    """latent_channels: M (hyper channels == M). K: 1 -> mean-scale Gaussian;
    K > 1 -> K-component Gaussian mixture. transform: "conv5x5" ("res3x3"
    is not ported and raises NotImplementedError). dtype, device and seed
    as the joint-AR model's."""

    def __init__(self, latent_channels: int = 192, K: int = 1, transform: str = "conv5x5",
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        kw = self._build_transforms(latent_channels, K, transform, dtype, device, seed)
        m = latent_channels
        self.entropy_parameters = EntropyParameters(m, m, K, input_channels=2 * m, **kw)

    def entropy_params_from_hyper(self, z_in: torch.Tensor):
        """Every y entropy parameter from the hyperprior alone. z_in
        (B, h/4, w/4, M) NHWC. The codec runs this on both sides."""
        return self.entropy_parameters(self.hyper_decoder(_nchw(z_in)))

    def _entropy_params(self, y_in: torch.Tensor, z_in: torch.Tensor):
        return self.entropy_params_from_hyper(z_in)
