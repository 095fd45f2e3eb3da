"""Factorized-prior model (Balle et al. 2017/2018, no hyperprior), port of
models/factorized_prior.py: encoder -> the factorized bottleneck on y ->
decoder, the ladder's lower bound.

It is not a hierarchical model: there is no hyper path, so H and W need only
be multiples of 16. The transforms are the 5x5 conv/GDN set or the 3x3
residual blocks (``transform``). The output dict has the hierarchical
families' keys, so ``rd_loss``, the Trainer, the evaluator and
``make_serving_fn`` run unchanged: z, z_in, p_z and logp_z are the JAX
model's zero-rate placeholders of shape (B, 1, 1, 1) (z and z_in zeros,
p_z ones, logp_z zeros). The transforms run the GDN kernel (3 GDN, 3
IGDN); there is no mixture, so the mixture kernel never runs. Training
adds U(-0.5, 0.5) noise to y alone.
"""

from typing import Dict, Optional

import torch
from torch import nn

from neural_image_compression_tpu_torch.entropy.factorized import FactorizedEntropyBottleneck
from neural_image_compression_tpu_torch.models.joint_ar import _TRANSFORMS, _nchw, _nhwc, quantize
from neural_image_compression_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = ["FactorizedPrior"]


class FactorizedPrior(nn.Module):
    """latent_channels: M. transform: "conv5x5" or "res3x3" (another name
    raises KeyError, as the JAX package's lookup does). dtype: the
    transforms' compute dtype; the entropy math stays float32. device and
    seed as the joint-AR model's."""

    def __init__(self, latent_channels: int = 192, transform: str = "conv5x5",
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        if latent_channels < 1:
            raise ValueError(f"latent_channels must be >= 1, got {latent_channels}")
        enc, dec = _TRANSFORMS[transform][:2]  # the analysis and synthesis alone
        device = resolve_device(device)
        self.latent_channels, self.dtype, self.transform = latent_channels, dtype, transform
        m = latent_channels
        kw = dict(dtype=dtype, device=device, generator=torch.Generator().manual_seed(seed))
        self.encoder = enc(m, **kw)
        self.decoder = dec(m, **kw)
        self.factorized_entropy_model = FactorizedEntropyBottleneck(
            m, device=device, generator=kw["generator"])

    def forward(self, x: torch.Tensor, training: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) in [0, 1], H and W multiples of 16. training:
        noise quantization of y, recorded by autograd; else rounding under
        no_grad. generator: the noise's torch.Generator (on x's device)."""
        if x.shape[1] % 16 or x.shape[2] % 16:
            raise ValueError(
                f"H and W must be multiples of 16 (x16 transform), got "
                f"{x.shape[1]}x{x.shape[2]}; pad first and crop the output")
        if training:
            return self._forward(x, True, generator)
        with torch.no_grad():
            return self._forward(x, False, None)

    def _forward(self, x: torch.Tensor, training: bool,
                 generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        y = _nhwc(self.encoder(_nchw(x)))
        y_in = quantize(y.float(), training, generator)
        p_y = self.factorized_entropy_model(y_in)
        x_hat = _nhwc(self.decoder(_nchw(y_in))).float()
        # zero-rate z placeholders keep rd_loss's bpp_y / bpp_z split valid
        ones = torch.ones((x.shape[0], 1, 1, 1), dtype=torch.float32, device=x.device)
        return {
            "x_hat": x_hat,
            "y": y,
            "y_in": y_in,
            "z": torch.zeros_like(ones),
            "z_in": torch.zeros_like(ones),
            "p_y": p_y,
            "logp_y": torch.log(p_y),
            "p_z": ones,  # likelihood 1: logp 0, no rate
            "logp_z": torch.log(ones),
            "training": training,
        }
