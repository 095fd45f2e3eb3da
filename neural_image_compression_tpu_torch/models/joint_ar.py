"""Joint autoregressive + hierarchical-prior model (Minnen et al. 2018), port
of models/joint_ar.py: the 5x5 conv/GDN transforms, factorized hyper-
bottleneck, masked-conv context and entropy parameters, with a mean-scale
Gaussian (K=1) or K-component Gaussian mixture conditional.

This slice ports the eval forward (round quantization). Its output dict has
the JAX model's keys, NHWC: x_hat, y, y_in, z, z_in, p_z, logp_z, p_y,
logp_y, training, plus mu/sigma (K=1) or weights/mus/sigmas (K>1, each
(B, h, w, K, M)). The K>1 rate comes from the mixture-likelihood kernel:
logp_y is its output and p_y = exp(logp_y).
"""

from typing import Dict, Optional

import torch
from torch import nn

from neural_image_compression_tpu_torch.entropy.factorized import FactorizedEntropyBottleneck
from neural_image_compression_tpu_torch.entropy.gaussian import gaussian_likelihood
from neural_image_compression_tpu_torch.models.components import (
    Decoder5x5, Encoder5x5, HyperDecoder5x5, HyperEncoder5x5,
)
from neural_image_compression_tpu_torch.models.parameters import EntropyParameters
from neural_image_compression_tpu_torch.ops.kernels.gmm_kernel import gmm_logp
from neural_image_compression_tpu_torch.ops.masked_conv import ContextModel
from neural_image_compression_tpu_torch.utils.device import DeviceLike, resolve_device


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) channels_last -> (B, H, W, C): a view, no copy."""
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) in channels_last memory: a view."""
    return x.permute(0, 3, 1, 2)


class JointAutoregressiveHierarchical(nn.Module):
    """latent_channels: M (hyper channels H == M). K: 1 -> mean-scale
    Gaussian; K > 1 -> Gaussian mixture. dtype: transform compute dtype
    (e.g. torch.bfloat16); entropy math stays float32. seed: the weights'
    init, drawn on the CPU so one seed gives one model on every device."""

    def __init__(self, latent_channels: int = 192, K: int = 1,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        if latent_channels < 1:
            raise ValueError(f"latent_channels must be >= 1, got {latent_channels}")
        if K < 1:
            raise ValueError(f"K must be >= 1, got {K}")
        device = resolve_device(device)
        self.latent_channels, self.K, self.dtype = latent_channels, K, dtype
        m = latent_channels
        kw = dict(dtype=dtype, device=device,
                  generator=torch.Generator().manual_seed(seed))
        self.encoder = Encoder5x5(m, **kw)
        self.decoder = Decoder5x5(m, **kw)
        self.hyper_encoder = HyperEncoder5x5(m, **kw)
        self.hyper_decoder = HyperDecoder5x5(m, **kw)
        self.factorized_entropy_model = FactorizedEntropyBottleneck(
            m, device=device, generator=kw["generator"])
        self.context_model = ContextModel(m, **kw)
        self.entropy_parameters = EntropyParameters(m, m, K, **kw)

    def entropy_params_from_latents(self, y_in: torch.Tensor, z_in: torch.Tensor):
        """psi = hyperdec(z_in), phi = context(y_in) -> conditional params.
        y_in (B, h, w, M) and z_in (B, h/4, w/4, M), NHWC."""
        psi = self.hyper_decoder(_nchw(z_in))
        phi = self.context_model(_nchw(y_in))
        combined = torch.cat([phi, psi], dim=1)
        return self.entropy_parameters(combined)

    def forward(self, x: torch.Tensor, training: bool = True) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) in [0, 1], H and W multiples of 64."""
        if training:
            raise NotImplementedError("training forward: later slice")
        if x.shape[1] % 64 or x.shape[2] % 64:
            raise ValueError(
                f"H and W must be multiples of 64 (x16 transform + x4 hyper "
                f"downsampling), got {x.shape[1]}x{x.shape[2]}; pad first "
                f"and crop the output")
        # eval forward only: the kernels' backward comes with the training slice
        with torch.no_grad():
            return self._eval_forward(x)

    def _eval_forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = _nhwc(self.encoder(_nchw(x)))
        z = _nhwc(self.hyper_encoder(_nchw(y)))
        # torch.round rounds half to even, as jnp.round does
        z_in = torch.round(z.float())
        y_in = torch.round(y.float())

        params_t = self.entropy_params_from_latents(y_in, z_in)
        if self.K == 1:
            mu, sigma = params_t
            params = {"mu": mu, "sigma": sigma}
            p_y = gaussian_likelihood(y_in, mu, sigma)
            logp_y = torch.log(p_y)
        else:
            weights, mus, sigmas = (t.contiguous() for t in params_t)
            params = {"weights": weights, "mus": mus, "sigmas": sigmas}
            b, h, w, k, m = weights.shape
            logp_y = gmm_logp(y_in.reshape(-1, m), weights.view(-1, k, m),
                              mus.view(-1, k, m), sigmas.view(-1, k, m)).view(b, h, w, m)
            p_y = torch.exp(logp_y)

        p_z = self.factorized_entropy_model(z_in)
        logp_z = torch.log(p_z)

        x_hat = _nhwc(self.decoder(_nchw(y_in))).float()

        out = {
            "x_hat": x_hat,
            "y": y,
            "y_in": y_in,
            "z": z,
            "z_in": z_in,
            "p_z": p_z,
            "logp_z": logp_z,
            "p_y": p_y,
            "logp_y": logp_y,
            "training": False,
        }
        out.update(params)
        return out
