"""Joint autoregressive + hierarchical-prior model (Minnen et al. 2018), port
of models/joint_ar.py: the 5x5 conv/GDN transforms, factorized hyper-
bottleneck, masked-conv context and entropy parameters, with a mean-scale
Gaussian (K=1) or K-component Gaussian mixture conditional. The part every
hierarchical family shares (transforms, quantization, the conditional
likelihood, the forward's contract) is ``HierarchicalModel`` here; the
hyperprior and checkerboard families (``models/hyperprior.py``,
``models/checkerboard.py``) differ only in their entropy parameters.

Quantization as in the JAX model: training adds U(-0.5, 0.5) noise to both
z and y (float32, drawn on the model's device from the caller's
torch.Generator, z first, then y); eval rounds. The output dict has the JAX
model's keys, NHWC: x_hat, y, y_in, z, z_in, p_z, logp_z, p_y, logp_y,
training, plus mu/sigma (K=1) or weights/mus/sigmas (K>1, each
(B, h, w, K, M)). The K>1 rate comes from the mixture-likelihood kernel
(differentiable: its backward is a kernel too): logp_y is its output and
p_y = exp(logp_y). The K=1 rate is the plain Gaussian likelihood, as in the
JAX package, which has no kernel there.
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


def noise_quantize(x: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Additive uniform-noise relaxation: x + U(-0.5, 0.5), the noise float32
    on x's device (torch's default generator there when none is given)."""
    noise = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return x + noise.uniform_(-0.5, 0.5, generator=generator)


def quantize(x: torch.Tensor, training: bool,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if training:
        return noise_quantize(x, generator)
    # torch.round rounds half to even, as jnp.round does
    return torch.round(x)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) channels_last -> (B, H, W, C): a view, no copy."""
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) in channels_last memory: a view."""
    return x.permute(0, 3, 1, 2)


def conditional_likelihood(K: int, y_in: torch.Tensor, params_t):
    """(params, p_y, logp_y) of y_in (B, h, w, M) under the entropy
    parameters params_t: {mu, sigma} and the Gaussian likelihood (K=1), or
    {weights, mus, sigmas} and the mixture kernel's log-likelihood (K>1,
    p_y = exp(logp_y))."""
    if K == 1:
        mu, sigma = params_t
        p_y = gaussian_likelihood(y_in, mu, sigma)
        return {"mu": mu, "sigma": sigma}, p_y, torch.log(p_y)
    weights, mus, sigmas = (t.contiguous() for t in params_t)
    b, h, w, k, m = weights.shape
    logp_y = gmm_logp(y_in.reshape(-1, m), weights.view(-1, k, m),
                      mus.view(-1, k, m), sigmas.view(-1, k, m)).view(b, h, w, m)
    return {"weights": weights, "mus": mus, "sigmas": sigmas}, torch.exp(logp_y), logp_y


class HierarchicalModel(nn.Module):
    """What the hierarchical families share: the 5x5 conv/GDN transforms,
    the factorized hyper-bottleneck, quantization and the forward. A family
    adds its entropy-parameter modules and ``_entropy_params(y_in, z_in)``.

    latent_channels: M (hyper channels H == M). K: 1 -> mean-scale
    Gaussian; K > 1 -> Gaussian mixture. transform: "conv5x5" (the 3x3
    residual transforms are not ported). dtype: transform compute dtype
    (e.g. torch.bfloat16); entropy math stays float32. seed: the weights'
    init, drawn on the CPU so one seed gives one model on every device."""

    def _build_transforms(self, latent_channels: int, K: int, transform: str,
                          dtype: Optional[torch.dtype], device: DeviceLike, seed: int) -> dict:
        """Check the arguments and build the shared modules; returns the
        keyword arguments (dtype, device, the init generator) for the
        family's own modules, to be built after these."""
        if latent_channels < 1:
            raise ValueError(f"latent_channels must be >= 1, got {latent_channels}")
        if K < 1:
            raise ValueError(f"K must be >= 1, got {K}")
        if transform != "conv5x5":
            raise NotImplementedError(
                f"transform {transform!r} is not ported: this package has the 5x5 conv/GDN "
                f"transforms ('conv5x5') only")
        device = resolve_device(device)
        self.latent_channels, self.K, self.dtype = latent_channels, K, dtype
        self.transform = transform
        m = latent_channels
        kw = dict(dtype=dtype, device=device, generator=torch.Generator().manual_seed(seed))
        self.encoder = Encoder5x5(m, **kw)
        self.decoder = Decoder5x5(m, **kw)
        self.hyper_encoder = HyperEncoder5x5(m, **kw)
        self.hyper_decoder = HyperDecoder5x5(m, **kw)
        self.factorized_entropy_model = FactorizedEntropyBottleneck(
            m, device=device, generator=kw["generator"])
        return kw

    @property
    def distribution(self) -> str:
        return "Mean-Scale Gaussian" if self.K == 1 else "Mixture of Gaussians"

    def _entropy_params(self, y_in: torch.Tensor, z_in: torch.Tensor):
        raise NotImplementedError

    def forward(self, x: torch.Tensor, training: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) in [0, 1], H and W multiples of 64. training:
        noise quantization, recorded by autograd; else rounding under
        no_grad. generator: the noise's torch.Generator (on x's device)."""
        if x.shape[1] % 64 or x.shape[2] % 64:
            raise ValueError(
                f"H and W must be multiples of 64 (x16 transform + x4 hyper "
                f"downsampling), got {x.shape[1]}x{x.shape[2]}; pad first "
                f"and crop the output")
        if training:
            return self._forward(x, True, generator)
        with torch.no_grad():
            return self._forward(x, False, None)

    def _forward(self, x: torch.Tensor, training: bool,
                 generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        y = _nhwc(self.encoder(_nchw(x)))
        z = _nhwc(self.hyper_encoder(_nchw(y)))
        # z first, then y: the order of the JAX model's noise keys (rng_z, rng_y)
        z_in = quantize(z.float(), training, generator)
        y_in = quantize(y.float(), training, generator)

        params, p_y, logp_y = conditional_likelihood(self.K, y_in,
                                                     self._entropy_params(y_in, z_in))
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
            "training": training,
        }
        out.update(params)
        return out


class JointAutoregressiveHierarchical(HierarchicalModel):
    """The hierarchical prior with the masked 5x5 context (serial decode:
    the codec's host wavefront). Arguments as ``HierarchicalModel``'s."""

    def __init__(self, latent_channels: int = 192, K: int = 1,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        kw = self._build_transforms(latent_channels, K, "conv5x5", dtype, device, seed)
        m = latent_channels
        self.context_model = ContextModel(m, **kw)
        self.entropy_parameters = EntropyParameters(m, m, K, **kw)

    def entropy_params_from_latents(self, y_in: torch.Tensor, z_in: torch.Tensor):
        """psi = hyperdec(z_in), phi = context(y_in) -> conditional params.
        y_in (B, h, w, M) and z_in (B, h/4, w/4, M), NHWC."""
        psi = self.hyper_decoder(_nchw(z_in))
        phi = self.context_model(_nchw(y_in))
        combined = torch.cat([phi, psi], dim=1)
        return self.entropy_parameters(combined)

    _entropy_params = entropy_params_from_latents
