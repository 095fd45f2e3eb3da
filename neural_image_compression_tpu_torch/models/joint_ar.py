"""Joint autoregressive + hierarchical-prior model (Minnen et al. 2018), port
of models/joint_ar.py: the analysis/synthesis transforms (5x5 conv/GDN, or
the 3x3 residual blocks of ``HierarchicalMixtureResidual``), factorized
hyper-bottleneck, masked-conv context and entropy parameters, with a
mean-scale Gaussian (K=1) or K-component Gaussian mixture conditional. The
part every hierarchical family shares (transforms, quantization, the
conditional likelihood, the forward's contract) is ``HierarchicalModel``
here; the hyperprior and checkerboard families (``models/hyperprior.py``,
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
    Decoder3x3, Decoder5x5, Encoder3x3, Encoder5x5, HyperDecoder3x3, HyperDecoder5x5,
    HyperEncoder3x3, HyperEncoder5x5,
)
from neural_image_compression_tpu_torch.models.parameters import EntropyParameters
from neural_image_compression_tpu_torch.ops.kernels.gmm_kernel import gmm_logp
from neural_image_compression_tpu_torch.ops.masked_conv import ContextModel
from neural_image_compression_tpu_torch.utils.device import DeviceLike, resolve_device

# transform name -> (encoder, decoder, hyper-encoder, hyper-decoder)
_TRANSFORMS = {
    "conv5x5": (Encoder5x5, Decoder5x5, HyperEncoder5x5, HyperDecoder5x5),
    "res3x3": (Encoder3x3, Decoder3x3, HyperEncoder3x3, HyperDecoder3x3),
}


def noise_quantize(x: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Additive uniform-noise relaxation: x + U(-0.5, 0.5), the noise float32
    on x's device (torch's default generator there when none is given).
    generator may also be a noise source, an object whose ``draw(x)``
    returns the noise for x: ``RowShardNoise`` (data parallelism) or
    ``GivenNoise`` (the vmapped lambda sweep)."""
    if generator is not None and not isinstance(generator, torch.Generator):
        return x + generator.draw(x)
    noise = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return x + noise.uniform_(-0.5, 0.5, generator=generator)


class RowShardNoise:
    """Noise for one data-parallel rank's rows: each draw takes the noise
    that ``generator`` draws for the global batch (``count`` ranks of x's
    rows each) and keeps rows [index * b, (index + 1) * b). With one
    generator state on every rank, each rank's rows get the noise that a
    one-rank run on the global batch gives them."""

    def __init__(self, generator: torch.Generator, index: int, count: int):
        self.generator, self.index, self.count = generator, index, count

    def draw(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        noise = torch.empty((b * self.count, *x.shape[1:]), dtype=torch.float32, device=x.device)
        noise.uniform_(-0.5, 0.5, generator=self.generator)
        return noise[self.index * b:(self.index + 1) * b]


class GivenNoise:
    """Noise drawn beforehand: each draw hands out the next of ``noises``,
    which must have x's shape."""

    def __init__(self, noises):
        self._noises = iter(noises)

    def draw(self, x: torch.Tensor) -> torch.Tensor:
        noise = next(self._noises, None)
        if noise is None or noise.shape != x.shape:
            raise ValueError(f"no given noise of shape {tuple(x.shape)}: got "
                             f"{None if noise is None else tuple(noise.shape)}")
        return noise


def round_quantize(x: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.round(x)


def quantize(x: torch.Tensor, training: bool,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if training:
        return noise_quantize(x, generator)
    return round_quantize(x)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) channels_last -> (B, H, W, C): a view, no copy."""
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) in channels_last memory: a view."""
    return x.permute(0, 3, 1, 2)


def _scaled(t: torch.Tensor, g: Optional[torch.Tensor]) -> torch.Tensor:
    """t (..., C) times the channel scale g (C,) in t's dtype; t itself when
    g is None."""
    return t if g is None else t * g.to(t.dtype)


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
    """What the hierarchical families share: the transforms, the factorized
    hyper-bottleneck, quantization and the forward. A family adds its
    entropy-parameter modules and ``_entropy_params(y_in, z_in)``.

    latent_channels: M (hyper channels H == M). K: 1 -> mean-scale
    Gaussian; K > 1 -> Gaussian mixture. transform: "conv5x5" (5x5
    conv/GDN) or "res3x3" (3x3 residual blocks); another name raises
    KeyError, as the JAX package's lookup does. dtype: transform compute dtype
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
        enc, dec, henc, hdec = _TRANSFORMS[transform]
        device = resolve_device(device)
        self.latent_channels, self.K, self.dtype = latent_channels, K, dtype
        self.transform = transform
        m = latent_channels
        kw = dict(dtype=dtype, device=device, generator=torch.Generator().manual_seed(seed))
        self.encoder = enc(m, **kw)
        self.decoder = dec(m, **kw)
        self.hyper_encoder = henc(m, **kw)
        self.hyper_decoder = hdec(m, **kw)
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
        return self._run(x, training, generator, None)

    def _gains(self, level):
        """The channel scales at ``level`` (``_forward``'s gains): none for
        a fixed-rate model."""
        return None

    def _run(self, x: torch.Tensor, training: bool, generator: Optional[torch.Generator],
             level) -> Dict[str, torch.Tensor]:
        if x.shape[1] % 64 or x.shape[2] % 64:
            raise ValueError(
                f"H and W must be multiples of 64 (x16 transform + x4 hyper "
                f"downsampling), got {x.shape[1]}x{x.shape[2]}; pad first "
                f"and crop the output")
        if training:
            return self._forward(x, True, generator, self._gains(level))
        with torch.no_grad():
            return self._forward(x, False, None, self._gains(level))

    def _forward(self, x: torch.Tensor, training: bool, generator: Optional[torch.Generator],
                 gains=None) -> Dict[str, torch.Tensor]:
        """gains: None, or the variable-rate families' (g_y, ig_y, g_z, ig_z)
        at one level (``models.gained``), each (M,) float32: y and z are
        scaled into the coded domain by g_y and g_z (in the transforms'
        dtype), and only the decoders see y_in * ig_y and z_in * ig_z; the
        context and entropy nets and both likelihoods work in the coded
        domain."""
        g_y, ig_y, g_z, ig_z = gains if gains is not None else (None,) * 4
        y = _scaled(_nhwc(self.encoder(_nchw(x))), g_y)
        z = _scaled(_nhwc(self.hyper_encoder(_nchw(y))), g_z)
        # z first, then y: the order of the JAX model's noise keys (rng_z, rng_y)
        z_in = quantize(z.float(), training, generator)
        y_in = quantize(y.float(), training, generator)

        # every family's hyper-decoder is the only consumer of its z argument
        params, p_y, logp_y = conditional_likelihood(
            self.K, y_in, self._entropy_params(y_in, _scaled(z_in, ig_z)))
        p_z = self.factorized_entropy_model(z_in)
        logp_z = torch.log(p_z)

        x_hat = _nhwc(self.decoder(_nchw(_scaled(y_in, ig_y)))).float()

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

    def __init__(self, latent_channels: int = 192, K: int = 1, transform: str = "conv5x5",
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        kw = self._build_transforms(latent_channels, K, transform, dtype, device, seed)
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


def HierarchicalMixtureResidual(latent_channels: int = 192, K: int = 1,
                                dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                                seed: int = 0) -> JointAutoregressiveHierarchical:
    """The reference's residual variant: the joint-AR model with the 3x3
    residual-block transforms (``transform="res3x3"``), same forward."""
    return JointAutoregressiveHierarchical(latent_channels, K, "res3x3", dtype, device, seed)
