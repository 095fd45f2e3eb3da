"""Encode-time latent refinement, port of coding/refine.py (every family:
joint-AR, checkerboard, hyperprior, channel-conditional checkerboard,
factorized and scalable).

The encoder gives one amortized guess of the latents. At encode time the
true objective R(round(y), round(z)) + lambda * D(decoder(round(y)), x) is
differentiable through straight-through rounding, so Adam steps on the
latents themselves, the weights frozen, close part of the amortization gap
(Yang, Bamler & Mandt, NeurIPS 2020). Decode does not change: the entropy
parameters derive only from z_q and the coded y context, so a refined
stream is an ordinary one; pair with the codecs' ``compress_latents``.

The entropy parameters follow the JAX package's modes: "ctx" (the joint-AR,
checkerboard and channel-conditional checkerboard families,
``entropy_params_from_latents``), "hyper" (the hyperprior,
``entropy_params_from_hyper``), "factorized" (the factorized prior: y
alone, under its bottleneck; no z) and "scalable" (the two-layer model:
each layer's rate through its own context and entropy nets over the
shared psi, under ``vision_rd_loss`` without the distillation term, so the
refined stream still truncates). Each step runs the decoder, the
hyper-decoder, the context model (if any), the entropy parameters and the
rate forward and backward on the model's device. With the weights frozen,
autograd asks the GDN backward for dx alone, so its dgamma/dbeta stage does
not run. Kernel launches per refine call, for ``steps`` steps: GDN forward
6 + 3 steps + 3 (the eval forward, three IGDN a step, the final forward;
the scalable model's eval forward adds its LatentSpaceTransform's three),
GDN backward 3 steps, mixture forward 1 + steps + 1 and mixture backward
steps (K > 1, two of each for the scalable model's two layers; none for
the factorized prior).
"""

from typing import Callable, Dict, Tuple

import torch

from neural_image_compression_tpu_torch.models.factorized_prior import FactorizedPrior
from neural_image_compression_tpu_torch.models.joint_ar import (
    _nchw, _nhwc, conditional_likelihood,
)
from neural_image_compression_tpu_torch.models.scalable import ScalableImageCoding
from neural_image_compression_tpu_torch.train.loss import rd_loss, vision_rd_loss

__all__ = ["make_refiner", "refine_latents"]

_METRICS = ("loss", "bpp_total", "bpp_y", "bpp_z", "psnr", "mse")


def _ste_round(v: torch.Tensor) -> torch.Tensor:
    """round(v) in the forward pass, the identity in the backward pass."""
    return v + (torch.round(v) - v).detach()


def _mode(model) -> str:
    """How the model's entropy parameters see the latents: "factorized" (y
    alone, no z), "scalable" (two layers, from y and z), "ctx" (from y and
    z) or "hyper" (from z alone)."""
    if isinstance(model, FactorizedPrior):
        return "factorized"
    if isinstance(model, ScalableImageCoding):
        return "scalable"
    if hasattr(type(model), "entropy_params_from_latents"):
        return "ctx"
    if hasattr(type(model), "entropy_params_from_hyper"):
        return "hyper"
    raise NotImplementedError(
        f"latent refinement does not support {type(model).__name__} (no "
        f"latent-conditional entropy-parameter entry point)")


def _objective(model) -> Callable:
    return vision_rd_loss if _mode(model) == "scalable" else rd_loss


def _rd_out(model, y: torch.Tensor, z) -> Dict[str, torch.Tensor]:
    """The eval output the objective reads, for latents rounded
    straight-through (z None for the factorized prior, whose z rate is
    zero)."""
    y_in = _ste_round(y)
    x_hat = _nhwc(model.decoder(_nchw(y_in))).float()
    mode = _mode(model)
    if mode == "factorized":
        return {"x_hat": x_hat, "logp_y": torch.log(model.factorized_entropy_model(y_in)),
                "logp_z": torch.zeros((y.shape[0], 1, 1, 1), device=y.device)}
    z_in = _ste_round(z)
    logp_z = torch.log(model.factorized_entropy_model(z_in))
    if mode == "scalable":
        psi = model.hyper_decoder(_nchw(z_in))
        out = {"x_hat": x_hat, "logp_z": logp_z}
        for layer, y_layer in enumerate(model.split(y_in), 1):
            out[f"logp_y{layer}"] = conditional_likelihood(
                model.K, y_layer, model.layer_params(layer, y_layer, psi))[2]
        return out
    params_t = (model.entropy_params_from_latents(y_in, z_in) if mode == "ctx"
                else model.entropy_params_from_hyper(z_in))
    _, _, logp_y = conditional_likelihood(model.K, y_in, params_t)
    return {"x_hat": x_hat, "logp_y": logp_y, "logp_z": logp_z}


def _refine(model, x, lambda_rd: float, steps: int, lr: float):
    """The refinement itself: (y, z, metrics), y and z the float latents
    after the last Adam step (z None for the factorized prior)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=next(model.parameters()).device)
    frozen = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in frozen:
        p.requires_grad_(False)
    try:
        objective = _objective(model)
        out0 = model(x, training=False)  # raises unless H and W are multiples of 64 (16)
        m0 = objective(out0, x, lambda_rd)
        names = ("y",) if _mode(model) == "factorized" else ("y", "z")
        latents = [out0[k].detach().float().clone(memory_format=torch.contiguous_format)
                   .requires_grad_(True) for k in names]
        y, z = latents[0], (latents[1] if len(latents) > 1 else None)
        del out0
        opt = torch.optim.Adam(latents, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            objective(_rd_out(model, y, z), x, lambda_rd)["loss"].backward()
            opt.step()
        with torch.no_grad():
            m1 = objective(_rd_out(model, y, z), x, lambda_rd)
    finally:
        for p, flag in frozen:
            p.requires_grad_(flag)
    metrics = {}
    for k in _METRICS:
        metrics["pre_" + k] = m0[k]
        metrics["post_" + k] = m1[k]
    return y.detach(), None if z is None else z.detach(), metrics


def make_refiner(model, lambda_rd: float, steps: int = 100,
                 lr: float = 1e-3) -> Callable[[torch.Tensor], Tuple]:
    """``refine(x) -> (y_q, z_q, metrics)`` for a
    ``models.JointAutoregressiveHierarchical``, ``CheckerboardHierarchical``,
    ``MeanScaleHyperprior``, ``ChannelCheckerboardHierarchical``,
    ``FactorizedPrior`` or ``ScalableImageCoding``.

    x: (B, H, W, 3) float32 in [0, 1] (a tensor or an array), H and W
    multiples of 64 (16 for the factorized prior): pad first, as the codec
    does. y_q (B, h, w, M) and z_q (B, h/4, w/4, M) are float32 grids of
    integers on the model's device, ready for ``compress_latents``; the
    factorized prior's z_q is an empty (B, 0, 0, 0) placeholder. metrics
    holds the objective's (rd_loss's; vision_rd_loss's for the scalable
    model) loss, bpp_total, bpp_y, bpp_z, psnr and mse for the
    encoder's latents ("pre_*") and the refined ones ("post_*"), both true
    eval values (the forward sees rounded latents), computed without
    autograd. Adam (betas 0.9/0.999, eps 1e-8) runs over the latents; the
    model's parameters are frozen for the call and their requires_grad
    flags restored afterwards.
    """
    _mode(model)  # raises for a model without a latent-conditional entry point

    def refine(x):
        y, z, metrics = _refine(model, x, lambda_rd, steps, lr)
        z_q = (torch.zeros((y.shape[0], 0, 0, 0), device=y.device) if z is None
               else torch.round(z))
        return torch.round(y), z_q, metrics

    return refine


def refine_latents(model, x, lambda_rd: float, steps: int = 100, lr: float = 1e-3):
    """One call of ``make_refiner(model, lambda_rd, steps, lr)`` on x."""
    return make_refiner(model, lambda_rd, steps, lr)(x)
