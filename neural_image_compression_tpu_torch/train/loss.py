"""Rate-distortion objectives, port of train/loss.py (``rd_loss`` and
``msssim_rd_loss``; ``vision_rd_loss`` waits for the scalable family).

Every value stays a tensor on the model's device: no ``.item()``, so a
caller reads what it needs without a sync per value.

    bpp = -sum(logp) / ln2 / (H*W) per image, mean over the batch;
    rd_loss:        loss = bpp_total + lambda * 255^2 * MSE;
    msssim_rd_loss: loss = bpp_total + lambda * (1 - MS-SSIM).
"""

from typing import Dict, Optional, Tuple

import torch

from neural_image_compression_tpu_torch.ops.math import LOG2

_EPS = 1e-8


def _sum_nonbatch(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=tuple(range(1, x.dim())))


def _rate_and_mse(model_out: Dict[str, torch.Tensor], x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The rate and MSE terms both objectives report, in their order."""
    bits_y = -_sum_nonbatch(model_out["logp_y"]) / LOG2  # [B]
    bits_z = -_sum_nonbatch(model_out["logp_z"]) / LOG2  # [B]
    num_pixels = x.shape[1] * x.shape[2]
    bpp_y = torch.mean(bits_y / num_pixels)
    bpp_z = torch.mean(bits_z / num_pixels)

    mse_per_image = torch.mean((model_out["x_hat"] - x) ** 2, dim=tuple(range(1, x.dim())))
    mse = torch.mean(mse_per_image)
    return {
        "bpp_y": bpp_y,
        "bpp_z": bpp_z,
        "bpp_total": bpp_y + bpp_z,
        "mse": mse,
        "psnr": -10.0 * torch.log10(mse + _EPS),
        "mse_per_image": mse_per_image.detach(),
        "psnr_per_image": -10.0 * torch.log10(mse_per_image.detach() + _EPS),
        "bits_y": torch.mean(bits_y),
        "bits_z": torch.mean(bits_z),
        "bits_total": torch.mean(bits_y + bits_z),
    }


def rd_loss(model_out: Dict[str, torch.Tensor], x: torch.Tensor,
            lambda_rd: float) -> Dict[str, torch.Tensor]:
    """x: (B, H, W, 3); model_out: the model's output dict (NHWC)."""
    terms = _rate_and_mse(model_out, x)
    return {"loss": terms["bpp_total"] + lambda_rd * (255.0 ** 2) * terms["mse"], **terms}


def msssim_rd_loss(model_out: Dict[str, torch.Tensor], x: torch.Tensor, lambda_rd: float,
                   weights: Optional[Tuple[float, ...]] = None) -> Dict[str, torch.Tensor]:
    """MS-SSIM rate-distortion objective: distortion is
    ``1 - MS-SSIM(x_hat, x)`` and ``loss = bpp_total + lambda * distortion``
    (no 255^2 scale: lambda values are not comparable with rd_loss's;
    typical range 2-120).

    weights: optional per-level MS-SSIM weights; fewer levels lower the
    minimum image size (the default 5 levels need >= 161 px per side).
    MSE and PSNR are reported without a gradient, so runs under either
    objective log comparable metrics.
    """
    # imported here: the evaluation package imports this module
    from neural_image_compression_tpu_torch.evaluation.msssim import ms_ssim

    terms = _rate_and_mse(model_out, x)
    kwargs = {} if weights is None else {"weights": tuple(weights)}
    msssim_per_image = ms_ssim(model_out["x_hat"], x, data_range=1.0,
                               size_average=False, **kwargs)  # [B]
    msssim = torch.mean(msssim_per_image)
    out = {"loss": terms["bpp_total"] + lambda_rd * (1.0 - msssim)}
    out.update((k, terms[k]) for k in ("bpp_y", "bpp_z", "bpp_total"))
    out.update(msssim=msssim, msssim_per_image=msssim_per_image.detach(),
               mse=terms["mse"].detach(), psnr=terms["psnr"].detach())
    out.update((k, terms[k]) for k in ("mse_per_image", "psnr_per_image", "bits_y", "bits_z",
                                       "bits_total"))
    return out
