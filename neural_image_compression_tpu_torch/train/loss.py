"""Rate-distortion objective, port of train/loss.py (``rd_loss`` so far).

Every value stays a tensor on the model's device: no ``.item()``, so a
caller reads what it needs without a sync per value.

    bpp = -sum(logp) / ln2 / (H*W) per image, mean over the batch;
    loss = bpp_total + lambda * 255^2 * MSE.
"""

from typing import Dict

import torch

from neural_image_compression_tpu_torch.ops.math import LOG2

_EPS = 1e-8


def _sum_nonbatch(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=tuple(range(1, x.dim())))


def rd_loss(model_out: Dict[str, torch.Tensor], x: torch.Tensor,
            lambda_rd: float) -> Dict[str, torch.Tensor]:
    """x: (B, H, W, 3); model_out: the model's output dict (NHWC)."""
    bits_y = -_sum_nonbatch(model_out["logp_y"]) / LOG2  # [B]
    bits_z = -_sum_nonbatch(model_out["logp_z"]) / LOG2  # [B]
    num_pixels = x.shape[1] * x.shape[2]
    bpp_y = torch.mean(bits_y / num_pixels)
    bpp_z = torch.mean(bits_z / num_pixels)
    bpp_total = bpp_y + bpp_z

    mse_per_image = torch.mean((model_out["x_hat"] - x) ** 2, dim=tuple(range(1, x.dim())))
    mse = torch.mean(mse_per_image)
    psnr = -10.0 * torch.log10(mse + _EPS)
    psnr_per_image = -10.0 * torch.log10(mse_per_image + _EPS)

    loss = bpp_total + lambda_rd * (255.0 ** 2) * mse

    return {
        "loss": loss,
        "bpp_y": bpp_y,
        "bpp_z": bpp_z,
        "bpp_total": bpp_total,
        "mse": mse,
        "psnr": psnr,
        "mse_per_image": mse_per_image.detach(),
        "psnr_per_image": psnr_per_image.detach(),
        "bits_y": torch.mean(bits_y),
        "bits_z": torch.mean(bits_z),
        "bits_total": torch.mean(bits_y + bits_z),
    }
