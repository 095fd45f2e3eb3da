"""Serving function: the eval forward with per-image rates, port of
serving.py's ``make_serving_fn``. (The JAX package also freezes it into a
StableHLO artifact; that export has no counterpart here yet.)

    serve(x: float32 (B, H, W, 3) in [0, 1])
      -> {"x_hat": float32 (B, H, W, 3) clipped to [0, 1],
          "bpp_y": (B,), "bpp_z": (B,), "bpp_total": (B,)}

The tensors stay on the model's device.
"""

import torch

from neural_image_compression_tpu_torch.ops.math import LOG2

__all__ = ["make_serving_fn"]


def make_serving_fn(model):
    """x -> dict with x_hat and per-image bpp, on the model's device."""
    device = next(model.parameters()).device

    def serve(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        with torch.inference_mode():
            out = model(x, training=False)
            npix = float(x.shape[1] * x.shape[2])

            def bpp(logp):
                return -torch.sum(logp.float(), dim=tuple(range(1, logp.dim()))) / LOG2 / npix

            bpp_y = bpp(out["logp_y"])
            bpp_z = bpp(out["logp_z"])
            return {"x_hat": torch.clamp(out["x_hat"].float(), 0.0, 1.0),
                    "bpp_y": bpp_y, "bpp_z": bpp_z, "bpp_total": bpp_y + bpp_z}

    return serve
