"""Classical-codec anchor RD curves (JPEG / WebP, via Pillow), port of
evaluation/anchors.py.

Learned-compression results are conventionally reported as BD-rate against a
classical anchor ("x% over JPEG at equal PSNR"); the reference repo publishes
a single learned RD point with no anchor tooling (its one artifact,
eval_results/eval_results_0.005_lambda_GM-Capacity128_K3.txt, quotes bpp/PSNR
in isolation). This module sweeps a classical codec's quality knob over an
eval set and returns RD points in the same ``{"bpp", "psnr", ...}`` shape the
lambda sweep and `evaluation.bdrate` use, so

    bd_rate(classical_rd_curve(imgs, "jpeg"), model_curve)

answers the standard question directly.

Encoding is host-side (Pillow + numpy), so the curve is reproducible on any
machine. MS-SSIM is optional: it runs ``evaluation.ms_ssim`` per image on
``device`` (``cuda`` unless the caller names another).
"""

import io
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neural_image_compression_tpu_torch.evaluation.msssim import ms_ssim
from neural_image_compression_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = ["classical_rd_curve", "classical_rd_point", "encode_decode",
           "DEFAULT_QUALITIES", "SUPPORTED_CODECS"]

SUPPORTED_CODECS = ("jpeg", "webp")

# Quality ladders chosen to span the bpp range learned models operate in
# (~0.1-2 bpp on photographic content). WebP quality is not comparable to
# JPEG quality point-for-point, hence separate ladders.
DEFAULT_QUALITIES: Dict[str, Tuple[int, ...]] = {
    "jpeg": (10, 20, 35, 50, 65, 80, 90, 95),
    "webp": (5, 15, 30, 50, 70, 85, 95),
}


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """Accept HWC uint8 or float [0,1] (optionally with a leading batch-1
    axis, the dataloader convention) and return HWC uint8."""
    arr = np.asarray(img)
    if arr.ndim == 4:
        if arr.shape[0] != 1:
            raise ValueError(
                f"expected one image (HWC or 1HWC), got batch {arr.shape}")
        arr = arr[0]
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected HxWx3 image, got {arr.shape}")
    if arr.dtype == np.uint8:
        return arr
    if not np.issubdtype(arr.dtype, np.floating):
        raise ValueError(f"expected uint8 or float image, got {arr.dtype}")
    # the codec's uint8 convention:
    # round-half-away via +0.5 truncation on clipped [0,1].
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def encode_decode(img: np.ndarray, codec: str = "jpeg",
                  quality: int = 75) -> Tuple[int, np.ndarray]:
    """Encode one image with the classical codec and decode it back.

    Returns ``(n_bytes, decoded_uint8)`` where n_bytes is the full container
    size (what a user would store — headers included, same accounting as the
    learned codecs' stream bytes).
    """
    from PIL import Image

    codec = codec.lower()
    if codec not in SUPPORTED_CODECS:
        raise ValueError(f"codec must be one of {SUPPORTED_CODECS}, "
                         f"got {codec!r}")
    u8 = _to_uint8(img)
    buf = io.BytesIO()
    if codec == "jpeg":
        Image.fromarray(u8).save(buf, "JPEG", quality=int(quality))
    else:
        Image.fromarray(u8).save(buf, "WEBP", quality=int(quality),
                                 lossless=False)
    data = buf.getvalue()
    with Image.open(io.BytesIO(data)) as im:
        dec = np.asarray(im.convert("RGB"), np.uint8)
    return len(data), dec


def _psnr(a_u8: np.ndarray, b_u8: np.ndarray) -> float:
    """PSNR on [0,1] floats — the evaluator's convention
    (``evaluation.compute_metrics``)."""
    a = a_u8.astype(np.float64) / 255.0
    b = b_u8.astype(np.float64) / 255.0
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * float(np.log10(1.0 / mse))


def classical_rd_point(images: Sequence[np.ndarray], codec: str = "jpeg",
                       quality: int = 75, with_msssim: bool = False,
                       device: DeviceLike = None) -> Dict[str, float]:
    """One RD point: mean bpp and mean per-image PSNR over the eval set
    (the aggregation of the evaluator's RD points)."""
    if with_msssim:
        device = resolve_device(device)
    bpps: List[float] = []
    psnrs: List[float] = []
    mss: List[float] = []
    for img in images:
        u8 = _to_uint8(img)
        n_bytes, dec = encode_decode(u8, codec, quality)
        h, w = u8.shape[:2]
        bpps.append(n_bytes * 8.0 / (h * w))
        psnrs.append(_psnr(u8, dec))
        if with_msssim:
            a = torch.tensor(u8, dtype=torch.float32, device=device)[None] / 255.0
            b = torch.tensor(dec, dtype=torch.float32, device=device)[None] / 255.0
            mss.append(float(ms_ssim(b, a, data_range=1.0)))
    point = {"bpp": float(np.mean(bpps)), "psnr": float(np.mean(psnrs)),
             "quality": int(quality)}
    if with_msssim:
        point["msssim"] = float(np.mean(mss))
    return point


def classical_rd_curve(images: Sequence[np.ndarray], codec: str = "jpeg",
                       qualities: Optional[Iterable[int]] = None,
                       with_msssim: bool = False,
                       device: DeviceLike = None) -> List[Dict[str, float]]:
    """RD curve for a classical codec over an eval set.

    ``images``: HWC uint8 or float-[0,1] arrays (batch-1 NHWC also accepted).
    Returns points sorted by rate, directly consumable by
    `evaluation.bd_rate` / `bd_psnr` as either curve argument.
    """
    codec = codec.lower()
    if qualities is None:
        qualities = DEFAULT_QUALITIES.get(codec)
        if qualities is None:
            raise ValueError(f"codec must be one of {SUPPORTED_CODECS}, "
                             f"got {codec!r}")
    pts = [classical_rd_point(images, codec, q, with_msssim=with_msssim, device=device)
           for q in qualities]
    pts.sort(key=lambda p: p["bpp"])
    return pts
