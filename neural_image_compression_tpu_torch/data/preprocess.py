"""Offline training-patch extraction, port of data/preprocess.py (numpy
and PIL, no device: a patch here equals the JAX package's byte for byte
for one input directory and seed).

Capability parity with the reference pipeline (preprocess.py:12-76): drop
over-saturated images, drop images too small to survive the worst-case
downsample, add U(-0.5/levels, 0.5/levels) dequantization noise, random
bicubic downsample by a factor drawn from U(min_factor, 1), random
target_size^2 crop. The *semantics* match the reference so trained models
see the same data distribution; the implementation is our own:

- numpy-array core (`PatchExtractor`) with PIL only at the decode/resize
  boundary, so every stage is unit-testable on arrays;
- parallel workers (the reference loops serially; PIL decode + bicubic
  resize release the GIL, so a thread pool scales on multicore hosts);
- order-independent determinism: each file gets its own RNG derived from
  (seed, filename), so the output patch for a given image is identical
  regardless of worker count or scheduling (a global serial RNG, as in the
  reference, changes every patch when the file set changes).
"""

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

_EXTS = (".jpg", ".jpeg", ".png")


@dataclass(frozen=True)
class PatchConfig:
    """Knobs of the extraction pipeline (defaults = reference defaults)."""

    target_size: int = 256
    min_factor: float = 0.75
    saturation_threshold: float = 0.95
    max_saturated_fraction: float = 0.05
    quantization_levels: int = 256


class PatchExtractor:
    """Turns one decoded RGB image into one training patch (or rejects it).

    Stages (applied in reference order): saturation filter -> size filter ->
    dequantization dither -> random downsample -> random crop. All stages
    take/return uint8 HWC arrays; the RNG is supplied per call.
    """

    def __init__(self, config: PatchConfig = PatchConfig()):
        self.config = config

    # -- filters -------------------------------------------------------
    def saturated_fraction(self, arr: np.ndarray) -> float:
        """Fraction of pixels whose channel spread exceeds the threshold."""
        f = arr.astype(np.float32) / 255.0
        spread = f.max(axis=-1) - f.min(axis=-1)
        return float((spread > self.config.saturation_threshold).mean())

    def accepts(self, arr: np.ndarray) -> bool:
        cfg = self.config
        if self.saturated_fraction(arr) > cfg.max_saturated_fraction:
            return False
        # worst-case downsample (x min_factor) must still fit a full crop
        return min(arr.shape[:2]) * cfg.min_factor >= cfg.target_size

    # -- transforms ----------------------------------------------------
    def dither(self, arr: np.ndarray, rng) -> np.ndarray:
        """Uniform dequantization dither of +-0.5 quantization step,
        re-quantized to uint8 (the training data stays 8-bit on disk)."""
        levels = self.config.quantization_levels
        f = arr.astype(np.float32) / 255.0
        f = f + rng.uniform(-0.5 / levels, 0.5 / levels, size=f.shape)
        # NOTE: truncating (not rounding) re-quantization deliberately
        # matches the reference byte-for-byte (preprocess.py:16
        # `(np_img * 255).astype(np.uint8)`): it skews the dither ~-0.5 LSB
        # dark, but trained-model parity requires the same data distribution.
        return (np.clip(f, 0.0, 1.0) * 255.0).astype(np.uint8)

    def random_patch(self, arr: np.ndarray, rng) -> Optional[np.ndarray]:
        """Bicubic downsample by U(min_factor, 1), then a random
        target_size^2 crop. None if the resized image cannot fit one."""
        from PIL import Image

        cfg = self.config
        h, w = arr.shape[:2]
        factor = float(rng.uniform(cfg.min_factor, 1.0))
        nh, nw = int(h * factor), int(w * factor)
        if nh < cfg.target_size or nw < cfg.target_size:
            return None
        small = np.asarray(
            Image.fromarray(arr).resize((nw, nh), Image.BICUBIC))
        top = int(rng.integers(0, nh - cfg.target_size + 1))
        left = int(rng.integers(0, nw - cfg.target_size + 1))
        return small[top:top + cfg.target_size, left:left + cfg.target_size]

    def __call__(self, arr: np.ndarray, rng) -> Optional[np.ndarray]:
        if not self.accepts(arr):
            return None
        return self.random_patch(self.dither(arr, rng), rng)


def _file_rng(seed, name: str):
    """Per-file RNG: deterministic in (seed, filename), independent of
    processing order and worker count."""
    import hashlib

    digest = hashlib.sha256(name.encode()).digest()[:8]
    return np.random.default_rng(
        (0 if seed is None else int(seed), int.from_bytes(digest, "little")))


def preprocess_images(input_dir, output_dir, target_size: int = 256,
                      min_factor: float = 0.75, saturation_thresh: float = 0.95,
                      seed=None, overwrite: bool = False,
                      workers: Optional[int] = None) -> int:
    """Extract one patch per eligible jpg/png in input_dir into output_dir.

    Returns the number of patches on disk afterwards (kept + pre-existing).
    When seed is None each run draws fresh patches; with a seed the output
    is reproducible per file (see _file_rng).
    """
    from PIL import Image

    in_root, out_root = Path(input_dir), Path(output_dir)
    out_root.mkdir(parents=True, exist_ok=True)
    extractor = PatchExtractor(PatchConfig(
        target_size=target_size, min_factor=min_factor,
        saturation_threshold=saturation_thresh))

    files = sorted(p for p in in_root.iterdir()
                   if p.suffix.lower() in _EXTS)
    base_seed = seed if seed is not None else int.from_bytes(os.urandom(8),
                                                             "little")

    def _process(path: Path) -> bool:
        dst = out_root / path.name
        if dst.exists() and not overwrite:
            return True
        try:
            with Image.open(path) as img:
                arr = np.asarray(img.convert("RGB"))
        except OSError:
            print(f"[preprocess] unreadable image, skipped: {path}")
            return False
        patch = extractor(arr, _file_rng(base_seed, path.name))
        if patch is None:
            return False
        Image.fromarray(patch).save(dst)
        return True

    n_workers = workers or min(8, os.cpu_count() or 1)
    if n_workers <= 1 or len(files) <= 1:
        results = [_process(p) for p in files]
    else:
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            results = list(pool.map(_process, files))
    return sum(results)


# ---------------------------------------------------------------------------
# PIL-level helpers, kept as the stable public API (reference
# preprocess.py:12-33 exposes the same three operations).
# ---------------------------------------------------------------------------

def add_quantization_noise(img, levels: int = 256, rng=None):
    """PIL -> PIL with uniform dequantization dither (preprocess.py:12-16)."""
    from PIL import Image

    gen = rng if rng is not None else np.random.default_rng()
    cfg = PatchConfig(quantization_levels=levels)
    return Image.fromarray(
        PatchExtractor(cfg).dither(np.asarray(img), gen))


def is_saturated(img, threshold: float = 0.95) -> bool:
    """True if >5% of pixels exceed the channel-spread threshold
    (preprocess.py:18-21)."""
    ex = PatchExtractor(PatchConfig(saturation_threshold=threshold))
    return ex.saturated_fraction(np.asarray(img)) > ex.config.max_saturated_fraction


def random_downsample_crop(img, target_size: int = 256, min_factor: float = 0.75,
                           rng=None):
    """PIL -> PIL random downsample+crop, or None (preprocess.py:23-33)."""
    from PIL import Image

    gen = rng if rng is not None else np.random.default_rng()
    cfg = PatchConfig(target_size=target_size, min_factor=min_factor)
    patch = PatchExtractor(cfg).random_patch(np.asarray(img), gen)
    return None if patch is None else Image.fromarray(patch)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Extract training patches from a folder of images.")
    parser.add_argument("--input_dir", type=str, default="./data/coco_val2017")
    parser.add_argument("--output_dir", type=str, default="./data/coco_preprocessed")
    parser.add_argument("--target_size", type=int, default=256)
    parser.add_argument("--min_factor", type=float, default=0.75)
    parser.add_argument("--saturation_thresh", type=float, default=0.95)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--workers", type=int, default=None)
    args = parser.parse_args(argv)
    n = preprocess_images(args.input_dir, args.output_dir, args.target_size,
                          args.min_factor, args.saturation_thresh, args.seed,
                          args.overwrite, args.workers)
    print(f"{n} patches in {args.output_dir}")


if __name__ == "__main__":
    main()
