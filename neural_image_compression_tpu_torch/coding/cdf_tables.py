"""Quantized CDF tables for the factorized bottleneck (the z path), port of
coding/cdf_tables.py.

The model's device evaluates each channel's learned PMF on an integer grid
(``FactorizedEntropyBottleneck.grid_pmf``); the host quantizes those rows
to 16-bit cumulative tables for the native coder's indexed stream. The last
symbol of each row is an escape that carries out-of-range values as raw
bits.
"""

from typing import Tuple

import numpy as np
import torch

from neural_image_compression_tpu_torch.coding.backend import PROB_SCALE
from neural_image_compression_tpu_torch.utils.device import fixed_numerics


def quantize_pmf_rows(pmf: np.ndarray) -> np.ndarray:
    """(C, L) float pmf rows (escape mass as the last column) -> (C, L+1)
    uint32 cumulative rows summing to 2^16, every frequency >= 1."""
    c, L = pmf.shape
    pmf = np.maximum(pmf.astype(np.float64), 0.0)
    total = pmf.sum(axis=1, keepdims=True)
    total[total <= 0] = 1.0
    budget = PROB_SCALE - L
    freq = 1 + np.floor(pmf / total * budget).astype(np.uint64)
    # the remainder goes to the most likely symbol of each row
    rem = PROB_SCALE - freq.sum(axis=1)
    argmax = pmf.argmax(axis=1)
    freq[np.arange(c), argmax] += rem
    cum = np.zeros((c, L + 1), np.uint32)
    cum[:, 1:] = np.cumsum(freq, axis=1).astype(np.uint32)
    return cum


def factorized_tables(model, zmin: int, zmax: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-channel CDF rows over the integer support [zmin, zmax].

    model: a module owning ``factorized_entropy_model``; its PMF is taken on
    the model's device. Returns (cdfs (C, L+1) uint32, offsets (C,) int32,
    sizes (C,) int32), where L = (zmax - zmin + 1) + 1 (escape last).
    """
    bottleneck = model.factorized_entropy_model
    device = next(bottleneck.parameters()).device
    xs = torch.arange(zmin, zmax + 1, dtype=torch.float32, device=device)
    with torch.no_grad(), fixed_numerics():
        pmf = bottleneck.grid_pmf(xs).cpu().numpy()
    c, n = pmf.shape
    esc = np.clip(1.0 - pmf.sum(axis=1, keepdims=True), 0.0, 1.0)
    rows = np.concatenate([pmf, esc], axis=1)  # (C, n+1)
    cdfs = quantize_pmf_rows(rows)
    offsets = np.full(c, zmin, np.int32)
    sizes = np.full(c, n + 1, np.int32)
    return cdfs, offsets, sizes
