"""Bjøntegaard-delta metrics (BD-rate / BD-PSNR) for comparing RD curves,
a copy of the JAX package's evaluation/bdrate.py (numpy).

The reference publishes a single RD point and has no curve-comparison
tooling; a compression framework needs the standard codec-comparison
metric. This implements the modern (JVET-style) piecewise-cubic-Hermite
variant: interpolate each curve with a monotone PCHIP in the integration
variable, integrate both over the overlapping range, and report the mean
gap — average bitrate delta at equal quality (BD-rate, %) or average
quality delta at equal bitrate (BD-PSNR, dB).

Pure numpy (float64): no scipy dependency, deterministic, and the
Fritsch–Carlson derivative rule matches scipy.interpolate.PchipInterpolator.

Curves are sequences of RD points: either ``(rate, distortion)`` pairs or
dicts with ``"bpp"`` and a metric key (``"psnr"`` by default), the shape
``evaluation.classical_rd_curve`` gives.
"""

from typing import Sequence, Tuple, Union

import numpy as np

Point = Union[Tuple[float, float], dict]

__all__ = ["bd_rate", "bd_psnr"]


def _extract(points: Sequence[Point], metric: str) -> Tuple[np.ndarray, np.ndarray]:
    if len(points) < 2:
        raise ValueError(f"need >= 2 RD points, got {len(points)}")
    if isinstance(points[0], dict):
        rate = np.asarray([p["bpp"] for p in points], np.float64)
        dist = np.asarray([p[metric] for p in points], np.float64)
    else:
        arr = np.asarray(points, np.float64)
        rate, dist = arr[:, 0], arr[:, 1]
    if np.any(rate <= 0):
        raise ValueError("rates must be positive")
    order = np.argsort(rate)
    rate, dist = rate[order], dist[order]
    # Real measured sweeps on small eval sets can have flat or slightly
    # inverted quality between adjacent rate points. PCHIP needs a strictly
    # monotone curve, so prune dominated points (>= rate, <= quality — they
    # carry no RD information) instead of raising; only a curve that is
    # non-monotone THROUGHOUT (fewer than 2 survivors) is an error.
    keep_r, keep_d = [rate[0]], [dist[0]]
    for r, q in zip(rate[1:], dist[1:]):
        if q <= keep_d[-1]:
            continue                          # dominated: >= bits, <= quality
        if r == keep_r[-1]:
            keep_d[-1] = q                    # same rate, better quality wins
            continue
        keep_r.append(r)
        keep_d.append(q)
    if len(keep_r) < 2:
        raise ValueError(
            "RD curve is not monotone: after pruning dominated points fewer "
            "than 2 remain (distortion metric must increase with rate "
            "somewhere on the curve)")
    return np.asarray(keep_r), np.asarray(keep_d)


def _pchip_derivatives(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Fritsch–Carlson monotone derivatives (scipy PchipInterpolator rule)."""
    h = np.diff(x)
    delta = np.diff(y) / h
    n = len(x)
    d = np.zeros(n)
    if n == 2:
        d[:] = delta[0]
        return d
    # interior: weighted harmonic mean where slopes share a sign
    for i in range(1, n - 1):
        if delta[i - 1] * delta[i] <= 0:
            d[i] = 0.0
        else:
            w1 = 2 * h[i] + h[i - 1]
            w2 = h[i] + 2 * h[i - 1]
            d[i] = (w1 + w2) / (w1 / delta[i - 1] + w2 / delta[i])

    def edge(h0, h1, d0, d1):
        val = ((2 * h0 + h1) * d0 - h0 * d1) / (h0 + h1)
        if np.sign(val) != np.sign(d0):
            return 0.0
        if np.sign(d0) != np.sign(d1) and abs(val) > 3 * abs(d0):
            return 3 * d0
        return val

    d[0] = edge(h[0], h[1], delta[0], delta[1])
    d[-1] = edge(h[-1], h[-2], delta[-1], delta[-2])
    return d


def _pchip_integral(x: np.ndarray, y: np.ndarray, lo: float, hi: float) -> float:
    """Exact integral of the PCHIP interpolant over [lo, hi] ⊆ [x0, xn]."""
    d = _pchip_derivatives(x, y)

    def seg_integral(i: int, t0: float, t1: float) -> float:
        # Antiderivatives of the cubic Hermite basis on normalized t ∈ [0,1];
        # dx = h·dt, so the x-space integral carries one factor of h (two on
        # the derivative terms, whose basis is scaled by h).
        h = x[i + 1] - x[i]

        def F(t):
            i00 = t ** 4 / 2 - t ** 3 + t            # ∫ 2t³−3t²+1
            i10 = t ** 4 / 4 - 2 * t ** 3 / 3 + t * t / 2  # ∫ t³−2t²+t
            i01 = -(t ** 4) / 2 + t ** 3             # ∫ −2t³+3t²
            i11 = t ** 4 / 4 - t ** 3 / 3            # ∫ t³−t²
            return h * (y[i] * i00 + h * d[i] * i10
                        + y[i + 1] * i01 + h * d[i + 1] * i11)

        return F(t1) - F(t0)

    total = 0.0
    for i in range(len(x) - 1):
        a, b = max(lo, x[i]), min(hi, x[i + 1])
        if a >= b:
            continue
        h = x[i + 1] - x[i]
        total += seg_integral(i, (a - x[i]) / h, (b - x[i]) / h)
    return total


def _mean_gap(x_a: np.ndarray, y_a: np.ndarray,
              x_t: np.ndarray, y_t: np.ndarray) -> float:
    """Mean of (test − anchor) interpolants over the overlapping x-range."""
    lo = max(x_a[0], x_t[0])
    hi = min(x_a[-1], x_t[-1])
    if hi <= lo:
        raise ValueError(
            f"RD curves do not overlap (anchor [{x_a[0]:.4g}, {x_a[-1]:.4g}] "
            f"vs test [{x_t[0]:.4g}, {x_t[-1]:.4g}])")
    return (_pchip_integral(x_t, y_t, lo, hi)
            - _pchip_integral(x_a, y_a, lo, hi)) / (hi - lo)


def bd_rate(anchor: Sequence[Point], test: Sequence[Point],
            metric: str = "psnr") -> float:
    """Average bitrate change of `test` vs `anchor` at equal quality, in
    percent (negative = test needs fewer bits). Integrates log-rate as a
    function of the quality metric over the curves' overlapping range."""
    rate_a, dist_a = _extract(anchor, metric)
    rate_t, dist_t = _extract(test, metric)
    gap = _mean_gap(dist_a, np.log(rate_a), dist_t, np.log(rate_t))
    return float((np.exp(gap) - 1.0) * 100.0)


def bd_psnr(anchor: Sequence[Point], test: Sequence[Point],
            metric: str = "psnr") -> float:
    """Average quality change of `test` vs `anchor` at equal bitrate, in the
    metric's units (positive = test is better). Integrates the metric as a
    function of log-rate over the overlapping range."""
    rate_a, dist_a = _extract(anchor, metric)
    rate_t, dist_t = _extract(test, metric)
    return float(_mean_gap(np.log(rate_a), dist_a, np.log(rate_t), dist_t))
