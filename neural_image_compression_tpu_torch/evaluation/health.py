"""RD-curve health validation, a copy of the JAX package's
evaluation/health.py (plain Python).

A rate-distortion curve trained per-λ can contain silently degenerate
points: a replica that diverged late, collapsed, or landed on an
RD-inverted optimum (a joint-AR λ=0.08 collapse, a hyperprior λ=0.08 point
paying 2.4× the rate of its own λ=0.02 point for −0.006 dB), so curves pass
this guard. The reference trains one λ per notebook run and publishes
single points; this is the check its workflow leaves to a human reading
the numbers.
"""

from typing import Dict, List, Sequence

__all__ = ["curve_health"]


def curve_health(points: Sequence[Dict[str, float]],
                 psnr_tol_db: float = 0.05,
                 rate_factor: float = 2.0,
                 min_gain_db: float = 0.1) -> List[str]:
    """Flag RD-degenerate points in one family's per-λ curve.

    points: dicts with keys "lambda", "bpp", "psnr" (any extra keys are
    ignored). Checks, over λ-ascending points:

    * PSNR monotone non-decreasing with λ (tolerance ``psnr_tol_db``) —
      a higher distortion weight must not buy LESS quality;
    * bpp monotone non-decreasing with λ (2% tolerance) — a higher
      distortion weight must not buy FEWER bits than a lower one (an
      augmented channel_cb λ=0.005 replica once landed above its own
      λ=0.02 sibling's rate at 3 dB less PSNR — rate-dominated outright,
      which the first check cannot see);
    * rate efficiency: no point may pay >= ``rate_factor`` × the bpp of
      another point while gaining <= ``min_gain_db`` PSNR (the shape of
      both failures above).

    Returns a list of human-readable warnings; empty means healthy.
    """
    warns: List[str] = []
    pts = sorted(points, key=lambda p: p["lambda"])
    for lo, hi in zip(pts, pts[1:]):
        if hi["psnr"] < lo["psnr"] - psnr_tol_db:
            warns.append(
                f"PSNR non-monotone: λ={hi['lambda']} gives {hi['psnr']:.2f}"
                f" dB < λ={lo['lambda']}'s {lo['psnr']:.2f} dB")
        if hi["bpp"] < lo["bpp"] * 0.98:
            warns.append(
                f"bpp non-monotone: λ={lo['lambda']} pays {lo['bpp']:.4f}"
                f" bpp, more than λ={hi['lambda']}'s {hi['bpp']:.4f} — the"
                f" lower-λ replica is rate-dominated")
    for lo in pts:
        for hi in pts:
            if (hi["bpp"] >= rate_factor * lo["bpp"]
                    and hi["psnr"] - lo["psnr"] <= min_gain_db):
                warns.append(
                    f"rate-inefficient point: λ={hi['lambda']} pays "
                    f"{hi['bpp']:.3f} bpp vs λ={lo['lambda']}'s "
                    f"{lo['bpp']:.3f} for only "
                    f"{hi['psnr'] - lo['psnr']:+.3f} dB")
    return warns
