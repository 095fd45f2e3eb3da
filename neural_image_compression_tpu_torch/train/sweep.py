"""Rate-distortion curves, port of train/sweep.py's sequential functions.

``lambda_sweep`` trains one model per lambda with the Trainer and
evaluates each; ``gained_rd_curve`` gets a whole curve from one trained
variable-rate model by folding its gains at each level (``models.gained``)
and evaluating the fixed-rate model that results. Both give the same
points ({lambda, [level,] bpp, psnr, msssim}, sorted by bpp), which
``plot_rd_curve`` and ``evaluation.bd_rate`` take. The JAX package's
``vmapped_lambda_sweep`` (one program over stacked replicas) is not ported.
"""

import json
import math
import os
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["gained_rd_curve", "interp_lambda", "lambda_sweep", "plot_rd_curve"]


def _write_curve(points: List[Dict[str, float]], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "rd_curve.json"), "w") as f:
        json.dump(points, f, indent=1)


def _point(metrics: Dict[str, float]) -> Dict[str, float]:
    return {"bpp": metrics["BPP"], "psnr": metrics["PSNR(RGB)"],
            "msssim": metrics["MS-SSIM(RGB)"]}


def lambda_sweep(model_factory: Callable[[], object], train_loader, val_loader,
                 lambdas: Sequence[float], max_steps: int, learning_rate: float = 1e-4,
                 scheduler: Optional[str] = None, out_dir: str = "./sweep", mesh=None,
                 seed: int = 0, eval_loader=None) -> List[Dict[str, float]]:
    """Train a fresh ``model_factory()`` per lambda for ``max_steps`` and
    evaluate it on ``eval_loader`` (``val_loader`` when None); returns the
    RD points sorted by bpp, also written to ``out_dir/rd_curve.json``.
    Each run logs to ``out_dir/runs/lambda_<l>`` and checkpoints to
    ``out_dir/ckpt/lambda_<l>.pt``."""
    if mesh is not None:
        raise NotImplementedError("lambda_sweep over a device mesh is not ported "
                                  "(ROADMAP A5: parallel and sweep)")
    from neural_image_compression_tpu_torch.evaluation import CompressionEvaluator
    from neural_image_compression_tpu_torch.train.trainer import Trainer

    os.makedirs(out_dir, exist_ok=True)
    eval_loader = eval_loader or val_loader
    points = []
    for lam in lambdas:
        tag = f"lambda_{lam:g}"
        model = model_factory()
        trainer = Trainer(model, train_loader, val_loader=val_loader, lambda_val=lam,
                          learning_rate=learning_rate, scheduler=scheduler, max_steps=max_steps,
                          log_dir=os.path.join(out_dir, "runs", tag),
                          checkpoint_path=os.path.join(out_dir, "ckpt", tag + ".pt"), seed=seed)
        model = trainer.train()
        ev = CompressionEvaluator(model, eval_loader, lam,
                                  save_dir=os.path.join(out_dir, "eval", tag))
        metrics, _, _ = ev.evaluate()
        points.append({"lambda": lam, **_point(metrics)})
    points.sort(key=lambda p: p["bpp"])
    _write_curve(points, out_dir)
    return points


def gained_rd_curve(model, eval_loader, levels: Optional[Sequence[float]] = None,
                    out_dir: Optional[str] = None) -> List[Dict[str, float]]:
    """The RD curve of one variable-rate model (``models.GainedJointAR`` or
    a sibling): at each level (default: the integer ladder; fractional
    levels interpolate) its gains are folded into the fixed-rate model
    (``folded_model``, ``fold_gains``), which the evaluator runs at that
    level's lambda. Points as ``lambda_sweep``'s, with the level; written to
    ``out_dir/rd_curve.json`` when out_dir is given."""
    from neural_image_compression_tpu_torch.evaluation import CompressionEvaluator
    from neural_image_compression_tpu_torch.models.gained import fold_gains, folded_model

    if levels is None:
        levels = list(range(len(model.levels)))
    fm = folded_model(model)
    state = model.state_dict()
    points = []
    for level in levels:
        fm.load_state_dict(fold_gains(state, level))
        lam = float(interp_lambda(model.levels, level))
        metrics, _, _ = CompressionEvaluator(fm, eval_loader, lam, save_dir=None).evaluate()
        points.append({"lambda": lam, "level": float(level), **_point(metrics)})
    points.sort(key=lambda p: p["bpp"])
    if out_dir:
        _write_curve(points, out_dir)
    return points


def interp_lambda(levels: Sequence[float], level) -> float:
    """The lambda of a (possibly fractional) gain level: the geometric
    interpolation of the ladder, as ``models.interp_gain`` interpolates
    gains."""
    n = len(levels)
    lv = min(max(float(level), 0.0), n - 1)
    lo = int(lv)
    hi = min(lo + 1, n - 1)
    t = lv - lo
    return math.exp((1 - t) * math.log(levels[lo]) + t * math.log(levels[hi]))


def plot_rd_curve(points: List[Dict[str, float]], save_path: str, metric: str = "psnr") -> str:
    """Plot ``metric`` against bpp to ``save_path`` (matplotlib, imported
    here: it is optional); returns the path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 4))
    plt.plot([p["bpp"] for p in points], [p[metric] for p in points], "o-")
    plt.xlabel("bpp")
    plt.ylabel(metric.upper())
    plt.title("Rate-distortion curve")
    plt.grid(True, linestyle="--", alpha=0.5)
    plt.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)
    return save_path
