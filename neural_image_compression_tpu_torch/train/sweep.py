"""Rate-distortion curves, port of train/sweep.py's sequential functions.

``lambda_sweep`` trains one model per lambda with the Trainer and
evaluates each; ``gained_rd_curve`` gets a whole curve from one trained
variable-rate model by folding its gains at each level (``models.gained``)
and evaluating the fixed-rate model that results. Both give the same
points ({lambda, [level,] bpp, psnr, msssim}, sorted by bpp), which
``plot_rd_curve`` and ``evaluation.bd_rate`` take. ``vmapped_lambda_sweep``
trains the whole curve at once: one step over L replicas stacked on a
leading axis (``torch.func.vmap``), which returns the replicas' weights.
"""

import json
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["gained_rd_curve", "interp_lambda", "lambda_sweep", "plot_rd_curve",
           "vmapped_lambda_sweep"]


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
    ``out_dir/ckpt/lambda_<l>.pt``; with a mesh each run's Trainer is data
    parallel over it (every rank calls this with its share of the
    loaders)."""
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
                          checkpoint_path=os.path.join(out_dir, "ckpt", tag + ".pt"), seed=seed,
                          mesh=mesh)
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


class _NoiseShapes:
    """A noise source that records the shapes a forward draws, in order."""

    def __init__(self):
        self.shapes: List[Tuple[int, ...]] = []

    def draw(self, x: torch.Tensor) -> torch.Tensor:
        self.shapes.append(tuple(x.shape))
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


def _replica_noise(shapes: Sequence[Tuple[int, ...]], generators: Sequence[torch.Generator],
                   device: torch.device) -> List[torch.Tensor]:
    """For each drawn shape, the (L, *shape) stack of the replicas' noise:
    replica i's draws, in the forward's order, are those that the model
    draws with generator i (``models.noise_quantize``)."""
    return [torch.stack([torch.empty(shape, dtype=torch.float32, device=device)
                         .uniform_(-0.5, 0.5, generator=g) for g in generators])
            for shape in shapes]


def _flip_bits(generator: torch.Generator) -> List[bool]:
    """(horizontal, vertical, transpose): three fair coins from the sweep's
    shared host generator."""
    return [bool(b) for b in torch.randint(0, 2, (3,), generator=generator)]


def _augment(x: torch.Tensor, bits: Sequence[bool]) -> torch.Tensor:
    """The dihedral augmentation of JAX's sweep: W flip, H flip, and the
    H/W transpose only for square batches."""
    flip_w, flip_h, transpose = bits
    if flip_w:
        x = x.flip(2)
    if flip_h:
        x = x.flip(1)
    if transpose and x.shape[1] == x.shape[2]:
        x = x.transpose(1, 2)
    return x.contiguous()


def _clip_per_replica(grads: List[torch.Tensor], max_norm: float) -> None:
    """``parallel.clip_by_global_norm`` of each replica on its own: the
    global norm over all leaves of the replica (leading axis), in place."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.reshape(g.shape[0], -1), dim=1) for g in grads]), dim=0)
    below = norm < max_norm
    div = torch.where(below, torch.ones_like(norm), norm)
    mul = torch.where(below, torch.ones_like(norm), torch.full_like(norm, max_norm))
    for g in grads:
        shape = (-1,) + (1,) * (g.dim() - 1)
        g.div_(div.view(shape)).mul_(mul.view(shape))


def vmapped_lambda_sweep(model, lambdas: Sequence[float], train_iter, steps: int,
                         learning_rate: float = 1e-4, seed: int = 0, rd_loss=None,
                         log_every: int = 0, log_fn=print, clip_grad_norm: Optional[float] = None,
                         augment: bool = False, init_states=None):
    """Train one model per lambda at once: L replicas stacked on a leading
    axis, one step for all of them.

    The step is ``torch.func.vmap`` of ``torch.func.grad_and_value`` over
    ``torch.func.functional_call`` of ``model``, with in_dims (0, 0, None,
    0): the stacked parameters, the lambdas, the batch every replica shares,
    and each replica's noise. The convolutions batch over the replicas (as
    grouped convolutions) and the hand kernels run under the transform:
    GDN once a replica (each has its own gamma and beta), the mixture
    likelihood once for all (its rows fold). Adam (learning_rate, betas
    (0.9, 0.999), eps 1e-8: optax's) steps the stacked leaves; it works
    element by element, so it is one Adam a replica. clip_grad_norm clips
    each replica to its own global norm.

    model: the module whose forward and buffers the replicas share; every
    replica starts from its weights, or replica i from init_states[i] (a
    state dict) where given (JAX's sweep inits replica i from key i; a
    port model carries its weights). train_iter: yields (B, H, W, 3)
    batches, float in [0, 1] or uint8, shared by all replicas. Replica i
    draws its noise from ``torch.Generator`` seeded seed + 1 + i on the
    model's device, exactly as ``parallel.make_train_step`` would with that
    generator: the noise is drawn outside the transform (whose random ops
    cannot take a generator) and passed in, after one no-grad forward that
    finds its shapes (again for each new batch shape). augment flips the
    shared batch as JAX's sweep does (W, H, and the transpose for square
    batches), each step's three coins from a host generator seeded seed, one
    draw for all replicas; without it that generator is not drawn from.
    log_every > 0 prints the replicas' losses every that many steps (one
    host sync each).

    Returns (a list of L state dicts, the (L,) losses of the last step).
    """
    from torch.func import functional_call, grad_and_value, vmap

    from neural_image_compression_tpu_torch.models.joint_ar import GivenNoise
    from neural_image_compression_tpu_torch.parallel.train_step import batch_to_device
    from neural_image_compression_tpu_torch.train.loss import rd_loss as default_rd_loss

    rd_loss = rd_loss or default_rd_loss
    n = len(lambdas)
    named = dict(model.named_parameters())
    device = next(iter(named.values())).device
    if init_states is None:
        init_states = [named] * n
    if len(init_states) != n:
        raise ValueError(f"{len(init_states)} initial states for {n} lambdas")
    params = {name: torch.stack([torch.as_tensor(state[name]).to(device, p.dtype)
                                 for state in init_states]).detach()
              for name, p in named.items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8)
    lams = torch.tensor(list(lambdas), dtype=torch.float32, device=device)
    generators = [torch.Generator(device=device).manual_seed(seed + 1 + i) for i in range(n)]
    aug_generator = torch.Generator().manual_seed(seed)

    def loss_fn(p, lam, x, noise):
        out = functional_call(model, p, (x,), {"training": True, "generator": GivenNoise(noise)})
        return rd_loss(out, x, lam)["loss"]

    sweep_step = vmap(grad_and_value(loss_fn), in_dims=(0, 0, None, 0))
    shapes: Dict[Tuple[int, ...], List[Tuple[int, ...]]] = {}
    it = iter(train_iter)
    losses = None
    for i in range(steps):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(train_iter)
            batch = next(it)
        x = batch_to_device(batch, device)
        if augment:
            x = _augment(x, _flip_bits(aug_generator))
        if tuple(x.shape) not in shapes:
            probe = _NoiseShapes()
            with torch.no_grad():
                model(x, training=True, generator=probe)
            shapes[tuple(x.shape)] = probe.shapes
        noise = _replica_noise(shapes[tuple(x.shape)], generators, device)
        grads, losses = sweep_step(params, lams, x, noise)
        if clip_grad_norm is not None:
            _clip_per_replica(list(grads.values()), clip_grad_norm)
        for name, leaf in params.items():
            leaf.grad = grads[name]
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        if log_every and (i % log_every == 0 or i == steps - 1):
            log_fn(f"  [sweep] step {i} losses {[round(float(v), 4) for v in losses]}")

    buffers = dict(model.named_buffers())
    states = [{**buffers, **{name: leaf[r].clone() for name, leaf in params.items()}}
              for r in range(n)]
    return states, losses
