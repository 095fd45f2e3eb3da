"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``port_bench/reference``), run on the same
weights, images and noise after the window.

Serve: for each sampled request, the serving dict (x_hat and the per-image
bpp_y, bpp_z, bpp_total) and any captured module output (the scalable
model's F~), against the reference's float32 eval forward on the same
batch, in blocks of images:

* ``x_hat_rel``: the largest, over images, of ||x^ - x^_ref|| / ||x^_ref||;
* ``bpp_rel``: the largest, over images and the three rates, of
  |bpp - bpp_ref| / bpp_ref;
* ``<captured>_rel``: as x_hat_rel, for each captured output.

Train: the step's first three calls (made at set-up, through the window's
own call and on distinct batches), against the reference's three steps of
plain autograd and a plain Adam from the same weights, on the same batches
and with noise drawn from a generator in the same state:

* ``first_loss_rel``: |L - L_ref| / |L_ref| of the first step's loss (the
  later steps' losses carry the round-off that Adam's first update gives
  the elements with all but no gradient, which the randomly drawn models
  of some seeds amplify by orders of magnitude);
* ``grad_rel``: the first gradient as Adam holds it after one step
  (exp_avg / (1 - beta1)), by the worst leaf: | |g| - |g_ref| | over the
  larger of |g_ref| and the median leaf's |g_ref|;
* ``step_median_rel``: the same gap for the parameters' change after three
  steps, by the median leaf (by the worst leaf, ``step_rel``, it is the
  round-off of a small bias whose elements Adam moves by the sign of an
  all but zero gradient).

Leaves whose reference gradient is under a thousandth of the median leaf's
(round-off moves them under Adam) are left out of the leaf-wise numbers.
"""

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from port_bench.reference import layers as L

SERVE_BLOCK = 8
NEGLIGIBLE_GRAD = 1e-3


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN's and cuBLAS's TF32 switched to ``enabled`` for the block."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = enabled
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False, allow_tf32=enabled):
            yield
    finally:
        matmul.allow_tf32 = saved


# -- serve ---------------------------------------------------------------------

def _nhwc_float(t: torch.Tensor) -> torch.Tensor:
    """A module output (B, C, H, W) in channels_last memory as NHWC float32."""
    return t.permute(0, 2, 3, 1).float()


@torch.no_grad()
def serve_reference(cell, weights, x, num: L.Numerics = L.F32) -> dict:
    """The reference's serving dict (and F~ where the model has it) for
    the batch x, computed SERVE_BLOCK images at a time."""
    ref = cell.reference
    parts = []
    for xb in torch.split(x, SERVE_BLOCK):
        out = ref.forward(cell.config, weights, xb, training=False, num=num)
        block = ref.serving_outputs(out, xb)
        if "F_tilde" in out:
            block["F_tilde"] = out["F_tilde"]
        parts.append(block)
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _rel_rms(a, b) -> float:
    a, b = a.flatten(1).float(), b.flatten(1).float()
    den = torch.linalg.vector_norm(b, dim=1).clamp_min(1e-30)
    return float(torch.max(torch.linalg.vector_norm(a - b, dim=1) / den))


RATES = ("bpp_y", "bpp_z", "bpp_total")


def rate_gaps(served: dict, ref: dict) -> Dict[str, torch.Tensor]:
    """Each rate's |bpp - bpp_ref| / bpp_ref, image by image."""
    return {k: torch.abs(served[k].float() - ref[k]) / torch.abs(ref[k]).clamp_min(1e-30)
            for k in RATES}


def serve_numbers(served: dict, captured: dict, ref: dict) -> Dict[str, float]:
    out = {"x_hat_rel": _rel_rms(served["x_hat"], ref["x_hat"])}
    out["bpp_rel"] = max(float(torch.max(g)) for g in rate_gaps(served, ref).values())
    for name, t in captured.items():
        out[f"{name}_rel"] = _rel_rms(_nhwc_float(t), ref[name])
    return out


def serve_reference_numbers(ref: dict, ctl: dict) -> Dict[str, float]:
    """The numbers of a reference-side run (the control) against the
    reference: ``ctl`` is judged as the program's outputs would be."""
    served = {k: ctl[k] for k in ("x_hat", "bpp_y", "bpp_z", "bpp_total")}
    captured = {k: ctl[k].permute(0, 3, 1, 2) for k in ctl if k not in served}
    return serve_numbers(served, captured, ref)


# -- train ---------------------------------------------------------------------

@dataclass
class TrainRecord:
    """Three steps' losses, the first gradient's norm by leaf, the change's
    norm by leaf after the third step."""
    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]


def _norms(named: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(named)
    values = torch.stack([torch.linalg.vector_norm(named[n].float()) for n in names]).tolist()
    return dict(zip(names, values))


def grad_norms_from_adam(model, optimizer) -> Dict[str, float]:
    """Each leaf's first gradient, as Adam holds it after one step:
    exp_avg / (1 - beta1); 0 for a leaf Adam has not stepped."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    named = {}
    for name, p in model.named_parameters():
        state = optimizer.state.get(p, {})
        avg = state.get("exp_avg")
        named[name] = torch.zeros((), device=p.device) if avg is None else avg / (1.0 - beta1)
    return _norms(named)


def change_norms(model, initial: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return _norms({n: p.detach() - initial[n] for n, p in model.named_parameters()})


def reference_train(cell, weights, teacher, batches, generator_states, device,
                    tf32_on: bool = False, fault: Optional[str] = None) -> TrainRecord:
    """Three reference steps. fault: None, or "half_batch" (the loss's
    mean taken over the first half of each batch: the fault a step that
    drops half its rows would have)."""
    cfg, ref = cell.config, cell.reference
    lr, (b1, b2), eps = cfg["learning_rate"], cfg["adam_betas"], cfg["adam_eps"]
    params = {n: t.detach().clone().requires_grad_(True) for n, t in weights.items()}
    m = {n: torch.zeros_like(t) for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in params.items()}
    gen = torch.Generator(device=device)
    losses, first_grads = [], None
    with tf32(tf32_on):
        for step, (x, state) in enumerate(zip(batches, generator_states), start=1):
            gen.set_state(state)
            out = ref.forward(cfg, params, x, training=True, generator=gen, teacher=teacher)
            if fault == "half_batch":
                half = x.shape[0] // 2
                out = {k: t[:half] for k, t in out.items()}
                x = x[:half]
            loss = ref.loss(cfg, out, x, teacher)
            names = list(params)
            grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
            grads = {n: (torch.zeros_like(params[n]) if g is None else g)
                     for n, g in zip(names, grads)}
            losses.append(float(loss.detach()))
            if first_grads is None:
                first_grads = _norms(grads)
            with torch.no_grad():
                for n in names:
                    g = grads[n]
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n].sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                    params[n].addcdiv_(m[n], denom, value=-lr / (1 - b1 ** step))
    change = _norms({n: params[n].detach() - weights[n] for n in params})
    return TrainRecord(losses, first_grads, change)


def _median(values):
    s = sorted(values)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    """Each leaf's | |prog| - |ref| | over the larger of its |ref| and the
    median leaf's."""
    med = _median([ref[n] for n in leaves])
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves}


def counted_leaves(ref: TrainRecord):
    """The leaves whose reference gradient is not negligible."""
    med = _median(list(ref.grad_norms.values()))
    return [n for n, g in ref.grad_norms.items() if g >= NEGLIGIBLE_GRAD * med]


def train_numbers(prog: TrainRecord, ref: TrainRecord) -> Dict[str, float]:
    leaves = counted_leaves(ref)
    grads = list(leaf_gaps(prog.grad_norms, ref.grad_norms, leaves).values())
    steps = list(leaf_gaps(prog.change_norms, ref.change_norms, leaves).values())
    return {"first_loss_rel": abs(prog.losses[0] - ref.losses[0]) / max(abs(ref.losses[0]), 1e-30),
            "grad_rel": max(grads), "step_rel": max(steps), "step_median_rel": _median(steps)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a number that is not finite fails)."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
