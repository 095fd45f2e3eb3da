"""The training step, port of parallel/train_step.py (``make_train_step``)
for one device: the model's forward with noise quantization, the
rate-distortion loss, its backward (through the GDN and mixture-likelihood
backward kernels on a card) and the caller's optimizer.

PyTorch's idiom replaces the JAX step's pure (params, opt_state) threading:
the step updates the model and the optimizer in place and returns only the
metrics. The JAX step's ``mesh`` (data parallelism) has no counterpart here
yet.
"""

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn


def batch_to_device(batch, device: torch.device) -> torch.Tensor:
    """An image batch (array or tensor) on ``device``; uint8 becomes float
    x / 255 there (4x less host-to-device traffic)."""
    batch = torch.as_tensor(batch, device=device)
    if batch.dtype == torch.uint8:
        return batch.float() / 255.0
    return batch


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global L2 norm of at most ``max_norm``,
    as optax.clip_by_global_norm does: unchanged where the norm is below
    max_norm, else g / norm * max_norm, with no epsilon
    (torch.nn.utils.clip_grad_norm_ divides by norm + 1e-6). The norm stays
    a tensor on the gradients' device, so the host does not wait for it.
    Returns the norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    below = norm < max_norm
    torch._foreach_div_(grads, torch.where(below, torch.ones_like(norm), norm))
    torch._foreach_mul_(grads, torch.where(below, torch.ones_like(norm),
                                           torch.full_like(norm, max_norm)))
    return norm


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, rd_loss: Callable,
                    lambda_val: float, ema_decay: Optional[float] = None,
                    clip_grad_norm: Optional[float] = None,
                    levels: Optional[Sequence[float]] = None):
    """Build step(batch, generator=None) -> metrics.

    batch: (B, H, W, 3) float in [0, 1] or uint8, moved to the model's
    device; generator: the noise's torch.Generator on that device (torch's
    default there when None). The step runs model(batch, training=True),
    rd_loss(out, batch, lambda_val)["loss"].backward(), optimizer.step() and
    optimizer.zero_grad(set_to_none=True). The metrics are rd_loss's dict,
    detached, still on the device: the step never waits for the card.

    With clip_grad_norm > 0 the gradients are clipped to that global norm
    (``clip_by_global_norm``) between the backward and the optimizer's
    step; the JAX package chains optax.clip_by_global_norm before its
    optimizer, and torch has no optimizer chain.

    With ema_decay in (0, 1) the step also keeps an exponential moving
    average of the parameters, e <- e + (1 - d) * (p - e) after each update,
    starting from the parameters as they are now: ``step.ema_params``, a
    dict name -> tensor (None without ema_decay).

    With levels (the lambda ladder of a variable-rate model, ``models.
    gained``), each step draws one level n uniformly in [0, N) on the
    device from ``generator``, before the noise (the JAX step splits its
    level key first), forwards at that level and weights the loss with
    levels[n], read from a device tensor (lambda_val is unused): the host
    never waits for the draw.
    """
    if ema_decay is not None and not (0.0 < ema_decay < 1.0):
        raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
    if clip_grad_norm is not None and clip_grad_norm <= 0.0:
        raise ValueError(f"clip_grad_norm must be > 0, got {clip_grad_norm}")
    named = list(model.named_parameters())
    device = named[0][1].device
    lam_table = None if levels is None else torch.tensor(levels, dtype=torch.float32,
                                                         device=device)
    ema: Optional[Dict[str, torch.Tensor]] = None
    if ema_decay is not None:
        ema = {name: p.detach().clone() for name, p in named}
        ema_list = list(ema.values())
        params = [p for _, p in named]

    def step(batch, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        x = batch_to_device(batch, device)
        if lam_table is None:
            kwargs, lam = {}, lambda_val
        else:
            n = torch.randint(0, lam_table.shape[0], (1,), device=device, generator=generator)
            kwargs, lam = {"level": n[0]}, lam_table.index_select(0, n)[0]
        metrics = rd_loss(model(x, training=True, generator=generator, **kwargs), x, lam)
        metrics["loss"].backward()
        if clip_grad_norm is not None:
            clip_by_global_norm([p.grad for _, p in named if p.grad is not None],
                                clip_grad_norm)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        if ema is not None:
            with torch.no_grad():
                torch._foreach_lerp_(ema_list, params, 1.0 - ema_decay)
        return {k: v.detach() for k, v in metrics.items()}

    step.ema_params = ema
    return step
