"""The train and eval steps, port of parallel/train_step.py
(``make_train_step``, ``make_eval_step``, ``shard_batch``, ``replicate``):
the model's forward with noise quantization, the rate-distortion loss, its
backward (through the GDN and mixture-likelihood backward kernels on a card)
and the caller's optimizer, on one device or over a device mesh
(``parallel.mesh``).

PyTorch's idiom replaces the JAX step's pure (params, opt_state) threading:
the step updates the model and the optimizer in place and returns only the
metrics. Over a mesh each rank runs this same step on its own piece of the
global batch (``shard_batch``), one device a rank, and the collectives are
explicit where XLA inserts them in JAX.
"""

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.distributed.tensor import Shard

from neural_image_compression_tpu_torch.models.joint_ar import RowShardNoise
from neural_image_compression_tpu_torch.parallel.mesh import (
    axis_group, axis_index, axis_size, batch_sharding,
)
from neural_image_compression_tpu_torch.parallel.tp import gather_shard, leaf_sharding


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


def _all_reduce_mean(tensors: List[torch.Tensor], group, size: int) -> None:
    """Average ``tensors`` in place over ``group``: one flattened all-reduce
    a dtype (one bucket for a float32 model)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = _flatten_dense_tensors(same)
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        for t, averaged in zip(same, _unflatten_dense_tensors(flat, same)):
            t.copy_(averaged)


class _TensorParallel:
    """The "model" dimension of a mesh step (``parallel.tp``): the
    optimizer steps this rank's shards of the parameters (its state is
    sharded with them), the gradients come to the shards by reduce-scatter
    and the whole weights go back into the model by all-gather after each
    update."""

    def __init__(self, named, optimizer: torch.optim.Optimizer, mesh):
        self.group, self.size = axis_group(mesh, "model"), axis_size(mesh, "model")
        self.params = [p for _, p in named]
        self.layouts = [leaf_sharding(name, p, mesh) for name, p in named]
        self.shards = [nn.Parameter(layout.local(p.detach()).contiguous().clone())
                       for p, layout in zip(self.params, self.layouts)]
        swap = dict(zip(self.params, self.shards))
        for group in optimizer.param_groups:
            group["params"] = [swap[p] for p in group["params"]]
        for p, layout in zip(self.params, self.layouts):
            if p in optimizer.state:  # state of earlier steps: keep this rank's part
                optimizer.state[swap[p]] = {
                    k: (layout.local(v).contiguous().clone()
                        if isinstance(v, torch.Tensor) and v.shape == p.shape else v)
                    for k, v in optimizer.state.pop(p).items()}

    def scatter_grads(self) -> None:
        """Each shard's gradient: the reduce-scatter of the whole averaged
        gradients over "model", divided by its size (every "model" rank
        holds the same rows, so the mean is that gradient). A replicated
        leaf's gradient is all-reduced the same way, so that ranks whose
        cuDNN sums differ in the last bits keep one copy of it."""
        for p, shard, layout in zip(self.params, self.shards, self.layouts):
            if p.grad is None:
                shard.grad = None
                continue
            axis = next((q.dim for q in layout.placements if isinstance(q, Shard)), None)
            if axis is None:
                grad = p.grad.clone()
                dist.all_reduce(grad, group=self.group)
            else:
                grad = torch.empty_like(shard)
                dist.reduce_scatter(grad, [c.contiguous() for c in p.grad.chunk(self.size, axis)],
                                    group=self.group)
            shard.grad = grad.div_(self.size)
            p.grad = None

    @torch.no_grad()
    def gather_params(self) -> None:
        for p, shard, layout in zip(self.params, self.shards, self.layouts):
            p.copy_(gather_shard(shard, layout))

    @torch.no_grad()
    def reshard(self) -> None:
        """Each shard anew from the model's whole weights (after a load)."""
        for p, shard, layout in zip(self.params, self.shards, self.layouts):
            shard.copy_(layout.local(p))

    def _positions(self, optimizer):
        """The optimizer's state_dict indices -> positions in self.params."""
        where = {id(s): k for k, s in enumerate(self.shards)}
        return [where[id(p)] for g in optimizer.param_groups for p in g["params"]]

    def optimizer_state_dict(self, optimizer: torch.optim.Optimizer) -> dict:
        """The optimizer's state_dict with each sharded state tensor gathered
        whole (a collective: every "model" rank calls it)."""
        sd = optimizer.state_dict()
        positions = self._positions(optimizer)
        for i, state in sd["state"].items():
            shard, layout = self.shards[positions[i]], self.layouts[positions[i]]
            sd["state"][i] = {k: (gather_shard(v, layout) if isinstance(v, torch.Tensor)
                                  and v.dim() and v.shape == shard.shape else v)
                              for k, v in state.items()}
        return sd

    def load_optimizer_state_dict(self, optimizer: torch.optim.Optimizer, sd: dict) -> None:
        """Load a whole optimizer state_dict (``optimizer_state_dict``'s) as
        this rank's shards, and the shards of the model's weights."""
        self.reshard()
        positions = self._positions(optimizer)
        state = {}
        for i, st in sd["state"].items():
            p, layout = self.params[positions[int(i)]], self.layouts[positions[int(i)]]
            state[i] = {k: (layout.local(v).contiguous().clone() if isinstance(v, torch.Tensor)
                            and v.dim() and v.shape == p.shape else v)
                        for k, v in st.items()}
        optimizer.load_state_dict({**sd, "state": state})


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, rd_loss: Callable,
                    lambda_val: float, ema_decay: Optional[float] = None,
                    clip_grad_norm: Optional[float] = None,
                    levels: Optional[Sequence[float]] = None, mesh=None):
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

    With a mesh (``parallel.make_mesh``) the step is data parallel over its
    "data" dimension: the model's weights are broadcast from rank 0 when the
    step is built, batch is this rank's rows of the global batch
    (``shard_batch``), and after the backward one flattened all-reduce
    averages the gradients over "data", before the clipping, so that the
    clipping, the optimizer and the EMA see the global batch's gradient as
    in JAX. The 0-dim metrics ride the same all-reduce (their mean over the
    ranks: the global batch's loss, bpp and MSE; PSNR is the ranks' mean).
    generator is then required and must be in one state on every rank: each
    rank's rows get the noise that a one-rank step on the global batch
    would draw for them (``models.RowShardNoise``), and the level draw is
    the same on every rank. With a "model" dimension the optimizer steps
    this rank's shards of the parameters instead (``parallel.tp``): build
    it over ``model.parameters()`` and the step rebinds it to the shards.
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

    tp = None
    if mesh is not None:
        replicate(model, mesh)
        data_group, data_size = axis_group(mesh, "data"), axis_size(mesh, "data")
        data_index = axis_index(mesh, "data")
        if "model" in mesh.mesh_dim_names:
            tp = _TensorParallel(named, optimizer, mesh)

    def step(batch, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        x = batch_to_device(batch, device)
        noise = generator
        if mesh is not None:
            if generator is None:
                raise ValueError("a mesh step needs the noise generator, in one state on "
                                 "every rank")
            noise = RowShardNoise(generator, data_index, data_size)
        if lam_table is None:
            kwargs, lam = {}, lambda_val
        else:
            n = torch.randint(0, lam_table.shape[0], (1,), device=device, generator=generator)
            kwargs, lam = {"level": n[0]}, lam_table.index_select(0, n)[0]
        metrics = rd_loss(model(x, training=True, generator=noise, **kwargs), x, lam)
        metrics["loss"].backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        grads = [p.grad for _, p in named if p.grad is not None]
        if mesh is not None:
            scalars = [k for k, v in metrics.items() if v.dim() == 0]
            averaged = [*grads, *(metrics[k] for k in scalars)]
            _all_reduce_mean(averaged, data_group, data_size)
        if clip_grad_norm is not None:
            clip_by_global_norm(grads, clip_grad_norm)
        if tp is not None:
            tp.scatter_grads()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        if tp is not None:
            tp.gather_params()
        if ema is not None:
            with torch.no_grad():
                torch._foreach_lerp_(ema_list, params, 1.0 - ema_decay)
        return metrics

    step.ema_params = ema
    step.tensor_parallel = tp
    return step


def make_eval_step(model: nn.Module, mesh=None, spatial: bool = False):
    """Build forward(batch) -> model(batch, training=False)'s outputs.

    batch: (B, H, W, 3) float in [0, 1] or uint8, moved to the model's
    device. With a mesh, batch is this rank's piece of the global batch and
    the outputs are those of its rows: its rows (``shard_batch``), or with
    spatial=True and a "spatial" dimension its rows' H-slab
    (``spatial_sharding(mesh).local``), which the step all-gathers over
    "spatial" into whole images before the forward. That saves no memory:
    every rank of a "spatial" group runs the whole images of its rows, and
    XLA's halo exchange, which lets JAX convolve slabs apart, has no
    counterpart here. With a "model" dimension the model holds whole
    weights (the train step gathers them), so the forward is as without
    one."""
    device = next(model.parameters()).device
    group = axis_group(mesh, "spatial") if (mesh is not None and spatial) else None

    def forward(batch) -> Dict[str, torch.Tensor]:
        x = batch_to_device(batch, device)
        if group is not None:
            slabs = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
            dist.all_gather(slabs, x.contiguous(), group=group)
            x = torch.cat(slabs, dim=1)
        return model(x, training=False)

    return forward


def shard_batch(batch, mesh) -> torch.Tensor:
    """This rank's rows of the global batch (an array or a tensor, left on
    its device): the batch over "data"."""
    return batch_sharding(mesh).local(torch.as_tensor(batch))


@torch.no_grad()
def replicate(tree, mesh):
    """Broadcast every tensor of ``tree`` (a module's state, or a mapping of
    tensors) from rank 0, in place; returns tree. ``mesh`` names the ranks:
    the whole world, which every mesh spans."""
    tensors = (list(tree.state_dict().values()) if isinstance(tree, nn.Module)
               else list(tree.values()))
    for t in tensors:
        dist.broadcast(t, src=0)
    return tree
