"""Tensor (channel) parallelism over the mesh's "model" dimension, port of
parallel/tp.py.

The JAX package writes the layout as GSPMD annotations and lets XLA insert
the collectives. Here the same rule picks each leaf's layout and the train
step (``parallel.make_train_step`` with a "model" dimension) does the
collectives by hand: each rank keeps its shards of the parameters and of
the optimizer's state, gathers the whole weights after each update (the
modules and the kernels always see whole, plain tensors), and takes its
shard of the averaged gradient by reduce-scatter. The families of this
package fit one card many times over, so this is a capability and a
template for wider models, not a speedup (and with one H100 there is no
second card to shard over).

The rule, by leaf path and shape, is JAX's, read in the port's layouts:
the axis JAX shards is the trailing axis of its layout (a conv kernel's
output channels, a bias's or GDN beta's channels, GDN gamma's output
columns, a gain table's channels), which is axis 0 of a torch conv weight
(out, in, kh, kw) and axis 1 of a transposed conv's (in, out, kh, kw); the
factorized entropy model's leaves shard axis 0 (its channel axis) in both.
A leaf whose axis does not divide over the "model" ranks (the M -> 3 RGB
layer) and every 0-dim leaf stay replicated. Trees are mappings of tensors,
flat (a ``state_dict``) or nested (an optimizer's state under parameter
names): the rule reads the path's last two names.
"""

from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from neural_image_compression_tpu_torch.parallel.mesh import Sharding, replicated


def channel_axis(path: str, shape) -> Optional[int]:
    """The axis that the JAX rule shards, in the port's layout; None for a
    0-dim leaf."""
    if len(shape) == 0:
        return None
    if "factorized_entropy_model" in path:
        return 0
    names = path.split(".")
    module = names[-2] if len(names) > 1 else ""
    if names[-1] == "weight" and len(shape) == 4:
        return 1 if module.startswith("Deconv2d_") else 0
    return len(shape) - 1


def _map(fn, tree: Mapping, prefix: str = "") -> dict:
    return {name: (_map(fn, sub, f"{prefix}{name}.") if isinstance(sub, Mapping)
                   else fn(f"{prefix}{name}", sub))
            for name, sub in tree.items()}


def leaf_sharding(path: str, leaf: torch.Tensor, mesh: DeviceMesh) -> Sharding:
    if "model" not in mesh.mesh_dim_names:
        return replicated(mesh)
    model_dim = mesh.mesh_dim_names.index("model")
    axis = channel_axis(path, leaf.shape)
    if axis is None or leaf.shape[axis] % mesh.size(model_dim):
        return replicated(mesh)
    return Sharding(mesh, tuple(Shard(axis) if d == model_dim else Replicate()
                                for d in range(mesh.ndim)))


def tp_shardings(tree: Mapping, mesh: DeviceMesh) -> Any:
    """The tree with each tensor leaf replaced by its ``Sharding``: channel
    axes over "model"; every leaf replicated without a "model" dimension.
    Non-tensor leaves (an optimizer's step count as an int) stay
    replicated."""
    return _map(lambda path, leaf: (leaf_sharding(path, leaf, mesh)
                                    if isinstance(leaf, torch.Tensor) else replicated(mesh)),
                tree)


def shard_params(tree: Mapping, mesh: DeviceMesh) -> Any:
    """The tree with each tensor leaf replaced by this rank's shard of it
    (a contiguous copy; replicated leaves are copied whole)."""
    return _map(lambda path, leaf: (leaf_sharding(path, leaf, mesh).local(leaf).contiguous().clone()
                                    if isinstance(leaf, torch.Tensor) else leaf),
                tree)


def gather_shard(shard: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The whole tensor from every "model" rank's shard (``sharding`` as
    ``leaf_sharding`` gives it); a replicated leaf comes back as it is."""
    for mesh_dim, placement in enumerate(sharding.placements):
        if isinstance(placement, Shard):
            group = sharding.mesh.get_group(mesh_dim)
            parts = [torch.empty_like(shard) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, shard.contiguous(), group=group)
            shard = torch.cat(parts, dim=placement.dim)
    return shard
