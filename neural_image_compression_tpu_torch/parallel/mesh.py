"""Process groups and the device mesh, port of parallel/mesh.py.

PyTorch runs one process per device: a mesh is a ``torch.distributed``
``DeviceMesh`` over the world's ranks, with the JAX package's dimension
names:

  * ``"data"``: the batch axis. Each rank steps on its rows of the global
    batch and the gradients are averaged over this axis
    (``parallel.make_train_step``).
  * ``"spatial"``: image rows (H) for large-image evaluation
    (``parallel.make_eval_step(spatial=True)``).
  * ``"model"``: channels (``parallel.tp``). The ~10-40M-parameter families
    of this package fit one card many times over, so this is a capability
    and a template for wider models, not a speedup.

``"model"`` is the innermost dimension (neighbouring ranks) and ``"data"``
the outermost, as in JAX; a dimension of size 1 drops its name. Layouts
(``batch_sharding``, ``spatial_sharding``, ``replicated``) are the mesh with
one DTensor placement per mesh dimension; ``Sharding.local`` cuts a rank's
piece out of a whole tensor. The kernels never see a DTensor: the steps
hand them this rank's plain tensors.
"""

import datetime
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Placement, Replicate, Shard

# how long a rank waits for the others at init_distributed (JAX's default
# initialization timeout is 300 s as well)
INIT_TIMEOUT = datetime.timedelta(seconds=300)


def _backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the process group, once a process, before ``make_mesh``: NCCL
    where there is a card, gloo on the CPU.

    With no arguments the settings come from the environment torchrun sets
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); without WORLD_SIZE there
    is one process and nothing to join. coordinator_address ("host:port"
    or "tcp://host:port"), num_processes and process_id name them instead;
    then a failure to reach the coordinator raises, since a rank that went
    on alone would train an independent replica. A second call does
    nothing. On a card each rank takes the card LOCAL_RANK names (its
    process_id modulo the card count without it), so ``resolve_device``'s
    ``cuda`` is the rank's own card."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None and process_id is None:
        if "WORLD_SIZE" not in os.environ:
            return
        rank, world, init_method = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("coordinator_address, num_processes and process_id go together")
        rank, world = process_id, num_processes
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    backend = _backend()
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=INIT_TIMEOUT)


def process_index() -> int:
    """This rank in the world's group (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The world's size (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_shape(n: int, spatial: int = 1, model: int = 1) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, dimension names) of the mesh over n ranks: (data,) by
    default, then spatial and model where they exceed 1."""
    inner = spatial * model
    if n % inner:
        raise ValueError(f"{n} devices not divisible by spatial={spatial} * model={model}")
    shape, names = [n // inner], ["data"]
    if spatial > 1:
        shape.append(spatial)
        names.append("spatial")
    if model > 1:
        shape.append(model)
        names.append("model")
    return tuple(shape), tuple(names)


def make_mesh(n_devices: Optional[int] = None, spatial: int = 1, model: int = 1) -> DeviceMesh:
    """The mesh over every rank of the process group (``init_distributed``
    first): (data,) by default, else (data, spatial, model) without the
    dimensions of size 1. n_devices, where given, must be the world's size:
    each rank holds one device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed() "
                           "(or run under torchrun) first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh spans the world's {world} ranks, one device each; got "
                         f"n_devices={n_devices}")
    shape, names = mesh_shape(n, spatial, model)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


class Sharding(NamedTuple):
    """A layout over a mesh: one DTensor placement per mesh dimension."""
    mesh: DeviceMesh
    placements: Tuple[Placement, ...]

    def local(self, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a whole tensor: along each dimension that a
        ``Shard`` names, the rank's equal part (which must divide)."""
        for mesh_dim, placement in enumerate(self.placements):
            if isinstance(placement, Shard):
                size = self.mesh.size(mesh_dim)
                axis = placement.dim
                if tensor.shape[axis] % size:
                    raise ValueError(f"axis {axis} of {tuple(tensor.shape)} does not divide "
                                     f"over {size} ranks of '{self.mesh.mesh_dim_names[mesh_dim]}'")
                part = tensor.shape[axis] // size
                start = self.mesh.get_local_rank(mesh_dim) * part
                tensor = tensor.narrow(axis, start, part)
        return tensor


def _layout(mesh: DeviceMesh, shards: Sequence[Tuple[str, int]]) -> Sharding:
    by_name = dict(shards)
    return Sharding(mesh, tuple(Shard(by_name[name]) if name in by_name else Replicate()
                                for name in mesh.mesh_dim_names))


def batch_sharding(mesh: DeviceMesh) -> Sharding:
    """The leading (batch) axis sharded over "data"."""
    return _layout(mesh, [("data", 0)])


def spatial_sharding(mesh: DeviceMesh) -> Sharding:
    """NHWC images: the batch over "data", H over "spatial" (if present)."""
    return _layout(mesh, [("data", 0), ("spatial", 1)])


def replicated(mesh: DeviceMesh) -> Sharding:
    return _layout(mesh, [])


def axis_group(mesh: DeviceMesh, name: str):
    """The process group of mesh dimension ``name``; None where the mesh
    lacks it (a dimension of size 1)."""
    return mesh.get_group(name) if name in mesh.mesh_dim_names else None


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name)) if name in mesh.mesh_dim_names else 1


def axis_index(mesh: DeviceMesh, name: str) -> int:
    return mesh.get_local_rank(name) if name in mesh.mesh_dim_names else 0
