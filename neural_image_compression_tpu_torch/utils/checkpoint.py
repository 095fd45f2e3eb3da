"""Single-file checkpoints on torch.save, port of utils/checkpoint.py.

A checkpoint is one file holding {"state": ..., "aux": ...}: ``state`` a
dict of tensors and state dicts (model, optimizer, generator, EMA), ``aux``
a small dict of Python scalars, strings, lists and dicts (the step, the
plateau controller). It is written to a temporary file and moved into
place with ``os.replace``, so a preemption mid-write leaves the previous
checkpoint whole. It loads with ``weights_only=True``: tensors and plain
containers only, nothing that runs code.
"""

import os
from typing import Any, Optional, Tuple

import torch


def save_checkpoint(path: str, state: Any, aux: Optional[dict] = None) -> None:
    """Write ``state`` (and ``aux``) to ``path`` atomically."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"state": state, "aux": aux}, tmp)
    os.replace(tmp, path)


def _load(path: str, map_location=None, mmap: bool = False) -> dict:
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True,
                      mmap=mmap)


def restore_checkpoint(path: str, map_location=None) -> Tuple[Any, Optional[dict]]:
    """(state, aux) of a checkpoint written by save_checkpoint, its tensors
    on ``map_location`` (their saved devices when None)."""
    ckpt = _load(path, map_location)
    return ckpt["state"], ckpt["aux"]


def restore_raw(path: str, map_location=None) -> Any:
    """The whole saved state tree (what ``save_checkpoint`` was given, as
    nested dicts), without its aux: the JAX package's ``restore_raw``, which
    restores without a template and keeps aux in a side file."""
    return _load(path, map_location)["state"]


def checkpoint_keys(path: str) -> set:
    """Top-level keys of a checkpoint's state, read through a memory map
    (no tensor data is copied). Lets a caller adapt to what the checkpoint
    holds, e.g. a checkpoint written without an EMA."""
    return set(_load(path, "cpu", mmap=True)["state"].keys())


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(os.path.abspath(path))
