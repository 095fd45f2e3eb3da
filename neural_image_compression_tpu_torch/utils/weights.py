"""Carry the JAX package's flax parameters into the port.

The port's modules are named after the JAX parameter tree (``encoder.
Conv2d_0``, ``decoder.GDN_1``, ``context_model.MaskedConv2d_0``, ...), so a
tree leaf at path ``a/b/leaf`` becomes the ``state_dict`` entry ``a.b.<name>``
with a layout change where the two frameworks differ:

* conv kernel (HWIO, under ``Conv2d_*`` / ``MaskedConv2d_*``) -> ``weight``
  OIHW;
* deconv kernel (under ``Deconv2d_*``: a direct-conv HWIO kernel, the
  spatial flip of torch's) -> ``weight`` in ConvTranspose2d's (in, out, kh,
  kw) with the flip undone;
* conv biases, GDN ``beta``/``gamma`` (gamma stays (C_in, C_out)) and the
  factorized ``matrix_i``/``bias_i``/``factor_i`` -> the same name, as is.

Leaves are numpy arrays (or anything ``np.asarray`` takes). Each leaf maps
to exactly one key; a key the model lacks, or one it has that the tree does
not fill, raises.
"""

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _convert(path: str, module: str, leaf: str, value: np.ndarray):
    if leaf == "kernel":
        if module.startswith("Deconv2d_"):
            # (kh, kw, in, out) direct-conv kernel -> torch (in, out, kh, kw), unflipped
            return "weight", np.transpose(value, (2, 3, 0, 1))[:, :, ::-1, ::-1]
        if module.startswith(("Conv2d_", "MaskedConv2d_")):
            return "weight", np.transpose(value, (3, 2, 0, 1))
        raise KeyError(f"{path}: kernel under an unknown module kind {module!r}")
    if leaf in ("bias", "beta", "gamma") or leaf.startswith(("matrix_", "bias_", "factor_")):
        return leaf, value
    raise KeyError(f"{path}: unknown parameter name {leaf!r}")


def joint_ar_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree of models.joint_ar.JointAutoregressiveHierarchical
    (the ``params`` collection) -> the port's state_dict (CPU tensors)."""
    state: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: tuple):
        for name, sub in tree.items():
            path = prefix + (name,)
            if isinstance(sub, Mapping):
                walk(sub, path)
                continue
            module = prefix[-1] if prefix else ""
            leaf, value = _convert("/".join(path), module, name, np.asarray(sub))
            key = ".".join(prefix + (leaf,))
            if key in state:
                raise KeyError(f"{'/'.join(path)} maps onto {key}, which another leaf filled")
            state[key] = torch.tensor(np.ascontiguousarray(value, dtype=np.float32))

    walk(params, ())
    return state


def load_jax_params(model: nn.Module, params: Mapping, strict: bool = True) -> nn.Module:
    """Copy a JAX parameter tree into ``model`` (on whatever device it is)."""
    state = joint_ar_state_from_jax(params)
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    unexpected = sorted(set(state) - set(expected))
    if strict and (missing or unexpected):
        raise KeyError(f"JAX params do not fit the model: missing {missing}, "
                       f"unexpected {unexpected}")
    for key, value in state.items():
        if key in expected and expected[key].shape != value.shape:
            raise ValueError(f"{key}: JAX shape {tuple(value.shape)} vs model "
                             f"shape {tuple(expected[key].shape)}")
    model.load_state_dict(state, strict=strict)
    return model
