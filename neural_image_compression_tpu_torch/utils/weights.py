"""Carry the JAX package's flax parameters into the port.

The port's modules are named after the JAX parameter tree (``encoder.
Conv2d_0``, ``decoder.GDN_1``, ``context_model.MaskedConv2d_0``, the
checkerboard's ``context_model.Conv2d_0``, the channel-conditional model's
``spatial_ctx_0`` and ``channel_ctx_1.Conv2d_0``, the residual transforms'
``decoder.ResidualBlockUpsample_0.TransposedDeconv3x3_1.Deconv2d_0``, ...),
so a tree leaf at path ``a/b/leaf`` becomes the ``state_dict`` entry
``a.b.<name>`` with a layout change where the two frameworks differ, chosen
by the leaf's immediate module. The walk goes by names alone, so it serves
every family (joint-AR, checkerboard, hyperprior, channel-conditional
checkerboard, factorized prior, and the gained variants of the first four)
with either transform:

* conv kernel (HWIO, under ``Conv2d_*`` / ``MaskedConv2d_*``, or directly
  under a bare conv the model names itself, ``spatial_ctx_*``) -> ``weight``
  OIHW;
* deconv kernel (under ``Deconv2d_*``: a direct-conv HWIO kernel, the
  spatial flip of torch's) -> ``weight`` in ConvTranspose2d's (in, out, kh,
  kw) with the flip undone;
* conv biases, GDN ``beta``/``gamma`` (gamma stays (C_in, C_out)), the
  factorized ``matrix_i``/``bias_i``/``factor_i``, the gained families'
  top-level (N, M) ``gain_y``/``igain_y``/``gain_z``/``igain_z`` and the
  backbones' BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
  (batch_stats) -> the same name, as is.

The scalable model's tree (``context_model_1``/``_2``,
``entropy_parameters_1``/``_2``, ``LST``) walks the same way. A backbone's
flax variables (``{"params", "batch_stats"}`` under ``layers_{i}_0``) go
through ``load_jax_variables`` and come back from ``variables_to_jax``.

Leaves are numpy arrays (or anything ``np.asarray`` takes). Each leaf maps
to exactly one key; a key the model lacks, or one it has that the tree does
not fill, raises. ``joint_ar_params_to_jax`` is the exact inverse: a model's
parameters back to the flax tree (the portable card quantizes flax-layout
kernels, where a deconv kernel is the flipped direct-conv one).
"""

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

# the variable-rate families' (N, M) gain tables: top-level leaves, as they are
_GAIN_LEAVES = ("gain_y", "igain_y", "gain_z", "igain_z")
# module names whose kernels are direct convolutions: flax's auto-named conv
# modules, and the bare convs a model names itself (channel_cb.py's
# spatial_ctx_{i}, a GraphBackbone's layers_{i}_0)
_CONV_MODULES = ("Conv2d_", "MaskedConv2d_", "spatial_ctx_", "layers_")
# leaves that carry across as they are (BatchNorm's mean and var are flax's
# batch_stats collection; everything else is its params)
_AS_IS = ("bias", "beta", "gamma", "scale", "mean", "var")
_BATCH_STATS = ("mean", "var")


def _convert(path: str, module: str, leaf: str, value: np.ndarray):
    if module == "" and leaf in _GAIN_LEAVES:
        return leaf, value
    if leaf == "kernel":
        if module.startswith("Deconv2d_"):
            # (kh, kw, in, out) direct-conv kernel -> torch (in, out, kh, kw), unflipped
            return "weight", np.transpose(value, (2, 3, 0, 1))[:, :, ::-1, ::-1]
        if module.startswith(_CONV_MODULES):
            return "weight", np.transpose(value, (3, 2, 0, 1))
        raise KeyError(f"{path}: kernel under an unknown module kind {module!r}")
    if leaf in _AS_IS or leaf.startswith(("matrix_", "bias_", "factor_")):
        return leaf, value
    raise KeyError(f"{path}: unknown parameter name {leaf!r}")


def joint_ar_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree of a model (the ``params`` collection of the JAX
    package's JointAutoregressiveHierarchical, CheckerboardHierarchical,
    MeanScaleHyperprior, ChannelCheckerboardHierarchical or FactorizedPrior)
    -> the port's state_dict (CPU tensors)."""
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


def _to_jax(key: str, value: np.ndarray):
    path = key.split(".")
    module, leaf = (path[-2] if len(path) > 1 else ""), path[-1]
    if module == "" and leaf in _GAIN_LEAVES:
        return leaf, value
    if leaf == "weight":
        if module.startswith("Deconv2d_"):
            # torch (in, out, kh, kw) -> the flipped direct-conv kernel (kh, kw, in, out)
            return "kernel", np.transpose(value[:, :, ::-1, ::-1], (2, 3, 0, 1))
        if module.startswith(_CONV_MODULES):
            return "kernel", np.transpose(value, (2, 3, 1, 0))
        raise KeyError(f"{key}: weight under an unknown module kind {module!r}")
    if leaf in _AS_IS or leaf.startswith(("matrix_", "bias_", "factor_")):
        return leaf, value
    raise KeyError(f"{key}: unknown parameter name {leaf!r}")


def joint_ar_params_to_jax(model: nn.Module) -> Dict:
    """The model's parameters as the flax ``params`` tree of the same family
    in the JAX package: float32 numpy copies (whatever the model's dtype) in
    the JAX layouts, the inverse of ``joint_ar_state_from_jax``."""
    params: Dict = {}
    for key, tensor in model.state_dict().items():
        leaf, value = _to_jax(key, tensor.detach().to("cpu", torch.float32).numpy())
        node = params
        for name in key.split(".")[:-1]:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(value)
    return params


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


def _merged(a: Mapping, b: Mapping) -> Dict:
    out = dict(a)
    for name, sub in b.items():
        out[name] = _merged(out.get(name, {}), sub) if isinstance(sub, Mapping) else sub
    return out


def load_jax_variables(model: nn.Module, variables: Mapping, strict: bool = True) -> nn.Module:
    """Copy a flax variables dict (collection name -> tree: a backbone's
    ``params`` and ``batch_stats``) into ``model``: the collections merge
    into one tree, which ``load_jax_params`` loads."""
    merged: Dict = {}
    for tree in variables.values():
        merged = _merged(merged, tree)
    return load_jax_params(model, merged, strict)


def variables_to_jax(model: nn.Module) -> Dict:
    """The model's weights as flax variables: {"params": ..., "batch_stats":
    ...}, BatchNorm's mean and var in the second (``joint_ar_params_to_jax``
    split by leaf name)."""
    def split(tree: Mapping, stats: bool) -> Dict:
        out = {}
        for name, sub in tree.items():
            if isinstance(sub, Mapping):
                sub = split(sub, stats)
                if sub:
                    out[name] = sub
            elif (name in _BATCH_STATS) == stats:
                out[name] = sub
        return out

    tree = joint_ar_params_to_jax(model)
    return {"params": split(tree, False), "batch_stats": split(tree, True)}
