"""Import the reference's (PyTorch) checkpoints, port of utils/torch_import.py.

Maps a state_dict of the reference's JointAutoregressiveHierarchical or
HierarchicalMixtureResidual onto the flax-layout parameter tree that
``utils.weights.load_jax_params`` takes (``joint_ar_params_from_torch``),
so a reference checkpoint loads into the port's
``JointAutoregressiveHierarchical(transform=...)`` without the JAX package:

    params = load_reference_checkpoint("ckpt.pth", transform="res3x3")
    load_jax_params(HierarchicalMixtureResidual(M, K), params)

Layouts, as the JAX package's importer converts them:

* Conv2d weights (O, I, kh, kw) -> HWIO (kh, kw, I, O).
* ConvTranspose2d weights (I, O, kh, kw) -> direct-conv HWIO kernels: both
  spatial dims flipped, I/O kept.
* GDN beta/gamma in the same sqrt+pedestal form (ops/bound.py); gamma
  transposed to (C_in, C_out).
* The factorized bottleneck's ``matrices.i`` / ``biases.i`` / ``factors.i``
  -> ``matrix_i`` / ``bias_i`` / ``factor_i``, shapes unchanged.

The scalable model's and the YOLO backbone's mappings are not ported.
"""

from typing import Callable, Dict, Mapping

import numpy as np
import torch

Array = np.ndarray
StateDict = Mapping[str, Array]


def _conv_kernel(w: Array) -> Array:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _deconv_kernel(w: Array) -> Array:
    return np.ascontiguousarray(np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1)))


def _conv(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return {"kernel": _conv_kernel(sd[prefix + ".weight"]),
            "bias": np.asarray(sd[prefix + ".bias"])}


def _deconv(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return {"kernel": _deconv_kernel(sd[prefix + ".weight"]),
            "bias": np.asarray(sd[prefix + ".bias"])}


def _gdn(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return {"beta": np.asarray(sd[prefix + ".beta"]),
            "gamma": np.ascontiguousarray(sd[prefix + ".gamma"].T)}


def _td3x3(sd: StateDict, prefix: str) -> Dict[str, Array]:
    """The reference's TransposedDeconv3x3 wrapper (its ``deconv``)."""
    return {"Deconv2d_0": _deconv(sd, prefix + ".deconv")}


def _residual_block(sd: StateDict, prefix: str) -> Dict[str, Array]:
    out = {"Conv2d_0": _conv(sd, prefix + ".conv1"),
           "Conv2d_1": _conv(sd, prefix + ".conv2")}
    if prefix + ".skip.weight" in sd:
        out["Conv2d_2"] = _conv(sd, prefix + ".skip")
    return out


def _residual_block_stride(sd: StateDict, prefix: str) -> Dict[str, Array]:
    out = _residual_block(sd, prefix)
    out["GDN_0"] = _gdn(sd, prefix + ".gdn")
    return out


def _residual_block_upsample(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return {"TransposedDeconv3x3_0": _td3x3(sd, prefix + ".subpel_conv"),
            "Conv2d_0": _conv(sd, prefix + ".conv"),
            "GDN_0": _gdn(sd, prefix + ".igdn"),
            "TransposedDeconv3x3_1": _td3x3(sd, prefix + ".upsample")}


def _seq(sd: StateDict, prefix: str, layout) -> Dict[str, Array]:
    """A torch nn.Sequential: layout = [(net index, flax name, mapper), ...]."""
    return {name: fn(sd, f"{prefix}.net.{i}") for i, name, fn in layout}


def _encoder5x5(sd, p):
    return _seq(sd, p, [(0, "Conv2d_0", _conv), (1, "GDN_0", _gdn),
                        (2, "Conv2d_1", _conv), (3, "GDN_1", _gdn),
                        (4, "Conv2d_2", _conv), (5, "GDN_2", _gdn),
                        (6, "Conv2d_3", _conv)])


def _decoder5x5(sd, p):
    return _seq(sd, p, [(0, "Deconv2d_0", _deconv), (1, "GDN_0", _gdn),
                        (2, "Deconv2d_1", _deconv), (3, "GDN_1", _gdn),
                        (4, "Deconv2d_2", _deconv), (5, "GDN_2", _gdn),
                        (6, "Deconv2d_3", _deconv)])


def _hyper_encoder5x5(sd, p):
    return _seq(sd, p, [(0, "Conv2d_0", _conv), (2, "Conv2d_1", _conv),
                        (4, "Conv2d_2", _conv)])


def _hyper_decoder5x5(sd, p):
    return _seq(sd, p, [(0, "Deconv2d_0", _deconv), (2, "Deconv2d_1", _deconv),
                        (4, "Conv2d_0", _conv)])


def _encoder3x3(sd, p):
    return _seq(sd, p, [(0, "ResidualBlockWithStride_0", _residual_block_stride),
                        (1, "ResidualBlock_0", _residual_block),
                        (2, "ResidualBlockWithStride_1", _residual_block_stride),
                        (3, "ResidualBlock_1", _residual_block),
                        (4, "ResidualBlockWithStride_2", _residual_block_stride),
                        (5, "ResidualBlock_2", _residual_block),
                        (6, "Conv2d_0", _conv)])


def _decoder3x3(sd, p):
    return _seq(sd, p, [(0, "ResidualBlock_0", _residual_block),
                        (1, "ResidualBlockUpsample_0", _residual_block_upsample),
                        (2, "ResidualBlock_1", _residual_block),
                        (3, "ResidualBlockUpsample_1", _residual_block_upsample),
                        (4, "ResidualBlock_2", _residual_block),
                        (5, "ResidualBlockUpsample_2", _residual_block_upsample),
                        (6, "ResidualBlock_3", _residual_block),
                        (7, "TransposedDeconv3x3_0", _td3x3)])


def _hyper_encoder3x3(sd, p):
    return _seq(sd, p, [(0, "Conv2d_0", _conv), (2, "Conv2d_1", _conv),
                        (4, "Conv2d_2", _conv), (6, "Conv2d_3", _conv),
                        (8, "Conv2d_4", _conv)])


def _hyper_decoder3x3(sd, p):
    return _seq(sd, p, [(0, "Conv2d_0", _conv),
                        (2, "TransposedDeconv3x3_0", _td3x3),
                        (4, "Conv2d_1", _conv),
                        (6, "TransposedDeconv3x3_1", _td3x3),
                        (8, "Conv2d_2", _conv)])


def _factorized(sd: StateDict, prefix: str) -> Dict[str, Array]:
    out = {}
    for i in range(4):
        out[f"matrix_{i}"] = np.asarray(sd[f"{prefix}.matrices.{i}"])
        out[f"bias_{i}"] = np.asarray(sd[f"{prefix}.biases.{i}"])
        if i < 3:
            out[f"factor_{i}"] = np.asarray(sd[f"{prefix}.factors.{i}"])
    return out


def _context(sd: StateDict, prefix: str) -> Dict[str, Array]:
    # the reference multiplies its weight by the mask in place every
    # forward; the port masks functionally, so a masked or unmasked weight
    # gives the same effective kernel
    return {"MaskedConv2d_0": _conv(sd, prefix + ".masked")}


def _entropy_parameters(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return _seq(sd, prefix, [(0, "Conv2d_0", _conv), (2, "Conv2d_1", _conv),
                             (4, "Conv2d_2", _conv)])


_TRANSFORM_MAPPERS: Dict[str, Dict[str, Callable]] = {
    "conv5x5": {"encoder": _encoder5x5, "decoder": _decoder5x5,
                "hyper_encoder": _hyper_encoder5x5, "hyper_decoder": _hyper_decoder5x5},
    "res3x3": {"encoder": _encoder3x3, "decoder": _decoder3x3,
               "hyper_encoder": _hyper_encoder3x3, "hyper_decoder": _hyper_decoder3x3},
}


def joint_ar_params_from_torch(sd: StateDict, transform: str = "conv5x5") -> Dict:
    """A reference state_dict (JointAutoregressiveHierarchical, or
    HierarchicalMixtureResidual with transform "res3x3"; numpy values) ->
    the flax-layout tree of ``JointAutoregressiveHierarchical(transform=...)``
    that ``utils.weights.load_jax_params`` takes."""
    m = _TRANSFORM_MAPPERS[transform]
    return {
        "encoder": m["encoder"](sd, "encoder"),
        "decoder": m["decoder"](sd, "decoder"),
        "hyper_encoder": m["hyper_encoder"](sd, "hyper_encoder"),
        "hyper_decoder": m["hyper_decoder"](sd, "hyper_decoder"),
        "factorized_entropy_model": _factorized(sd, "factorized_entropy_model"),
        "context_model": _context(sd, "context_model"),
        "entropy_parameters": _entropy_parameters(sd, "entropy_parameters"),
    }


def load_reference_checkpoint(path: str, transform: str = "conv5x5",
                              scalable: bool = False) -> Dict:
    """A reference Trainer checkpoint (a .pth of {'model_state_dict': ...,
    'optimizer_state_dict': ..., 'step': ...}, or a bare state_dict) -> the
    flax-layout tree of the matching model (``joint_ar_params_from_torch``).
    Loaded with ``weights_only=True``: tensors and plain containers only."""
    if scalable:
        raise NotImplementedError(
            "the scalable model's checkpoint mapping is not ported yet (ROADMAP A4)")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("model_state_dict", blob) if isinstance(blob, dict) else blob
    sd = {k: v.numpy() for k, v in sd.items()}
    return joint_ar_params_from_torch(sd, transform)
