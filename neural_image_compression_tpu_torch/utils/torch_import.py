"""Import the reference's (PyTorch) checkpoints, port of utils/torch_import.py.

Maps a state_dict of the reference's JointAutoregressiveHierarchical or
HierarchicalMixtureResidual (``joint_ar_params_from_torch``), or of its
ScalableImageCoding (``scalable_params_from_torch``), onto the flax-layout
parameter tree that ``utils.weights.load_jax_params`` takes, so a reference
checkpoint loads into the port's model without the JAX package:

    params = load_reference_checkpoint("ckpt.pth", transform="res3x3")
    load_jax_params(HierarchicalMixtureResidual(M, K), params)

A YOLOv5-family state_dict (ultralytics naming) maps onto the variables of
``models.build_yolo_backbone`` (``yolo_backbone_variables_from_torch``),
which ``utils.weights.load_jax_variables`` takes.

Layouts, as the JAX package's importer converts them:

* Conv2d weights (O, I, kh, kw) -> HWIO (kh, kw, I, O).
* ConvTranspose2d weights (I, O, kh, kw) -> direct-conv HWIO kernels: both
  spatial dims flipped, I/O kept.
* GDN beta/gamma in the same sqrt+pedestal form (ops/bound.py); gamma
  transposed to (C_in, C_out).
* The factorized bottleneck's ``matrices.i`` / ``biases.i`` / ``factors.i``
  -> ``matrix_i`` / ``bias_i`` / ``factor_i``, shapes unchanged.
* BatchNorm ``weight`` / ``bias`` -> ``scale`` / ``bias`` (params),
  ``running_mean`` / ``running_var`` -> ``mean`` / ``var`` (batch_stats).
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


def _lst(sd: StateDict, prefix: str) -> Dict[str, Array]:
    """The reference's LatentSpaceTransform (attributes RB1..RB4,
    URB1..URB3, conv) -> the flax creation-order names."""
    out = {}
    for i in range(3):
        out[f"ResidualBlock_{i}"] = _residual_block(sd, f"{prefix}.RB{i + 1}")
        out[f"ResidualBlockUpsample_{i}"] = _residual_block_upsample(sd, f"{prefix}.URB{i + 1}")
    out["ResidualBlock_3"] = _residual_block(sd, prefix + ".RB4")
    out["Conv2d_0"] = _conv(sd, prefix + ".conv")
    return out


def scalable_params_from_torch(sd: StateDict) -> Dict:
    """A reference ScalableImageCoding state_dict (numpy values) -> the
    flax-layout tree of ``models.ScalableImageCoding``."""
    return {
        "encoder": _encoder5x5(sd, "encoder"),
        "decoder": _decoder5x5(sd, "decoder"),
        "hyper_encoder": _hyper_encoder5x5(sd, "hyper_encoder"),
        "hyper_decoder": _hyper_decoder5x5(sd, "hyper_decoder"),
        "factorized_entropy_model": _factorized(sd, "factorized_entropy_model"),
        "context_model_1": _context(sd, "context_model_1"),
        "context_model_2": _context(sd, "context_model_2"),
        "entropy_parameters_1": _entropy_parameters(sd, "entropy_parameters_1"),
        "entropy_parameters_2": _entropy_parameters(sd, "entropy_parameters_2"),
        "LST": _lst(sd, "LST"),
    }


def load_reference_checkpoint(path: str, transform: str = "conv5x5",
                              scalable: bool = False) -> Dict:
    """A reference Trainer checkpoint (a .pth of {'model_state_dict': ...,
    'optimizer_state_dict': ..., 'step': ...}, or a bare state_dict) -> the
    flax-layout tree of the matching model (``scalable_params_from_torch``
    with scalable=True, else ``joint_ar_params_from_torch``). Loaded with
    ``weights_only=True``: tensors and plain containers only."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("model_state_dict", blob) if isinstance(blob, dict) else blob
    sd = {k: v.numpy() for k, v in sd.items()}
    if scalable:
        return scalable_params_from_torch(sd)
    return joint_ar_params_from_torch(sd, transform)


# --- the YOLO-family frozen backbone (models/backbones.py) ------------------------

def _conv_bn_silu(sd: StateDict, prefix: str):
    """YOLO's 'Conv' (conv without bias, BatchNorm, SiLU) -> a ConvBNSiLU's
    (params, batch_stats)."""
    params = {"Conv2d_0": {"kernel": _conv_kernel(sd[prefix + ".conv.weight"])},
              "BatchNorm_0": {"scale": np.asarray(sd[prefix + ".bn.weight"]),
                              "bias": np.asarray(sd[prefix + ".bn.bias"])}}
    stats = {"BatchNorm_0": {"mean": np.asarray(sd[prefix + ".bn.running_mean"]),
                             "var": np.asarray(sd[prefix + ".bn.running_var"])}}
    return params, stats


def _c3(sd: StateDict, prefix: str, depth: int):
    """YOLO's C3: cv1 -> the bottlenecks, cv2 the bypass, cv3 the fuse."""
    params, stats = {}, {}
    for ours, theirs in (("ConvBNSiLU_0", "cv1"), ("ConvBNSiLU_1", "cv2"),
                         ("ConvBNSiLU_2", "cv3")):
        params[ours], stats[ours] = _conv_bn_silu(sd, f"{prefix}.{theirs}")
    for j in range(depth):
        bp, bs = {}, {}
        for ours, theirs in (("ConvBNSiLU_0", "cv1"), ("ConvBNSiLU_1", "cv2")):
            bp[ours], bs[ours] = _conv_bn_silu(sd, f"{prefix}.m.{j}.{theirs}")
        params[f"Bottleneck_{j}"], stats[f"Bottleneck_{j}"] = bp, bs
    return params, stats


def _sppf(sd: StateDict, prefix: str):
    params, stats = {}, {}
    for ours, theirs in (("ConvBNSiLU_0", "cv1"), ("ConvBNSiLU_1", "cv2")):
        params[ours], stats[ours] = _conv_bn_silu(sd, f"{prefix}.{theirs}")
    return params, stats


# the yolov5 yaml's layers 0-17 with parameters (11/15 upsample, 12/16 concat)
_YOLO_LAYERS = {0: "conv", 1: "conv", 2: "c3", 3: "conv", 4: "c3", 5: "conv", 6: "c3",
                7: "conv", 8: "c3", 9: "sppf", 10: "conv", 13: "c3", 14: "conv", 17: "c3"}


def yolo_backbone_variables_from_torch(sd: StateDict, depth: int = 1,
                                       prefix: str = "model.") -> Dict:
    """A YOLOv5-family state_dict (numpy values; ultralytics naming:
    ``model.{i}.conv/bn`` for Conv layers, ``model.{i}.cv1/cv2/cv3`` and
    ``model.{i}.m.{j}.cv1/cv2`` for C3, ``model.{i}.cv1/cv2`` for SPPF) ->
    the variables ({'params', 'batch_stats'}) of
    ``models.build_yolo_backbone(width, depth)``. Layers past 17 (the
    detection head) are ignored; C3 depths follow the yaml ladder times
    ``depth``."""
    from neural_image_compression_tpu_torch.models.backbones import _C3_DEPTH

    params, stats = {}, {}
    for i, kind in _YOLO_LAYERS.items():
        name, p = f"layers_{i}_0", f"{prefix}{i}"
        if kind == "conv":
            params[name], stats[name] = _conv_bn_silu(sd, p)
        elif kind == "c3":
            params[name], stats[name] = _c3(sd, p, _C3_DEPTH[i] * depth)
        else:
            params[name], stats[name] = _sppf(sd, p)
    return {"params": params, "batch_stats": stats}
