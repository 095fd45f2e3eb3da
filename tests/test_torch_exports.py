"""PyTorch port: each package's public names against the JAX package's.

Every name a JAX package exports is exported by the port's package of the
same path, except the names of modules not ported yet, listed here by name
with the ROADMAP item that ports them. The list must match exactly, so it
shrinks as the port grows; the port's own extra names are allowed.
"""

import importlib

import jax  # noqa: F401  (the JAX package's import needs it; the tests stay on the CPU)
import numpy as np
import pytest
import torch

from neural_image_compression_tpu_torch import coding, models, ops, utils
from neural_image_compression_tpu_torch.utils import restore_raw, save_checkpoint

torch.set_num_threads(1)

A6 = "A6: serving export, config, CLI and data"

NOT_PORTED = {
    "": {"config": A6, "Config": A6, "build_model": A6},
    "coding": {},
    "data": {"add_quantization_noise": A6, "is_saturated": A6,
             "preprocess_images": A6, "random_downsample_crop": A6,
             "download_coco_subset": A6},
    "entropy": {},
    "evaluation": {},
    "models": {},
    "ops": {},
    "parallel": {},
    "serving": {"export_model": A6, "save_exported": A6, "load_exported": A6},
    "train": {},
    "utils": {},
}


def _module(package, sub):
    return importlib.import_module(package + (f".{sub}" if sub else ""))


@pytest.mark.parametrize("sub", sorted(NOT_PORTED))
def test_port_exports_what_jax_exports(sub):
    jax_names = set(_module("neural_image_compression_tpu", sub).__all__)
    port = _module("neural_image_compression_tpu_torch", sub)
    missing = jax_names - set(port.__all__)
    assert missing == set(NOT_PORTED[sub]), (
        f"not exported by the port: {sorted(missing - set(NOT_PORTED[sub]))}; listed as not "
        f"ported but exported: {sorted(set(NOT_PORTED[sub]) - missing)}")
    for name in port.__all__:
        assert hasattr(port, name), f"{sub}.__all__ names {name}, which the package lacks"


def test_quantizers_and_math_names():
    """The C1 names that were defined but not exported now work from the
    package paths the JAX package gives them."""
    x = torch.tensor([-1.5, -0.5, 0.5, 1.5, 2.4])
    assert torch.equal(models.round_quantize(x), torch.tensor([-2.0, -0.0, 0.0, 2.0, 2.0]))
    assert torch.equal(models.quantize(x, training=False), models.round_quantize(x))
    noisy = models.quantize(x, True, torch.Generator().manual_seed(0))
    assert 0 < (noisy - x).abs().max() <= 0.5
    assert torch.allclose(ops.nats_to_bits(torch.tensor([np.log(2.0), np.log(8.0)]).float()),
                          torch.tensor([1.0, 3.0]))
    assert utils.mfu(10.0, 2e12, 40.0) == pytest.approx(0.5)
    assert utils.joint_ar_eval_flops(16, 1, 64, 64)["total"] > 0
    assert utils.factorized_prior_eval_flops(16, 64, 64)["total"] > 0
    pix, sizes = coding.wavefront_order(2, 3)
    assert pix.shape == (6, 2) and int(sizes.sum()) == 6
    assert callable(coding.portable_ar_encode) and callable(coding.portable_ar_decode)


def test_restore_raw(tmp_path):
    path = str(tmp_path / "ckpt.pt")
    state = {"model": {"w": torch.arange(3.0)}, "step": torch.tensor(7)}
    save_checkpoint(path, state, {"epoch": 1})
    raw = restore_raw(path)
    assert set(raw) == {"model", "step"}
    assert torch.equal(raw["model"]["w"], state["model"]["w"]) and int(raw["step"]) == 7
