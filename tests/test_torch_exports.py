"""PyTorch port: each package's public names against the JAX package's,
the CLI's subcommands and options against the JAX CLI's, and the import
graph of the package and its CLI.

Every name a JAX package exports is exported by the port's package of the
same path. ``NOT_PORTED`` lists, by name with the ROADMAP item that ports
them, the names of modules not ported yet: it must match exactly, and it
is empty now that every module is ported. The port's own extra names are
allowed.
"""

import contextlib
import importlib
import io
import os
import re
import subprocess
import sys

import jax  # noqa: F401  (the JAX package's import needs it; the tests stay on the CPU)
import numpy as np
import pytest
import torch

from neural_image_compression_tpu import cli as jax_cli
from neural_image_compression_tpu_torch import cli, coding, models, ops, utils
from neural_image_compression_tpu_torch.utils import restore_raw, save_checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NOT_PORTED = {
    "": {},
    "coding": {},
    "data": {},
    "entropy": {},
    "evaluation": {},
    "models": {},
    "ops": {},
    "parallel": {},
    "serving": {},
    "train": {},
    "utils": {},
}
# the JAX CLI's subcommands the port's leaves out, with the ROADMAP item
# that brings each
CLI_NOT_PORTED = {"bench": "D1: the benchmark PR's script"}
# the subcommands that run a model (or MS-SSIM) take --device; export takes
# it in place of --platforms
CLI_DEVICE = {"train", "eval", "compress", "decompress", "export", "anchor-curve"}


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


def _help(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        main([*argv, "--help"])
    assert e.value.code == 0
    return out.getvalue()


def _subcommands(main):
    (choices,) = re.findall(r"\{([a-z,-]+)\}", _help(main, []))[:1]
    return choices.split(",")


def _options(main, cmd):
    """A subcommand's option strings and positional arguments, from its
    usage line."""
    usage = _help(main, [cmd]).split("\n\n")[0]
    return set(re.findall(r"\[?(--?[\w-]+|[a-z_]+(?= |\]|$))", usage.split(f" {cmd} ", 1)[1]))


def test_cli_subcommands_are_the_jax_clis():
    want = _subcommands(jax_cli.main)
    assert _subcommands(cli.main) == [c for c in want if c not in CLI_NOT_PORTED]
    assert set(CLI_NOT_PORTED) <= set(want)


@pytest.mark.parametrize("cmd", ["preprocess", "download-coco", "train", "eval", "compress",
                                 "decompress", "export", "anchor-curve", "bdrate"])
def test_cli_options_are_the_jax_clis(cmd):
    want = _options(jax_cli.main, cmd)
    if cmd in CLI_DEVICE:
        want = (want - {"--platforms"}) | {"--device"}
    assert _options(cli.main, cmd) == want


def test_package_and_cli_import_no_jax():
    code = (
        "import sys\n"
        "import neural_image_compression_tpu_torch\n"
        "import neural_image_compression_tpu_torch.cli\n"
        "import neural_image_compression_tpu_torch.data.preprocess\n"
        "import neural_image_compression_tpu_torch.data.coco\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'neural_image_compression_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax.', 'neural_image_compression_tpu.')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
