"""The control on the card: the reference in the next precision down, put
in the program's place (TF32 for the float32 train cells, fp8 operands for
the bfloat16 serve cells), comes out not correct under each cell's limits,
while the program comes out correct. At the published widths, on fewer and
smaller images than the cells time. Run on the card with
``pytest -m cuda port_bench/tests``."""

import pytest
import torch

from port_bench import calibrate, checks
from port_bench.tests.tiny import tiny_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    from neural_image_compression_tpu_torch.ops.kernels import _build
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda", 0)


CELLS = {"gm128k3.train_f32_b16": dict(m=128, batch=4, size=128),
         "scal192.train_f32_b16": dict(m=192, batch=4, size=128),
         "gm128k3.serve_bf16_kodak24": dict(m=128, batch=4, size=256),
         "scal192.serve_bf16_kodak24": dict(m=192, batch=4, size=256)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails_and_program_passes(card, name):
    cell = tiny_cell(name, pool=4, **CELLS[name])
    if "base_channels" in cell.config:  # the published split and teacher
        cell.config = dict(cell.config, base_channels=128,
                           teacher=dict(cell.config["teacher"], width=64))
    r = calibrate.readings(cell, 31, card, 0.5, program_only=False)
    control = r["control_fp8" if cell.mix["kind"] == "serve" else "control_tf32"]
    assert checks.judge(r["program"], cell.limits), r
    assert not checks.judge(control, cell.limits), r
