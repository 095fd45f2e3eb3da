"""Serving: the eval forward with per-image rates, and its export to a
self-contained artifact, port of serving.py.

    serve(x: float32 (B, H, W, 3) in [0, 1])
      -> {"x_hat": float32 (B, H, W, 3) clipped to [0, 1],
          "bpp_y": (B,), "bpp_z": (B,), "bpp_total": (B,)}

``make_serving_fn`` runs it on the live model. ``export_model`` traces it
with ``torch.export`` into an ``ExportedProgram`` (B symbolic by default;
H and W fixed at export, as the JAX package's StableHLO artifact fixes
them), ``save_exported`` writes it to a ``.pt2`` file and ``load_exported``
reads it back: a program that needs none of the model's Python code. The
GDN and mixture kernels enter the graph as the operators
``nic_torch::gdn`` and ``nic_torch::gmm_logp`` (``ops/kernels``), never as
their plain versions, so the loaded program launches the hand-written
kernels on a CUDA device and runs the plain versions on the CPU, as the
live model does.

Where the JAX package lowers for named platforms with the weights baked in
as constants, ``torch.export`` keeps the weights in the program's state
dict on the device they had at export: an artifact is served on the kind
of device it was exported on (export on ``cuda`` to serve on the card).

For real bitstreams use ``coding.*Codec``: this is the analytic-rate eval
forward, the serving path for rate and quality prediction and for
reconstruction at the edge.
"""

from typing import Optional

import torch
from torch import nn

from neural_image_compression_tpu_torch.ops.math import LOG2

__all__ = ["make_serving_fn", "export_model", "save_exported", "load_exported"]


def _serving_outputs(out, x):
    """The eval forward's outputs as the serving dict: x_hat clipped, and
    per-image rates (sums over every axis but the batch)."""
    npix = float(x.shape[1] * x.shape[2])

    def bpp(logp):
        return -torch.sum(logp.float(), dim=tuple(range(1, logp.dim()))) / LOG2 / npix

    # the y rate: every logp_* stream but z (a two-layer model splits y into
    # logp_y1 and logp_y2)
    bpp_y = sum(bpp(v) for k, v in out.items() if k.startswith("logp_") and k != "logp_z")
    bpp_z = bpp(out["logp_z"])
    return {"x_hat": torch.clamp(out["x_hat"].float(), 0.0, 1.0),
            "bpp_y": bpp_y, "bpp_z": bpp_z, "bpp_total": bpp_y + bpp_z}


def make_serving_fn(model):
    """x -> dict with x_hat and per-image bpp, on the model's device."""
    device = next(model.parameters()).device

    def serve(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        with torch.inference_mode():
            return _serving_outputs(model(x, training=False), x)

    return serve


class _Serving(nn.Module):
    """The model's eval forward and the serving dict, as the module that
    ``torch.export`` traces (the model call itself, without
    ``make_serving_fn``'s inference-mode closure, which would put grad-mode
    nodes in the graph)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return _serving_outputs(self.model(x, training=False), x)


def export_model(model, height: int, width: int, batch: Optional[int] = None):
    """The eval forward as a ``torch.export.ExportedProgram`` on the model's
    device: x float32 (B, height, width, 3) -> the serving dict.

    batch: None -> a symbolic batch dimension (any B at call time); an int
    -> that fixed batch size. A variable-rate model is exported folded at a
    level (``models.folded_model`` and ``models.fold_gains``), as the CLI
    does.
    """
    if height % 64 or width % 64:
        raise ValueError(f"H and W must be multiples of 64 (the model's "
                         f"total downsampling), got {height}x{width}; "
                         "pad first (data.pad_to_multiple)")
    device = next(model.parameters()).device
    # a symbolic batch is traced at 2: export specializes dimensions of size 1
    x = torch.zeros((2 if batch is None else batch, height, width, 3), device=device)
    dynamic = {"x": {0: torch.export.Dim("batch")}} if batch is None else None
    with torch.no_grad():
        return torch.export.export(_Serving(model), (x,), dynamic_shapes=dynamic)


def save_exported(exported, path: str) -> None:
    torch.export.save(exported, path)


def load_exported(path: str):
    """A saved artifact as an ``ExportedProgram``: call it as
    ``load_exported(path).module()(x)``. The kernels' operators are
    registered first (importing ``ops.kernels``), and the weights come back
    on the device they were exported on, frozen: the program serves, it
    does not train."""
    import neural_image_compression_tpu_torch.ops.kernels  # noqa: F401  (registers nic_torch::*)

    exported = torch.export.load(path)
    for t in exported.state_dict.values():
        t.requires_grad_(False)
    return exported
