"""What a metric's reader (``metrics/<name>.py``) is handed: ``Run``, the
cell (its configuration, mix and family) with the measured window, the
set-up time and, in a traced run, the traced window's device operations
and harness spans; and the few reductions that several readers share.

Host-clock metrics read the measured window, which runs with no profiler;
device-trace metrics read the traced window that follows it. A reader
returns None where its cell gives it nothing to read, and a FLOP or byte
count that only one metric needs belongs in that metric's own file."""

import statistics
from dataclasses import dataclass
from typing import Optional

from port_bench import flops, kernel_layers, traffic
from port_bench import trace as tracing

ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


@dataclass
class Run:
    cell: object                          # cells.Cell
    window: traffic.Window                # the measured window (no profiler)
    setup_s: float
    trace: Optional[tracing.Trace] = None   # the traced window (``--trace 1``)
    traced_units: int = 0                 # requests or steps in the traced window

    def is_unit(self, unit: str) -> bool:
        return self.cell.unit == unit


# -- host clock: the measured window ---------------------------------------------

def units_per_s(run: Run, unit: str) -> Optional[float]:
    """Whole requests or steps over the whole window."""
    if not run.is_unit(unit) or run.window.units == 0:
        return None
    return run.window.units / run.window.seconds


def p95_ms(run: Run, unit: str) -> Optional[float]:
    """The 95th percentile of every request's latency in the window."""
    if not run.is_unit(unit) or len(run.window.latency) < 2:
        return None
    return 1e3 * statistics.quantiles(run.window.latency, n=20, method="inclusive")[18]


def host_ms(run: Run, unit: str) -> Optional[float]:
    """Mean host ms to enqueue one call, no sync."""
    if not run.is_unit(unit) or not run.window.enqueue:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1 in run.window.enqueue) / run.window.units


def flops_per_unit(cell) -> float:
    """The frozen count of one request or step: the batch's eval forwards,
    or its training steps."""
    mix, cfg, family = cell.mix, cell.config, cell.family
    h, w = mix["height"], mix["width"]
    per_image = family.step_flops(cfg, h, w) if mix["kind"] == "train" else family.eval_flops(cfg, h, w)
    return mix["batch"] * per_image


def mfu_pct(run: Run, unit: str) -> Optional[float]:
    """The window's FLOPs a second over the card's dense peak for the
    mix's dtype."""
    rate = units_per_s(run, unit)
    if rate is None:
        return None
    peak = flops.H100_PEAK_TFLOPS["bf16" if run.cell.mix["dtype"] == "bfloat16" else "f32"]
    return 100.0 * rate * flops_per_unit(run.cell) / (peak * 1e12)


# -- device trace: the traced window ---------------------------------------------

def _traced(run: Run, unit: str) -> bool:
    return run.is_unit(unit) and run.trace is not None and run.traced_units > 0


def device_seconds(run: Run, select) -> float:
    lo, hi = run.trace.window
    return sum(e - s for name, s, e in run.trace.ops if s >= lo and e <= hi and select(name))


def conv_ms(run: Run, unit: str) -> Optional[float]:
    if not _traced(run, unit):
        return None
    seconds = device_seconds(run, kernel_layers.is_convolution)
    return 1e3 * seconds / run.traced_units if seconds > 0 else None


def gdn_bytes(cell, backward: bool) -> float:
    """The bytes bound of one unit's GDN calls, from their shapes: each
    input read once and each output written once (forward x, out, gamma,
    beta; backward x, dy, dx, gamma, dgamma, dbeta)."""
    mix = cell.mix
    b, h, w, elem = mix["batch"], mix["height"], mix["width"], ELEMENT_BYTES[mix["dtype"]]
    total = 0.0
    for pixels, c in cell.family.gdn_sites(cell.config, h, w, mix["kind"] == "train"):
        rows, params = b * pixels, 4 * (c * c + c)
        total += (3 * rows * c * elem + 2 * params) if backward else (2 * rows * c * elem + params)
    return total


def gdn_roofline_pct(run: Run, unit: str, backward: bool) -> Optional[float]:
    """The GDN calls' bytes bound at the card's HBM bandwidth over the
    device time of every GDN kernel of that direction."""
    if not _traced(run, unit):
        return None
    select = kernel_layers.is_gdn_backward if backward else kernel_layers.is_gdn_forward
    seconds = device_seconds(run, select)
    if seconds <= 0:
        return None
    moved = run.traced_units * gdn_bytes(run.cell, backward)
    return 100.0 * moved / flops.H100_HBM_BYTES_S / seconds


def idle_pct(run: Run, unit: str) -> Optional[float]:
    """The share of the traced window that no device operation covers."""
    if not _traced(run, unit) or run.trace.seconds <= 0:
        return None
    return 100.0 * (1.0 - tracing.busy_seconds(run.trace) / run.trace.seconds)
