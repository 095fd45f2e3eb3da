"""Run one cell of the benchmark once and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up (imports, the kernels' build or load, weights, inputs, warm-up)
is timed as ``setup_s``; then the window measures for ``--seconds``. With
``--trace 1`` a second window of at most TRACE_SECONDS follows under
torch.profiler (device operations only), and the cell's per-layer metrics
are printed in place of its end-to-end ones: those on the host's clock from
the first window, those from the device trace from the second. Every
metric is read by its own file, ``metrics/<name>.py``. After the windows
the program's outputs are compared with the plain reference
(``checks.py``).

Standard output ends with two JSON lines: the run's noise record (set-up
phases; the card's clocks, power and temperature beside the window) and the
result. Standard error ends with each compared number beside its limit.
Exits non-zero without a result when no card (or too few) is present, and
when JAX, flax or the JAX package is loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from port_bench import cells  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "neural_image_compression_tpu")
TRACE_SECONDS = 8.0
CHECKOUT = Path(__file__).resolve().parents[1]
CACHE = CHECKOUT / ".bench_cache"


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the port's name only begins with the JAX package's)."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = cells.load_cell(args.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # full-f32 arithmetic and cuDNN's heuristic choice, in every cell
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.set_num_threads(2)

    from port_bench import monitor, readers, trace as tracing
    from port_bench.checks import judge
    from port_bench.session import Session

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    session = Session(cell, args.seed, device)
    session.phases["imports"] = time.perf_counter() - T_START
    with session.phase("extensions"):
        from neural_image_compression_tpu_torch.ops.kernels import _build
        _build.build()
        for name in _build.KERNEL_SOURCES:
            _build.load(name)
    session.setup()
    setup_s = time.perf_counter() - T_START

    sampler = monitor.GpuSampler()
    sampler.start()
    traced, tr = None, None
    try:
        session.quiesce()
        win = session.window(args.seconds)
        if args.trace:
            session.quiesce()
            spans = tracing.SpanLog()
            with tracing.profiler() as prof:
                with spans(tracing.WINDOW_SPAN):
                    traced = session.window(min(args.seconds, TRACE_SECONDS), span=spans)
            tr = tracing.from_profile(prof, spans)
            del prof
    finally:
        gpu = sampler.stop()
    memory_peak = torch.cuda.max_memory_allocated(device)
    windows = [w for w in (win, traced) if w is not None]
    attempted = sum(w.units for w in windows)
    failed = sum(session.failed(w) for w in windows)

    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    run = readers.Run(cell, win, setup_s, tr, traced.units if traced else 0)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = cells.metric_reader(m["name"], cell.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = None
    if tr is not None:
        device_info.update(busy_s=tracing.busy_seconds(tr), window_s=tr.seconds)
        breakdown = {"device_ops": [[n[:120], s] for n, s in tracing.device_ops(tr)],
                     "idle_gaps": [[n[:120], s] for n, s in tracing.longest_gaps(tr)]}

    session.free_program()
    numbers = session.check()
    correct = failed == 0 and judge(numbers, cell.limits)

    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3

    noise = {"setup_phases_s": session.phases, "setup_s": setup_s, "gpu": gpu,
             "window_units": win.units, "window_s": win.seconds}
    if tr is not None:
        noise.update(traced_units=traced.units, traced_s=tr.seconds,
                     device_ops_outside_window=tr.outside(), device_ops=len(tr.ops))
    print(json.dumps({"noise": noise}), flush=True)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in cell.limits}
    print(json.dumps(result), flush=True)
    for k in cell.limits:
        print(f"check {k} = {numbers[k]!r} limit {cell.limits[k]!r}", file=sys.stderr)
    print(f"check failed_units = {failed} limit 0", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
