"""The benchmark's cells at a size a CPU test run holds, and a run of
``port_bench.run`` on the CPU with the harness's look for a card skipped."""

import contextlib
import io
import json

import torch

from port_bench import cells


def bench_with(name: str) -> dict:
    """BENCHMARK.json, with the cell ``name`` (``<config>.<traffic>`` of
    ``configs/`` and ``mixes/``) and its configuration added where it does
    not list them."""
    bench = cells.load_benchmark()
    config, traffic = name.split(".", 1)
    if not any(c["name"] == config for c in bench["configs"]):
        bench["configs"].append({"name": config, "file": f"port_bench/configs/{config}.json"})
    if not any(w["name"] == name for w in bench["workloads"]):
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1})
    return bench


def tiny_cell(name: str, m: int = 16, batch: int = 2, size: int = 64, pool: int = 4):
    """The cell ``name`` with M = m channels (M1 = m / 2 and a teacher of
    width m / 4 for the scalable model), ``batch`` images of size x size and
    a pool of ``pool`` batches."""
    cell = cells.load_cell(name, bench_with(name))
    cfg = dict(cell.config, latent_channels=m)
    if "base_channels" in cfg:
        cfg["base_channels"] = m // 2
        cfg["teacher"] = dict(cfg["teacher"], width=m // 4)
    cell.config = cfg
    cell.mix = dict(cell.mix, batch=batch, height=size, width=size, pool_batches=pool)
    return cell


class _HostEvent:
    def record(self):
        pass

    def synchronize(self):
        pass


def run_on_cpu(monkeypatch, cell_name: str, seed: int = 2 ** 31 + 7, seconds: float = 0.5,
               trace: int = 0):
    """``port_bench.run.main`` on the CPU for the tiny ``cell_name``:
    returns (exit code, the result line as a dict or None)."""
    import port_bench.session as session
    from neural_image_compression_tpu_torch.ops.kernels import _build
    from port_bench import run

    cell = tiny_cell(cell_name)
    monkeypatch.setattr(cells, "load_cell", lambda name, *a, **k: cell)
    for name, value in (("is_available", lambda: True), ("device_count", lambda: 1),
                        ("set_device", lambda d: None), ("synchronize", lambda *a: None),
                        ("max_memory_allocated", lambda *a: 0),
                        ("get_device_name", lambda *a: "cpu"),
                        ("Event", lambda *a, **k: _HostEvent())):
        monkeypatch.setattr(torch.cuda, name, value)
    # the CPU's build of torch traces no CUDA activity: profile its host instead
    from torch.profiler import ProfilerActivity, profile
    from port_bench import trace as tracing
    monkeypatch.setattr(tracing, "profiler", lambda: profile(activities=[ProfilerActivity.CPU]))
    monkeypatch.setattr(_build, "build", lambda *a, **k: {})
    monkeypatch.setattr(_build, "load", lambda *a, **k: None)
    real = session.Session.__post_init__

    def on_cpu(self):
        self.device = torch.device("cpu")
        real(self)

    monkeypatch.setattr(session.Session, "__post_init__", on_cpu)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell_name, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)
