"""Find a cell's parts by name: ``BENCHMARK.json`` names the cell's
configuration and traffic; ``configs/<config>.json`` names its family
(``families/<family>.py``, with the plain reference
``reference/<family>.py``); ``mixes/<traffic>.json`` is its mix, whose kind
names its driver (``drivers/<kind>.py``); ``limits/<cell>.json`` holds its
correctness limits; ``metrics/<metric>.py`` reads each metric, end-to-end
or per-layer. A new cell, configuration, mix, kind of traffic or metric is
a new file and a new entry: nothing here changes."""

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from port_bench import traffic

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


def _module(path: Path, name: str):
    """The module of the source file ``path``, loaded once under ``name``."""
    module = sys.modules.get(name)
    if module is not None and Path(getattr(module, "__file__", "")) == path:
        return module
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def part(root: Path, folder: str, name: str):
    """``<folder>/<name>.py`` under ``root``, or the benchmark's own where
    ``root`` has none."""
    path = root / folder / f"{name}.py"
    if not path.is_file():
        path = HERE / folder / f"{name}.py"
    return _module(path, f"port_bench.{folder}.{name}")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = HERE

    @property
    def family(self):
        return part(self.root, "families", self.config["family"])

    @property
    def reference(self):
        return part(self.root, "reference", self.config["family"])

    @property
    def driver(self):
        return part(self.root, "drivers", self.mix["kind"])

    @property
    def unit(self) -> str:
        """What one request or step is called in metric names: "serve", or
        the configuration's step name ("train", "distill")."""
        return self.driver.unit_name(self.config)


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, bench: Optional[dict] = None, root: Path = HERE) -> Cell:
    bench = load_benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root.parent / conf["file"]).read_text())
    mix = traffic.load_mix(entry["traffic"], root / "mixes", root / "drivers")
    limits = json.loads((root / "limits" / f"{name}.json").read_text())
    return Cell(name, entry["chips"], config, mix, limits,
                [m for m in bench["end_to_end"] if _listed(m, name)],
                [m for m in bench["per_layer"] if _listed(m, name)], root)


def metric_reader(name: str, root: Path = HERE):
    """The ``read(run)`` function of ``metrics/<name>.py``: it returns the
    metric's value from a ``readers.Run``, or None where the run gives it
    nothing to read."""
    return part(root, "metrics", name).read
