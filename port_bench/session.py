"""One cell's run: set-up from the seed, the measured window, and the check
of what the window produced.

Everything the program gets is made here from ``--seed``: the weights
(one uniform draw on the device, shaped by the reference's leaf
specifications and loaded into the port's model), the image pool and the
noise generator. The reference is handed the same weights, images and
noise-generator states, and works out everything else itself. What a kind
of traffic does with them is its driver's (``drivers/<kind>.py``).
"""

import contextlib
import gc
import time
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from port_bench import traffic
from port_bench.reference import layers as L

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def sub_seeds(seed: int, n: int = 4):
    """n independent 63-bit seeds from one whole number of any size."""
    return [int(s) >> 1 for s in np.random.SeedSequence(abs(int(seed))).generate_state(n, np.uint64)]


class _HostEvent:
    """What the window needs of a CUDA event, for a run on the CPU."""

    def record(self):
        pass

    def synchronize(self):
        pass


@dataclass
class Session:
    cell: object
    seed: int
    device: torch.device
    phases: Dict[str, float] = field(default_factory=dict)
    clock = staticmethod(time.perf_counter)

    def __post_init__(self):
        self.cuda = self.device.type == "cuda"
        self.weight_seed, self.pool_seed, self.noise_seed, self.sample_seed = sub_seeds(self.seed)
        self.mix, self.config = self.cell.mix, self.cell.config
        self.driver = self.cell.driver

    # -- helpers ---------------------------------------------------------------
    def synchronize(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def new_event(self):
        return torch.cuda.Event() if self.cuda else _HostEvent()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = self.clock()
        yield
        self.synchronize()
        self.phases[name] = self.phases.get(name, 0.0) + self.clock() - t0

    def new_generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- set-up ----------------------------------------------------------------
    def setup(self):
        cfg, mix, family, ref = self.config, self.mix, self.cell.family, self.cell.reference
        with self.phase("model_and_weights"):
            gen = self.new_generator(self.weight_seed)
            self.weights = L.draw(ref.specs(cfg), gen, self.device)
            self.teacher = (L.draw(ref.teacher_specs(cfg), gen, self.device)
                            if hasattr(ref, "teacher_specs") else None)
            self.model = family.build_model(cfg, DTYPES[mix["dtype"]], self.device)
            self.model.load_state_dict(self.weights, strict=True)
        with self.phase("inputs"):
            self.pool = traffic.make_pool(mix, self.new_generator(self.pool_seed), self.device)
        with self.phase("warmup"):
            self.driver.setup(self)

    # -- the window ------------------------------------------------------------
    def quiesce(self):
        """Before the window: collect garbage and let the device drain."""
        gc.collect()
        self.synchronize()

    def window(self, seconds: float, span=None) -> traffic.Window:
        return self.driver.window(self, seconds, span or traffic.no_span)

    def failed(self, win: traffic.Window) -> int:
        return self.driver.failed(self, win)

    def free_program(self):
        """Drop the program's model, optimizer and step before the
        reference runs (what the check needs is kept)."""
        for name in ("model", "optimizer", "step", "serve"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------
    def check(self) -> Dict[str, float]:
        return self.driver.check(self)
