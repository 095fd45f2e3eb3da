"""Profiling and step timing, port of utils/profiling.py.

  * ``trace(log_dir)``: a context manager around ``torch.profiler`` that
    writes a Chrome/Perfetto trace (JSON) into log_dir; it records CUDA
    activity where a card is present.
  * ``StepTimer``: wall-clock per-step timing with summary percentiles.
    Work on a card is asynchronous: pass ``barrier=torch.cuda.synchronize``
    so that a step's time includes its device work.
"""

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; yields the ``torch.profiler.profile`` object and
    writes ``trace_<pid>_<ns>.json`` into log_dir when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    def __init__(self):
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, barrier: Optional[Callable] = None):
        if barrier is not None:
            barrier()
        self._times.append(time.perf_counter() - self._t0)

    @contextlib.contextmanager
    def step(self, barrier: Optional[Callable] = None):
        self.start()
        try:
            yield
        finally:
            self.stop(barrier)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[min(n - 1, int(n * 0.9))],
            "steps_per_sec": n / sum(ts),
        }
