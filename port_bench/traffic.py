"""The general traffic generator: every mix is a data file
(``mixes/<name>.json``) read here.

``kind: "serve"``: a closed loop of one client. Each request is one batch
of ``batch`` images of ``height`` x ``width``, taken in turn from a pool of
``pool_batches`` distinct batches made on the card from the seed, served by
the program's serving function; it ends when the outputs are synchronised.
The next request starts when the previous one has ended, while the window
lasts.

``kind: "train"``: steps of the program's train step on batches of the
pool, enqueued ahead: before enqueuing a step the host waits on the CUDA
event of the step ``ahead`` behind it, and nowhere else until the one
synchronisation at the window's end. Each step's metric tensors are kept
and read after that end.

Images are smooth random fields in [0, 1] (uniform noise on an eighth of
the grid, bilinearly upsampled, with a little full-resolution noise), made
in one call on the device.
"""

import collections
import contextlib
import json
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

MIXES = Path(__file__).resolve().parent / "mixes"
DRIVERS = MIXES.parent / "drivers"


def load_mix(name: str, root: Path = MIXES, drivers: Path = DRIVERS) -> dict:
    """The mix ``<root>/<name>.json``; its ``kind`` names its driver,
    ``drivers/<kind>.py`` (in ``drivers`` or the benchmark's own)."""
    mix = json.loads((root / f"{name}.json").read_text())
    kind = f"{mix.get('kind')}.py"
    if not ((drivers / kind).is_file() or (DRIVERS / kind).is_file()):
        raise ValueError(f"mix {name}: no driver for kind {mix.get('kind')!r}")
    return mix


def make_pool(mix: dict, generator: torch.Generator, device) -> torch.Tensor:
    """(pool_batches, batch, height, width, 3) float32 in [0, 1]."""
    p, b, h, w = mix["pool_batches"], mix["batch"], mix["height"], mix["width"]
    coarse = torch.rand((p * b, 3, h // 8, w // 8), generator=generator, device=device)
    fine = torch.rand((p * b, 3, h, w), generator=generator, device=device)
    x = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    x = torch.clamp(x + 0.1 * (fine - 0.5), 0.0, 1.0)
    return x.permute(0, 2, 3, 1).contiguous().view(p, b, h, w, 3)


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, random.Random(seed), 0, {}

    def offer(self, index: int, item) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept[index] = item
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            del self.kept[sorted(self.kept)[j]]
            self.kept[index] = item


@dataclass
class Window:
    """What a window did: its bounds on the host clock, the host spans of
    each unit (request or step) and what each returned."""
    start: float = 0.0
    end: float = 0.0
    enqueue: List[tuple] = field(default_factory=list)  # (t0, t1) of each call
    latency: List[float] = field(default_factory=list)  # serve: call to synchronised outputs
    outputs: list = field(default_factory=list)         # each unit's metrics or rates

    @property
    def units(self) -> int:
        return len(self.enqueue)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def no_span(name):
    return contextlib.nullcontext()


def serve_window(serve: Callable, pool: torch.Tensor, seconds: float, first: int,
                 reservoir: Optional[Reservoir], captured: Optional[dict],
                 clock: Callable[[], float], synchronize: Callable[[], None],
                 span: Callable = no_span) -> Window:
    """Requests pool[(first + i) % P] for i = 0, 1, ... while the window
    lasts; each request's outputs, with the captured module outputs, are
    offered to ``reservoir`` under the request's number."""
    win = Window()
    n = pool.shape[0]
    win.start = clock()
    deadline = win.start + seconds
    i = 0
    while True:
        t0 = clock()
        if t0 >= deadline:
            break
        index = (first + i) % n
        with span("serve.call"):
            out = serve(pool[index])
        t1 = clock()
        with span("serve.sync"):
            synchronize()
        t2 = clock()
        win.enqueue.append((t0, t1))
        win.latency.append(t2 - t0)
        win.outputs.append({"bpp_total": out["bpp_total"]})
        win.end = t2
        if reservoir is not None:
            reservoir.offer(first + i, (index, out, dict(captured or {})))
        i += 1
    return win


def train_window(step: Callable, pool: torch.Tensor, generator, seconds: float, first: int,
                 ahead: int, clock: Callable[[], float], new_event: Callable,
                 synchronize: Callable[[], None], steps: Optional[int] = None,
                 span: Callable = no_span) -> Window:
    """Steps on pool[(first + k) % P] while the window lasts (or, given
    ``steps``, that many). Before each enqueue the host waits on the event
    of the step ``ahead`` behind; the window ends at the synchronisation
    after the last step."""
    win = Window()
    n = pool.shape[0]
    events = collections.deque()
    win.start = clock()
    deadline = win.start + seconds
    k = 0
    while steps is None or k < steps:
        if len(events) >= ahead:
            with span("train.wait"):
                events.popleft().synchronize()
        t0 = clock()
        if t0 >= deadline:
            break
        with span("train.step"):
            win.outputs.append(step(pool[(first + k) % n], generator))
            event = new_event()
            event.record()
        events.append(event)
        win.enqueue.append((t0, clock()))
        k += 1
    with span("train.sync"):
        synchronize()
    win.end = clock()
    return win
