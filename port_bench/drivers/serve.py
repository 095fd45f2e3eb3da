"""Serving: a closed loop of one client over the program's serving function
(``traffic.serve_window``); the check compares a sample of the window's
requests, drawn from the seed, with the reference's eval forward."""

from typing import Dict

import torch

from port_bench import checks, traffic
from port_bench.reference import layers as L

UNIT = "serve"


def unit_name(config) -> str:
    return UNIT


def setup(session) -> None:
    from neural_image_compression_tpu_torch.serving import make_serving_fn

    session.model.eval()
    session.serve = make_serving_fn(session.model)
    session.captured = {}
    for name, module in session.cell.family.captured_modules(session.model).items():
        module.register_forward_hook(
            lambda mod, args, out, name=name: session.captured.__setitem__(name, out))
    # as many outputs alive as the window's sample holds, so that the
    # allocator has grown to the window's needs before it starts
    k = session.mix["checked_requests"]
    n = max(session.mix["warmup_requests"], k + 1)
    held = [(session.serve(session.pool[i % session.pool.shape[0]]), dict(session.captured))
            for i in range(n)]
    session.synchronize()
    del held
    session.first = n


def window(session, seconds: float, span) -> traffic.Window:
    session.sample = traffic.Reservoir(session.mix["checked_requests"], session.sample_seed)
    return traffic.serve_window(session.serve, session.pool, seconds, session.first,
                                session.sample, session.captured, session.clock,
                                session.synchronize, span)


def failed(session, win: traffic.Window) -> int:
    """Requests whose rate is not finite."""
    if not win.outputs:
        return 0
    values = torch.stack([o["bpp_total"].float().reshape(-1).sum() for o in win.outputs])
    return int((~torch.isfinite(values)).sum())


def check(session) -> Dict[str, float]:
    numbers = {}
    for index, served, captured in session.sample.kept.values():
        ref = checks.serve_reference(session.cell, session.weights, session.pool[index])
        for k, v in checks.serve_numbers(served, captured, ref).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    return numbers


def calibration(session) -> dict:
    """The control's readings beside the program's: the reference with fp8
    operands and results, on the same sampled requests, judged as the
    program's outputs are, and each rate's gap for both sides."""
    control, gaps = {}, {"program": [], "control": []}
    for index, served, _ in session.sample.kept.values():
        x = session.pool[index]
        ref = checks.serve_reference(session.cell, session.weights, x)
        ctl = checks.serve_reference(session.cell, session.weights, x, num=L.Numerics("fp8"))
        for k, v in checks.serve_reference_numbers(ref, ctl).items():
            control[k] = max(control.get(k, 0.0), v)
        gaps["program"].append((served, ref))
        gaps["control"].append((ctl, ref))
    return {"control_fp8": control,
            "rates": {side: _rate_summary(pairs) for side, pairs in gaps.items()}}


def _rate_summary(pairs) -> dict:
    """Each rate's gap over the checked images: the largest, the mean, and
    that of the mean rate."""
    out = {}
    for k in checks.RATES:
        got = torch.cat([a[k].float() for a, _ in pairs])
        want = torch.cat([b[k] for _, b in pairs])
        gap = torch.abs(got - want) / want.abs()
        out[k] = {"max": float(gap.max()), "mean": float(gap.mean()),
                  "of_mean": float(abs(got.mean() - want.mean()) / want.mean().abs())}
    return out
