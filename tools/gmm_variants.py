#!/usr/bin/env python3
"""Time variants of the mixture log-likelihood kernels' source against each other on one card.

Each variant is csrc/gmm_kernel.cu with text substitutions applied (each
[old, new], every occurrence), or, where the name maps to a path, another
commit's kernel (unpacked with git archive): its csrc/ directory or its
gmm_kernel.cu. Every variant is built by nvcc (all in parallel, with the
port's flags) into _build/variants_gmm/<name>/ and called through its C
entry points (gmm_logp_forward, gmm_logp_backward: the same signatures in
every commit) at each --shape ROWS:K:M (default the main path's three:
the serve's 73,728 rows, the train step's 4,096 and refinement's 1,536, K
= 3, M = 128). For each variant, shape and kernel it prints the median
CUDA-event ms a call, the profiler's device ms a launch, each with its
share of the device-memory bound ((3K + 2) M 4 bytes a row forward, (6K +
3) M 4 backward, at 3.35 TB/s), whether two runs give the same bits, the
bits against the first variant's, and WRONG where the forward's bulk
(p > 1e-6) is more than 1e-5 from the plain version or a gradient is
outside 1e-4 relative plus 1e-6 of the largest (chip_smoke.py's rules).
The variants run in turns (first to last, then last to first). The inputs
are the same every launch, so at 4,096 rows and fewer they may be in L2.

    python3 tools/gmm_variants.py variants.json [--shape ROWS:K:M ...] [--host ROOT ...]

variants.json maps a name to a list of [old, new] substitutions, or to a
path; the source as it stands is {"base": []}. tools/gmm_variants.json
undoes two of the kernels' design choices: the fit of small calls (a ring
of a block's tiles, more blocks an SM, one tile a block read directly)
and the 1,024-position tiles where a block takes 16 or more.
To set the parent commit beside them, unpack it (git archive) under
_checkout/parent and add "parent": "_checkout/parent/
neural_image_compression_tpu_torch/csrc" as the first entry.

--host ROOT (repeatable) also measures each checkout's wrapper on the
host: microseconds a call by the host clock, the median of five chunks of
200 calls each enqueued after a synchronize, at refinement's 1,536 x 3 x
128, for the public forward (no autograd), the public backward and an
autograd forward and backward (torch.autograd.grad), each checkout in its
own process, in turns (first to last, then last to first).
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neural_image_compression_tpu_torch.ops.kernels import _build, gmm_kernel  # noqa: E402

SHAPES = ("73728:3:128", "4096:3:128", "1536:3:128")  # serve, train step, refinement
HBM_BYTES_PER_S = 3.35e12
HOST_CALLS = 1000

HOST_SNIPPET = r"""
import json, statistics, sys, time
import numpy as np, torch
from neural_image_compression_tpu_torch.ops.kernels import gmm_kernel as gk
n, k, m, calls = 1536, 3, 128, int(sys.argv[1])
rng = np.random.default_rng(0)
y = torch.from_numpy(np.round(rng.normal(0, 2, (n, m))).astype(np.float32)).cuda()
w = torch.softmax(torch.from_numpy(rng.normal(size=(n, k, m)).astype(np.float32)), 1).cuda()
mu = torch.from_numpy(rng.normal(0, 2, (n, k, m)).astype(np.float32)).cuda()
s = torch.from_numpy(rng.uniform(0.2, 3.0, (n, k, m)).astype(np.float32)).cuda()
g = torch.ones(n, m, device="cuda")
leaves = [t.clone().requires_grad_(True) for t in (y, w, mu, s)]
cases = {"forward": lambda: gk.gmm_logp(y, w, mu, s),
         "backward": lambda: gk.gmm_logp_backward(y, w, mu, s, g),
         "autograd forward+backward": lambda: torch.autograd.grad(gk.gmm_logp(*leaves), leaves, g)}
out = {}
for name, fn in cases.items():
    for _ in range(50):
        fn()
    chunks = []
    for _ in range(5):  # the median of five chunks' means
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls // 5):
            fn()
        chunks.append((time.perf_counter() - t0) / (calls // 5) * 1e6)
    torch.cuda.synchronize()
    out[name] = statistics.median(chunks)
print(json.dumps(out))
"""


def build(variants):
    out_root = _build.BUILD_DIR / "variants_gmm"
    procs = {}
    for name, subs in variants.items():
        if isinstance(subs, str):
            path = Path(subs)
            src = (path / "gmm_kernel.cu" if path.is_dir() else path).read_text()
            subs = []
        else:
            src = (_build.CSRC / "gmm_kernel.cu").read_text()
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} is not in gmm_kernel.cu")
            src = src.replace(old, new)
        out_dir = out_root / name
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "gmm_kernel.cu").write_text(src)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
               str(out_dir / "gmm_kernel.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc exited {proc.returncode}\n{log}")
        lines = log.splitlines()
        for line in lines:
            if "warning" in line.lower():
                print(f"{name} {line.strip()}", flush=True)
        for i, line in enumerate(lines):
            if "Compiling" in line and "gmm_logp" in line:
                inst = line.split("Compiling entry function", 1)[-1].strip()
                usage = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                                 if "registers" in x or "spill" in x)
                print(f"{name} {inst}: {usage}", flush=True)
        lib = ctypes.CDLL(str(out_root / name / f"lib{name}.so"))
        fwd, bwd = lib.gmm_logp_forward, lib.gmm_logp_backward
        fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p]
        bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p]
        fwd.restype = bwd.restype = ctypes.c_int
        entries[name] = (fwd, bwd)
    return entries


def mixture_symbols(n, k, m, seed):
    """chip_smoke.py's inputs: mixture parameters and symbols drawn from the mixture."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, k, m))
    w = np.exp(a - a.max(axis=1, keepdims=True))
    w = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    mus = (2 * rng.normal(size=(n, k, m))).astype(np.float32)
    sigmas = (np.log1p(np.exp(rng.normal(size=(n, k, m)))) + 1e-6).astype(np.float32)
    comp = np.minimum((np.cumsum(w, axis=1) < rng.uniform(size=(n, 1, m))).sum(axis=1), k - 1)
    mu_sel = np.take_along_axis(mus, comp[:, None, :], axis=1)[:, 0, :]
    sig_sel = np.take_along_axis(sigmas, comp[:, None, :], axis=1)[:, 0, :]
    y = np.round(mu_sel + sig_sel * rng.normal(size=(n, m))).astype(np.float32)
    y[0, :] = 1000.0  # a row below the 1e-9 floor
    return y, w, mus, sigmas


def median_ms(fn, reps=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def profiler_ms(fn, launches=20, retries=3):
    """Device ms a launch of the kernels whose names hold "gmm_logp", by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if "gmm_logp" in e.key]
    count = sum(e.count for e in rows)
    if count < launches and retries:  # CUPTI dropped launches: take it again
        return profiler_ms(fn, launches, retries - 1)
    return sum(e.self_device_time_total for e in rows) / count / 1e3 if count else float("nan")


def host_times(roots):
    """Each checkout's wrapper on the host, in its own process, in turns."""
    results = {root: [] for root in roots}
    for root in list(roots) + list(roots)[::-1]:
        res = subprocess.run([sys.executable, "-c", HOST_SNIPPET, str(HOST_CALLS)], cwd=root,
                             env={**os.environ, "PYTHONPATH": str(root)},
                             capture_output=True, text=True, timeout=600)
        if res.returncode:
            raise SystemExit(f"host timing in {root} failed:\n{res.stderr[-3000:]}")
        results[root].append(json.loads(res.stdout.strip().splitlines()[-1]))
    for root, runs in results.items():
        cells = ", ".join(f"{name} " + " / ".join(f"{r[name]:.2f}" for r in runs) + " us"
                          for name in runs[0])
        print(f"host {root}: {cells} (a call, each run)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("gmm_variants: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", type=Path)
    parser.add_argument("--shape", action="append", help="ROWS:K:M (repeatable)")
    parser.add_argument("--host", action="append", default=[], type=Path,
                        help="a checkout whose wrapper's host time to measure (repeatable)")
    args = parser.parse_args()
    variants = json.loads(args.variants.read_text())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    entries = build(variants)
    stream = torch.cuda.current_stream().cuda_stream
    for shape in args.shape or SHAPES:
        n, k, m = map(int, shape.split(":"))
        dev = torch.device("cuda")
        y, w, mu, s = (torch.from_numpy(a).to(dev) for a in mixture_symbols(n, k, m, seed=1))
        g = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (n, m), dtype=np.float32)).to(dev)
        want = gmm_kernel.mixture_log_likelihood_reference(y, w, mu, s)
        want_grads = gmm_kernel.mixture_log_likelihood_backward_reference(y, w, mu, s, g)
        bulk = want > float(np.log(1e-6))
        fwd_bound = (3 * k + 2) * m * n * 4 / HBM_BYTES_PER_S * 1e3
        bwd_bound = (6 * k + 3) * m * n * 4 / HBM_BYTES_PER_S * 1e3
        out = torch.empty_like(y)
        grads = [torch.empty_like(y)] + [torch.empty_like(w) for _ in range(3)]

        def forward(fn):
            err = fn(y.data_ptr(), w.data_ptr(), mu.data_ptr(), s.data_ptr(), out.data_ptr(),
                     n, k, m, stream)
            if err:
                raise SystemExit(f"forward launch failed with CUDA error {err}")

        def backward(fn):
            err = fn(y.data_ptr(), w.data_ptr(), mu.data_ptr(), s.data_ptr(), g.data_ptr(),
                     *(t.data_ptr() for t in grads), n, k, m, stream)
            if err:
                raise SystemExit(f"backward launch failed with CUDA error {err}")

        first = {}
        for kind, bound_ms in (("forward", fwd_bound), ("backward", bwd_bound)):
            cells = []
            order = list(entries.items())
            for name, (fwd, bwd) in order + order[::-1]:
                fn = fwd if kind == "forward" else bwd
                run = (lambda: forward(fn)) if kind == "forward" else (lambda: backward(fn))
                run()
                got = [out.clone()] if kind == "forward" else [t.clone() for t in grads]
                run()
                now = [out] if kind == "forward" else grads
                repeat = all(torch.equal(a, b) for a, b in zip(got, now))
                first.setdefault(kind, got)
                bits = all(torch.equal(a, b) for a, b in zip(got, first[kind]))
                if kind == "forward":
                    ok = bool(((got[0] - want).abs()[bulk] <= 1e-5).all())
                else:
                    ok = all(bool(((a - b).abs() <= 1e-4 * b.abs() + 1e-6 * b.abs().max()).all())
                             for a, b in zip(got, want_grads))
                ms = median_ms(run)
                prof_ms = profiler_ms(run)
                cells.append(f"{name} {ms:.4f} ms ({100 * bound_ms / ms:.1f}%) profiler "
                             f"{prof_ms:.4f} ms ({100 * bound_ms / prof_ms:.1f}%), "
                             f"{'same bits' if bits else 'other bits'}"
                             f"{'' if repeat else ', RUNS DIFFER'}{'' if ok else ' WRONG'}")
            print(f"rows={n} K={k} M={m} {kind} (bound {bound_ms:.4f} ms): " + "; ".join(cells),
                  flush=True)
        del y, w, mu, s, g, want, want_grads, out, grads, first
        torch.cuda.empty_cache()
    if args.host:
        host_times(args.host)
    return 0


if __name__ == "__main__":
    sys.exit(main())
