#!/usr/bin/env python3
"""Time variants of the GDN forward kernel's source against each other on one card.

Each variant is the forward's sources (csrc/gdn_kernel.cu and the headers
it includes, csrc/gdn_wgmma.cuh and csrc/gdn_wide.cuh) with text
substitutions applied, each [old, new] to the one source that holds old;
each is built by nvcc (all in parallel, with the port's flags) into
_build/variants/<name>/ and called through its C entry point at each
--shape ROWS:C (default the flagship's H/2 site of chip_smoke.py, C =
128), f32 and bf16, GDN and IGDN. Each variant's output is checked against
the plain version after every one of --checks launches (a race shows as a
wrong launch among many) and against the first variant's output, bit for
bit ("same bits" or "other bits"). The variants run in turns (first to
last, then last to first) so that drift of the card's clock shows. Prints ptxas's
register and spill lines of each variant's row kernels and one line of
times per shape, dtype and direction.

    python3 tools/gdn_variants.py variants.json [--shape ROWS:C ...] [--checks N]

variants.json maps a name to a list of [old, new] substitutions; the
source as it stands is {"base": []}. For example, three warpgroups for
float32 too, at the widths whose ring holds three tiles:
    {"base": [], "three": [["(ESZ == 2 && CP <= 192) ? 3 : 2", "(CP <= 128) ? 3 : 2"]]}
A name may map to a path instead, to time another commit's kernel (unpacked
with git archive) beside this one: its csrc/ directory, taken as it is, or
its gdn_kernel.cu alone, built against this checkout's headers.
tools/gdn_wide_variants.json holds the wide loop's (C > 128) design
choices, each undone: two consumer warpgroups everywhere, two (with two
fragment sets) at float32 192, gamma's planes written before the first box
is asked for, a cluster-scope release, no output stores, no products.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neural_image_compression_tpu_torch.ops.kernels import _build, gdn_kernel  # noqa: E402

SITE_SHAPE = f"{48 * 256 * 384}:128"  # H/2 at batch 48, 768x512, M = 128
HBM_BYTES_PER_S = 3.35e12
SOURCES = ("gdn_kernel.cu", "gdn_wgmma.cuh", "gdn_wide.cuh")


def build(variants):
    out_root = _build.BUILD_DIR / "variants"
    procs = {}
    for name, subs in variants.items():
        if isinstance(subs, str) and Path(subs).is_dir():
            srcs = {f.name: f.read_text() for f in Path(subs).glob("*.cu*")}
            subs = []
        elif isinstance(subs, str):
            srcs, subs = {"gdn_kernel.cu": Path(subs).read_text()}, []
        else:
            srcs = {f: (_build.CSRC / f).read_text() for f in SOURCES}
        for old, new in subs:
            holders = [f for f, src in srcs.items() if old in src]
            if len(holders) != 1:
                raise SystemExit(f"variant {name}: {old!r} is in {holders or 'no source'}")
            srcs[holders[0]] = srcs[holders[0]].replace(old, new)
        out_dir = out_root / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for f, src in srcs.items():
            (out_dir / f).write_text(src)
        # the variant's own headers come first (beside its .cu), then csrc/'s
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out_dir / f"lib{name}.so"), str(out_dir / "gdn_kernel.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc exited {proc.returncode}\n{log}")
        lines = log.splitlines()
        # ptxas's warnings (a wgmma pipeline it serializes, for one)
        for line in lines:
            if "warning" in line.lower():
                print(f"{name} {line.strip()}", flush=True)
        for k, line in enumerate(lines):
            if "Compiling" in line and "gdn_rows_kernel" in line:
                inst = line.split("gdn_rows_kernel", 1)[1].split("EEEv", 1)[0]
                usage = " ".join(x.split(":", 1)[-1].strip() for x in lines[k + 1:k + 4]
                                 if "registers" in x or "spill" in x)
                print(f"{name} gdn_rows_kernel{inst}: {usage}", flush=True)
        fn = ctypes.CDLL(str(out_root / name / f"lib{name}.so")).gdn_forward
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def median_ms(fn, reps=30):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("gdn_variants: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", type=Path)
    parser.add_argument("--shape", action="append", help="ROWS:C (repeatable)")
    parser.add_argument("--checks", type=int, default=1,
                        help="launches of each variant checked against the plain version")
    args = parser.parse_args()
    variants = json.loads(args.variants.read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    entries = build(variants)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for shape in args.shape or [SITE_SHAPE]:
        rows, C = map(int, shape.split(":"))
        gamma = np.abs(rng.normal(0.0, 0.02, (C, C))).astype(np.float32)
        gamma[np.arange(C), np.arange(C)] += 0.1
        g = torch.from_numpy(gamma).to(dev)
        b = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev)
        x32 = torch.from_numpy(rng.standard_normal((rows, C), dtype=np.float32)).to(dev)

        def run(fn, x, inverse):
            out = torch.empty_like(x)
            err = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(), rows, C,
                     int(inverse), int(x.dtype == torch.bfloat16),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"launch failed with CUDA error {err}")
            return out

        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            bound_ms = rows * C * x.element_size() * 2 / HBM_BYTES_PER_S * 1e3
            tol = 1e-5 if dtype == torch.float32 else 8e-3
            for inverse in (False, True):
                want = gdn_kernel.gdn_reference(x, g, b, inverse).float()
                order = list(entries.items())
                first = run(order[0][1], x, inverse)
                cells = []
                for name, fn in order + order[::-1]:
                    ok = all(torch.allclose(run(fn, x, inverse).float(), want, rtol=tol, atol=tol)
                             for _ in range(args.checks))
                    bits = "same bits" if torch.equal(run(fn, x, inverse), first) else "other bits"
                    ms = median_ms(lambda: run(fn, x, inverse))
                    cells.append(f"{name} {ms:.4f} ms ({100 * bound_ms / ms:.1f}%, {bits})"
                                 + ("" if ok else " WRONG"))
                print(f"rows={rows} C={C} {str(dtype).replace('torch.', '')} "
                      f"{'igdn' if inverse else 'gdn'}: " + ", ".join(cells), flush=True)
        del x32, x, want, first
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
