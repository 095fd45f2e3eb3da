#!/usr/bin/env python3
"""Time variants of the GDN backward's source against each other on one card.

Each variant is the backward's sources (csrc/gdn_bwd_kernel.cu and the
headers it includes, csrc/gdn_wgmma.cuh and csrc/gdn_wide.cuh) with text
substitutions applied, each [old, new] to the one source that holds old,
or another commit's sources taken as they are: its csrc/ directory
(unpacked with git archive), or its gdn_bwd_kernel.cu alone, built against
this checkout's headers. Each is built by nvcc (all in parallel, with the
port's flags) into _build/bwd_variants/<name>/ and called through its C
entry point in place of the port's own. At each --shape ROWS:C (default
every train site with the dgamma/dbeta stage, and refinement's C=192 rows),
f32 and bf16, GDN and IGDN: the backward against its plain version
(chip_smoke.check_gdn_backward, unless the variant is marked unchecked);
each launch's device time from torch.profiler (norm, mix, partials,
reduce, or at 65 to 128 channels fused, partials, reduce:
chip_smoke.partials_stage) beside the bytes floor of the launches that
compute dx (norm and mix: t written once and read once, d1; the fused
launch: x and g read, dx and t written), so that a parent's norm + mix and
this checkout's fused launch read side by side; the whole backward's time
and that of dx alone (no dgamma/dbeta stage) from CUDA events; and whether
dx, dgamma and dbeta are bit-identical to the first variant's. The variants run in turns (first to
last, then last to first) so that drift of the card's clock shows. Prints
ptxas's register and spill lines of each variant's rows and partials
instantiations and one summary line per case.

    python3 tools/gdn_bwd_variants.py variants.json [--shape ROWS:C ...]

(about 4 minutes a variant). variants.json maps a name to [substitutions
or a path, checked]; the source as it stands is {"base": [[], true]}, the
parent commit's {"parent": ["<dir>/neural_image_compression_tpu_torch/csrc",
true]}. A variant that computes something else on purpose (one product of
the three, to see what the products cost) is [subs, false].
tools/gdn_bwd_wide_variants.json holds the cluster loop's backward design
choices (C > 128), each undone: no L2 prefetch, one chunk of gamma's loads
in flight in place of four, gamma's planes written before the first box is
asked for, fragments a box at a time in place of a k-step, IGDN's terms
correctly rounded. tools/gdn_repeats.py takes the
same file to look for bits that move from run to run.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from neural_image_compression_tpu_torch.ops.kernels import _build, gdn_kernel  # noqa: E402

# every train site with the dgamma/dbeta stage (batch 16 of 256x256): H/2,
# H/4 and H/8 at C=128 (the flagship; the LST's C=128 is H/8's rows) and
# C=192 (the residual and scalable families), the LST's C=256; refinement's
# H/2 rows at C=128 and C=192 (one 768x512 image)
CASES = ("262144:128", "65536:128", "16384:128", "98304:128", "262144:192", "65536:192",
         "16384:192", "16384:256", "98304:192")
SOURCES = ("gdn_bwd_kernel.cu", "gdn_wgmma.cuh", "gdn_wide.cuh")
OUTPUTS = ("dx", "dgamma", "dbeta")


def build(variants):
    out_root = _build.BUILD_DIR / "bwd_variants"
    procs = {}
    for name, (subs, _) in variants.items():
        if isinstance(subs, str) and Path(subs).is_dir():
            srcs = {f.name: f.read_text() for f in Path(subs).glob("*.cu*")}
            subs = []
        elif isinstance(subs, str):
            srcs, subs = {"gdn_bwd_kernel.cu": Path(subs).read_text()}, []
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
               "-o", str(out_dir / f"lib{name}.so"), str(out_dir / "gdn_bwd_kernel.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc exited {proc.returncode}\n{log}")
        lines = log.splitlines()
        # ptxas's warnings (a wgmma pipeline it serializes, for one)
        for line in lines:
            if "warning" in line.lower():
                print(f"  {name} {line.strip()}", flush=True)
        for k, line in enumerate(lines):
            if "Compiling" in line and any(f"gdn_bwd_{s}_kernel" in line
                                           for s in ("norm", "mix", "fused", "partials")):
                inst = line.split("gdn_bwd_", 1)[1].split("EEEv", 1)[0]
                usage = " ".join(x.split(":", 1)[-1].strip() for x in lines[k + 1:k + 4]
                                 if "registers" in x or "spill" in x)
                print(f"  {name} {inst}: {usage}")
        fn = ctypes.CDLL(str(out_root / name / f"lib{name}.so")).gdn_backward
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def use_widest_scratch():
    """Makes ops/kernels/gdn_kernel.py give every entry point the scratch
    of the widest layout (t; d1 for bfloat16 rows; the partials): another
    commit's entry point may need what this checkout's does not (before the
    fused launch at 65 to 128 channels, t and d1 at every width)."""
    gdn_kernel._scratch_floats = lambda n, c, bf16, param_grads, chunks: (
        n * c * (2 if bf16 else 1) + (chunks * c * (c + 1) if param_grads else 0))


def rows_floor_ms(rows, c, esz, fused):
    """The bytes floor of the launches that compute dx, with the
    dgamma/dbeta stage: norm reads x and g and writes t and d1 (float32),
    mix reads t, x and d1 and writes dx; or the fused launch reads x and g
    and writes dx and t."""
    per_element = 3 * esz + 4 if fused else 2 * esz + 8 + 2 * esz + 8
    return rows * c * per_element / cs.HBM_BYTES_PER_S * 1e3


def rows_ms(launches, rows, c, esz):
    """The launches that compute dx in one profile, as "norm + mix" or
    "fused" ms with their share of rows_floor_ms, or "not measured"."""
    if launches.get("fused"):
        ms = launches["fused"]
        return f"fused {ms:.4f} ({100 * rows_floor_ms(rows, c, esz, True) / ms:.1f}%)"
    norm, mix = launches.get("norm"), launches.get("mix")
    if norm and mix:
        return (f"{norm:.4f} + {mix:.4f} "
                f"({100 * rows_floor_ms(rows, c, esz, False) / (norm + mix):.1f}%)")
    return "not measured"


def main() -> int:
    if not torch.cuda.is_available():
        print("gdn_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", type=Path)
    parser.add_argument("--shape", action="append", help="ROWS:C (repeatable)")
    args = parser.parse_args()
    variants = json.loads(args.variants.read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    entries = build(variants)
    use_widest_scratch()
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    data = []
    for shape in args.shape or CASES:
        rows, c = map(int, shape.split(":"))
        gamma, beta = cs.gdn_params(c, rng, dev)
        x = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        g = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        data.append((rows, c, gamma, beta, x, g))
    runs, first_bits, same = {}, {}, {}
    order = list(variants)
    for name in order + order[::-1]:
        gdn_kernel._backward_entry = lambda fn=entries[name]: fn
        for rows, c, gamma, beta, x32, g32 in data:
            for dtype in (torch.float32, torch.bfloat16):
                x, g = x32.to(dtype), g32.to(dtype)
                dname = str(dtype).replace("torch.", "")
                for inverse in (False, True):
                    direction = "igdn" if inverse else "gdn"
                    label = f"{name} rows={rows} C={c} {dname} {direction}"
                    if variants[name][1]:
                        cs.check_gdn_backward(x, gamma, beta, g, inverse, label)
                    got = gdn_kernel.gdn_backward(x, gamma, beta, g, inverse)
                    key = (rows, c, dname, direction)
                    if name == order[0]:
                        first_bits.setdefault(key, got)
                    else:
                        same.setdefault((key, name), [
                            o for o, a, b in zip(OUTPUTS, got, first_bits[key])
                            if torch.equal(a, b)])
                    del got
                    stage = cs.partials_stage(x, gamma, beta, g, inverse, label,
                                              expect=(cs.BWD_LAUNCHES_TWO,
                                                      cs.BWD_LAUNCHES_FUSED))
                    whole = cs.median_ms(
                        lambda: gdn_kernel.gdn_backward(x, gamma, beta, g, inverse))
                    dx_ms = cs.median_ms(lambda: gdn_kernel.gdn_backward(
                        x, gamma, beta, g, inverse, param_grads=False))
                    runs.setdefault(key, {}).setdefault(name, []).append(
                        (stage["launches_ms"], whole, dx_ms))
    print(f"== each run: norm + mix or fused ms (profiler; share of their bytes floor), "
          f"partials ms, whole backward / dx alone ms (CUDA events); bits of dx, dgamma, dbeta "
          f"against {order[0]}'s")
    for (rows, c, dname, direction), by_name in runs.items():
        esz = 4 if dname == "float32" else 2
        floors = " / ".join(f"{rows_floor_ms(rows, c, esz, fused):.4f}" for fused in (False, True))
        cells = []
        for name, r in by_name.items():
            each = []
            for launches, whole, dx_ms in r:
                part = launches.get("partials")
                each.append(f"{rows_ms(launches, rows, c, esz)}, "
                            f"{part if part is None else round(part, 4)}, "
                            f"{whole:.4f} / {dx_ms:.4f}")
            held = same.get(((rows, c, dname, direction), name))
            bits = "" if held is None else f" [same bits: {', '.join(held) or 'none'}]"
            cells.append(f"{name} " + " | ".join(each) + bits)
        print(f"rows={rows} C={c} {dname} {direction} (floor norm + mix / fused {floors} ms): "
              + "  ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
