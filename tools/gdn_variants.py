#!/usr/bin/env python3
"""Time variants of the GDN kernel's source against each other on one card.

Each variant is csrc/gdn_kernel.cu with text substitutions applied; each is
built by nvcc (all in parallel, with the port's flags) into
_build/variants/ and called through its C entry point at the flagship's
GDN shape (C = 128, ROWS rows, default the H/2 site of chip_smoke.py),
f32 and bf16, GDN and IGDN, after a check against the plain version. The
variants run in turns (first to last, then last to first) so that drift
of the card's clock shows. Prints ptxas's register and spill lines per
variant and one line of times per dtype and direction.

    python3 tools/gdn_variants.py variants.json [ROWS]

variants.json maps a name to a list of [old, new] substitutions; the
source as it stands is {"base": []}. For example, three warpgroups for
float32 too, at the widths whose ring holds three tiles:
    {"base": [], "three": [["(ESZ == 2 && CP <= 192) ? 3 : 2", "(CP <= 128) ? 3 : 2"]]}
A name may map to a path instead: another gdn_kernel.cu taken as it is (an
older commit's, unpacked with git archive), to time it beside this one.
"""

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

C = 128
SITE_ROWS = 48 * 256 * 384  # H/2 at batch 48, 768x512
HBM_BYTES_PER_S = 3.35e12


def build(variants):
    source = (_build.CSRC / "gdn_kernel.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        if isinstance(subs, str):
            src, subs = Path(subs).read_text(), []
        else:
            src = source
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        # -I: the variant lives in _build/variants/, its header in csrc/
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out_dir / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc exited {proc.returncode}\n{log}")
        usage = sorted({line.strip() for line in log.splitlines()
                        if "registers" in line or "spill" in line})
        print(f"{name}: " + " ; ".join(usage), flush=True)
        fn = ctypes.CDLL(str(out_dir / f"lib{name}.so")).gdn_forward
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
    variants = json.loads(Path(sys.argv[1]).read_text())
    rows = int(sys.argv[2]) if len(sys.argv) > 2 else SITE_ROWS
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; rows={rows} C={C}")
    entries = build(variants)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gamma = np.abs(rng.normal(0.0, 0.02, (C, C))).astype(np.float32)
    gamma[np.arange(C), np.arange(C)] += 0.1
    g = torch.from_numpy(gamma).to(dev)
    b = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev)
    x32 = torch.from_numpy(rng.standard_normal((rows, C), dtype=np.float32)).to(dev)

    def run(fn, x, inverse):
        out = torch.empty_like(x)
        err = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(), rows, C, int(inverse),
                 int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
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
            cells = []
            for name, fn in order + order[::-1]:
                ok = torch.allclose(run(fn, x, inverse).float(), want, rtol=tol, atol=tol)
                ms = median_ms(lambda: run(fn, x, inverse))
                cells.append(f"{name} {ms:.4f} ms ({100 * bound_ms / ms:.1f}%)"
                             + ("" if ok else " WRONG"))
            print(f"{str(dtype).replace('torch.', '')} {'igdn' if inverse else 'gdn'}: "
                  + ", ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
