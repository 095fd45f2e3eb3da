#!/usr/bin/env python3
"""Time variants of the GDN backward's source against each other on one card.

Each variant is csrc/gdn_bwd_kernel.cu with text substitutions applied, or
another gdn_bwd_kernel.cu taken as it is (a path); each is built by nvcc
(all in parallel, with the port's flags) into _build/bwd_variants/ and
called through its C entry point in place of the port's own. At each train
site (rows, C), f32 and bf16, GDN: the backward against its plain version
(chip_smoke.check_gdn_backward, unless the variant is marked unchecked),
the dgamma/dbeta partials launch's device time from torch.profiler
(chip_smoke.partials_stage) and the whole backward's time from CUDA
events. The variants run in turns (first to last, then last to first) so
that drift of the card's clock shows. Prints ptxas's register and spill
lines of each variant's partials instantiations and one summary line per
case.

    python3 tools/gdn_bwd_variants.py variants.json

(about 2 minutes a variant). variants.json maps a name to [substitutions
or a path, checked]; the source as it stands is {"base": [[], true]}, the
parent commit's (unpacked with git archive) {"parent": ["<dir>/neural_
image_compression_tpu_torch/csrc/gdn_bwd_kernel.cu", true]}. A variant
that computes something else on purpose (one product of the three, to see
what the products cost) is [subs, false].
"""

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
# C=192 (the residual and scalable families), the LST's C=256
CASES = ((262_144, 128), (65_536, 128), (16_384, 128), (262_144, 192), (65_536, 192),
         (16_384, 192), (16_384, 256))


def build(variants):
    source = (_build.CSRC / "gdn_bwd_kernel.cu").read_text()
    out_dir = _build.BUILD_DIR / "bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (subs, _) in variants.items():
        src = Path(subs).read_text() if isinstance(subs, str) else source
        for old, new in ([] if isinstance(subs, str) else subs):
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        lib = out_dir / f"lib{name}.so"
        # -I: the variant lives in _build/bwd_variants/, its header in csrc/
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
               str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    entries = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc exited {proc.returncode}\n{log}")
        lines = log.splitlines()
        for k, line in enumerate(lines):
            if "partials_kernel" in line and "Compiling" in line:
                inst = line.split("partials_kernel", 1)[1].split("EEEv", 1)[0]
                usage = " ".join(x.split(":", 1)[-1].strip() for x in lines[k + 1:k + 4]
                                 if "registers" in x or "spill" in x)
                print(f"  {name} {inst}: {usage}")
        fn = ctypes.CDLL(str(lib)).gdn_backward
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("gdn_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    variants = json.loads(Path(sys.argv[1]).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    entries = build(variants)
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    data = []
    for rows, c in CASES:
        gamma, beta = cs.gdn_params(c, rng, dev)
        x = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        g = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        data.append((rows, c, gamma, beta, x, g))
    runs = {}
    for name in list(variants) + list(variants)[::-1]:
        gdn_kernel._backward_entry = lambda fn=entries[name]: fn
        for rows, c, gamma, beta, x32, g32 in data:
            for dtype in (torch.float32, torch.bfloat16):
                x, g = x32.to(dtype), g32.to(dtype)
                label = f"{name} rows={rows} C={c} {str(dtype).replace('torch.', '')}"
                if variants[name][1]:
                    cs.check_gdn_backward(x, gamma, beta, g, False, label)
                stage = cs.partials_stage(x, gamma, beta, g, False, label)
                whole = cs.median_ms(lambda: gdn_kernel.gdn_backward(x, gamma, beta, g))
                runs.setdefault((rows, c, label.rsplit(" ", 1)[1]), {}).setdefault(
                    name, []).append((stage["ms"], whole))
    print("== partials ms (profiler) / whole backward ms (CUDA events), each run")
    for (rows, c, dname), by_name in runs.items():
        print(f"rows={rows} C={c} {dname}: " + "  ".join(
            f"{name} " + ", ".join(f"{p if p is None else round(p, 4)}/{w:.4f}" for p, w in r)
            for name, r in by_name.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
