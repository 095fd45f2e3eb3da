"""Readings that the correctness limits are set from, for one cell at its
own size, on the card: per seed, the program's numbers (as a run computes
them, after a short window at the cell's own load), the control's (the
reference in the next precision down, judged against the reference) and,
for a training cell, the half-batch fault's: each driver's
``calibration``.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1 2 3 [--program-only]

The benchmark's own runs never run this. Prints one JSON line a seed.
"""

import argparse
import json
import sys

import torch

from port_bench import cells
from port_bench.session import Session

def readings(cell, seed: int, device, seconds: float, program_only: bool) -> dict:
    session = Session(cell, seed, device)
    session.setup()
    session.quiesce()
    session.window(seconds)
    session.free_program()
    out = {"seed": seed, "program": session.check()}
    if not program_only:
        out.update(cell.driver.calibration(session))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--program-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    cell = cells.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, torch.device("cuda", 0), args.seconds,
                                  args.program_only)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
