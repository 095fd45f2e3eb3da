#!/usr/bin/env python3
"""The flagship's serve and train (``chip_smoke.py`` phases 4 and 5) of
several checkouts of the repo, in turns, on one card: parent against
change where a change touches code the flagship runs.

Each ``DIR:TAG`` runs in its own process, which imports that checkout's
package and ``chip_smoke.py`` and builds its kernels into that checkout's
``_build/`` (the first run of a checkout pays the build). Each prints one
JSON line: img/s and batch-1 latency (f32, bf16), steps/s and ms a step
(bf16, f32), and the card's name and power limit.

    git archive <parent> | tar -x -C _checkout/parent   (and the change)
    python3 tools/ab_flagship.py _checkout/parent:p1 _checkout/change:c1 \\
        _checkout/change:c2 _checkout/parent:p2
"""

import json
import os
import subprocess
import sys
import time


def run_one(root: str, tag: str) -> None:
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from neural_image_compression_tpu_torch.ops.kernels import _build, reset_launch_counts

    if not torch.cuda.is_available():
        raise SystemExit("ab_flagship: no CUDA device")
    t0 = time.perf_counter()
    _build.build(verbose=False)
    build_s = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(8)
    dev = torch.device("cuda")
    card = cs.card_line()
    reset_launch_counts()
    _, serve = cs.serve_phase(dev, card)
    _, train = cs.train_phase(dev, card)
    print(json.dumps({
        "tag": tag, "checkout": root, "build_s": build_s, "card": card,
        "serve": {k: {m: v[m] for m in ("img_per_s", "batch1_latency_ms")}
                  for k, v in serve.items()},
        "train": {k: {m: v[m] for m in ("steps_per_s", "ms_per_step")}
                  for k, v in train.items()}}), flush=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        run_one(argv[1], argv[2])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for spec in argv:
        root, tag = spec.rsplit(":", 1)
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, tag],
                             capture_output=True, text=True)
        lines = [line for line in res.stdout.splitlines() if line.startswith('{"tag"')]
        if res.returncode != 0 or not lines:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
            return res.returncode or 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
