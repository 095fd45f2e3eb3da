#!/usr/bin/env python3
"""Run the GDN kernels again and again on the same inputs and show where their bits move.

A race in a kernel (a stage of a ring refilled under a load still in
flight) can give results within tolerance that differ from run to run in
a few rows. This script calls each kernel five times a case and compares
every run's output with the first's: how many elements differ, the
largest relative difference, the rows (and their remainder modulo the
launch's tile rows) and the channels.

- The forward (this checkout's kernel, through ops/kernels/gdn_kernel.gdn)
  at the residual and scalable models' serve rows and the train step's
  H/2 rows (4,718,592 and 262,144) at C = 192 and 256, and the LST's
  train rows (16,384 at C = 256), float32 and bfloat16, GDN and IGDN.
- The backward, each variant of variants.json built as
  tools/gdn_bwd_variants.py builds it, through its C entry point, each run
  with its own scratch filled with NaN: at C = 192 and 256 dx alone (no
  dgamma/dbeta stage), the scratch's t (the norm launch's output) and dx
  (the mix launch's), at 262,144, 65,536 and 98,304 rows of C = 192 and
  262,144 and 16,384 of 256; at C = 128, where the fused launch writes t
  only for the dgamma/dbeta stage, with that stage: t and dx (the fused
  launch's), dgamma and dbeta, at 262,144, 98,304, 16,387 and 8,575 rows
  (ragged, and 67 tiles: the clusters take unequal numbers); float32 and
  bfloat16, GDN.

    python3 tools/gdn_repeats.py variants.json
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import gdn_bwd_variants as gv  # noqa: E402
from neural_image_compression_tpu_torch.ops.kernels import gdn_kernel  # noqa: E402

FORWARD_CASES = ((4_718_592, 192), (262_144, 192), (4_718_592, 256), (262_144, 256),
                 (16_384, 256))
BACKWARD_CASES = ((262_144, 192), (65_536, 192), (262_144, 256), (98_304, 192), (16_384, 256),
                  (262_144, 128), (98_304, 128), (16_387, 128), (8_575, 128))
REPEATS = 4
DTYPES = (torch.float32, torch.bfloat16)


def run_backward(entry, x, gamma, beta, g, param_grads):
    """{"t": t, "dx": dx} and, with param_grads, dgamma and dbeta from one
    call of the entry point (t: the scratch's first n * c values, which
    every layout of it starts with)."""
    n, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    dx = torch.empty_like(x)
    dgamma, dbeta = (torch.empty_like(gamma), torch.empty_like(beta)) if param_grads else (None,
                                                                                          None)
    chunk_rows, chunks = gdn_kernel._chunking(n)
    floats = n * c * (2 if bf16 else 1) + (chunks * c * (c + 1) if param_grads else 0)
    scratch = torch.full((floats,), float("nan"), device=x.device)
    err = entry(x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(), dx.data_ptr(),
                None if dgamma is None else dgamma.data_ptr(),
                None if dbeta is None else dbeta.data_ptr(), scratch.data_ptr(), n, c,
                chunk_rows, chunks, 0, int(bf16), torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed with CUDA error {err}")
    torch.cuda.synchronize()
    out = {"t": scratch[:n * c].view(n, c).clone(), "dx": dx}
    if param_grads:
        out.update(dgamma=dgamma, dbeta=dbeta.view(1, -1))
    return out


def where(a, b, tile_rows):
    differ = a.float() != b.float()
    if not bool(differ.any()):
        return "same"
    idx = differ.nonzero()
    rows, cols = idx[:, 0], idx[:, 1]
    rel = ((a.float() - b.float()).abs() / b.float().abs().clamp_min(1e-30))[differ].max().item()
    return (f"{int(differ.sum())} differ, max rel {rel:.2e}, rows {int(rows.min())}.."
            f"{int(rows.max())} (modulo tile rows {sorted(set((rows % tile_rows).tolist()))[:12]}), "
            f"channels {sorted(set(cols.tolist()))[:24]}")


def summary(diffs):
    return (f"{sum(d != 'same' for d in diffs)} of {REPEATS} runs differ "
            f"({next((d for d in diffs if d != 'same'), 'same')})")


def forward_repeats(rng, dev):
    for rows, c in FORWARD_CASES:
        gamma, beta = cs.gdn_params(c, rng, dev)
        x32 = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        for dtype in DTYPES:
            x = x32.to(dtype)
            tile_rows = gdn_kernel.wide_geometry(c, x.element_size())["tile_rows"]
            for inverse in (False, True):
                first = gdn_kernel.gdn(x, gamma, beta, inverse)
                diffs = [where(gdn_kernel.gdn(x, gamma, beta, inverse), first, tile_rows)
                         for _ in range(REPEATS)]
                print(f"forward rows={rows} C={c} {str(dtype).replace('torch.', '')} "
                      f"{'igdn' if inverse else 'gdn'}: out {summary(diffs)}", flush=True)
                del first
        del x32, x


def backward_repeats(entries, rng, dev):
    for rows, c in BACKWARD_CASES:
        gamma, beta = cs.gdn_params(c, rng, dev)
        x32 = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        g32 = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        for dtype in DTYPES:
            x, g = x32.to(dtype), g32.to(dtype)
            esz = x.element_size()
            fused = c <= 128
            if fused:
                tile_rows = gdn_kernel.wide_geometry(c, esz, "backward")["tile_rows"]
                rows_of = dict(t=tile_rows, dx=tile_rows, dgamma=c, dbeta=c)
            else:
                rows_of = dict(t=gdn_kernel.wide_geometry(c, esz, "norm")["tile_rows"],
                               dx=gdn_kernel.wide_geometry(c, esz, "mix")["tile_rows"])
            for name, entry in entries.items():
                first = run_backward(entry, x, gamma, beta, g, fused)
                diffs = {k: [] for k in first}
                for _ in range(REPEATS):
                    again = run_backward(entry, x, gamma, beta, g, fused)
                    for k in first:
                        diffs[k].append(where(again[k], first[k], rows_of[k]))
                print(f"backward {name} rows={rows} C={c} {str(dtype).replace('torch.', '')}"
                      f"{' with dgamma/dbeta' if fused else ''}: "
                      + "; ".join(f"{k} {summary(d)}" for k, d in diffs.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("gdn_repeats: no CUDA device", file=sys.stderr)
        return 1
    entries = gv.build(json.loads(Path(sys.argv[1]).read_text()))
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    forward_repeats(rng, dev)
    backward_repeats(entries, rng, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
