#!/usr/bin/env python3
"""Host time of the PyTorch port's native coders at the flagship's latent
grid (M=128, K=3, 768x512 -> 32x48 latents), with no device in the loop.

Random integer latents and psi (seeded) go through the wavefront coder as
one stream and as N interleaved streams (encode_n / decode_n: OpenMP
threads over the streams of each wave), and through the portable integer
coder. The one stream's encode is also split into the wavefront's
parameter sweep alone (``backend.arwave_param_sweep_time``: context gather
and entropy-parameter GEMMs) and the rest (CDFs and rANS). Prints the median ms of a few calls, the bytes, the host's core
count and the OpenMP settings it ran under, then one JSON line. The weights
are the model's random init from a seed; the coders' work does not depend
on their values.

    python3 tools/time_host_coders.py [--reps 3]
    OMP_NUM_THREADS=1 python3 tools/time_host_coders.py
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neural_image_compression_tpu_torch.coding import PortableCard, backend, codec  # noqa: E402
from neural_image_compression_tpu_torch.coding.portable import (  # noqa: E402
    portable_ar_decode, portable_ar_encode,
)
from neural_image_compression_tpu_torch.models import JointAutoregressiveHierarchical  # noqa: E402

M, K, H, W = 128, 3, 32, 48
STREAMS = (1, 2, 4, 8)


def median_ms(fn, reps):
    fn()  # warm-up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    model = JointAutoregressiveHierarchical(M, K, device="cpu", seed=10)
    coder = codec._HostParamNets(model).native_coder()
    rng = np.random.default_rng(0)
    y = np.round(rng.normal(scale=1.5, size=(H, W, M))).astype(np.float32)
    z = np.round(rng.normal(scale=1.5, size=(H // 4, W // 4, M))).astype(np.float32)
    psi = rng.normal(size=(H, W, 2 * M)).astype(np.float32)
    out = {"cores": os.cpu_count(), "omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
           "omp_wait_policy": os.environ.get("OMP_WAIT_POLICY"), "streams": {}}
    one = coder.encode(y, psi)
    out["one_stream"] = dict(bytes=len(one), encode_ms=median_ms(lambda: coder.encode(y, psi),
                                                                 args.reps),
                             decode_ms=median_ms(lambda: coder.decode(one, psi, H, W), args.reps))
    r = out["one_stream"]
    r["sweep_ms"] = median_ms(lambda: backend.arwave_param_sweep_time(coder, y, psi), args.reps)
    r["cdf_rans_ms"] = r["encode_ms"] - r["sweep_ms"]
    for n in STREAMS:
        data = coder.encode_n(y, psi, n)
        out["streams"][n] = dict(
            bytes=len(data), extra_bytes=len(data) - len(one),
            encode_ms=median_ms(lambda: coder.encode_n(y, psi, n), args.reps),
            decode_ms=median_ms(lambda: coder.decode_n(data, psi, H, W, n), args.reps))
    card = PortableCard.build(model)
    psi_fix = card.hyper_forward(z)
    data = portable_ar_encode(card, y, psi_fix)
    out["portable"] = dict(
        bytes=len(data), encode_ms=median_ms(lambda: portable_ar_encode(card, y, psi_fix),
                                             args.reps),
        decode_ms=median_ms(lambda: portable_ar_decode(card, data, psi_fix, H, W), args.reps))
    print(f"{out['cores']} cores, OMP_NUM_THREADS={out['omp_num_threads']}, "
          f"OMP_WAIT_POLICY={out['omp_wait_policy']}")
    r = out["one_stream"]
    print(f"one stream: {r['bytes']} bytes, encode {r['encode_ms']:.1f} ms, "
          f"decode {r['decode_ms']:.1f} ms; of the encode, the parameter sweep "
          f"{r['sweep_ms']:.1f} ms and CDFs + rANS {r['cdf_rans_ms']:.1f} ms")
    for n, r in out["streams"].items():
        print(f"n_streams={n}: +{r['extra_bytes']} bytes, encode {r['encode_ms']:.1f} ms, "
              f"decode {r['decode_ms']:.1f} ms")
    r = out["portable"]
    print(f"portable: {r['bytes']} bytes, encode {r['encode_ms']:.1f} ms, "
          f"decode {r['decode_ms']:.1f} ms")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
