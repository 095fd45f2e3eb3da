#!/usr/bin/env python3
"""Where the device time goes in the PyTorch port's serving forward.

Profiles the flagship eval forward (JointAutoregressiveHierarchical, M=128,
K=3) through make_serving_fn at 768x512, batch 48 and batch 1, in float32
and bfloat16 transforms, with torch.profiler on one CUDA card. Prints, per
configuration, the device time by layer (cuDNN convolutions, the GDN kernel,
the mixture-likelihood kernel, other) and the device's busy share of the
profiled window, then one JSON line with the same numbers. Imports only the
port, never JAX; TF32 off as in chip_smoke.py.

    python3 tools/profile_torch_serve.py
"""

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neural_image_compression_tpu_torch.models import JointAutoregressiveHierarchical  # noqa: E402
from neural_image_compression_tpu_torch.serving import make_serving_fn  # noqa: E402

ITERS = 3


def layer_of(kernel_name: str) -> str:
    n = kernel_name.lower()
    if "gdn_rows_kernel" in n:
        return "gdn kernel"
    if "gmm_logp_kernel" in n:
        return "gmm kernel"
    if any(s in n for s in ("conv", "xmma", "cudnn", "implicit", "dgrad", "wgrad", "fprop")):
        return "cudnn conv"
    if "gemm" in n or "cutlass" in n:
        return "gemm"
    return "other (elementwise, softmax, reductions, copies)"


def profile_config(serve, x):
    serve(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            serve(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_layer = defaultdict(float)
    by_kernel = defaultdict(float)
    for evt in prof.key_averages():
        dev_us = evt.self_device_time_total
        if dev_us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_layer[layer_of(evt.key)] += dev_us / 1e3 / ITERS
        by_kernel[evt.key] += dev_us / 1e3 / ITERS
    device_ms = sum(by_layer.values())
    return {"wall_ms_per_forward": wall_ms / ITERS, "device_ms_per_forward": device_ms,
            "device_busy_share": device_ms / (wall_ms / ITERS),
            "by_layer_ms": dict(sorted(by_layer.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    x48 = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(48, 512, 768, 3)).astype(np.float32)).cuda()
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        serve = make_serving_fn(JointAutoregressiveHierarchical(128, 3, dtype=dtype, device="cuda"))
        for batch in (48, 1):
            tag = f"{str(dtype).replace('torch.', '')} batch {batch}"
            r = profile_config(serve, x48[:batch].contiguous())
            results[tag] = r
            print(f"== {tag}: wall {r['wall_ms_per_forward']:.3f} ms/forward, device "
                  f"{r['device_ms_per_forward']:.3f} ms, busy {100 * r['device_busy_share']:.1f}% "
                  f"[{card}]")
            for layer, ms in r["by_layer_ms"].items():
                print(f"   {layer:50s} {ms:9.3f} ms  {100 * ms / r['device_ms_per_forward']:5.1f}%")
            for name, ms in r["top_kernels_ms"].items():
                print(f"     {ms:9.3f} ms  {name[:110]}")
    print(json.dumps({"card": card, "profile": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
