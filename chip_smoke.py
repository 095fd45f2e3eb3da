#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (neural_image_compression_tpu_torch)
on one NVIDIA GPU: the quickest proof that the port builds and runs there.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: torch and CUDA versions, the card's name and power limit; build
     every kernel from csrc/ (one nvcc per source, in parallel).
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the flagship's shapes (batch 48 at 768x512, M = 128, K = 3),
     timed with CUDA events beside its bound.
  3. cross-device parity: the M=128, K=3 eval forward on the card against
     the same weights on the CPU (the card runs the kernels, the CPU their
     plain versions).
  4. serve: the flagship eval forward through make_serving_fn at 768x512,
     batch 48 and batch 1, in float32 and bfloat16 transforms, with the
     kernels' launch counts read over exactly this phase.
The last lines are the kernels' JSON record and
{"ok": true, "device": {...}}.

TF32 is off throughout (convolutions and products in full float32).
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from neural_image_compression_tpu_torch.models import JointAutoregressiveHierarchical
from neural_image_compression_tpu_torch.ops.kernels import (
    _build, gdn_kernel, gmm_kernel, reset_launch_counts,
)
from neural_image_compression_tpu_torch.serving import make_serving_fn
from neural_image_compression_tpu_torch.train import rd_loss

# Published H100 SXM peaks (NVIDIA data sheet): device memory and float32
# outside the tensor cores. Both kernels compute in float32.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

M, K = 128, 3
BATCH, HEIGHT, WIDTH = 48, 512, 768
# GDN rows (B*h*w) at the three transform depths; each depth has one GDN
# (encoder) and one IGDN (decoder) site.
GDN_SITES = {"H/2": BATCH * (HEIGHT // 2) * (WIDTH // 2),
             "H/4": BATCH * (HEIGHT // 4) * (WIDTH // 4),
             "H/8": BATCH * (HEIGHT // 8) * (WIDTH // 8)}
GMM_ROWS = BATCH * (HEIGHT // 16) * (WIDTH // 16)
GDN_PER_FORWARD, GMM_PER_FORWARD = 6, 1
TIMING_REPS = 20

# cross-device parity: seed and gains on the last analysis convs chosen so
# that y and z spread over several integers and keep a rounding margin
# (checked at run time) above the two devices' difference
PARITY_SEED, PARITY_GAIN_Y, PARITY_GAIN_Z = 10, 4.0, 12.0
MIN_ROUNDING_MARGIN = 1e-5

SERVE_ITERS, LATENCY_ITERS = 5, 10

KERNEL_INFO = {
    "gdn": {"route": "cuda",
            "source": "neural_image_compression_tpu_torch/csrc/gdn_kernel.cu",
            "replaces": "neural_image_compression_tpu/ops/pallas/gdn_kernel.py:20"},
    "gmm_logp": {"route": "cuda",
                 "source": "neural_image_compression_tpu_torch/csrc/gmm_kernel.cu",
                 "replaces": "neural_image_compression_tpu/ops/pallas/gmm_kernel.py:59"},
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each of
    ``reps`` calls enqueued back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def bound(nbytes: float, flops: float):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


# --- phase 2: kernels against their plain versions --------------------------

def gdn_cases(dev):
    rng = np.random.default_rng(0)
    c = M
    gamma = np.abs(rng.normal(0.0, 0.02, (c, c))).astype(np.float32)
    gamma[np.arange(c), np.arange(c)] += 0.1
    gamma_t = torch.from_numpy(gamma).to(dev)
    beta_t = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(dev)
    records = []
    for site, rows in GDN_SITES.items():
        x32 = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
            x = x32.to(dtype)
            for inverse in (False, True):
                got = gdn_kernel.gdn(x, gamma_t, beta_t, inverse)
                want = gdn_kernel.gdn_reference(x, gamma_t, beta_t, inverse)
                torch.cuda.synchronize()
                check(got.dtype == dtype, f"gdn output dtype {got.dtype}")
                err = (got.float() - want.float()).abs().max().item()
                name = "igdn" if inverse else "gdn"
                # tolerance: f32 1e-5 (sum order of 128 products); bf16 one
                # rounding step of the output (2^-7 relative)
                check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                      f"{name} {site} {dtype}: max abs err {err:.3e} beyond {tol}")
                if dtype == torch.float32:
                    # both against float64 math on a slice: shows the size of
                    # the rounding the kernel-vs-plain comparison can see
                    xs = x[:8192].double()
                    n64 = (xs * xs) @ gamma_t.double() + beta_t.double()
                    exact = xs * (n64.sqrt() if inverse else n64.rsqrt())
                    err64 = ((got[:8192].double() - exact).abs() / exact.abs().clamp_min(1e-30)).max().item()
                    check(err64 <= 1e-5, f"{name} {site}: max rel err vs float64 {err64:.3e}")
                    print(f"  {name:4s} {site} float32 kernel max rel err vs float64: {err64:.3e}")
                del got, want
                ms = median_ms(lambda: gdn_kernel.gdn(x, gamma_t, beta_t, inverse))
                plain_ms = median_ms(lambda: gdn_kernel.gdn_reference(x, gamma_t, beta_t, inverse))
                io_bytes = rows * c * x.element_size() * 2 + (c * c + c) * 4
                bound_ms, bound_by = bound(io_bytes, 2.0 * rows * c * c + 4.0 * rows * c)
                records.append(dict(
                    name="gdn", **KERNEL_INFO["gdn"], site=site, inverse=inverse,
                    shape=[rows, c], dtype=str(dtype).replace("torch.", ""),
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None))
                print(f"  {name:4s} {site} rows={rows} {str(dtype):14s} err={err:.3e} "
                      f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
                      f"({bound_by})", flush=True)
        del x32, x
    return records


def mixture_symbols(n, k, m, seed):
    """Mixture params and symbols drawn from the mixture (a trained model's regime)."""
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
    return y, w, mus, sigmas


def gmm_cases(dev):
    n, k, m = GMM_ROWS, K, M
    args = [torch.from_numpy(a).to(dev) for a in mixture_symbols(n, k, m, seed=1)]
    got = gmm_kernel.gmm_logp(*args)
    want = gmm_kernel.mixture_log_likelihood_reference(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    bulk = want > float(np.log(1e-6))
    check(bulk.float().mean().item() > 0.99, "mixture symbols: bulk share")
    # tolerances: logp to 1e-5 where p > 1e-6 (both use CUDA's erff, so
    # only the order of the K-sum may differ), total nats to 1e-6
    bulk_err = (got[bulk] - want[bulk]).abs().max().item()
    check(bulk_err <= 1e-5, f"gmm_logp bulk max abs err {bulk_err:.3e}")
    tot_got, tot_want = got.double().sum().item(), want.double().sum().item()
    check(abs(tot_got - tot_want) <= 1e-6 * abs(tot_want),
          f"gmm_logp total nats {tot_got} vs {tot_want}")
    # the 1e-9 floor: symbols far outside every component
    y_far = torch.full_like(args[0], 1000.0)
    floor = gmm_kernel.gmm_logp(y_far, *args[1:])
    check(torch.allclose(floor, torch.full_like(floor, float(np.log(1e-9))), rtol=1e-6),
          "gmm_logp floor")
    ms = median_ms(lambda: gmm_kernel.gmm_logp(*args))
    plain_ms = median_ms(lambda: gmm_kernel.mixture_log_likelihood_reference(*args))
    io_bytes = (3 * k + 2) * m * n * 4
    # about 34 float32 operations per (position, component), counting each
    # erff as 10, plus the floor and the log per position
    bound_ms, bound_by = bound(io_bytes, (34.0 * k + 12.0) * n * m)
    print(f"  gmm  rows={n} K={k} M={m} err={err:.3e} (bulk {bulk_err:.3e}) "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    return [dict(name="gmm_logp", **KERNEL_INFO["gmm_logp"], shape=[n, k, m], dtype="float32",
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=None)]


# --- phase 3: the card against the CPU ---------------------------------------

def rounding_margin(v: torch.Tensor) -> float:
    f = v.double().abs()
    return (f - f.floor() - 0.5).abs().min().item()


def parity(dev):
    cpu_model = JointAutoregressiveHierarchical(M, K, device="cpu", seed=PARITY_SEED)
    with torch.no_grad():
        for conv, gain in ((cpu_model.encoder.Conv2d_3, PARITY_GAIN_Y),
                           (cpu_model.hyper_encoder.Conv2d_2, PARITY_GAIN_Z)):
            conv.weight.mul_(gain)
            conv.bias.mul_(gain)
    card_model = JointAutoregressiveHierarchical(M, K, device=dev, seed=PARITY_SEED)
    card_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(np.random.default_rng(PARITY_SEED).uniform(
        size=(2, 256, 256, 3)).astype(np.float32))
    ref = cpu_model(x, training=False)
    got = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
           for k, v in card_model(x.to(dev), training=False).items()}
    for key in ("y", "z"):
        margin = rounding_margin(ref[key])
        diff = (got[key] - ref[key]).abs().max().item()
        print(f"  {key}: rounding margin {margin:.3e}, card-vs-cpu max diff {diff:.3e}")
        check(margin >= MIN_ROUNDING_MARGIN, f"{key} rounding margin {margin:.3e}")
        check(diff < margin, f"{key} differs by {diff:.3e}, more than its margin")
        check(torch.equal(got[key + "_in"], ref[key + "_in"]), f"{key}_in differs")
    check(int((ref["y_in"] != 0).sum()) > 0, "y_in is all zeros")
    tolerances = {"x_hat": 1e-4, "logp_y": 1e-4, "logp_z": 1e-4, "weights": 1e-5,
                  "mus": 1e-4, "sigmas": 1e-4}
    for key, tol in tolerances.items():
        err = (got[key] - ref[key]).abs().max().item()
        print(f"  {key}: max abs diff {err:.3e} (tolerance {tol:g})")
        check(torch.allclose(got[key], ref[key], rtol=tol, atol=tol), f"{key} max diff {err:.3e}")
    loss_ref, loss_got = rd_loss(ref, x, 0.005), rd_loss(got, x, 0.005)
    for key in ("bpp_y", "bpp_z", "bpp_total"):
        a, b = loss_got[key].item(), loss_ref[key].item()
        print(f"  {key}: card {a:.7f} cpu {b:.7f}")
        check(abs(a - b) <= 1e-5 * abs(b), f"{key} card {a} vs cpu {b}")


# --- phase 4: the main path ---------------------------------------------------

def serve_phase(dev, card: str):
    rng = np.random.default_rng(2)
    x48 = torch.from_numpy(rng.uniform(size=(BATCH, HEIGHT, WIDTH, 3)).astype(np.float32)).to(dev)
    x1 = x48[:1].contiguous()
    forwards = 0
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = JointAutoregressiveHierarchical(M, K, dtype=dtype, device=dev, seed=0)
        serve = make_serving_fn(model)
        torch.cuda.reset_peak_memory_stats(dev)
        before = (gdn_kernel.gdn.launches, gmm_kernel.gmm_logp.launches)
        out = serve(x48)
        torch.cuda.synchronize()
        forwards += 1
        after = (gdn_kernel.gdn.launches, gmm_kernel.gmm_logp.launches)
        check(after[0] - before[0] == GDN_PER_FORWARD and after[1] - before[1] == GMM_PER_FORWARD,
              f"one forward launched {after[0] - before[0]} gdn and {after[1] - before[1]} gmm")
        check(out["x_hat"].shape == (BATCH, HEIGHT, WIDTH, 3), "x_hat shape")
        check(bool(torch.isfinite(out["x_hat"]).all()), "x_hat not finite")
        for key in ("bpp_y", "bpp_z", "bpp_total"):
            check(out[key].shape == (BATCH,), f"{key} shape")
            check(bool(torch.isfinite(out[key]).all() and (out[key] > 0).all()),
                  f"{key} not finite and positive")
        times = []
        for _ in range(SERVE_ITERS):
            t0 = time.perf_counter()
            serve(x48)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        forwards += SERVE_ITERS
        serve(x1)
        torch.cuda.synchronize()
        lat = []
        for _ in range(LATENCY_ITERS):
            t0 = time.perf_counter()
            serve(x1)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        forwards += 1 + LATENCY_ITERS
        name = str(dtype).replace("torch.", "")
        results[name] = dict(
            img_per_s=BATCH / statistics.median(times),
            batch48_ms=1e3 * statistics.median(times),
            batch1_latency_ms=1e3 * statistics.median(lat),
            peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            bpp_total_mean=out["bpp_total"].mean().item())
        print(f"  {name}: {results[name]['img_per_s']:.2f} img/s at batch {BATCH} "
              f"({results[name]['batch48_ms']:.2f} ms), batch-1 latency "
              f"{results[name]['batch1_latency_ms']:.3f} ms, peak memory "
              f"{results[name]['peak_mem_gib']:.2f} GiB [{card}]", flush=True)
        del model, serve, out
    return forwards, results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    print("== phase 1: device and build", flush=True)
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(card, flush=True)  # name and power limit, as nvidia-smi gives them
    t0 = time.perf_counter()
    _build.build(verbose=True)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    print("== phase 2: kernels against their plain versions", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    records = gdn_cases(dev) + gmm_cases(dev)

    print("== phase 3: card against CPU, M=128 K=3, 2x256x256", flush=True)
    torch.set_num_threads(8)
    parity(dev)

    print(f"== phase 4: serve, M={M} K={K}, {HEIGHT}x{WIDTH} [{card}]", flush=True)
    reset_launch_counts()
    forwards, serve_results = serve_phase(dev, card)
    launches = {"gdn": gdn_kernel.gdn.launches, "gmm_logp": gmm_kernel.gmm_logp.launches}
    check(launches["gdn"] == GDN_PER_FORWARD * forwards,
          f"gdn launches {launches['gdn']} over {forwards} forwards")
    check(launches["gmm_logp"] == GMM_PER_FORWARD * forwards,
          f"gmm launches {launches['gmm_logp']} over {forwards} forwards")
    print(f"main path: {forwards} forwards, launches {launches}")
    print(json.dumps({"serve": serve_results, "card": card}))

    for r in records:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
