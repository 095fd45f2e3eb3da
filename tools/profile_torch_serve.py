#!/usr/bin/env python3
"""Where the device time goes in the PyTorch port's serving forward, its
training step, its Trainer or its latent refinement.

Profiles, with torch.profiler on one CUDA card, the flagship
(JointAutoregressiveHierarchical, M=128, K=3), or with --family another
family at the same widths (MeanScaleHyperprior, CheckerboardHierarchical,
ChannelCheckerboardHierarchical with groups (16, 16, 32, 64), or
FactorizedPrior, which has no K), the residual family at its own
(HierarchicalMixtureResidual, M=192, K=1: the 3x3 residual transforms) or
the scalable family at its own (ScalableImageCoding, M=192, M1=128, K=1:
the LatentSpaceTransform on y1; its step and Trainer run vision_rd_loss at
lambda 0.01 with the vision term, gamma 1, against a frozen width-64
YOLOv5 teacher cut at layer 3), in
float32 and bfloat16 transforms: by
default the eval forward through make_serving_fn at 768x512,
batch 48 and batch 1; with --train the training step through
make_train_step (batch 16 of 256x256, rd_loss at lambda 0.005, Adam 1e-4);
with --trainer a step of train.Trainer (the same batch and loss, the
default Adam) at scalar_interval 1 (TensorBoard and JSONL, or JSONL alone)
and 1000 (a batch on the card, or uint8 batches from a BatchLoader) beside
the bare make_train_step, each also timed without the profiler and with
its scalar logging split into the fetch and the sinks' writes; with --refine
one call of coding.make_refiner (20 steps at lr 1e-2, lambda 0.005) on one
768x512 image; with --sweep a step of train.vmapped_lambda_sweep over L = 3
replicas (lambda 0.0018, 0.0067, 0.025; f32, batch 16 of 256x256: the
grouped convolutions of torch.func.vmap, GDN once a replica) beside the
single f32 training step, the sweep's window opened and closed from its
log_fn (log_every=1: one host sync a step). With --bwd-parent CSRC
(another commit's csrc/ directory, unpacked with git archive) each
configuration is profiled twice in one process, first with that commit's
GDN backward (built as tools/gdn_bwd_variants.py builds a variant) and
then with this checkout's, and their backward launches are printed side
by side (before and after the fused launch at 65 to 128 channels: norm +
mix against fused).
Prints, per configuration, the device time by layer (cuDNN convolutions,
the GDN kernels, the GDN backward split by launch: norm, mix, partials and
reduce, or at 65 to 128 channels fused, partials and reduce, the
mixture-likelihood kernels, the optimizer, other) and
the device's busy share of the profiled window and its host gap (wall less
device time), then one JSON line with the same numbers. Imports only the
port, never JAX; TF32 off as in chip_smoke.py, and cuDNN's autotuning off
(its heuristic picks each convolution's algorithm) unless --autotune.

    python3 tools/profile_torch_serve.py [--train | --trainer | --refine | --sweep]
        [--family joint_ar|hyperprior|checkerboard|channel_cb|factorized|residual|scalable]
        [--autotune] [--bwd-parent CSRC]
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neural_image_compression_tpu_torch.coding import make_refiner  # noqa: E402
from neural_image_compression_tpu_torch.models import (  # noqa: E402
    ChannelCheckerboardHierarchical, CheckerboardHierarchical, FactorizedPrior,
    HierarchicalMixtureResidual, JointAutoregressiveHierarchical, MeanScaleHyperprior,
    ScalableImageCoding, build_yolo_backbone, distillation_targets,
)
from neural_image_compression_tpu_torch.ops.kernels import gdn_kernel  # noqa: E402
from neural_image_compression_tpu_torch.parallel import make_train_step  # noqa: E402
from neural_image_compression_tpu_torch.serving import make_serving_fn  # noqa: E402
from neural_image_compression_tpu_torch.data import BatchLoader  # noqa: E402
from neural_image_compression_tpu_torch.train import (  # noqa: E402
    MetricsLogger, Trainer, rd_loss, vision_rd_loss, vmapped_lambda_sweep,
)
from neural_image_compression_tpu_torch.train import trainer as trainer_module  # noqa: E402

ITERS = 3


def factorized_prior(latent_channels, K, **kw):
    """FactorizedPrior with the hierarchical families' call shape (it has
    no K)."""
    return FactorizedPrior(latent_channels, **kw)


factorized_prior.__name__ = "FactorizedPrior"
# family -> (model constructor, (M, K))
FAMILIES = {"joint_ar": (JointAutoregressiveHierarchical, (128, 3)),
            "hyperprior": (MeanScaleHyperprior, (128, 3)),
            "checkerboard": (CheckerboardHierarchical, (128, 3)),
            "channel_cb": (ChannelCheckerboardHierarchical, (128, 3)),
            "factorized": (factorized_prior, (128, 3)),
            "residual": (HierarchicalMixtureResidual, (192, 1)),
            "scalable": (ScalableImageCoding, (192, 128, 1))}
# the profiled family's model constructor and widths (--family)
MODEL, WIDTHS = FAMILIES["joint_ar"]


def build(dtype):
    """The profiled family's model on the card, random weights from seed 0."""
    return MODEL(*WIDTHS, dtype=dtype, device="cuda")


def objective():
    """(loss, lambda) of the profiled family's step: rd_loss at 0.005, or
    for the scalable family vision_rd_loss at 0.01 with the vision term
    (gamma 1) against a frozen YOLOv5 teacher of width M1/2 cut at layer 3
    (seed 42, float32)."""
    if MODEL is not ScalableImageCoding:
        return rd_loss, 0.005
    act, V = distillation_targets(build_yolo_backbone(WIDTHS[1] // 2, device="cuda", seed=42), 3)
    return functools.partial(vision_rd_loss, gamma=1.0, frozen_activation=act, V=V), 0.01


def layer_of(kernel_name: str) -> str:
    n = kernel_name.lower()
    if "gdn_bwd_" in n:
        # one layer per launch of csrc/gdn_bwd_kernel.cu: gdn_bwd_<launch>_kernel
        return "gdn backward kernel: " + n.split("gdn_bwd_", 1)[1].split("_kernel", 1)[0]
    if "gdn_rows_kernel" in n:
        return "gdn kernel"
    if "gmm_logp_backward_kernel" in n:
        return "gmm backward kernel"
    if "gmm_logp_kernel" in n:
        return "gmm kernel"
    if "multi_tensor_apply" in n or "adam" in n:
        return "optimizer (Adam)"
    if any(s in n for s in ("conv", "xmma", "cudnn", "implicit", "dgrad", "wgrad", "fprop")):
        return "cudnn conv"
    if "gemm" in n or "cutlass" in n:
        return "gemm"
    return "other (elementwise, softmax, reductions, copies)"


def profile_config(run, x, warmup=1):
    for _ in range(warmup):
        run(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            run(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return summarize(prof, wall_ms)


def summarize(prof, wall_ms):
    """Device ms a call by layer and by kernel of a profile over ITERS calls
    that took wall_ms."""
    by_layer = defaultdict(float)
    by_kernel = defaultdict(float)
    for evt in prof.key_averages():
        dev_us = evt.self_device_time_total
        # record_function ranges (Optimizer.step, ...) also appear on the
        # device timeline and would count their kernels twice
        if (dev_us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        by_layer[layer_of(evt.key)] += dev_us / 1e3 / ITERS
        by_kernel[evt.key] += dev_us / 1e3 / ITERS
    device_ms = sum(by_layer.values())
    return {"wall_ms_per_call": wall_ms / ITERS, "device_ms_per_call": device_ms,
            "device_busy_share": device_ms / (wall_ms / ITERS),
            "host_gap_ms_per_call": wall_ms / ITERS - device_ms,
            "by_layer_ms": dict(sorted(by_layer.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])}


def report(tag, r, card, unit):
    print(f"== {tag}: wall {r['wall_ms_per_call']:.3f} ms/{unit}, device "
          f"{r['device_ms_per_call']:.3f} ms, busy {100 * r['device_busy_share']:.1f}%, host gap "
          f"{r['host_gap_ms_per_call']:.3f} ms [{card}]")
    for layer, ms in r["by_layer_ms"].items():
        print(f"   {layer:50s} {ms:9.3f} ms  {100 * ms / r['device_ms_per_call']:5.1f}%")
    for name, ms in r["top_kernels_ms"].items():
        print(f"     {ms:9.3f} ms  {name[:110]}")


def profile_serve(card):
    x48 = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(48, 512, 768, 3)).astype(np.float32)).cuda()
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        serve = make_serving_fn(build(dtype))
        for batch in (48, 1):
            tag = f"{str(dtype).replace('torch.', '')} batch {batch}"
            results[tag] = profile_config(serve, x48[:batch].contiguous())
            report(tag, results[tag], card, "forward")
    return results


def profile_train(card):
    x = torch.rand((16, 256, 256, 3), generator=torch.Generator(device="cuda").manual_seed(7),
                   device="cuda")
    # how the gradient reaches the GDN backward: rows as they are, or in
    # another layout the wrapper must copy first (autograd looks the
    # Function's backward up on the class at each call)
    backward = gdn_kernel._GDN.backward
    layouts = {"calls": 0, "g_copied": 0}

    def tallied(ctx, g):
        layouts["calls"] += 1
        layouts["g_copied"] += int(not g.is_contiguous())
        return backward(ctx, g)

    results = {}
    gdn_kernel._GDN.backward = staticmethod(tallied)
    try:
        loss, lam = objective()
        for dtype in (torch.bfloat16, torch.float32):
            model = build(dtype)
            opt = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
            step = make_train_step(model, opt, loss, lam)
            tag = f"{str(dtype).replace('torch.', '')} train step, batch 16 of 256x256"
            results[tag] = profile_config(step, x, warmup=3)
            report(tag, results[tag], card, "step")
            del model, opt, step
    finally:
        gdn_kernel._GDN.backward = staticmethod(backward)
    print(f"GDN backward: g came in another layout than contiguous rows, and was copied, in "
          f"{layouts['g_copied']} of {layouts['calls']} calls")
    results["gdn_backward_g_layout"] = layouts
    return results


TRAINER_TIMED = 20


def timed_ms(run, x, steps=TRAINER_TIMED):
    """Host-clock ms a call over ``steps`` calls, no profiler, one sync at
    the end (the profiler's own host work inflates a host-bound step)."""
    run(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


class ScalarLogTimer:
    """Host ms a step in the Trainer's scalar logging: the fetch
    (host_scalars, which waits for the step's last kernel) and the sinks'
    writes (JSONL, TensorBoard)."""

    def __init__(self, trainer):
        self.fetch_s = self.sinks_s = 0.0
        fetch, scalar = trainer_module.host_scalars, trainer.logger.scalar

        def timed_fetch(metrics):
            t0 = time.perf_counter()
            out = fetch(metrics)
            self.fetch_s += time.perf_counter() - t0
            return out

        def timed_scalar(*args):
            t0 = time.perf_counter()
            scalar(*args)
            self.sinks_s += time.perf_counter() - t0

        self._fetch = timed_fetch
        trainer.logger.scalar = timed_scalar

    def __enter__(self):
        self._saved = trainer_module.host_scalars
        trainer_module.host_scalars = self._fetch
        return self

    def __exit__(self, *exc):
        trainer_module.host_scalars = self._saved


def profile_trainer(card):
    """A Trainer step (its loop body: the step, the scalars' fetch and
    writes at scalar_interval 1, the learning rate) against the bare step:
    on the same batch already on the card, with JSONL and TensorBoard sinks
    or JSONL alone, and at scalar_interval 1000 also on uint8 batches from a
    prefetching BatchLoader (the host-to-device copy each step). Each
    configuration: host-clock ms a step over 20 steps without the profiler,
    then the profiler's device time over 3."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand((16, 256, 256, 3), generator=gen, device="cuda")
    patches = list(np.random.default_rng(7).integers(0, 256, size=(64, 256, 256, 3),
                                                     dtype=np.uint8))
    results = {}
    loss, lam = objective()
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")

            def bare():
                model = build(dtype)
                opt = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
                return make_train_step(model, opt, loss, lam)

            def trainer(interval, loader=None, tensorboard=True):
                log_dir = os.path.join(tmp, f"{name}_{interval}_{len(results)}")
                t = Trainer(build(dtype),
                            loader or [x], rd_loss=loss, lambda_val=lam, scalar_interval=interval,
                            log_interval=10 ** 9, img_interval=10 ** 9, log_dir=log_dir,
                            checkpoint_path=None)
                if not tensorboard:
                    t.logger.close()
                    t.logger = MetricsLogger(log_dir, tensorboard=False)
                t.max_steps = 3  # step 0's diagnostics run here
                t.train()

                def one_step(_):
                    t.max_steps = t.step + 1
                    t.train()

                return one_step, t

            configs = [("bare make_train_step", lambda: (bare(), None)),
                       ("Trainer, scalar_interval 1", lambda: trainer(1)),
                       ("Trainer, scalar_interval 1, JSONL only",
                        lambda: trainer(1, tensorboard=False)),
                       ("Trainer, scalar_interval 1000", lambda: trainer(1000)),
                       ("Trainer, scalar_interval 1000, uint8 BatchLoader",
                        lambda: trainer(1000, loader=BatchLoader(patches, batch_size=16,
                                                                 shuffle=True, prefetch=2))),
                       ("bare make_train_step, again", lambda: (bare(), None))]
            for label, make in configs:
                run, t = make()
                tag = f"{name} {label}, batch 16 of 256x256"
                if t is not None and t.scalar_interval == 1:
                    with ScalarLogTimer(t) as log_timer:
                        wall = timed_ms(run, x)
                    per_step = TRAINER_TIMED + 1
                    log_ms = {"fetch_ms": 1e3 * log_timer.fetch_s / per_step,
                              "sinks_ms": 1e3 * log_timer.sinks_s / per_step}
                else:
                    wall, log_ms = timed_ms(run, x), {}
                results[tag] = profile_config(run, x, warmup=1)
                results[tag].update(unprofiled_ms_per_step=wall, **log_ms)
                report(tag, results[tag], card, "step")
                print(f"   without the profiler: {wall:.3f} ms a step"
                      + (f"; scalar logging: fetch {log_ms['fetch_ms']:.3f} ms, sinks "
                         f"{log_ms['sinks_ms']:.3f} ms a step" if log_ms else ""), flush=True)
                del run, t
    return results


def profile_refine(card):
    x = torch.from_numpy(np.random.default_rng(12).uniform(
        size=(1, 512, 768, 3)).astype(np.float32)).cuda()
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        refine = make_refiner(build(dtype), objective()[1], steps=20, lr=1e-2)
        tag = f"{str(dtype).replace('torch.', '')} refine, 20 steps, 1x768x512"
        results[tag] = profile_config(refine, x)
        report(tag, results[tag], card, "call")
    return results


SWEEP_LAMBDAS = (0.0018, 0.0067, 0.025)


def profile_sweep(card):
    x = torch.rand((16, 256, 256, 3), generator=torch.Generator(device="cuda").manual_seed(7),
                   device="cuda")
    loss, lam = objective()
    model = build(torch.float32)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    results = {"f32 train step, batch 16 of 256x256": profile_config(
        make_train_step(model, opt, loss, lam), x, warmup=3)}
    del opt
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    stamps = []

    def window(line):
        # after steps 0 and 1 (warm-up), ITERS steps profiled
        stamps.append(time.perf_counter())
        if len(stamps) == 2:
            prof.start()
        elif len(stamps) == 2 + ITERS:
            torch.cuda.synchronize()
            prof.stop()

    model = build(torch.float32)
    vmapped_lambda_sweep(model, SWEEP_LAMBDAS, [x], 2 + ITERS, rd_loss=loss, log_every=1,
                         log_fn=window)
    results[f"f32 sweep step, L={len(SWEEP_LAMBDAS)}"] = summarize(
        prof, (stamps[-1] - stamps[1]) * 1e3)
    for tag, r in results.items():
        report(tag, r, card, "step")
    return results


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile the training step instead of the serving forward")
    mode.add_argument("--trainer", action="store_true",
                      help="profile a train.Trainer step against the bare training step")
    mode.add_argument("--refine", action="store_true",
                      help="profile latent refinement instead of the serving forward")
    mode.add_argument("--sweep", action="store_true",
                      help="profile a vmapped_lambda_sweep step (L=3, f32) beside one step")
    parser.add_argument("--family", choices=sorted(FAMILIES), default="joint_ar",
                        help="the model family to profile (M=128, K=3 where it has a "
                             "mixture; residual: M=192, K=1; scalable: M=192, M1=128, K=1)")
    parser.add_argument("--autotune", action="store_true",
                        help="turn on cuDNN's autotuning (torch.backends.cudnn.benchmark)")
    parser.add_argument("--bwd-parent", metavar="CSRC",
                        help="another commit's csrc/ directory: profile each configuration "
                             "with its GDN backward, then with this checkout's")
    args = parser.parse_args()
    global MODEL, WIDTHS
    MODEL, WIDTHS = FAMILIES[args.family]
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = args.autotune
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}, family {args.family} ({MODEL.__name__}), cuDNN autotuning "
          f"{'on' if args.autotune else 'off'}")
    run = (profile_train if args.train else profile_trainer if args.trainer else
           profile_refine if args.refine else profile_sweep if args.sweep else profile_serve)
    if not args.bwd_parent:
        results = run(card)
    else:
        results = {}
        for name, entry in backward_entries(args.bwd_parent).items():
            print(f"=== GDN backward: {name}", flush=True)
            gdn_kernel._backward_entry = lambda entry=entry: entry
            results[name] = run(card)
        compare_backward(results)
    print(json.dumps({"card": card, "family": args.family, "autotune": args.autotune,
                      "profile": results}))
    return 0


def backward_entries(parent_csrc):
    """The GDN backward's C entry points: another commit's (built from its
    csrc/ by tools/gdn_bwd_variants.py) and this checkout's. Both get the
    scratch of the widest layout, which the other commit's may need."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gdn_bwd_variants  # noqa: E402 (imports chip_smoke)

    gdn_bwd_variants.use_widest_scratch()
    parent = gdn_bwd_variants.build({"parent": [parent_csrc, True]})["parent"]
    return {"parent": parent, "this checkout": gdn_kernel._backward_entry()}


def compare_backward(results):
    """Each configuration's GDN backward launches under both entry points,
    and the launches that compute dx summed (norm + mix, or fused)."""
    names = list(results)
    for tag, last in results[names[-1]].items():
        if "by_layer_ms" not in last:
            continue
        cells = []
        for name in names:
            layers = results[name].get(tag, {}).get("by_layer_ms", {})
            bwd = {k.split(": ", 1)[1]: v for k, v in layers.items()
                   if k.startswith("gdn backward kernel: ")}
            rows = sum(v for k, v in bwd.items() if k in ("norm", "mix", "fused"))
            cells.append(f"{name}: " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(bwd.items()))
                         + f" (dx launches {rows:.3f} ms; device "
                         f"{results[name][tag]['device_ms_per_call']:.3f} ms)")
        print(f"== GDN backward, {tag}: " + " | ".join(cells), flush=True)


if __name__ == "__main__":
    sys.exit(main())
