#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (neural_image_compression_tpu_torch)
on one NVIDIA GPU: the quickest proof that the port builds and runs there.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: torch and CUDA versions, the card's name and power limit; build
     every kernel from csrc/ (one nvcc per source, in parallel).
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card, timed with CUDA events beside its bound: the forwards at the
     serve's shapes (batch 48 at 768x512, M = 128, K = 3) and at the train
     step's (batch 16 at 256x256), the backwards at the train step's (the
     GDN backward also beside its design's floor, the bytes its four
     launches move); GDN forward and backward also at a ragged row count,
     at 192 and 256 channels and at 10.
  3. cross-device parity: the M=128, K=3 eval forward, and one float32
     training step's loss and parameter gradients (batch 1 at 256x256, the
     noise drawn once on the CPU), on the card against the same weights on
     the CPU (the card runs the kernels, the CPU their plain versions).
  4. serve: the flagship eval forward through make_serving_fn at 768x512,
     batch 48 and batch 1, in float32 and bfloat16 transforms.
  5. train: the flagship's training step through make_train_step (batch 16
     of 256x256, rd_loss at lambda 0.005, Adam 1e-4) in bfloat16 and float32
     transforms: steps/s, peak memory and MFU over 20 timed steps, and the
     loss falling over 30 steps on one batch.
  6. codec: the GDN kernel against its plain version at the codec's rows,
     the IGDN backward (dx alone) and the mixture kernels at refinement's,
     then coding.JointARCodec on one 768x512 image (a uint8 and a float32
     one), f32 and bf16 transforms: the exact round trip of the latents,
     decompress against the eval forward, stream bits against the analytic
     rate, streams and psi the same across TF32/autotuning settings and
     fresh codecs, 3 GDN launches per compress and per decompress, and
     encode and decode latency split into device and host stages; then
     interleaved streams (n_streams 4 and 8 against 1: exact latents,
     bytes, latency by stage), 2x2 tiles (exact latents, bpp), a batch of 8
     images through compress_batch / decompress_batch (streams equal to
     compress's, exact latents, images/s against 8 single calls), latent
     refinement (20 Adam steps: the loss falls, the refined latents round
     trip, launches per call, ms a step) and portable streams (a card built
     on the card machine, saved and loaded; exact latents, bpp against the
     float stream, latency; at 64x128 the native and numpy coders write the
     same bytes).
  7. the Trainer and the evaluator (see trainer_phase).
  8. the other families at M = 128: MeanScaleHyperprior,
     CheckerboardHierarchical and ChannelCheckerboardHierarchical (K = 3,
     groups (16, 16, 32, 64)), and FactorizedPrior, each: card-vs-CPU
     parity of the eval forward (2x256x256), then its main path: serve (as
     phase 4), train (as phase 5, its own FLOP count for the MFU), and its
     codec on one 768x512 image (uint8 and float32, f32 and bf16 models:
     exact latents, decompress against the eval forward, bits against the
     analytic rate, encode and decode latency split into device stages
     (analysis, the parameter passes, synthesis) and host stages (the z
     coder, the y rANS)); for the three parallel-decode families also
     n_streams 1 and 8 (8 bytes a lane), TF32 and autotuning on at encode
     against off at decode and a batch of 8 against 8 single calls; then
     refinement, and portable streams from a card (set) built here. The
     factorized prior launches no mixture kernel: 6/0/0/0 a forward and
     6/6/0/0 a step.
  9. the residual family, HierarchicalMixtureResidual at M = 192, K = 1
     (the 3x3 residual transforms): the GDN kernels against their plain
     versions at C = 192 (the forward at the serve's, the train step's and
     the codec's rows, the backward at the train step's and refinement's);
     card-vs-CPU parity of its eval forward (2x256x256) and of the four
     other families with transform="res3x3" (M = 32, 1x128x128); then its
     main path: serve (as phase 4), train (as phase 5, MFU from the res3x3
     FLOP count), JointARCodec on one 768x512 image (f32 and bf16 models,
     n_streams 1 and 8: exact latents, decompress against the eval
     forward, bits against the analytic rate, latency by stage), a portable
     round trip (a card with the res3x3 integer hyper-decoder) and a
     20-step refine call. No mixture kernel: 6/0/0/0 a forward, 6/6/0/0 a
     step, 69/60/0/0 a refine call.
  10. the variable-rate families: GainedJointAR at M = 128, K = 3 (the
     default ladder of 5 levels; random gain tables from a seed, gain_y
     growing 4x a level, the inverse gains shrinking 4x): card-vs-CPU parity of its eval forward
     (2x256x256) at levels 0, 1.5 and 4, and of GainedHyperprior,
     GainedCheckerboard and GainedChannelCheckerboard at 1.5; the fold on
     the card at levels 0, 1.3 and 4 against the gained forward (rounded
     latents differ only at round() ties, counted; on the same latents
     x_hat and the rates agree); then its main path: serve (the gained
     forward at level 2 and the model folded there, as phase 4, beside
     phase 4's numbers), train with a level drawn each step (as phase 5,
     every level drawn over the timed steps, the loss falling over 30
     steps level by level), JointARCodec on the folds at levels 1 and 3 (f32 and bf16:
     exact latents, decompress, bits against the analytic rate, the level-3
     stream longer), level_for_bpp on one image, gained_rd_curve over 4
     images at 6 levels (bpp rising with the level), a Trainer validating
     at the middle level, and each sibling folded through its own codec
     (exact latents) and 5 steps. 6/0/1/0 launches a forward, 6/6/1/1 a
     step.
  11. scalable two-layer coding: ScalableImageCoding at M = 192, M1 = 128,
     K = 1 (the reference's scalable configuration; a K = 3 variant at the
     same widths), LST (2, 1, 1, 1), lambda 0.01 and gamma 1 against a
     frozen YOLOv5 teacher of width 64 cut at layer 3 (seeded random
     weights): the GDN kernel (IGDN) at the LatentSpaceTransform's C = 128
     and C = 256 against its plain version (the forward at the serve's, the
     train step's and decompress_base's H/8 rows, the backward with
     dgamma/dbeta at the train step's); card-vs-CPU parity of the eval
     forward (2x256x256, K = 1 and 3) and of one f32 step's gradients with
     the vision term; then its main path: serve (as phase 4, K = 1 and 3),
     train with the vision term and with gamma 0 and no teacher (as phase
     5, MFU over 3x the eval FLOPs plus the teacher's forward and input
     gradient; K = 3 three steps), ScalableCodec on one 768x512 image (f32
     and bf16: exact latents, decompress against x_hat, truncate_base ->
     decompress_base: y1 exact and F_tilde against the forward's, a
     truncated stream refused by decompress, full and base bits against
     the analytic rates, TF32 and autotuning on at encode and off at
     decode, latency by device and host stage), a portable card pair built,
     saved and loaded, one 20-step refine call and
     VisionCompressionEvaluator with the teacher on 2 images. 9/0/0/0
     launches a forward (+0/0/2/0 at K = 3), 9/9/0/0 a step (9/6/0/0 with
     gamma 0; +0/0/2/2 at K = 3), 3 a codec call, 72/60/0/0 a refine call.
Phases 4, 5, 6, 7, each family of phase 8, phase 9, phase 10 and phase 11
are the main paths: the kernels' launch counts are set to 0 just before
each and read just after it, and the kernels' record adds them up.
``--phase N`` (repeatable) runs phase 1 and phase N alone (7 and 10 bring
4 and 5); the kernels' record then covers the phases run.
The last lines are the kernels' JSON record and
{"ok": true, "device": {...}}.

TF32 is off throughout (convolutions and products in full float32), except
where phases 6, 8 and 11 turn it on to show that the codecs' streams do not
depend on it and phase 7 to show that MS-SSIM does not.
"""

import argparse
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from neural_image_compression_tpu_torch.coding import (
    ChannelCBCards, ChannelCheckerboardCodec, CheckerboardCodec, FactorizedCard,
    FactorizedPriorCodec, JointARCodec, MeanScaleHyperpriorCodec, PortableCard, ScalableCodec,
    build_channel_cb_cards, load_scalable_cards, make_refiner, save_scalable_cards,
)
from neural_image_compression_tpu_torch.coding import portable
from neural_image_compression_tpu_torch.coding import backend as rans_backend
from neural_image_compression_tpu_torch.coding import codec as codec_module
from neural_image_compression_tpu_torch.data import BatchLoader
from neural_image_compression_tpu_torch.entropy import mixture_likelihood
from neural_image_compression_tpu_torch.evaluation import (
    CompressionEvaluator, VisionCompressionEvaluator, ms_ssim, rgb_to_luma,
)
from neural_image_compression_tpu_torch.models import (
    ChannelCheckerboardHierarchical, CheckerboardHierarchical, FactorizedPrior,
    GainedChannelCheckerboard, GainedCheckerboard, GainedHyperprior, GainedJointAR,
    HierarchicalMixtureResidual, JointAutoregressiveHierarchical, MeanScaleHyperprior,
    ScalableImageCoding, build_yolo_backbone, distillation_targets, fold_gains, folded_model,
    joint_ar, level_for_bpp,
)
from neural_image_compression_tpu_torch.ops.kernels import (
    _build, gdn_kernel, gmm_kernel, launch_counts, reset_launch_counts,
)
from neural_image_compression_tpu_torch.parallel import make_train_step
from neural_image_compression_tpu_torch.serving import make_serving_fn
from neural_image_compression_tpu_torch.train import (
    Trainer, gained_rd_curve, msssim_rd_loss, rd_loss, vision_rd_loss,
)
from neural_image_compression_tpu_torch.utils import flops

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory, TF32
# on the tensor cores (GDN's channel mix, which the card can run there) and
# float32 outside them (the mixture kernel's erf arithmetic).
HBM_BYTES_PER_S = 3.35e12
PEAKS = {"tf32_tensor_core": flops.H100_PEAK_TFLOPS["tf32"] * 1e12,
         "f32_cuda_core": flops.H100_PEAK_TFLOPS["f32"] * 1e12}

M, K = 128, 3
BATCH, HEIGHT, WIDTH = 48, 512, 768
# GDN rows (B*h*w) at the three transform depths; each depth has one GDN
# (encoder) and one IGDN (decoder) site.
GDN_SITES = {"H/2": BATCH * (HEIGHT // 2) * (WIDTH // 2),
             "H/4": BATCH * (HEIGHT // 4) * (WIDTH // 4),
             "H/8": BATCH * (HEIGHT // 8) * (WIDTH // 8)}
GMM_ROWS = BATCH * (HEIGHT // 16) * (WIDTH // 16)
GDN_PER_FORWARD, GMM_PER_FORWARD = 6, 1
# the train step: batch 16 of 256x256 (bench.py's train shape)
TRAIN_BATCH, TRAIN_SIZE, LAMBDA = 16, 256, 0.005
TRAIN_GDN_SITES = {"H/2": TRAIN_BATCH * (TRAIN_SIZE // 2) ** 2,
                   "H/4": TRAIN_BATCH * (TRAIN_SIZE // 4) ** 2,
                   "H/8": TRAIN_BATCH * (TRAIN_SIZE // 8) ** 2}
TRAIN_GMM_ROWS = TRAIN_BATCH * (TRAIN_SIZE // 16) ** 2
PER_STEP = {"gdn": 6, "gdn_backward": 6, "gdn_backward_params": 6, "gmm_logp": 1,
            "gmm_logp_backward": 1}
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_CONVERGE = 3, 20, 30
# GDN correctness beyond the main path: (rows, channels)
GDN_EXTRA_CASES = ((100_003, 128), (65_536, 192), (65_536, 256), (65_536, 10))
# bf16 GDN against its plain version: at most one bf16 step apart, and only
# where the float32 norm sits on a rounding boundary of the output
BF16_MAX_DIFFERING_SHARE = 0.01
TIMING_REPS = 20

# cross-device parity: seed and gains on the last analysis convs chosen so
# that y and z spread over several integers and keep a rounding margin
# (checked at run time) above the two devices' difference
PARITY_SEED, PARITY_GAIN_Y, PARITY_GAIN_Z = 10, 4.0, 12.0
MIN_ROUNDING_MARGIN = 1e-5

# card-vs-CPU gradients: each leaf's max abs difference over its max abs
# value; the float32 sums of about 20 layers' forward and backward run in
# other orders (cuDNN's backward algorithms among them, which need not be
# deterministic). Measured on an H100 at most 6.3e-6 (median 8.0e-7) over
# the 59 leaves; 1e-4 leaves a factor of 16 for other cuDNN algorithms.
GRAD_SEED, GRAD_LEAF_TOL, GRAD_LOSS_RTOL = 11, 1e-4, 1e-5

SERVE_ITERS, LATENCY_ITERS = 5, 10

KERNEL_INFO = {
    "gdn": {"route": "cuda",
            "source": "neural_image_compression_tpu_torch/csrc/gdn_kernel.cu",
            "replaces": "neural_image_compression_tpu/ops/pallas/gdn_kernel.py:20"},
    "gmm_logp": {"route": "cuda",
                 "source": "neural_image_compression_tpu_torch/csrc/gmm_kernel.cu",
                 "replaces": "neural_image_compression_tpu/ops/pallas/gmm_kernel.py:59"},
    # the backward of gdn_fused_op (_gdn_bwd, XLA autodiff of _gdn_reference)
    "gdn_backward": {"route": "cuda",
                     "source": "neural_image_compression_tpu_torch/csrc/gdn_bwd_kernel.cu",
                     "replaces": "neural_image_compression_tpu/ops/pallas/gdn_kernel.py:48"},
    # the TPU kernel has no backward; JAX autodiffs entropy/gaussian.py:48-51
    "gmm_logp_backward": {"route": "cuda",
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


def bound(nbytes: float, flops: float, peak: str):
    """Least time for moving ``nbytes`` and doing ``flops`` at ``PEAKS[peak]``."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAKS[peak] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


# --- phase 2: kernels against their plain versions --------------------------

def gdn_params(c, rng, dev):
    gamma = np.abs(rng.normal(0.0, 0.02, (c, c))).astype(np.float32)
    gamma[np.arange(c), np.arange(c)] += 0.1
    beta = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return torch.from_numpy(gamma).to(dev), torch.from_numpy(beta).to(dev)


def bf16_steps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bf16 values lie between a and b (0 where equal)."""
    def ordered(t):
        bits = t.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def check_gdn(x, gamma_t, beta_t, inverse, label):
    """The kernel against its plain version (and float32 against float64
    math); returns the max abs error."""
    dtype = x.dtype
    got = gdn_kernel.gdn(x, gamma_t, beta_t, inverse)
    want = gdn_kernel.gdn_reference(x, gamma_t, beta_t, inverse)
    torch.cuda.synchronize()
    check(got.dtype == dtype and got.shape == x.shape, f"{label}: output {got.dtype} {tuple(got.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        # tolerance 1e-5: the split tensor-core sum and cuBLAS's float32 sum
        # add the products in other orders, each about 1e-7 relative
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"{label}: max abs err {err:.3e} beyond 1e-5")
        # both ends of the rows against float64 math: the size of the
        # rounding the kernel-vs-plain comparison can see
        err64 = 0.0
        for rows in (slice(0, 8192), slice(max(0, x.shape[0] - 8192), None)):
            xs = x[rows].double()
            n64 = (xs * xs) @ gamma_t.double() + beta_t.double()
            exact = xs * (n64.sqrt() if inverse else n64.rsqrt())
            err64 = max(err64, ((got[rows].double() - exact).abs()
                                / exact.abs().clamp_min(1e-30)).max().item())
        check(err64 <= 1e-5, f"{label}: max rel err vs float64 {err64:.3e}")
        print(f"  {label}: err {err:.3e}, max rel err vs float64 {err64:.3e}")
    else:
        steps = bf16_steps_apart(got, want)
        share = (steps > 0).float().mean().item()
        max_steps = steps.max().item()
        check(max_steps <= 1, f"{label}: {max_steps} bf16 steps from the plain version")
        check(share < BF16_MAX_DIFFERING_SHARE,
              f"{label}: {share:.4%} of elements differ from the plain version")
        print(f"  {label}: err {err:.3e}, {share:.4%} of elements one bf16 step "
              f"from the plain version, none further")
    return err


def gdn_site_records(path, sites, rng, gamma_t, beta_t, dev, tag="", inverses=(False, True)):
    """The GDN kernel at each site's rows against its plain version, timed
    beside its bound, in float32 and bfloat16, GDN and IGDN (``inverses``:
    IGDN alone with (True,)). tag: added to the printed labels."""
    c = gamma_t.shape[0]
    records = []
    for site, rows in sites.items():
        x32 = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            dname = str(dtype).replace("torch.", "")
            for inverse in inverses:
                name = "igdn" if inverse else "gdn"
                err = check_gdn(x, gamma_t, beta_t, inverse,
                                f"{name:4s}{tag} {path} {site} {dname}")
                ms = median_ms(lambda: gdn_kernel.gdn(x, gamma_t, beta_t, inverse))
                plain_ms = median_ms(
                    lambda: gdn_kernel.gdn_reference(x, gamma_t, beta_t, inverse))
                io_bytes = rows * c * x.element_size() * 2 + (c * c + c) * 4
                # the work counted once (not the three split products)
                peak = "tf32_tensor_core"
                bound_ms, bound_by = bound(io_bytes, 2.0 * rows * c * c + 4.0 * rows * c, peak)
                records.append(dict(
                    name="gdn", **KERNEL_INFO["gdn"], path=path, site=site, inverse=inverse,
                    shape=[rows, c], dtype=dname, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, peak=peak, library_ms=None))
                print(f"  {name:4s}{tag} {path} {site} rows={rows} {dname:8s} "
                      f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
                      f"({bound_by}, {100 * bound_ms / ms:.1f}% of it)", flush=True)
        del x32, x
    return records


def gdn_cases(dev):
    rng = np.random.default_rng(0)
    gamma_t, beta_t = gdn_params(M, rng, dev)
    records = []
    for path, sites in (("serve", GDN_SITES), ("train", TRAIN_GDN_SITES)):
        records += gdn_site_records(path, sites, rng, gamma_t, beta_t, dev)
    for rows, c in GDN_EXTRA_CASES:
        gamma_c, beta_c = gdn_params(c, rng, dev)
        x32 = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            for inverse in (False, True):
                name = "igdn" if inverse else "gdn"
                check_gdn(x32.to(dtype), gamma_c, beta_c, inverse,
                          f"{name:4s} rows={rows} C={c} {str(dtype).replace('torch.', '')}")
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
    return gmm_case(dev, "serve", GMM_ROWS, seed=1) + gmm_case(dev, "train", TRAIN_GMM_ROWS,
                                                                seed=6)


def gmm_case(dev, path, n, seed):
    k, m = K, M
    args = [torch.from_numpy(a).to(dev) for a in mixture_symbols(n, k, m, seed=seed)]
    got = gmm_kernel.gmm_logp(*args)
    want = gmm_kernel.mixture_log_likelihood_reference(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    bulk = want > float(np.log(1e-6))
    check(bulk.float().mean().item() > 0.99, f"mixture symbols ({path}): bulk share")
    # tolerances: logp to 1e-5 where p > 1e-6 (both use CUDA's erff, so
    # only the order of the K-sum may differ), total nats to 1e-6
    bulk_err = (got[bulk] - want[bulk]).abs().max().item()
    check(bulk_err <= 1e-5, f"gmm_logp {path}: bulk max abs err {bulk_err:.3e}")
    tot_got, tot_want = got.double().sum().item(), want.double().sum().item()
    check(abs(tot_got - tot_want) <= 1e-6 * abs(tot_want),
          f"gmm_logp {path}: total nats {tot_got} vs {tot_want}")
    # the 1e-9 floor: symbols far outside every component
    y_far = torch.full_like(args[0], 1000.0)
    floor = gmm_kernel.gmm_logp(y_far, *args[1:])
    check(torch.allclose(floor, torch.full_like(floor, float(np.log(1e-9))), rtol=1e-6),
          f"gmm_logp {path}: floor")
    ms = median_ms(lambda: gmm_kernel.gmm_logp(*args))
    plain_ms = median_ms(lambda: gmm_kernel.mixture_log_likelihood_reference(*args))
    io_bytes = (3 * k + 2) * m * n * 4
    # about 34 float32 operations per (position, component), counting each
    # erff as 10, plus the floor and the log per position
    bound_ms, bound_by = bound(io_bytes, (34.0 * k + 12.0) * n * m, "f32_cuda_core")
    print(f"  gmm  {path} rows={n} K={k} M={m} err={err:.3e} (bulk {bulk_err:.3e}) "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    return [dict(name="gmm_logp", **KERNEL_INFO["gmm_logp"], path=path, shape=[n, k, m],
                 dtype="float32", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, peak="f32_cuda_core", library_ms=None)]


def check_gdn_backward(x, gamma_t, beta_t, g, inverse, label, param_grads=True):
    """The backward kernel against its plain version: float32 outputs within
    1e-4 relative plus 1e-5 of the largest value (other summation orders,
    dgamma over up to 262,144 rows); a bf16 dx within one bf16 step of the
    plain version. Two runs give the same bits (no atomics). Without
    param_grads, dgamma and dbeta are None and dx is the full backward's.
    Returns the largest abs error of the outputs."""
    got = gdn_kernel.gdn_backward(x, gamma_t, beta_t, g, inverse, param_grads)
    want = gdn_kernel.gdn_backward_reference(x, gamma_t, beta_t, g, inverse, param_grads)
    torch.cuda.synchronize()
    check(got[0].dtype == x.dtype and got[0].shape == x.shape, f"{label}: dx {got[0].dtype}")
    if not param_grads:
        check(got[1] is None and got[2] is None, f"{label}: dgamma/dbeta without param_grads")
        full = gdn_kernel.gdn_backward(x, gamma_t, beta_t, g, inverse)
        check(torch.equal(got[0], full[0]), f"{label}: dx differs from the full backward's")
        got, want = got[:1], want[:1]
    errs = []
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        step = 2.0 ** -7 if (name == "dx" and x.dtype == torch.bfloat16) else 1e-4
        limit = step * b.abs() + 1e-5 * b.abs().max()
        check(bool((diff <= limit).all()),
              f"{label}: {name} max abs err {diff.max().item():.3e} beyond tolerance")
        errs.append(diff.max().item())
    again = gdn_kernel.gdn_backward(x, gamma_t, beta_t, g, inverse, param_grads)
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{label}: runs differ")
    print(f"  {label}: max abs err " + ", ".join(
        f"{n} {e:.3e}" for n, e in zip(("dx", "dgamma", "dbeta"), errs)))
    return max(errs)


def gdn_backward_design_bytes(rows, c, esz):
    """Bytes the GDN backward's four launches move, each launch's inputs read
    once and outputs written once (csrc/gdn_bwd_kernel.cu): norm reads x and
    g and writes t and d1 (float32); mix reads t, x and d1 and writes dx;
    partials reads x and t and writes the chunks' partials; reduce reads
    them and writes dgamma and dbeta. gamma and beta are read by the
    launches that use them."""
    elems, params = rows * c, (c * c + c) * 4
    part = gdn_kernel._chunking(rows)[1] * c * (c + 1) * 4
    norm = elems * (2 * esz + 8) + params
    mix = elems * (2 * esz + 8) + c * c * 4
    partials = elems * (esz + 4) + part
    reduce = part + params
    return norm + mix + partials + reduce


def gdn_backward_site_records(path, sites, rng, gamma_t, beta_t, dev, inverses=(False, True),
                              param_grads=True, tag=""):
    """The GDN backward kernel at each site's rows against its plain
    version, timed beside its bound, in float32 and bfloat16: with the
    dgamma/dbeta stage (and beside its design's floor), or without it
    (param_grads False: dx alone, as refinement runs it). tag: added to the
    printed labels."""
    c = gamma_t.shape[0]
    records = []
    for site, rows in sites.items():
        x32 = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        g32 = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x, g = x32.to(dtype), g32.to(dtype)
            dname = str(dtype).replace("torch.", "")
            for inverse in inverses:
                name = "igdn" if inverse else "gdn"
                prefix = (f"{name}-bwd{'' if param_grads else ' dx'}{tag}"
                          + ("" if path == "train" else f" {path}"))
                err = check_gdn_backward(x, gamma_t, beta_t, g, inverse,
                                         f"{prefix} {site} {dname}", param_grads=param_grads)
                ms = median_ms(lambda: gdn_kernel.gdn_backward(x, gamma_t, beta_t, g, inverse,
                                                               param_grads))
                plain_ms = median_ms(lambda: gdn_kernel.gdn_backward_reference(
                    x, gamma_t, beta_t, g, inverse, param_grads))
                peak = "tf32_tensor_core"
                if param_grads:
                    # x and g read, dx written; gamma and beta read, dgamma and
                    # dbeta written; the three (N, C) x (C, C) products, counted once
                    io_bytes = 3 * rows * c * x.element_size() + 2 * (c * c + c) * 4
                    bound_ms, bound_by = bound(io_bytes, 6.0 * rows * c * c + 12.0 * rows * c,
                                               peak)
                    # what this design must move (t written once, read twice; d1)
                    floor_ms = (gdn_backward_design_bytes(rows, c, x.element_size())
                                / HBM_BYTES_PER_S * 1e3)
                    floor_note = (f"  design floor {floor_ms:.4f} ms "
                                  f"({100 * floor_ms / ms:.1f}% of it)")
                else:
                    # x and g read, dx written, gamma and beta read; the two
                    # (N, C) x (C, C) products (the norm, t @ gamma^T), counted once
                    bound_ms, bound_by = bound(3 * rows * c * x.element_size() + (c * c + c) * 4,
                                               4.0 * rows * c * c + 10.0 * rows * c, peak)
                    floor_note = ""
                records.append(dict(
                    name="gdn_backward", **KERNEL_INFO["gdn_backward"], path=path, site=site,
                    inverse=inverse, **({} if param_grads else {"param_grads": False}),
                    shape=[rows, c], dtype=dname, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, peak=peak, library_ms=None))
                print(f"  {prefix} {site} rows={rows} {dname:8s} kernel {ms:.4f} ms  "
                      f"plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}, "
                      f"{100 * bound_ms / ms:.1f}% of it){floor_note}", flush=True)
        del x32, g32, x, g
    return records


def gdn_backward_cases(dev):
    rng = np.random.default_rng(3)
    gamma_t, beta_t = gdn_params(M, rng, dev)
    records = gdn_backward_site_records("train", TRAIN_GDN_SITES, rng, gamma_t, beta_t, dev)
    for rows, c in GDN_EXTRA_CASES:
        gamma_c, beta_c = gdn_params(c, rng, dev)
        x32 = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        g32 = torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            for inverse in (False, True):
                name = "igdn" if inverse else "gdn"
                check_gdn_backward(x32.to(dtype), gamma_c, beta_c, g32.to(dtype), inverse,
                                   f"{name}-bwd rows={rows} C={c} "
                                   f"{str(dtype).replace('torch.', '')}")
    return records


def gmm_backward_cases(dev):
    return gmm_backward_case(dev, "train", TRAIN_GMM_ROWS, seed=4)


def gmm_backward_case(dev, path, n, seed):
    k, m = K, M
    arrays = list(mixture_symbols(n, k, m, seed=seed))
    arrays[0] = arrays[0].copy()
    arrays[0][0, :] = 1000.0  # a row below the 1e-9 floor: zero gradient
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    g = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (n, m), dtype=np.float32)).to(dev)
    got = gmm_kernel.gmm_logp_backward(*args, g)
    want = gmm_kernel.mixture_log_likelihood_backward_reference(*args, g)
    torch.cuda.synchronize()
    # both use CUDA's erff and expf; the K-sum and the divisions may round
    # apart: 1e-4 relative plus 1e-6 of the largest value
    err = 0.0
    for name, a, b in zip(("dy", "dw", "dmu", "dsigma"), got, want):
        diff = (a - b).abs()
        check(bool((diff <= 1e-4 * b.abs() + 1e-6 * b.abs().max()).all()),
              f"gmm backward {name} max abs err {diff.max().item():.3e}")
        err = max(err, diff.max().item())
    check(int(torch.count_nonzero(got[0][0])) == 0, "gmm backward: gradient below the floor")
    ms = median_ms(lambda: gmm_kernel.gmm_logp_backward(*args, g))
    plain_ms = median_ms(lambda: gmm_kernel.mixture_log_likelihood_backward_reference(*args, g))
    io_bytes = (6 * k + 3) * m * n * 4
    # per (position, component): both edges' erff (10 each) and expf (8
    # each) and about 30 more; the floor, the division and the sum per position
    bound_ms, bound_by = bound(io_bytes, (66.0 * k + 12.0) * n * m, "f32_cuda_core")
    print(f"  gmm-bwd {path} rows={n} K={k} M={m} err={err:.3e} kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return [dict(name="gmm_logp_backward", **KERNEL_INFO["gmm_logp_backward"], path=path,
                 shape=[n, k, m], dtype="float32", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, peak="f32_cuda_core", library_ms=None)]


# --- phase 3: the card against the CPU ---------------------------------------

def rounding_margin(v: torch.Tensor) -> float:
    f = v.double().abs()
    return (f - f.floor() - 0.5).abs().min().item()


def bottleneck_convs(model):
    """The last convs of the analysis and of the hyper-analysis (None for a
    model without one, the factorized prior), for either transform."""
    res = getattr(model, "transform", "conv5x5") == "res3x3"
    hyper = getattr(model, "hyper_encoder", None)
    return ((model.encoder.Conv2d_0 if res else model.encoder.Conv2d_3),
            None if hyper is None else (hyper.Conv2d_4 if res else hyper.Conv2d_2))


def gained_model(device, dtype=None, cls=JointAutoregressiveHierarchical, widths=None,
                 seed=PARITY_SEED, gains=(PARITY_GAIN_Y, PARITY_GAIN_Z)):
    """The flagship (or another family, ``cls`` at ``widths``: (M, K) when
    None) from ``seed`` with ``gains`` on the last analysis convs (y's,
    z's), so that y and z spread over several integers."""
    model = cls(*(widths or (M, K)), dtype=dtype, device=device, seed=seed)
    with torch.no_grad():
        for conv, gain in zip(bottleneck_convs(model), gains):
            if conv is not None:
                conv.weight.mul_(gain)
                conv.bias.mul_(gain)
    return model


def parity(dev, cls=JointAutoregressiveHierarchical, widths=None, seed=PARITY_SEED,
           gains=(PARITY_GAIN_Y, PARITY_GAIN_Z), shape=(2, 256, 256, 3), loss=rd_loss):
    """The eval forward on the card against the CPU's on the same weights:
    rounded latents equal (each with a rounding margin above the devices'
    difference), every output within its tolerance, and ``loss``'s rates."""
    cpu_model = gained_model("cpu", cls=cls, widths=widths, seed=seed, gains=gains)
    card_model = cls(*(widths or (M, K)), device=dev, seed=seed)
    card_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(np.random.default_rng(seed).uniform(size=shape).astype(np.float32))
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
                  "mus": 1e-4, "sigmas": 1e-4, "mu": 1e-4, "sigma": 1e-4}
    # the scalable model: each layer's, and the LatentSpaceTransform's F_tilde
    tolerances.update({k + layer: tolerances[k] for k in ("logp_y", "weights", "mus", "sigmas",
                                                          "mu", "sigma") for layer in "12"},
                      F_tilde=1e-4)
    for key, tol in tolerances.items():
        if key not in ref:  # a K=1 model has mu and sigma, the factorized prior neither
            continue
        err = (got[key] - ref[key]).abs().max().item()
        print(f"  {key}: max abs diff {err:.3e} (tolerance {tol:g})")
        check(torch.allclose(got[key], ref[key], rtol=tol, atol=tol), f"{key} max diff {err:.3e}")
    loss_ref, loss_got = loss(ref, x, 0.005), loss(got, x, 0.005)
    for key in ("bpp_y", "bpp_z", "bpp_total"):
        a, b = loss_got[key].item(), loss_ref[key].item()
        print(f"  {key}: card {a:.7f} cpu {b:.7f}")
        check(abs(a - b) <= 1e-5 * abs(b), f"{key} card {a} vs cpu {b}")


@contextlib.contextmanager
def given_noise(noises):
    """The model's noise_quantize adds these tensors, in order, on whatever
    device it runs: one draw serves both devices."""
    it = iter(noises)
    drawn = joint_ar.noise_quantize
    joint_ar.noise_quantize = lambda v, generator=None: v + next(it).to(v.device)
    try:
        yield
    finally:
        joint_ar.noise_quantize = drawn


def grad_parity(dev, build=lambda device: JointAutoregressiveHierarchical(
        M, K, device=device, seed=GRAD_SEED), objective=lambda device: rd_loss, lam=LAMBDA,
        latent_channels=M, leaf_tol=lambda name: GRAD_LEAF_TOL):
    """One float32 training step's loss and every parameter's gradient, the
    card against the CPU, same weights, same noise: build(device) gives the
    model (the flagship by default), objective(device) its loss at lam, and
    leaf_tol(name) each gradient's tolerance (GRAD_LEAF_TOL)."""
    x = torch.from_numpy(np.random.default_rng(GRAD_SEED).uniform(
        size=(1, TRAIN_SIZE, TRAIN_SIZE, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(GRAD_SEED)
    h, m = TRAIN_SIZE, latent_channels
    noises = [torch.empty(1, h // 64, h // 64, m).uniform_(-0.5, 0.5, generator=gen),
              torch.empty(1, h // 16, h // 16, m).uniform_(-0.5, 0.5, generator=gen)]
    results = []
    for device in ("cpu", dev):
        model = build(device)
        xd = x.to(device)
        with given_noise(noises):
            loss = objective(device)(model(xd, training=True), xd, lam)["loss"]
        loss.backward()
        missing = [n for n, p in model.named_parameters() if p.grad is None]
        check(not missing, f"{device}: no gradient reached {missing}")
        results.append((loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (loss_cpu, grads_cpu), (loss_card, grads_card) = results
    print(f"  loss: card {loss_card:.7f} cpu {loss_cpu:.7f}")
    check(abs(loss_card - loss_cpu) <= GRAD_LOSS_RTOL * abs(loss_cpu),
          f"train loss card {loss_card} vs cpu {loss_cpu}")
    worst = []
    for name, want in grads_cpu.items():
        scale = want.abs().max().item()
        check(scale > 0, f"{name}: zero gradient on the CPU")
        worst.append(((grads_card[name] - want).abs().max().item() / scale, name))
    worst.sort(reverse=True)
    print(f"  {len(worst)} parameter gradients, card vs cpu: max abs diff over max abs value "
          f"at most {worst[0][0]:.3e} ({worst[0][1]}), median "
          f"{statistics.median(r for r, _ in worst):.3e}; each leaf (tolerance):")
    for rel, name in worst:
        print(f"    {rel:.3e}  {name} ({leaf_tol(name):g})")
    beyond = [f"{name} ({rel:.3e} > {leaf_tol(name):g})" for rel, name in worst
              if rel > leaf_tol(name)]
    check(not beyond, f"card-vs-cpu gradients beyond their tolerance (of their largest "
                      f"value): {', '.join(beyond)}")


# --- phase 4: the main path ---------------------------------------------------

def serve_phase(dev, card: str, cls=JointAutoregressiveHierarchical,
                gmm_per_forward=GMM_PER_FORWARD, z_rate=True, widths=None,
                latency_iters=LATENCY_ITERS, gdn_per_forward=GDN_PER_FORWARD):
    """serve() at batch 48 and 1 in f32 and bf16. gmm_per_forward and
    gdn_per_forward: the family's mixture and GDN launches a forward; z_rate
    False: the family has no z, so bpp_z must be 0 (else positive); widths:
    the model's constructor arguments ((M, K) when None); latency_iters:
    the batch-1 calls timed."""
    rng = np.random.default_rng(2)
    x48 = torch.from_numpy(rng.uniform(size=(BATCH, HEIGHT, WIDTH, 3)).astype(np.float32)).to(dev)
    x1 = x48[:1].contiguous()
    forwards = 0
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = cls(*(widths or (M, K)), dtype=dtype, device=dev, seed=0)
        serve = make_serving_fn(model)
        torch.cuda.reset_peak_memory_stats(dev)
        before = (gdn_kernel.gdn.launches, gmm_kernel.gmm_logp.launches)
        out = serve(x48)
        torch.cuda.synchronize()
        forwards += 1
        after = (gdn_kernel.gdn.launches, gmm_kernel.gmm_logp.launches)
        check(after[0] - before[0] == gdn_per_forward and after[1] - before[1] == gmm_per_forward,
              f"one forward launched {after[0] - before[0]} gdn and {after[1] - before[1]} gmm")
        check(out["x_hat"].shape == (BATCH, HEIGHT, WIDTH, 3), "x_hat shape")
        check(bool(torch.isfinite(out["x_hat"]).all()), "x_hat not finite")
        for key in ("bpp_y", "bpp_z", "bpp_total"):
            check(out[key].shape == (BATCH,), f"{key} shape")
            if key == "bpp_z" and not z_rate:
                check(bool((out[key] == 0).all()), "bpp_z of a family without z is not 0")
                continue
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
        for _ in range(latency_iters):
            t0 = time.perf_counter()
            serve(x1)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        forwards += 1 + latency_iters
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


# --- phase 5: the training step -------------------------------------------------

def train_run(dev, dtype, x, seed, steps, timed=False, cls=JointAutoregressiveHierarchical,
              per_step=PER_STEP, widths=None, loss=rd_loss, lam=LAMBDA):
    """``steps`` steps of a fresh model (``cls`` at ``widths``: M and K when
    None; weights from ``seed``) on batch x under ``loss`` at ``lam``, each
    launching ``per_step``. Returns the losses (tensors), per-step host
    times and the peak memory."""
    model = cls(*(widths or (M, K)), dtype=dtype, device=dev, seed=seed)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(model, opt, loss, lam)
    gen = torch.Generator(device=dev).manual_seed(100 + seed)
    losses, times = [], []
    if timed:
        for _ in range(TRAIN_WARMUP):
            losses.append(step(x, gen)["loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(steps):
        before = launch_counts()
        t0 = time.perf_counter()
        losses.append(step(x, gen)["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        check(launched == per_step, f"one step launched {launched}, not {per_step}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del model, opt, step
    return torch.stack(losses).cpu(), times, peak


def train_phase(dev, card: str, cls=JointAutoregressiveHierarchical,
                eval_flops=flops.joint_ar_eval_flops, per_step=PER_STEP, widths=None,
                loss=rd_loss, lam=LAMBDA, extra_flops=0):
    """The training step at batch 16 of 256^2 in bf16 and f32: steps/s,
    peak memory and MFU (3x ``eval_flops`` an image, plus ``extra_flops``:
    work beside the model, such as a distillation teacher), and the loss
    falling over 30 steps on one batch."""
    x = torch.rand((TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
                   generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    flops_img = flops.train_step_flops(eval_flops(*(widths or (M, K)), TRAIN_SIZE,
                                                  TRAIN_SIZE)["total"]) + extra_flops
    steps = 0
    results = {}
    for dtype, peak_name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        name = str(dtype).replace("torch.", "")
        losses, times, peak_mem = train_run(dev, dtype, x, seed=0, steps=TRAIN_TIMED,
                                            timed=True, cls=cls, per_step=per_step,
                                            widths=widths, loss=loss, lam=lam)
        check(bool(torch.isfinite(losses).all()), f"{name}: a loss is not finite: {losses}")
        conv, _, _ = train_run(dev, dtype, x, seed=1, steps=TRAIN_CONVERGE, cls=cls,
                               per_step=per_step, widths=widths, loss=loss, lam=lam)
        check(bool(torch.isfinite(conv).all()), f"{name}: a loss is not finite: {conv}")
        first, last = conv[:10].mean().item(), conv[20:30].mean().item()
        check(last < first, f"{name}: mean loss of steps 21-30 {last} not below steps 1-10 {first}")
        steps += TRAIN_WARMUP + TRAIN_TIMED + TRAIN_CONVERGE
        ms = 1e3 * statistics.median(times)
        peak = flops.H100_PEAK_TFLOPS[peak_name]
        results[name] = dict(
            steps_per_s=1e3 / ms, ms_per_step=ms, ms_per_step_mean=1e3 * statistics.mean(times),
            peak_mem_gib=peak_mem, mfu=flops.mfu(1e3 / ms * TRAIN_BATCH, flops_img, peak),
            mfu_peak=f"{peak_name} {peak:g} TFLOP/s", flops_per_image=flops_img,
            loss_first=losses[0].item(), loss_last=losses[-1].item(),
            converge_mean_1_10=first, converge_mean_21_30=last)
        r = results[name]
        print(f"  {name}: {r['steps_per_s']:.3f} steps/s ({r['ms_per_step']:.3f} ms a step, "
              f"mean {r['ms_per_step_mean']:.3f}) at batch {TRAIN_BATCH} of {TRAIN_SIZE}^2, "
              f"peak memory {r['peak_mem_gib']:.2f} GiB, MFU {100 * r['mfu']:.2f}% of the "
              f"{r['mfu_peak']} peak; loss {r['loss_first']:.4f} -> {r['loss_last']:.4f}; "
              f"one batch, 30 steps: mean {first:.4f} (1-10) -> {last:.4f} (21-30) [{card}]",
              flush=True)
    return steps, results


# --- phase 6: the codec ------------------------------------------------------------

CODEC_SEED = 12
CODEC_WARMUP, CODEC_ITERS = 1, 5
# stream bits against the eval forward's analytic bits: 2% plus the 26-byte
# header and the two 4-byte rANS state flushes (z and y)
CODEC_RATE_SLACK, CODEC_FIXED_BYTES = 1.02, 26 + 2 * 4
# decompress against the eval forward's x_hat: float32 within 1e-5 (the
# decoders run the same operations on the same latents; cuDNN's transposed
# convolutions may sum in other orders from call to call); bfloat16 within
# one bf16 step
CODEC_F32_XHAT_TOL = 1e-5
NO_LAUNCHES = {"gdn": 0, "gdn_backward": 0, "gdn_backward_params": 0, "gmm_logp": 0,
               "gmm_logp_backward": 0}
CODEC_PER_CALL = dict(NO_LAUNCHES, gdn=3)  # 3 GDN in analysis, 3 IGDN in synthesis


# GDN rows of one image at the three transform depths (3 GDN in analysis,
# 3 IGDN in synthesis)
CODEC_GDN_SITES = {"H/2": (HEIGHT // 2) * (WIDTH // 2), "H/4": (HEIGHT // 4) * (WIDTH // 4),
                   "H/8": (HEIGHT // 8) * (WIDTH // 8)}


def gdn_codec_cases(dev):
    rng = np.random.default_rng(13)
    gamma_t, beta_t = gdn_params(M, rng, dev)
    return gdn_site_records("codec", CODEC_GDN_SITES, rng, gamma_t, beta_t, dev)


# latent refinement: the decoder's three IGDN backwards (dx alone: the
# weights are frozen) at one image's rows, and the mixture at its latents
REFINE_GMM_ROWS = (HEIGHT // 16) * (WIDTH // 16)


def refine_kernel_cases(dev):
    """The IGDN backward without its dgamma/dbeta stage at the codec's rows,
    and both mixture kernels at refinement's rows, against their plain
    versions, timed beside their bounds."""
    rng = np.random.default_rng(14)
    gamma_t, beta_t = gdn_params(M, rng, dev)
    records = gdn_backward_site_records("refine", CODEC_GDN_SITES, rng, gamma_t, beta_t, dev,
                                        inverses=(True,), param_grads=False)
    records += gmm_case(dev, "refine", REFINE_GMM_ROWS, seed=15)
    records += gmm_backward_case(dev, "refine", REFINE_GMM_ROWS, seed=16)
    return records


def codec_images():
    rng = np.random.default_rng(CODEC_SEED)
    return {"uint8": (rng.uniform(size=(1, HEIGHT, WIDTH, 3)) * 256).astype(np.uint8),
            "float32": rng.uniform(size=(1, HEIGHT, WIDTH, 3)).astype(np.float32)}


def codec_references(dev, models, images):
    """The eval forward of each model on each image (uint8 as x/255): the
    latents, the clipped x_hat and the analytic bits, on the host."""
    refs = {}
    for dname, model in models.items():
        for iname, x in images.items():
            xf = x.astype(np.float32) / 255.0 if x.dtype == np.uint8 else x
            xd = torch.from_numpy(xf).to(dev)
            out = model(xd, training=False)
            refs[dname, iname] = dict(
                y_in=out["y_in"][0].cpu().numpy(), z_in=out["z_in"][0].cpu().numpy(),
                x_hat=torch.clamp(out["x_hat"], 0.0, 1.0).cpu().numpy(),
                bits=rd_loss(out, xd, LAMBDA)["bits_total"].item())
            del out, xd
    return refs


def counted(total, expect, fn, *args):
    """fn(*args) with its kernel launches checked against ``expect`` and
    added to ``total``; returns (result, seconds on the host clock)."""
    before = launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = launch_counts()
    got = {k: after[k] - before[k] for k in after}
    check(got == expect, f"{getattr(fn, '__name__', fn)} launched {got}, not {expect}")
    for k, v in got.items():
        total[k] += v
    return out, seconds


def median_call_ms(total, expect, fn, *args):
    """Median host-clock ms of CODEC_ITERS calls after CODEC_WARMUP."""
    for _ in range(CODEC_WARMUP):
        counted(total, expect, fn, *args)
    return 1e3 * statistics.median(counted(total, expect, fn, *args)[1]
                                   for _ in range(CODEC_ITERS))


def set_fast_numerics(on: bool) -> None:
    torch.backends.cudnn.benchmark = on
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def codec_numerics_check(total, model, x, dname):
    """Compress with cuDNN autotuning and TF32 on, decode with both off: the
    stream decodes exactly (its decoded latents re-encode to the same
    bytes) and psi is the same bits; two fresh codecs give equal bytes and
    equal psi."""
    set_fast_numerics(True)
    try:
        fast = JointARCodec(model)
        data, _ = counted(total, CODEC_PER_CALL, fast.compress, x)
        check(torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.benchmark
              and torch.backends.cuda.matmul.allow_tf32,
              f"{dname}: the codec did not restore the caller's numerics settings")
        (y_fast, z_fast), _ = counted(total, NO_LAUNCHES, fast.decode_latents, data)
        psi_fast = fast._psi(z_fast[None])
    finally:
        set_fast_numerics(False)
    plain = JointARCodec(model)
    (y_q, z_q), _ = counted(total, NO_LAUNCHES, plain.decode_latents, data)
    check(np.array_equal(y_q, y_fast) and np.array_equal(z_q, z_fast),
          f"{dname}: latents decoded with TF32 off differ from those decoded with it on")
    again, _ = counted(total, NO_LAUNCHES, plain.compress_latents, y_q, z_q, HEIGHT, WIDTH)
    check(again == data, f"{dname}: the TF32-on stream's latents re-encode to other bytes "
                         f"with TF32 off")
    check(np.array_equal(plain._psi(z_q[None]), psi_fast), f"{dname}: psi depends on TF32")
    first, second = JointARCodec(model), JointARCodec(model)
    d1, _ = counted(total, CODEC_PER_CALL, first.compress, x)
    d2, _ = counted(total, CODEC_PER_CALL, second.compress, x)
    check(d1 == d2, f"{dname}: two fresh codecs wrote different streams")
    z1 = first.decode_latents(d1)[1][None]
    check(np.array_equal(first._psi(z1), second._psi(z1)), f"{dname}: two fresh codecs' psi differ")
    print(f"  {dname}: TF32 + autotuned compress decodes exactly with both off (stream "
          f"re-encodes to the same {len(data)} bytes, psi bit-equal); two fresh codecs: "
          f"equal bytes and psi", flush=True)


def codec_round_trip(total, codec, x, ref, dname, iname, n_streams=None):
    """compress (with n_streams when given) and decode one image: exact
    latents, decompress against the eval forward's x_hat (float32 within
    CODEC_F32_XHAT_TOL, bfloat16 within one bf16 step), the uint8 output,
    the stream's bits against the analytic bits (8 bytes more a lane).
    Returns (stream, y_q, z_q, x_hat's max abs difference, its note, stream
    bits over analytic)."""
    label = f"{dname} {iname}" + ("" if n_streams is None else f" n_streams={n_streams}")
    kwargs = {} if n_streams is None else {"n_streams": n_streams}
    data, _ = counted(total, CODEC_PER_CALL, functools.partial(codec.compress, **kwargs), x)
    (y_q, z_q), _ = counted(total, NO_LAUNCHES, codec.decode_latents, data)
    check(np.array_equal(y_q, ref["y_in"]) and np.array_equal(z_q, ref["z_in"]),
          f"{label}: decoded latents differ from the eval forward's y_in/z_in "
          f"({int((y_q != ref['y_in']).sum())} y, {int((z_q != ref['z_in']).sum())} z)")
    check(len(np.unique(y_q)) >= 3, f"{label}: y_q takes fewer than 3 values")
    x_hat, _ = counted(total, CODEC_PER_CALL, codec.decompress, data)
    check(x_hat.shape == (1, HEIGHT, WIDTH, 3) and np.isfinite(x_hat).all(), f"{label}: x_hat")
    xhat_err = float(np.abs(x_hat - ref["x_hat"]).max())
    if dname == "float32":
        check(xhat_err <= CODEC_F32_XHAT_TOL, f"{label}: x_hat differs by {xhat_err:.3e}")
        xhat_note = f"max abs diff {xhat_err:.3e}"
    else:
        steps = bf16_steps_apart(torch.from_numpy(x_hat).bfloat16(),
                                 torch.from_numpy(ref["x_hat"]).bfloat16()).max().item()
        check(steps <= 1, f"{label}: x_hat {steps} bf16 steps from the eval forward's")
        xhat_note = f"max abs diff {xhat_err:.3e}, at most {steps} bf16 step(s)"
    if iname == "uint8":
        x8, _ = counted(total, CODEC_PER_CALL, codec.decompress, data, True)
        want8 = np.round(x_hat * 255.0).astype(np.int32)
        check(x8.dtype == np.uint8 and np.abs(x8.astype(np.int32) - want8).max() <= 1,
              f"{label}: as_uint8 output beyond one level")
    bits = 8 * len(data)
    lanes = 0 if not n_streams or n_streams == 1 else n_streams
    check(bits <= ref["bits"] * CODEC_RATE_SLACK + 8 * (CODEC_FIXED_BYTES + 8 * lanes),
          f"{label}: {bits} stream bits against {ref['bits']:.1f} analytic")
    return data, y_q, z_q, xhat_err, xhat_note, bits / ref["bits"]


def codec_case(total, codec, x, ref, dname, iname, card):
    """One model on one image: correctness, then latency by stage."""
    label = f"{dname} {iname}"
    data, y_q, z_q, xhat_err, xhat_note, ratio = codec_round_trip(total, codec, x, ref, dname,
                                                                  iname)
    bits = 8 * len(data)

    encode_ms = median_call_ms(total, CODEC_PER_CALL, codec.compress, x)
    decode_ms = median_call_ms(total, CODEC_PER_CALL, codec.decompress, data)
    # the stages compress and decompress run, one at a time
    img_h, img_w, y_s, z_s, psi = counted(total, CODEC_PER_CALL, codec._analyse_image, x)[0]
    header = codec._header(data)
    y_payload = data[codec_module._HEADER_SIZE + header[9]:]
    h, w = HEIGHT // 16, WIDTH // 16
    stages = {
        "encode_analysis_psi": median_call_ms(total, CODEC_PER_CALL, codec._analyse_image, x),
        "encode_host_z_and_wavefront": median_call_ms(total, NO_LAUNCHES, codec._encode_from,
                                                      y_s, z_s, psi, img_h, img_w),
        "decode_host_z": median_call_ms(total, NO_LAUNCHES, codec._decode_z, data, header),
        "decode_psi": median_call_ms(total, NO_LAUNCHES, codec._psi, z_q[None]),
        "decode_host_wavefront": median_call_ms(total, NO_LAUNCHES,
                                                codec_module._ar_decode_latents,
                                                codec._host_nets, y_payload, psi, h, w),
        "decode_synthesis": median_call_ms(total, CODEC_PER_CALL, codec._synthesize, y_q[None],
                                           HEIGHT, WIDTH),
    }
    result = dict(
        encode_ms=encode_ms, decode_ms=decode_ms,
        encode_device_ms=stages["encode_analysis_psi"],
        encode_host_ms=stages["encode_host_z_and_wavefront"],
        decode_device_ms=stages["decode_psi"] + stages["decode_synthesis"],
        decode_host_ms=stages["decode_host_z"] + stages["decode_host_wavefront"],
        stages_ms=stages, stream_bytes=len(data), bpp=bits / (HEIGHT * WIDTH),
        analytic_bpp=ref["bits"] / (HEIGHT * WIDTH), stream_over_analytic=ratio,
        x_hat_max_abs_diff=xhat_err)
    print(f"  {label}: encode {encode_ms:.2f} ms (device {result['encode_device_ms']:.2f}, host "
          f"{result['encode_host_ms']:.2f}), decode {decode_ms:.2f} ms (device "
          f"{result['decode_device_ms']:.2f}, host {result['decode_host_ms']:.2f}); "
          f"{result['bpp']:.5f} bpp, {ratio:.5f} of analytic; latents exact, x_hat {xhat_note} "
          f"[{card}, {os.cpu_count()} host cores]", flush=True)
    return result


CODEC_STREAMS = (4, 8)
CODEC_TILES = (2, 2)
BATCH_IMAGES, BATCH_ITERS = 8, 3
REFINE_STEPS, REFINE_LR, REFINE_ITERS = 20, 1e-2, 3
# the eval forward (3 GDN, 3 IGDN, 1 mixture), each step's decoder (3 IGDN
# forward and backward, dx alone) and rate (1 mixture forward and
# backward), and the refined latents' forward (3 IGDN, 1 mixture)
REFINE_PER_CALL = dict(NO_LAUNCHES, gdn=6 + 3 * REFINE_STEPS + 3, gdn_backward=3 * REFINE_STEPS,
                       gmm_logp=1 + REFINE_STEPS + 1, gmm_logp_backward=REFINE_STEPS)
REFINE_ZERO_STEPS = dict(NO_LAUNCHES, gdn=9, gmm_logp=2)
PORTABLE_SMALL = (64, 128)


def check_latents(label, got, ref):
    y_q, z_q = got
    check(np.array_equal(y_q, ref["y_in"]) and np.array_equal(z_q, ref["z_in"]),
          f"{label}: decoded latents differ from the eval forward's y_in/z_in "
          f"({int((y_q != ref['y_in']).sum())} y, {int((z_q != ref['z_in']).sum())} z)")


def codec_streams_case(total, codec, x, ref, dname):
    """Interleaved streams against one stream in this call: exact latents,
    bytes (each stream adds a 4-byte length-table entry and a 4-byte rANS
    flush) and latency by stage, the device stages shared by every N."""
    img_h, img_w, y_s, z_s, psi = counted(total, CODEC_PER_CALL, codec._analyse_image, x)[0]
    h, w = HEIGHT // 16, WIDTH // 16
    rows = {}
    for n in (1,) + CODEC_STREAMS:
        data, _ = counted(total, CODEC_PER_CALL, codec.compress, x, None, n)
        check_latents(f"{dname} n_streams={n}", counted(total, NO_LAUNCHES,
                                                        codec.decode_latents, data)[0], ref)
        if n == 1:
            base = len(data)
        check(len(data) <= base + 8 * n, f"{dname} n_streams={n}: {len(data)} bytes against "
                                         f"{base} in one stream")
        header = codec._header(data)
        payload = data[codec_module._HEADER_SIZE + header[9]:]
        rows[n] = dict(
            stream_bytes=len(data), extra_bytes=len(data) - base,
            encode_ms=median_call_ms(total, CODEC_PER_CALL, codec.compress, x, None, n),
            decode_ms=median_call_ms(total, CODEC_PER_CALL, codec.decompress, data),
            encode_host_ms=median_call_ms(total, NO_LAUNCHES, codec._encode_from, y_s, z_s, psi,
                                          img_h, img_w, None, n),
            decode_host_z_ms=median_call_ms(total, NO_LAUNCHES, codec._decode_z, data, header),
            decode_host_wavefront_ms=median_call_ms(total, NO_LAUNCHES, codec._decode_y, payload,
                                                    psi, h, w, header[6]))
    z_q = ref["z_in"][None]
    device = dict(
        encode_analysis_psi_ms=median_call_ms(total, CODEC_PER_CALL, codec._analyse_image, x),
        decode_psi_ms=median_call_ms(total, NO_LAUNCHES, codec._psi, z_q),
        decode_synthesis_ms=median_call_ms(total, CODEC_PER_CALL, codec._synthesize,
                                           ref["y_in"][None], HEIGHT, WIDTH))
    for n in CODEC_STREAMS:
        r = rows[n]
        r["decode_wavefront_speedup"] = (rows[1]["decode_host_wavefront_ms"]
                                         / r["decode_host_wavefront_ms"])
        r["encode_host_speedup"] = rows[1]["encode_host_ms"] / r["encode_host_ms"]
        print(f"  {dname} n_streams={n}: +{r['extra_bytes']} bytes; encode {r['encode_ms']:.2f} ms "
              f"(host {r['encode_host_ms']:.2f}, {r['encode_host_speedup']:.2f}x N=1's "
              f"{rows[1]['encode_host_ms']:.2f}), decode {r['decode_ms']:.2f} ms (host wavefront "
              f"{r['decode_host_wavefront_ms']:.2f}, {r['decode_wavefront_speedup']:.2f}x N=1's "
              f"{rows[1]['decode_host_wavefront_ms']:.2f}); N=1 encode {rows[1]['encode_ms']:.2f}, "
              f"decode {rows[1]['decode_ms']:.2f} ms; latents exact", flush=True)
    return dict(by_streams=rows, device_ms=device)


def codec_tiles_case(total, codec, x, ref, dname):
    """2x2 tiles: exact latents, and their rate against one stream (on
    random weights the border pixels' lost context costs less than on a
    trained model)."""
    data, _ = counted(total, CODEC_PER_CALL, codec.compress, x, CODEC_TILES)
    check_latents(f"{dname} tiles {CODEC_TILES}",
                  counted(total, NO_LAUNCHES, codec.decode_latents, data)[0], ref)
    one, _ = counted(total, CODEC_PER_CALL, codec.compress, x)
    r = dict(bpp=8 * len(data) / (HEIGHT * WIDTH), untiled_bpp=8 * len(one) / (HEIGHT * WIDTH),
             decode_ms=median_call_ms(total, CODEC_PER_CALL, codec.decompress, data))
    r["bpp_over_untiled"] = r["bpp"] / r["untiled_bpp"]
    print(f"  {dname} tiles {CODEC_TILES}: {r['bpp']:.5f} bpp against {r['untiled_bpp']:.5f} "
          f"untiled ({r['bpp_over_untiled']:.4f}x); decode {r['decode_ms']:.2f} ms; latents exact",
          flush=True)
    return r


def batch_images():
    rng = np.random.default_rng(CODEC_SEED + 1)
    return (rng.uniform(size=(BATCH_IMAGES, HEIGHT, WIDTH, 3)) * 256).astype(np.uint8)


def batch_references(model, xs, dev):
    """The eval forward's latents and clipped x_hat for each image, one
    image a forward as compress runs the analysis (a batched bf16 forward
    may round a latent on its boundary the other way)."""
    outs = [model(torch.from_numpy(xs[b:b + 1]).to(dev).float() / 255.0, training=False)
            for b in range(len(xs))]
    return tuple(np.concatenate([f(o).cpu().numpy() for o in outs])
                 for f in (lambda o: o["y_in"], lambda o: o["z_in"],
                           lambda o: torch.clamp(o["x_hat"], 0.0, 1.0)))


def codec_batch_case(total, codec, xs, refs, dname, iters=BATCH_ITERS):
    """compress_batch / decompress_batch of BATCH_IMAGES images: streams equal
    to compress's, exact latents, images against decompress's, and
    images/s against one call per image (medians of ``iters``)."""
    n = len(xs)
    enc_batch = dict(NO_LAUNCHES, gdn=3 * n)
    streams, _ = counted(total, enc_batch, codec.compress_batch, xs)
    singles = [counted(total, CODEC_PER_CALL, codec.compress, xs[b:b + 1])[0] for b in range(n)]
    check(streams == singles, f"{dname}: compress_batch streams differ from compress's")
    y_in, z_in, x_ref = refs
    for b, data in enumerate(streams):
        check_latents(f"{dname} batch image {b}",
                      counted(total, NO_LAUNCHES, codec.decode_latents, data)[0],
                      dict(y_in=y_in[b], z_in=z_in[b]))
    images, _ = counted(total, CODEC_PER_CALL, codec.decompress_batch, streams)
    one_by_one = np.concatenate([counted(total, CODEC_PER_CALL, codec.decompress, d)[0]
                                 for d in streams])
    check(images.shape == (n, HEIGHT, WIDTH, 3), f"{dname}: decompress_batch shape {images.shape}")
    for got in (images, one_by_one):
        if dname == "float32":  # one batched synthesis against batch-1 ones and the forward
            err = float(np.abs(got - x_ref).max())
            check(err <= CODEC_F32_XHAT_TOL, f"{dname}: batch images differ by {err:.3e}")
        else:
            steps = bf16_steps_apart(torch.from_numpy(got).bfloat16(),
                                     torch.from_numpy(x_ref).bfloat16()).max().item()
            check(steps <= 1, f"{dname}: batch images {steps} bf16 steps from the forward's")

    def per_image_encode():
        return [codec.compress(xs[b:b + 1]) for b in range(n)]

    def per_image_decode():
        return [codec.decompress(d) for d in streams]

    def median_s(expect, fn, *args):
        return statistics.median(counted(total, expect, fn, *args)[1] for _ in range(iters))

    r = dict(encode_batch_s=median_s(enc_batch, codec.compress_batch, xs),
             encode_single_s=median_s(dict(NO_LAUNCHES, gdn=3 * n), per_image_encode),
             decode_batch_s=median_s(CODEC_PER_CALL, codec.decompress_batch, streams),
             decode_single_s=median_s(dict(NO_LAUNCHES, gdn=3 * n), per_image_decode))
    for k in ("encode_batch", "encode_single", "decode_batch", "decode_single"):
        r[k + "_img_per_s"] = n / r[k + "_s"]
    print(f"  {dname} batch of {n}: encode {r['encode_batch_img_per_s']:.2f} img/s "
          f"(one call per image {r['encode_single_img_per_s']:.2f}), decode "
          f"{r['decode_batch_img_per_s']:.2f} img/s ({r['decode_single_img_per_s']:.2f}); streams "
          f"equal compress's, latents exact [{os.cpu_count()} host cores]", flush=True)
    return r


def refine_case(total, model, codec, x, dev, dname, per_call=REFINE_PER_CALL,
                zero_steps=REFINE_ZERO_STEPS, iters=REFINE_ITERS):
    """REFINE_STEPS Adam steps on one image's latents: the loss falls, the
    refined latents round trip through the codec, the launches per call
    (``per_call``; ``zero_steps`` for a call of none), and ms a step (a call
    of REFINE_STEPS steps less one of none: medians of ``iters`` calls
    after the first; with iters 0, the first call and one of none)."""
    xd = torch.from_numpy(x).to(dev)
    refine = make_refiner(model, LAMBDA, steps=REFINE_STEPS, lr=REFINE_LR)
    (y_q, z_q, m), first_s = counted(total, per_call, refine, xd)
    pre, post = m["pre_loss"].item(), m["post_loss"].item()
    check(np.isfinite(pre) and np.isfinite(post) and post <= pre,
          f"{dname} refine: loss {pre} -> {post}")
    # keywords: the factorized codec's compress_latents is (y_q, img_h, img_w, z_q=None)
    data, _ = counted(total, NO_LAUNCHES, functools.partial(
        codec.compress_latents, y_q, z_q=z_q, img_h=HEIGHT, img_w=WIDTH))
    y_d, z_d = counted(total, NO_LAUNCHES, codec.decode_latents, data)[0]
    check(np.array_equal(y_d, y_q[0].cpu().numpy()) and np.array_equal(z_d, z_q[0].cpu().numpy()),
          f"{dname} refine: the refined latents do not round trip")
    none = make_refiner(model, LAMBDA, steps=0, lr=REFINE_LR)
    full_ms = 1e3 * statistics.median([counted(total, per_call, refine, xd)[1]
                                       for _ in range(iters)] or [first_s])
    zero_ms = 1e3 * statistics.median(counted(total, zero_steps, none, xd)[1]
                                      for _ in range(max(iters, 1)))
    r = dict(pre_loss=pre, post_loss=post, pre_bpp=m["pre_bpp_total"].item(),
             post_bpp=m["post_bpp_total"].item(), pre_psnr=m["pre_psnr"].item(),
             post_psnr=m["post_psnr"].item(), refine_ms=full_ms, no_steps_ms=zero_ms,
             ms_per_step=(full_ms - zero_ms) / REFINE_STEPS, stream_bytes=len(data),
             launches_per_call=per_call)
    print(f"  {dname} refine {REFINE_STEPS} steps (lr {REFINE_LR}): loss {pre:.4f} -> {post:.4f}, "
          f"bpp {r['pre_bpp']:.5f} -> {r['post_bpp']:.5f}, PSNR {r['pre_psnr']:.3f} -> "
          f"{r['post_psnr']:.3f}; {full_ms:.2f} ms a call, {r['ms_per_step']:.3f} ms a step; "
          f"round trip exact; launches {per_call}", flush=True)
    return r


def portable_case(total, model, x, ref, float_bytes, dname, codec_cls=JointARCodec,
                  coder=(portable.portable_ar_encode, portable.portable_ar_decode),
                  card_type=(PortableCard.build, PortableCard.load), median=median_call_ms):
    """A card built here, saved and loaded (same hash); compress_portable's
    latents exact, its rate against the float stream's, encode and decode
    latency (``median``: the timer); at 64x128 the native and numpy coders
    (``coder``: the card family's encode and decode) write the same bytes.
    card_type: the card's (build, load)."""
    encode, decode = coder
    build, load = card_type
    t0 = time.perf_counter()
    card, _ = counted(total, NO_LAUNCHES, build, model)
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "card.npz")
        card.save(path)
        loaded = load(path)
    check(loaded.hash == card.hash, f"{dname}: the loaded card's hash differs")
    codec = codec_cls(model, portable_card=loaded)
    encode_only = dict(NO_LAUNCHES, gdn=3)
    data, _ = counted(total, encode_only, codec.compress_portable, x)
    check_latents(f"{dname} portable", counted(total, NO_LAUNCHES, codec.decode_latents, data)[0],
                  ref)
    r = dict(card_hash=card.hash.hex(), card_build_s=build_s, stream_bytes=len(data),
             bpp=8 * len(data) / (HEIGHT * WIDTH), over_float=len(data) / float_bytes,
             encode_ms=median(total, encode_only, codec.compress_portable, x),
             decode_ms=median(total, CODEC_PER_CALL, codec.decompress, data))
    small = x[:, :PORTABLE_SMALL[0], :PORTABLE_SMALL[1]]
    small_data, _ = counted(total, encode_only, codec.compress_portable, small)
    y_s, z_s = counted(total, NO_LAUNCHES, codec.decode_latents, small_data)[0]
    psi_fix = loaded.hyper_forward(z_s)
    check(np.array_equal(psi_fix, loaded.hyper_forward(z_s, native=False)),
          f"{dname}: native and numpy hyper_forward differ")
    native = encode(loaded, y_s, psi_fix)
    check(native == encode(loaded, y_s, psi_fix, native=False),
          f"{dname}: native and numpy portable streams differ at {PORTABLE_SMALL}")
    h, w = PORTABLE_SMALL[0] // 16, PORTABLE_SMALL[1] // 16
    check(np.array_equal(decode(loaded, native, psi_fix, h, w, native=False), y_s),
          f"{dname}: the numpy decoder misreads the native stream")
    print(f"  {dname} portable: card {r['card_hash']} built in {build_s:.2f} s, saved and loaded "
          f"(same hash); {r['bpp']:.5f} bpp, {r['over_float']:.5f}x the float stream; encode "
          f"{r['encode_ms']:.2f} ms, decode {r['decode_ms']:.2f} ms; latents exact; native = numpy "
          f"bytes at {PORTABLE_SMALL[0]}x{PORTABLE_SMALL[1]}", flush=True)
    return r


def codec_phase(dev, card):
    """Returns (launches of the codec's calls, results)."""
    images = codec_images()
    models = {"float32": gained_model(dev), "bfloat16": gained_model(dev, torch.bfloat16)}
    refs = codec_references(dev, models, images)
    xs = batch_images()
    batch_refs = {dname: batch_references(model, xs, dev) for dname, model in models.items()}
    reset_launch_counts()
    total = dict(NO_LAUNCHES)
    results = {}
    for dname, model in models.items():
        codec = JointARCodec(model)
        results[dname] = {iname: codec_case(total, codec, x, refs[dname, iname], dname, iname,
                                            card)
                          for iname, x in images.items()}
        codec_numerics_check(total, model, images["float32"], dname)
        x, ref = images["float32"], refs[dname, "float32"]
        results[dname]["interleaved"] = codec_streams_case(total, codec, x, ref, dname)
        results[dname]["tiles"] = codec_tiles_case(total, codec, x, ref, dname)
        results[dname]["batch"] = codec_batch_case(total, codec, xs, batch_refs[dname], dname)
        results[dname]["refine"] = refine_case(total, model, codec, x, dev, dname)
        results[dname]["portable"] = portable_case(
            total, model, x, ref, results[dname]["float32"]["stream_bytes"], dname)
    launches = launch_counts()
    check(launches == total, f"codec launches {launches}, its calls counted {total}")
    return launches, results


# --- phase 7: the Trainer and the evaluator -----------------------------------

TRAINER_SEED = 20
TRAINER_IMAGES, TRAINER_STEPS, TRAINER_RESUME_STEPS = 64, 30, 10
TRAINER_SETTINGS = dict(lambda_val=LAMBDA, scheduler="plateau", val_interval=10,
                        checkpoint_interval=10, ema_decay=0.999, clip_grad_norm=1.0,
                        log_interval=15, img_interval=15, scalar_interval=1)
VAL_IMAGES, EVAL_IMAGES = 2, 4
FORWARD = dict(NO_LAUNCHES, gdn=GDN_PER_FORWARD, gmm_logp=GMM_PER_FORWARD)
MSSSIM_LAMBDA, MSSSIM_STEPS = 16.0, 5
# card against CPU MS-SSIM with TF32 on: the blur runs in full float32 on
# both, so only the order of float32 sums differs
MSSSIM_CARD_TOL = 1e-5
EVAL_STREAMS, EVAL_REFINE_STEPS = 8, 5


def scaled(launches, n):
    return {k: v * n for k, v in launches.items()}


def added(*parts):
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def refine_launches(steps, mixture=True):
    """One refine call of ``steps`` steps (REFINE_PER_CALL's terms; no
    mixture launches for a family without one)."""
    return dict(NO_LAUNCHES, gdn=6 + 3 * steps + 3, gdn_backward=3 * steps,
                gmm_logp=(1 + steps + 1) * mixture, gmm_logp_backward=steps * mixture)


def expecting(total, expect, fn, label, calls):
    """fn with each call's kernel launches checked against ``expect(*args)``
    and added to ``total``; ``calls`` counts the calls under ``label``."""
    def wrapped(*args, **kwargs):
        before = launch_counts()
        out = fn(*args, **kwargs)
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after}
        want = expect(*args, **kwargs)
        check(got == want, f"{label} launched {got}, not {want}")
        for k, v in got.items():
            total[k] += v
        calls[label] = calls.get(label, 0) + 1
        return out
    return wrapped


def instrument(trainer, total, calls):
    """Check the launches of each step (6/6/1/1), each validation (6/0/1/0
    a forward) and each diagnostic forward (6/0/1/0) of a Trainer."""
    n_val = len(trainer.val_loader or [])
    trainer._train_step = expecting(total, lambda *a: PER_STEP, trainer._train_step, "step",
                                    calls)
    trainer._validate = expecting(total, lambda: scaled(FORWARD, n_val), trainer._validate,
                                  "validation", calls)
    trainer._diagnostics = expecting(total, lambda *a: FORWARD, trainer._diagnostics,
                                     "diagnostics", calls)
    return trainer


def trainer_data():
    rng = np.random.default_rng(TRAINER_SEED)
    patches = list(rng.integers(0, 256, size=(TRAINER_IMAGES, TRAIN_SIZE, TRAIN_SIZE, 3),
                                dtype=np.uint8))
    val = [rng.uniform(size=(1, HEIGHT, WIDTH, 3)).astype(np.float32) for _ in range(VAL_IMAGES)]
    return patches, val


def trainer_loader(patches):
    return BatchLoader(patches, batch_size=TRAIN_BATCH, shuffle=True, seed=TRAINER_SEED,
                       prefetch=2)


def jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def trainer_run_case(dev, total, calls, patches, val, tmp):
    """30 bf16 steps with every option, checkpoints at 10, 20 and 30, then a
    resumed Trainer to step 40."""
    log_dir, ckpt = os.path.join(tmp, "runs"), os.path.join(tmp, "ckpt.pt")
    model = JointAutoregressiveHierarchical(M, K, dtype=torch.bfloat16, device=dev,
                                            seed=TRAINER_SEED)
    t0 = time.perf_counter()
    first = instrument(Trainer(model, trainer_loader(patches), val_loader=val,
                               max_steps=TRAINER_STEPS, log_dir=log_dir, checkpoint_path=ckpt,
                               **TRAINER_SETTINGS), total, calls)
    first.train()
    check(os.path.isfile(ckpt), "no checkpoint written")
    resumed_model = JointAutoregressiveHierarchical(M, K, dtype=torch.bfloat16, device=dev,
                                                    seed=TRAINER_SEED + 1)
    second = instrument(Trainer(resumed_model, trainer_loader(patches), val_loader=val,
                                max_steps=TRAINER_RESUME_STEPS, resume=True, log_dir=log_dir,
                                checkpoint_path=ckpt, **TRAINER_SETTINGS), total, calls)
    check(second.step == TRAINER_STEPS and second.max_steps == TRAINER_STEPS + TRAINER_RESUME_STEPS,
          f"resumed at step {second.step} of {second.max_steps}")
    for name, p in resumed_model.named_parameters():
        check(torch.equal(p, dict(model.named_parameters())[name]),
              f"{name}: the resumed model does not hold the checkpoint's weights")
    second.train()
    seconds = time.perf_counter() - t0
    end = TRAINER_STEPS + TRAINER_RESUME_STEPS
    rows = jsonl(os.path.join(log_dir, "metrics.jsonl"))
    losses = [r for r in rows if r["tag"] == "losses/loss"]
    check([r["step"] for r in losses] == list(range(end)), "losses/loss steps")
    check(all(isinstance(r["value"], float) and np.isfinite(r["value"]) for r in losses),
          "a logged loss is not finite")
    val_steps = [r["step"] for r in rows if r["tag"] == "validation/validation_loss"]
    check(val_steps == list(range(0, end, TRAINER_SETTINGS["val_interval"])),
          f"validation at steps {val_steps}")
    diag_steps = [r["step"] for r in rows if r["tag"] == "activity/y_dead_channels_by_entropy"]
    check(diag_steps == list(range(0, end, TRAINER_SETTINGS["log_interval"])),
          f"diagnostics at steps {diag_steps}")
    check(calls == {"step": end, "validation": len(val_steps), "diagnostics": len(diag_steps)},
          f"calls {calls}")
    files = sorted(os.listdir(log_dir))
    r = dict(steps=end, seconds=seconds, loss_first=losses[0]["value"],
             loss_last=losses[-1]["value"], validation_steps=val_steps,
             validation_loss=[x["value"] for x in rows
                              if x["tag"] == "validation/validation_loss"],
             learning_rate_last=second.current_lr(), log_files=files)
    print(f"  bf16 Trainer: {end} steps over a resume at {TRAINER_STEPS} in {seconds:.1f} s "
          f"(validation at {val_steps}, diagnostics at {diag_steps}, checkpoints every "
          f"{TRAINER_SETTINGS['checkpoint_interval']}); loss {r['loss_first']:.4f} -> "
          f"{r['loss_last']:.4f}; launches a step {PER_STEP}, a validation forward and a "
          f"diagnostic forward {FORWARD}; log files {files}", flush=True)
    return r


def trainer_throughput(dev, total, patches, dtype, scalar_interval, rd=rd_loss,
                       lam=LAMBDA, timed=None):
    """ms a step of a Trainer over TRAIN_WARMUP + ``timed`` steps, from the
    host clock around the timed ones (validation, diagnostics and
    checkpoints outside them), and its logged losses."""
    timed = timed or TRAIN_TIMED
    with tempfile.TemporaryDirectory() as tmp:
        model = JointAutoregressiveHierarchical(M, K, dtype=dtype, device=dev, seed=TRAINER_SEED)
        trainer = Trainer(model, trainer_loader(patches), rd_loss=rd, lambda_val=lam,
                          max_steps=TRAIN_WARMUP, scalar_interval=scalar_interval,
                          log_interval=10 ** 9, img_interval=10 ** 9, log_dir=tmp,
                          checkpoint_path=None)
        before = launch_counts()
        trainer.train()  # step 0's diagnostics run here
        torch.cuda.synchronize()
        trainer.max_steps += timed
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / timed
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after}
        want = added(scaled(PER_STEP, TRAIN_WARMUP + timed), FORWARD)
        check(got == want, f"Trainer launched {got}, not {want}")
        for k, v in got.items():
            total[k] += v
        losses = [r["value"] for r in jsonl(os.path.join(tmp, "metrics.jsonl"))
                  if r["tag"] == "losses/loss"]
    return ms, losses


def msssim_parity(dev):
    """ms_ssim (RGB and Y) of one 768x512 pair on the card, with TF32 on,
    against the CPU's."""
    rng = np.random.default_rng(TRAINER_SEED + 2)
    a = rng.uniform(size=(1, HEIGHT, WIDTH, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1).astype(np.float32)
    set_fast_numerics(True)
    try:
        xa, xb = torch.from_numpy(a), torch.from_numpy(b)
        got = {"RGB": ms_ssim(xb.to(dev), xa.to(dev)).item(),
               "Y": ms_ssim(rgb_to_luma(xb.to(dev)), rgb_to_luma(xa.to(dev))).item()}
        check(torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32,
              "ms_ssim did not restore the caller's TF32 settings")
    finally:
        set_fast_numerics(False)
    want = {"RGB": ms_ssim(xb, xa).item(), "Y": ms_ssim(rgb_to_luma(xb), rgb_to_luma(xa)).item()}
    for k in want:
        diff = abs(got[k] - want[k])
        check(diff <= MSSSIM_CARD_TOL, f"MS-SSIM({k}) card {got[k]} vs cpu {want[k]}")
    print(f"  MS-SSIM with TF32 on: card RGB {got['RGB']:.8f} Y {got['Y']:.8f}, cpu RGB "
          f"{want['RGB']:.8f} Y {want['Y']:.8f} (tolerance {MSSSIM_CARD_TOL:g})", flush=True)
    return {"card": got, "cpu": want}


def evaluator_case(dev, total, tmp, card):
    """evaluate() and evaluate_codec(n_streams=8) on EVAL_IMAGES seeded
    768x512 images, a refined codec evaluation of one, the results file."""
    model = gained_model(dev)
    rng = np.random.default_rng(TRAINER_SEED + 3)
    imgs = [rng.uniform(size=(1, HEIGHT, WIDTH, 3)).astype(np.float32)
            for _ in range(EVAL_IMAGES)]
    ev = CompressionEvaluator(model, imgs, LAMBDA, tmp)
    (avg, _, recons), eval_s = counted(total, scaled(FORWARD, EVAL_IMAGES), ev.evaluate)
    check(all(np.isfinite(v) for v in avg.values()), f"evaluate: {avg}")
    check(abs(avg["BPP"] - avg["BPP(y)"] - avg["BPP(z)"]) <= 1e-6 * avg["BPP"]
          and avg["BPP(reference_reported)"] == avg["BPP(y)"], f"evaluate bpp fields {avg}")
    codec = JointARCodec(model)
    per_image = added(scaled(CODEC_PER_CALL, 2), FORWARD)  # compress, decompress, analytic
    codec_avg, codec_s = counted(total, scaled(per_image, EVAL_IMAGES),
                                 functools.partial(ev.evaluate_codec, n_streams=EVAL_STREAMS),
                                 codec)
    check(all(np.isfinite(v) for v in codec_avg.values()), f"evaluate_codec: {codec_avg}")
    slack_bpp = 8 * CODEC_FIXED_BYTES / (HEIGHT * WIDTH)
    check(codec_avg["BPP(bitstream)"] <= CODEC_RATE_SLACK * codec_avg["BPP(analytic)"] + slack_bpp,
          f"bitstream {codec_avg['BPP(bitstream)']} bpp against {codec_avg['BPP(analytic)']}")
    check(abs(codec_avg["BPP(analytic)"] - avg["BPP"]) <= 1e-5 * avg["BPP"],
          f"analytic {codec_avg['BPP(analytic)']} against evaluate's {avg['BPP']}")
    # decode against the eval forward's x_hat (phase 6's tolerance), and the
    # PSNR that tolerance allows: |dMSE| <= 2 t sqrt(MSE) + t^2
    data, _ = counted(total, CODEC_PER_CALL, codec.compress, imgs[0])
    x_hat, _ = counted(total, CODEC_PER_CALL, codec.decompress, data)
    xhat_err = float(np.abs(x_hat[0] - recons[0]).max())
    check(xhat_err <= CODEC_F32_XHAT_TOL, f"decoded image differs by {xhat_err:.3e}")
    mse = avg["MSE(255)"] / 255.0 ** 2
    t = CODEC_F32_XHAT_TOL
    psnr_tol = 10 / np.log(10) * (2 * t * np.sqrt(mse) + t * t) / mse
    psnr_diff = abs(codec_avg["PSNR(RGB)"] - avg["PSNR(RGB)"])
    check(psnr_diff <= psnr_tol, f"PSNR(RGB) decoded {codec_avg['PSNR(RGB)']} vs "
                                 f"{avg['PSNR(RGB)']} (tolerance {psnr_tol:.3e})")
    one = CompressionEvaluator(model, imgs[:1], LAMBDA, tmp)
    refined, refine_s = counted(
        total, added(refine_launches(EVAL_REFINE_STEPS), CODEC_PER_CALL, FORWARD),
        one.evaluate_codec, codec, EVAL_REFINE_STEPS, LAMBDA)
    check(all(np.isfinite(v) for v in refined.values()), f"refined: {refined}")
    path = ev.save_results(dict(avg, **{"codec/" + k: v for k, v in codec_avg.items()}),
                           TRAINER_STEPS + TRAINER_RESUME_STEPS, "GM-Capacity128_K3")
    with open(path) as f:
        lines = f.read().splitlines()
    check(os.path.basename(path) == "eval_results_0.005_lambda_GM-Capacity128_K3.txt"
          and lines[:2] == ["Lambda: 0.005", f"Trained for: {TRAINER_STEPS + TRAINER_RESUME_STEPS} "
                                             f"steps"]
          and lines[2].startswith("MSE(255): "), f"results file {path}: {lines[:3]}")
    r = dict(evaluate=avg, evaluate_codec=codec_avg, refined=refined,
             evaluate_s_per_image=eval_s / EVAL_IMAGES,
             evaluate_codec_s_per_image=codec_s / EVAL_IMAGES, refined_codec_s=refine_s,
             decoded_max_abs_diff=xhat_err, psnr_diff=psnr_diff, results_file=lines)
    print(f"  evaluate: {EVAL_IMAGES} images {HEIGHT}x{WIDTH}, {r['evaluate_s_per_image']:.3f} "
          f"s an image; BPP {avg['BPP']:.5f} (y {avg['BPP(y)']:.5f} + z {avg['BPP(z)']:.5f}), "
          f"PSNR {avg['PSNR(RGB)']:.4f}, MS-SSIM {avg['MS-SSIM(RGB)']:.5f} [{card}]", flush=True)
    print(f"  evaluate_codec n_streams={EVAL_STREAMS}: {r['evaluate_codec_s_per_image']:.3f} s an "
          f"image; BPP(bitstream) {codec_avg['BPP(bitstream)']:.5f}, analytic "
          f"{codec_avg['BPP(analytic)']:.5f} (overhead {codec_avg['bitstream_overhead']:.5f}); "
          f"decoded within {xhat_err:.2e} of x_hat, PSNR within {psnr_diff:.2e} dB; refined "
          f"({EVAL_REFINE_STEPS} steps) {refined['BPP(bitstream)']:.5f} bpp, PSNR "
          f"{refined['PSNR(RGB)']:.4f} in {refine_s:.2f} s; results file {len(lines)} lines",
          flush=True)
    return r


def trainer_phase(dev, card, bare):
    """Returns (launches checked by the phase, results)."""
    total = dict(NO_LAUNCHES)
    patches, val = trainer_data()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        results["run"] = trainer_run_case(dev, total, {}, patches, val, tmp)
        for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
            r = {}
            for interval in (1, 1000):
                ms, losses = trainer_throughput(dev, total, patches, dtype, interval)
                check(all(np.isfinite(losses)) and len(losses) == (
                    TRAIN_WARMUP + TRAIN_TIMED if interval == 1 else 1),
                      f"{name} Trainer at scalar_interval {interval}: losses {losses}")
                r[f"scalar_interval_{interval}"] = dict(ms_per_step=ms, steps_per_s=1e3 / ms)
            r["bare_make_train_step_steps_per_s"] = bare[name]["steps_per_s"]
            results[name] = r
            print(f"  {name} Trainer: {r['scalar_interval_1']['steps_per_s']:.3f} steps/s at "
                  f"scalar_interval 1, {r['scalar_interval_1000']['steps_per_s']:.3f} at 1000; "
                  f"bare make_train_step {r['bare_make_train_step_steps_per_s']:.3f} (phase 5) "
                  f"[{card}]", flush=True)
        ms_ms, ms_losses = trainer_throughput(dev, total, patches, torch.float32, 1,
                                              rd=msssim_rd_loss, lam=MSSSIM_LAMBDA,
                                              timed=MSSSIM_STEPS)
        check(all(np.isfinite(ms_losses)), f"msssim_rd_loss losses {ms_losses}")
        rd_ms = results["float32"]["scalar_interval_1"]["ms_per_step"]
        results["msssim_rd_loss"] = dict(ms_per_step=ms_ms, rd_loss_ms_per_step=rd_ms,
                                         losses=ms_losses)
        print(f"  float32 Trainer with msssim_rd_loss (lambda {MSSSIM_LAMBDA}): {ms_ms:.3f} ms a "
              f"step against rd_loss's {rd_ms:.3f}; losses {ms_losses[0]:.4f} -> "
              f"{ms_losses[-1]:.4f} [{card}]", flush=True)
        results["msssim_card_vs_cpu"] = msssim_parity(dev)
        results["evaluator"] = evaluator_case(dev, total, tmp, card)
    return total, results


# --- phase 8: the other families ------------------------------------------------

def factorized_prior(latent_channels, K, **kw):
    """FactorizedPrior with the hierarchical families' call shape (it has
    no K)."""
    return FactorizedPrior(latent_channels, **kw)


class Family:
    """One family of phase 8: its model (called as cls(M, K, ...)), codec
    and eval FLOPs (called as eval_flops(M, K, H, W)), its portable card's
    (build, load) and coder (encode, decode), and the kernels' launches of
    one forward, one train step and one refine call of n steps."""

    def __init__(self, cls, codec, eval_flops, card_type, coder, mixture=True):
        self.cls, self.codec, self.eval_flops = cls, codec, eval_flops
        self.card_type, self.coder, self.mixture = card_type, coder, mixture
        self.parallel = codec is not FactorizedPriorCodec  # lanes, batches, parameter passes
        self.forward = dict(FORWARD, gmm_logp=GMM_PER_FORWARD * mixture)
        self.step = dict(PER_STEP, gmm_logp=PER_STEP["gmm_logp"] * mixture,
                         gmm_logp_backward=PER_STEP["gmm_logp_backward"] * mixture)

    def refine(self, steps):
        return refine_launches(steps, self.mixture)


PORTABLE_CARD = (PortableCard.build, PortableCard.load)
FAMILIES = {
    "hyperprior": Family(MeanScaleHyperprior, MeanScaleHyperpriorCodec,
                         flops.hyperprior_eval_flops, PORTABLE_CARD,
                         (portable.portable_hp_encode, portable.portable_hp_decode)),
    "checkerboard": Family(CheckerboardHierarchical, CheckerboardCodec, flops.joint_ar_eval_flops,
                           PORTABLE_CARD,
                           (portable.portable_cb_encode, portable.portable_cb_decode)),
    "channel_cb": Family(ChannelCheckerboardHierarchical, ChannelCheckerboardCodec,
                         flops.channel_cb_eval_flops,
                         (build_channel_cb_cards, ChannelCBCards.load),
                         (portable.portable_ccb_encode, portable.portable_ccb_decode)),
    "factorized": Family(factorized_prior, FactorizedPriorCodec,
                         lambda m, k, h, w: flops.factorized_prior_eval_flops(m, h, w),
                         (FactorizedCard.build, FactorizedCard.load), None, mixture=False),
}
FAMILY_STREAMS = (1, 8)
# phase 8's repeats, cut to keep it near 40 s a family (and the whole run
# within 1.3x of its length before phase 9): medians of 2 codec calls after
# one, the device and z stages timed at n_streams 1 only (N lanes change the
# y rANS alone), one timed batch call
FAMILY_CODEC_ITERS, FAMILY_BATCH_ITERS = 2, 1


def family_median_ms(total, expect, fn, *args):
    """Median host-clock ms of FAMILY_CODEC_ITERS calls after one (phases 8
    and 9)."""
    counted(total, expect, fn, *args)
    return 1e3 * statistics.median(counted(total, expect, fn, *args)[1]
                                   for _ in range(FAMILY_CODEC_ITERS))


def decode_y_host(payload, layout, args):
    """The y rANS decode of one stream given its coder rows, block by block
    (the blocks in stream order), as decode runs it between the parameter
    passes."""
    _, mus, sigmas, weights, bounds = args
    decs = codec_module._open_lanes(payload, layout)
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        if b1 > b0:
            codec_module._decode_block_lanes(decs, mus[b0:b1], sigmas[b0:b1],
                                             None if weights is None else weights[b0:b1])
    codec_module._finish(decs)


def family_codec_case(total, codec, x, ref, dname, iname, n_streams, card, shared_stages=None):
    """One model, one image, one stream count: correctness, then latency by
    stage: device (analysis and its fetch; the parameter passes and their
    fetch; synthesis) and host (the z coder; the y rANS). shared_stages:
    the stages timed at n_streams 1, for n_streams > 1."""
    label = f"{dname} {iname} n_streams={n_streams}"
    data, y_q, z_q, xhat_err, xhat_note, ratio = codec_round_trip(total, codec, x, ref, dname,
                                                                  iname, n_streams)
    encode_ms = family_median_ms(total, CODEC_PER_CALL, codec.compress, x, n_streams)
    decode_ms = family_median_ms(total, CODEC_PER_CALL, codec.decompress, data)
    header = codec._header(data)
    payload = data[codec_module._HEADER_SIZE + header[9]:]

    def analysis():
        return codec._fetch_latents(*codec._analyse_device(x)[2:])

    def passes():
        return codec._coder_args(y_q, codec._enqueue(z_q[None]))

    args = passes()

    def y_encode():
        sym, mus, sigmas, weights, bounds = args
        if n_streams == 1:
            return rans_backend.encode_gaussian(sym, mus, sigmas, weights)
        return codec_module._encode_lanes(sym, mus, sigmas, weights, bounds, n_streams)

    stages = {
        "encode_host_y": family_median_ms(total, NO_LAUNCHES, y_encode),
        "decode_host_y": family_median_ms(total, NO_LAUNCHES, decode_y_host, payload, header[6],
                                          args),
    }
    if n_streams == 1:
        stages.update(
            encode_analysis=family_median_ms(total, CODEC_PER_CALL, analysis),
            parameter_passes=family_median_ms(total, NO_LAUNCHES, passes),
            encode_host_z=family_median_ms(total, NO_LAUNCHES, codec._encode_z, z_q),
            decode_host_z=family_median_ms(total, NO_LAUNCHES, codec._decode_z, data, header),
            decode_synthesis=family_median_ms(total, CODEC_PER_CALL, codec._synthesize,
                                              y_q[None], HEIGHT, WIDTH))
    else:  # the stages N lanes do not change: this image's at n_streams 1
        stages.update({k: v for k, v in shared_stages.items() if k not in stages})
    r = dict(encode_ms=encode_ms, decode_ms=decode_ms,
             encode_device_ms=stages["encode_analysis"] + stages["parameter_passes"],
             encode_host_ms=stages["encode_host_z"] + stages["encode_host_y"],
             decode_device_ms=stages["parameter_passes"] + stages["decode_synthesis"],
             decode_host_ms=stages["decode_host_z"] + stages["decode_host_y"],
             stages_ms=stages, stream_bytes=len(data), bpp=8 * len(data) / (HEIGHT * WIDTH),
             analytic_bpp=ref["bits"] / (HEIGHT * WIDTH), stream_over_analytic=ratio,
             x_hat_max_abs_diff=xhat_err)
    print(f"  {label}: encode {encode_ms:.2f} ms (device {r['encode_device_ms']:.2f}: analysis "
          f"{stages['encode_analysis']:.2f} + passes {stages['parameter_passes']:.2f}; host "
          f"{r['encode_host_ms']:.2f}: z {stages['encode_host_z']:.2f} + y "
          f"{stages['encode_host_y']:.2f}), decode {decode_ms:.2f} ms (device "
          f"{r['decode_device_ms']:.2f}: passes + synthesis {stages['decode_synthesis']:.2f}; host "
          f"{r['decode_host_ms']:.2f}: z {stages['decode_host_z']:.2f} + y "
          f"{stages['decode_host_y']:.2f}); {r['bpp']:.5f} bpp, {ratio:.5f} of analytic; latents "
          f"exact, x_hat {xhat_note} [{card}, {os.cpu_count()} host cores]", flush=True)
    return r


def factorized_codec_case(total, codec, x, ref, dname, iname, card):
    """The factorized codec on one image: correctness, then latency by
    stage: device (analysis and its fetch; synthesis) and host (the y
    tables, cached by range, and the indexed rANS). It has no z, no lanes
    and no parameter passes."""
    label = f"{dname} {iname}"
    data, y_q, _, xhat_err, xhat_note, ratio = codec_round_trip(total, codec, x, ref, dname,
                                                                iname)
    header = codec_module._read_header(data, codec.KINDS, codec.NAME)
    tables = codec._tables(header[7], header[8])
    stages = dict(
        encode_analysis=family_median_ms(total, CODEC_PER_CALL, codec._analyse_image, x),
        encode_host_y=family_median_ms(total, NO_LAUNCHES, codec._encode_from, y_q, HEIGHT,
                                       WIDTH),
        decode_host_y=family_median_ms(total, NO_LAUNCHES, codec.decode_latents, data),
        decode_synthesis=family_median_ms(total, CODEC_PER_CALL, codec._synthesize, y_q[None],
                                          HEIGHT, WIDTH))
    r = dict(encode_ms=family_median_ms(total, CODEC_PER_CALL, codec.compress, x),
             decode_ms=family_median_ms(total, CODEC_PER_CALL, codec.decompress, data),
             encode_device_ms=stages["encode_analysis"], encode_host_ms=stages["encode_host_y"],
             decode_device_ms=stages["decode_synthesis"], decode_host_ms=stages["decode_host_y"],
             stages_ms=stages, stream_bytes=len(data), bpp=8 * len(data) / (HEIGHT * WIDTH),
             analytic_bpp=ref["bits"] / (HEIGHT * WIDTH), stream_over_analytic=ratio,
             x_hat_max_abs_diff=xhat_err, y_range=[header[7], header[8]],
             table_rows=int(tables[0].shape[1]))
    print(f"  {label}: encode {r['encode_ms']:.2f} ms (device analysis "
          f"{stages['encode_analysis']:.2f}; host y {stages['encode_host_y']:.2f}), decode "
          f"{r['decode_ms']:.2f} ms (host y {stages['decode_host_y']:.2f}; device synthesis "
          f"{stages['decode_synthesis']:.2f}); y in [{header[7]}, {header[8]}]; {r['bpp']:.5f} "
          f"bpp, {ratio:.5f} of analytic; latents exact, x_hat {xhat_note} [{card}, "
          f"{os.cpu_count()} host cores]", flush=True)
    return r


def family_numerics_check(total, codec_cls, model, x, dname):
    """Compress with cuDNN autotuning and TF32 on, decode with both off: the
    latents are exact, they re-encode to the same bytes, and the parameter
    passes give the same rows; two fresh codecs write the same bytes."""
    parallel = codec_cls is not FactorizedPriorCodec
    lanes = dict(n_streams=FAMILY_STREAMS[-1]) if parallel else {}
    set_fast_numerics(True)
    try:
        fast = codec_cls(model)
        data, _ = counted(total, CODEC_PER_CALL, functools.partial(fast.compress, **lanes), x)
        check(torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.benchmark
              and torch.backends.cuda.matmul.allow_tf32,
              f"{dname}: the codec did not restore the caller's numerics settings")
        (y_fast, z_fast), _ = counted(total, NO_LAUNCHES, fast.decode_latents, data)
        rows_fast = fast._coder_args(y_fast, fast._enqueue(z_fast[None])) if parallel else ()
    finally:
        set_fast_numerics(False)
    plain = codec_cls(model)
    (y_q, z_q), _ = counted(total, NO_LAUNCHES, plain.decode_latents, data)
    check(np.array_equal(y_q, y_fast) and np.array_equal(z_q, z_fast),
          f"{dname}: latents decoded with TF32 off differ from those decoded with it on")
    again, _ = counted(total, NO_LAUNCHES, functools.partial(
        plain.compress_latents, y_q, z_q=z_q, img_h=HEIGHT, img_w=WIDTH, **lanes))
    check(again == data, f"{dname}: the TF32-on stream's latents re-encode to other bytes")
    if parallel:
        rows = plain._coder_args(y_q, plain._enqueue(z_q[None]))
        check(all(a is b or np.array_equal(a, b) for a, b in zip(rows, rows_fast)),
              f"{dname}: the parameter passes depend on TF32")
    d1, _ = counted(total, CODEC_PER_CALL, codec_cls(model).compress, x)
    d2, _ = counted(total, CODEC_PER_CALL, codec_cls(model).compress, x)
    check(d1 == d2, f"{dname}: two fresh codecs wrote different streams")
    note = f" (n_streams={lanes['n_streams']})" if lanes else ""
    rows_note = ", parameter rows bit-equal" if parallel else ""
    print(f"  {dname}: TF32 + autotuned compress{note} decodes exactly with both off (re-encodes "
          f"to the same {len(data)} bytes{rows_note}); two fresh codecs: equal bytes", flush=True)


def family_codec_inputs(dev, cls):
    """The codec's models (f32 and bf16, gained) and images, with the eval
    forward's references, computed before the main path's counts start."""
    images = codec_images()
    models = {"float32": gained_model(dev, cls=cls),
              "bfloat16": gained_model(dev, torch.bfloat16, cls=cls)}
    refs = codec_references(dev, models, images)
    if cls is factorized_prior:  # no z: the codec decodes an empty grid
        for ref in refs.values():
            ref["z_in"] = np.zeros((0, 0, 0), np.float32)
    xs = batch_images()
    return (images, models, refs, xs,
            {dname: batch_references(model, xs, dev) for dname, model in models.items()})


def family_codec(dev, total, card, family, inputs):
    fam = FAMILIES[family]
    images, models, refs, xs, batch_refs = inputs
    results = {}
    for dname, model in models.items():
        codec = fam.codec(model)
        results[dname] = {}
        for iname, x in images.items():
            if not fam.parallel:
                results[dname][iname] = factorized_codec_case(
                    total, codec, x, refs[dname, iname], dname, iname, card)
                continue
            one = None
            for n in FAMILY_STREAMS:
                r = family_codec_case(total, codec, x, refs[dname, iname], dname, iname, n, card,
                                      one and one["stages_ms"])
                one = one or r
                results[dname][f"{iname} n_streams={n}"] = r
        x, ref = images["float32"], refs[dname, "float32"]
        family_numerics_check(total, fam.codec, model, x, dname)
        if fam.parallel:
            results[dname]["batch"] = codec_batch_case(total, codec, xs, batch_refs[dname], dname,
                                                       FAMILY_BATCH_ITERS)
        results[dname]["refine"] = refine_case(total, model, codec, x, dev, dname,
                                               fam.refine(REFINE_STEPS), fam.refine(0))
        float_bytes = results[dname]["float32" + (" n_streams=1" if fam.parallel else "")][
            "stream_bytes"]
        results[dname]["portable"] = (
            portable_case(total, model, x, ref, float_bytes, dname, fam.codec, fam.coder,
                          fam.card_type) if fam.parallel
            else factorized_portable_case(total, model, x, ref, float_bytes, dname))
    return results


def factorized_portable_case(total, model, x, ref, float_bytes, dname):
    """A FactorizedCard built here, saved and loaded (same hash);
    compress_portable's latents exact, its rate against the float stream's,
    encode and decode latency."""
    t0 = time.perf_counter()
    card, _ = counted(total, NO_LAUNCHES, FactorizedCard.build, model)
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "card.npz")
        card.save(path)
        loaded = FactorizedCard.load(path)
    check(loaded.hash == card.hash, f"{dname}: the loaded card's hash differs")
    codec = FactorizedPriorCodec(model, portable_card=loaded)
    encode_only = dict(NO_LAUNCHES, gdn=3)
    data, _ = counted(total, encode_only, codec.compress_portable, x)
    check_latents(f"{dname} portable", counted(total, NO_LAUNCHES, codec.decode_latents, data)[0],
                  ref)
    r = dict(card_hash=card.hash.hex(), card_build_s=build_s, stream_bytes=len(data),
             bpp=8 * len(data) / (HEIGHT * WIDTH), over_float=len(data) / float_bytes,
             encode_ms=family_median_ms(total, encode_only, codec.compress_portable, x),
             decode_ms=family_median_ms(total, CODEC_PER_CALL, codec.decompress, data))
    print(f"  {dname} portable: card {r['card_hash']} built in {build_s:.2f} s, saved and loaded "
          f"(same hash); {r['bpp']:.5f} bpp, {r['over_float']:.5f}x the float stream; encode "
          f"{r['encode_ms']:.2f} ms, decode {r['decode_ms']:.2f} ms; latents exact", flush=True)
    return r


def family_phase(dev, card, family):
    """One family at M=128 (K=3 where it has a mixture): card against CPU
    and the codec's references, then the main path (serve, train, codec,
    refine) with its launches counted from 0. Returns (the main path's
    launches, results)."""
    fam = FAMILIES[family]
    t0 = time.perf_counter()
    print(f"  -- {family}: card against CPU, eval forward 2x256x256", flush=True)
    parity(dev, fam.cls)
    inputs = family_codec_inputs(dev, fam.cls)
    reset_launch_counts()
    print(f"  -- {family}: serve {HEIGHT}x{WIDTH}", flush=True)
    forwards, serve = serve_phase(dev, card, fam.cls, fam.forward["gmm_logp"],
                                  z_rate=fam.cls is not factorized_prior)
    print(f"  -- {family}: train, batch {TRAIN_BATCH} of {TRAIN_SIZE}x{TRAIN_SIZE}", flush=True)
    steps, train = train_phase(dev, card, fam.cls, fam.eval_flops, fam.step)
    total = added(scaled(fam.forward, forwards), scaled(fam.step, steps))
    check(launch_counts() == total, f"{family}: serve and train launched {launch_counts()}, "
                                    f"not {total} ({forwards} forwards, {steps} steps)")
    print(f"  -- {family}: codec and refine, one {HEIGHT}x{WIDTH} image", flush=True)
    codec = family_codec(dev, total, card, family, inputs)
    launches = launch_counts()
    check(launches == total, f"{family}: launches {launches}, its calls counted {total}")
    seconds = time.perf_counter() - t0
    print(f"main path ({family}): {forwards} forwards, {steps} steps, the codec's and refine's "
          f"calls: launches {launches} (a forward {fam.forward}, a step {fam.step}); phase 8 "
          f"for {family} took {seconds:.1f} s")
    return launches, dict(serve=serve, train=train, codec=codec, seconds=seconds,
                          launches_per_forward=fam.forward, launches_per_step=fam.step)


# --- phase 9: the residual family ------------------------------------------------

RES_M, RES_K = 192, 1  # HierarchicalMixtureResidual's defaults, the reference's
RES_WIDTHS = (RES_M, RES_K)
# gains on the residual transforms' bottleneck convs (encoder.Conv2d_0,
# hyper_encoder.Conv2d_4) and a seed whose latents keep a rounding margin
# (checked at run time): at M=192 on 2x256x256, y's std 0.58 (6 values,
# margin 3.6e-5 on a CPU) and z's 0.63 (5 values, margin 2.4e-5)
RES_GAINS, RES_PARITY_SEED = (5.0, 40.0), 15
# the four other families with transform="res3x3", card against CPU at a
# small width (K=3 where they have a mixture); margins 1.2e-3 and 6.1e-3
RES_SMALL_M, RES_SMALL_SEED, RES_SMALL_SHAPE = 32, 13, (1, 128, 128, 3)
RES_FORWARD = dict(FORWARD, gmm_logp=0)  # K=1: the Gaussian rate, no mixture kernel
RES_STEP = dict(PER_STEP, gmm_logp=0, gmm_logp_backward=0)
RES_STREAMS = (1, 8)
# the f32 batch-1 forward takes about a second (cuDNN's heuristic picks FFT
# algorithms for some of its 3x3 convolutions): 3 timed calls, and one
# refine call
RES_LATENCY_ITERS = 3


def residual_eval_flops(m, k, h, w):
    return flops.joint_ar_eval_flops(m, k, h, w, "res3x3")


def res3x3(cls):
    """A family's constructor, called as cls(M, K, ...), with the residual
    transforms."""
    if cls is FactorizedPrior:
        return lambda m, k, **kw: FactorizedPrior(m, "res3x3", **kw)
    return lambda m, k, **kw: cls(m, k, transform="res3x3", **kw)


RES_FAMILIES = {"hyperprior": MeanScaleHyperprior, "checkerboard": CheckerboardHierarchical,
                "channel_cb": ChannelCheckerboardHierarchical, "factorized": FactorizedPrior}


def residual_kernel_cases(dev):
    """The GDN kernels at C=192, the residual transforms' width: the
    forward at the serve's, the train step's and the codec's rows, the
    backward at the train step's (with the dgamma/dbeta stage, and at H/2
    dx alone) and, dx alone, at refinement's (the codec's rows, IGDN)."""
    rng = np.random.default_rng(30)
    gamma_t, beta_t = gdn_params(RES_M, rng, dev)
    tag = f" C={RES_M}"
    records = []
    for path, sites in (("serve", GDN_SITES), ("train", TRAIN_GDN_SITES),
                        ("codec", CODEC_GDN_SITES)):
        records += gdn_site_records(path, sites, rng, gamma_t, beta_t, dev, tag)
    records += gdn_backward_site_records("train", TRAIN_GDN_SITES, rng, gamma_t, beta_t, dev,
                                         tag=tag)
    records += gdn_backward_site_records("train", {"H/2": TRAIN_GDN_SITES["H/2"]}, rng, gamma_t,
                                         beta_t, dev, param_grads=False, tag=tag)
    records += gdn_backward_site_records("refine", CODEC_GDN_SITES, rng, gamma_t, beta_t, dev,
                                         inverses=(True,), param_grads=False, tag=tag)
    for r in records:
        r["families"] = ["residual"]
    return records


def residual_parity(dev):
    """The residual model against the CPU at M=192 on 2x256x256, then each
    other family with transform="res3x3" at M=32 on 1x128x128."""
    parity(dev, HierarchicalMixtureResidual, RES_WIDTHS, RES_PARITY_SEED, RES_GAINS)
    for family, cls in RES_FAMILIES.items():
        print(f"  -- {family}, transform res3x3, M={RES_SMALL_M}: card against CPU, eval "
              f"forward {'x'.join(map(str, RES_SMALL_SHAPE[:3]))}", flush=True)
        parity(dev, res3x3(cls), (RES_SMALL_M, K), RES_SMALL_SEED, RES_GAINS, RES_SMALL_SHAPE)


def residual_codec_case(total, codec, x, ref, dname, n_streams, card):
    """JointARCodec on the residual model, one image, one stream count:
    correctness (codec_round_trip), then latency; at n_streams 1 also its
    stages: device (analysis and psi; synthesis) and host (z and the
    wavefront)."""
    data, y_q, z_q, xhat_err, xhat_note, ratio = codec_round_trip(
        total, codec, x, ref, dname, "float32", n_streams)
    r = dict(encode_ms=family_median_ms(total, CODEC_PER_CALL, codec.compress, x, None,
                                        n_streams),
             decode_ms=family_median_ms(total, CODEC_PER_CALL, codec.decompress, data),
             stream_bytes=len(data), bpp=8 * len(data) / (HEIGHT * WIDTH),
             analytic_bpp=ref["bits"] / (HEIGHT * WIDTH), stream_over_analytic=ratio,
             x_hat_max_abs_diff=xhat_err)
    note = ""
    if n_streams == 1:
        img_h, img_w, y_s, z_s, psi = counted(total, CODEC_PER_CALL, codec._analyse_image, x)[0]
        header = codec._header(data)
        y_payload = data[codec_module._HEADER_SIZE + header[9]:]
        h, w = HEIGHT // 16, WIDTH // 16
        r["stages_ms"] = stages = dict(
            encode_analysis_psi=family_median_ms(total, CODEC_PER_CALL, codec._analyse_image, x),
            encode_host_z_and_wavefront=family_median_ms(total, NO_LAUNCHES, codec._encode_from,
                                                         y_s, z_s, psi, img_h, img_w),
            decode_host_z=family_median_ms(total, NO_LAUNCHES, codec._decode_z, data, header),
            decode_psi=family_median_ms(total, NO_LAUNCHES, codec._psi, z_q[None]),
            decode_host_wavefront=family_median_ms(total, NO_LAUNCHES,
                                                   codec_module._ar_decode_latents,
                                                   codec._host_nets, y_payload, psi, h, w),
            decode_synthesis=family_median_ms(total, CODEC_PER_CALL, codec._synthesize,
                                              y_q[None], HEIGHT, WIDTH))
        note = (f" (device {stages['encode_analysis_psi']:.2f}, host "
                f"{stages['encode_host_z_and_wavefront']:.2f}); decode device "
                f"{stages['decode_psi'] + stages['decode_synthesis']:.2f}, host "
                f"{stages['decode_host_z'] + stages['decode_host_wavefront']:.2f}")
    print(f"  {dname} n_streams={n_streams}: encode {r['encode_ms']:.2f} ms, decode "
          f"{r['decode_ms']:.2f} ms{note}; {len(data)} bytes, {r['bpp']:.5f} bpp, {ratio:.5f} of "
          f"analytic; latents exact, x_hat {xhat_note} [{card}, {os.cpu_count()} host cores]",
          flush=True)
    return r


def residual_phase(dev, card):
    """HierarchicalMixtureResidual at M=192, K=1: card against CPU (and
    the other families with transform="res3x3"), then the main path with
    its launches counted from 0: serve, train, the codec (f32 and bf16, one
    float32 image, n_streams 1 and 8), a portable round trip and a 20-step
    refine call (f32), timed once. Returns (the main path's launches,
    results)."""
    t0 = time.perf_counter()
    residual_parity(dev)
    x = codec_images()["float32"]
    models = {"float32": gained_model(dev, None, HierarchicalMixtureResidual, RES_WIDTHS,
                                      RES_PARITY_SEED, RES_GAINS),
              "bfloat16": gained_model(dev, torch.bfloat16, HierarchicalMixtureResidual,
                                       RES_WIDTHS, RES_PARITY_SEED, RES_GAINS)}
    refs = codec_references(dev, models, {"float32": x})
    reset_launch_counts()
    print(f"  -- serve {HEIGHT}x{WIDTH}", flush=True)
    forwards, serve = serve_phase(dev, card, HierarchicalMixtureResidual, 0, widths=RES_WIDTHS,
                                  latency_iters=RES_LATENCY_ITERS)
    print(f"  -- train, batch {TRAIN_BATCH} of {TRAIN_SIZE}x{TRAIN_SIZE}", flush=True)
    steps, train = train_phase(dev, card, HierarchicalMixtureResidual, residual_eval_flops,
                               RES_STEP, RES_WIDTHS)
    total = added(scaled(RES_FORWARD, forwards), scaled(RES_STEP, steps))
    check(launch_counts() == total, f"residual: serve and train launched {launch_counts()}, "
                                    f"not {total} ({forwards} forwards, {steps} steps)")
    print(f"  -- codec, one {HEIGHT}x{WIDTH} image", flush=True)
    codec = {}
    for dname, model in models.items():
        cod = JointARCodec(model)
        codec[dname] = {f"n_streams={n}": residual_codec_case(total, cod, x, refs[dname, "float32"],
                                                              dname, n, card)
                        for n in RES_STREAMS}
    model, ref = models["float32"], refs["float32", "float32"]
    codec["float32"]["portable"] = portable_case(
        total, model, x, ref, codec["float32"]["n_streams=1"]["stream_bytes"], "float32",
        median=family_median_ms)
    codec["float32"]["refine"] = refine_case(total, model, JointARCodec(model), x, dev, "float32",
                                             refine_launches(REFINE_STEPS, False),
                                             refine_launches(0, False), iters=0)
    launches = launch_counts()
    check(launches == total, f"residual: launches {launches}, its calls counted {total}")
    seconds = time.perf_counter() - t0
    print(f"main path (residual): {forwards} forwards, {steps} steps, the codec's and refine's "
          f"calls: launches {launches} (a forward {RES_FORWARD}, a step {RES_STEP}); phase 9 "
          f"took {seconds:.1f} s")
    return launches, dict(serve=serve, train=train, codec=codec, seconds=seconds, M=RES_M,
                          K=RES_K, transform="res3x3", launches_per_forward=RES_FORWARD,
                          launches_per_step=RES_STEP)


# --- phase 10: the variable-rate (gained) families ---------------------------------

GAINED_SEED, GAIN_TABLE_SEED = PARITY_SEED, 40
# gain_y grows 4x a level (as the JAX package's tests draw it), so higher
# levels code more bits at random init; z grows with it through the
# hyper-analysis, so gain_z does not (4x more a level would put z near 2e5
# at level 4, beyond the codec header's int16 z range); igain_y and
# igain_z shrink 4x a level, so the decoders see inputs of one scale at
# every level, as a trained ladder's inverse gains make them
GAIN_GROWTH = 4.0
GAIN_EXPONENTS = {"gain_y": 1, "igain_y": -1, "gain_z": 0, "igain_z": -1}
GAINED_PARITY_LEVELS, GAINED_FOLD_LEVELS = (0, 1.5, 4), (0, 1.3, 4)
GAINED_SERVE_LEVEL, GAINED_CODEC_LEVELS = 2, (1, 3)
GAINED_CURVE_LEVELS, GAINED_CURVE_IMAGES = (0, 1, 2, 3, 4, 2.5), 4
GAINED_TIMED = 30  # steps; with 5 levels each is drawn in 30 with probability 0.994
GAINED_RATE_TOL = 0.01
GAINED_TRAINER_STEPS, GAINED_TRAINER_VAL_INTERVAL = 4, 3
SIBLING_LEVEL, SIBLING_CODEC_LEVEL, SIBLING_STEPS = 1.5, 1, 5
GAINED_SIBLINGS = {"hyperprior": (GainedHyperprior, MeanScaleHyperpriorCodec),
                   "checkerboard": (GainedCheckerboard, CheckerboardCodec),
                   "channel_cb": (GainedChannelCheckerboard, ChannelCheckerboardCodec)}
# Where p_y lies within a few float32 steps of 0 (a latent far in the upper
# tail of its Gaussians), it is a sum of differences of two CDF values that
# round to neighbouring floats near 1, and the card's erf and the CPU's
# round them differently: p_y is held to four float32 steps of 1, logp_y
# where p_y > 1e-3 (the tails' count printed).
GAINED_P_Y_ATOL, GAINED_LOGP_BODY = 4.8e-7, 1e-3
# At high levels y and the mixture's means are hundreds while its scales
# are not, so the entropy parameters' 1e-6 relative differences between two
# forwards (card and CPU, folded and gained) move p_y by more than
# rounding: each side's rate is held against the plain mixture on its own
# parameters, and the two sides' total bits against each other to 1e-3
# (measured: printed).
GAINED_BITS_RTOL = 1e-3


def variable_rate_model(device, dtype=None, cls=GainedJointAR, seed=GAINED_SEED):
    """``cls`` at M and K from ``seed``, with random gain tables: 0.3 + 2U
    from GAIN_TABLE_SEED (all-ones gains would make every level the same
    model and the fold trivially exact), times GAIN_GROWTH to the power
    GAIN_EXPONENTS[table] a level; and the conv gains of gained_model
    (another meaning of "gained": scales on the last analysis and
    hyper-analysis convs) so that y spreads over several integers at level
    0 too."""
    model = gained_model(device, dtype, cls, seed=seed)
    rng = np.random.default_rng(GAIN_TABLE_SEED)
    with torch.no_grad():
        for name, exponent in GAIN_EXPONENTS.items():
            table = getattr(model, name)
            r = 0.3 + 2.0 * rng.uniform(size=tuple(table.shape)).astype(np.float32)
            r *= GAIN_GROWTH ** (exponent * np.arange(table.shape[0], dtype=np.float32))[:, None]
            table.copy_(torch.from_numpy(r))
    return model


def folded_at(model, level):
    """The fixed-rate model of ``model``'s family with its gains folded at
    ``level``."""
    fm = folded_model(model)
    fm.load_state_dict(fold_gains(model.state_dict(), level))
    return fm


class AtLevel(torch.nn.Module):
    """A gained model's forward at one level, for make_serving_fn."""

    def __init__(self, model, level):
        super().__init__()
        self.model, self.level = model, level

    def forward(self, x, training=False):
        return self.model(x, training=training, level=self.level)


@contextlib.contextmanager
def given_latents(latents):
    """The model's quantize returns these tensors, in order (z_in, then
    y_in), on whatever device it runs: a second forward on the rounded
    latents of a first."""
    it = iter(latents)
    rounded = joint_ar.quantize
    joint_ar.quantize = lambda v, training, generator=None: next(it).to(v.device)
    try:
        yield
    finally:
        joint_ar.quantize = rounded


def tie_flips(label, pre, rounded, window):
    """Rounded latents against round(pre): one step apart at most, and only
    where pre lies within ``window`` (the two forwards' largest difference
    before rounding) of a .5 tie. Returns the count of such flips."""
    want = torch.round(pre.float())
    mism = rounded != want
    flips = int(mism.sum())
    if flips:
        check((rounded[mism] - want[mism]).abs().max().item() <= 1.0,
              f"{label}: a rounded latent more than one step off")
        f = pre.double()[mism]
        dist = (f - f.floor() - 0.5).abs().max().item()
        check(dist <= window, f"{label}: {flips} rounded latents differ, one {dist:.3e} from a "
                              f"tie (the forwards differ by {window:.3e})")
    return flips


def same_rounding(label, got, ref, keys=("z", "y")):
    """The rounding of ``got``'s latents against ``ref``'s pre-round
    values: phase 3's margin rule where the margin exceeds the difference,
    else flips at ties only. Returns a printable note."""
    notes = []
    for key in keys:
        diff = (got[key].float() - ref[key].float()).abs().max().item()
        margin = rounding_margin(ref[key])
        flips = tie_flips(f"{label} {key}", ref[key], got[key + "_in"], diff)
        rule = "margin above the difference" if margin > diff else f"{flips} tie flips"
        notes.append(f"{key}: margin {margin:.3e}, max diff {diff:.3e}, {rule}")
    return "; ".join(notes)


def rates_close(label, got, ref):
    """Given the same rounded latents: the entropy parameters; got's p_y
    against the plain mixture on got's parameters (p_y to GAINED_P_Y_ATOL,
    logp_y where p_y > GAINED_LOGP_BODY); logp_z; and the total bits
    against ref's (GAINED_BITS_RTOL). Returns (tail latents, bits' relative
    difference)."""
    for key, tol in (("weights", 1e-5), ("mus", 1e-4), ("sigmas", 1e-4)):
        err = (got[key] - ref[key]).abs().max().item()
        check(torch.allclose(got[key], ref[key], rtol=tol, atol=tol),
              f"{label}: {key} max diff {err:.3e}")
    plain = mixture_likelihood(got["y_in"], got["weights"], got["mus"], got["sigmas"])
    check(torch.allclose(got["p_y"], plain, rtol=1e-4, atol=GAINED_P_Y_ATOL),
          f"{label}: p_y against the plain mixture, max diff "
          f"{(got['p_y'] - plain).abs().max().item():.3e}")
    body = plain > GAINED_LOGP_BODY
    check(torch.allclose(got["logp_y"][body], torch.log(plain)[body], rtol=1e-4, atol=1e-4),
          f"{label}: logp_y against the plain mixture")
    check(torch.allclose(got["logp_z"], ref["logp_z"], rtol=1e-4, atol=1e-4),
          f"{label}: logp_z differs")
    bits = [-(o["logp_y"].double().sum() + o["logp_z"].double().sum()).item() for o in (got, ref)]
    rel = abs(bits[0] - bits[1]) / abs(bits[1])
    check(rel <= GAINED_BITS_RTOL, f"{label}: bits {bits[0]} vs {bits[1]}")
    return int((~body).sum()), rel


def gained_parity(dev, cls, levels, shape=(2, 256, 256, 3)):
    """The card's gained eval forward against the CPU's at each level: the
    rounding (same_rounding), then, on the card's rounded latents, x_hat,
    the entropy parameters and the rates (rates_close)."""
    cpu_model = variable_rate_model("cpu", cls=cls)
    card_model = cls(M, K, device=dev, seed=GAINED_SEED)
    card_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(np.random.default_rng(GAINED_SEED).uniform(size=shape)
                         .astype(np.float32))
    for level in levels:
        got = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
               for k, v in card_model(x.to(dev), training=False, level=level).items()}
        with given_latents([got["z_in"], got["y_in"]]):
            ref = cpu_model(x, training=False, level=level)
        note = same_rounding(f"level {level}", got, ref)
        check(int((got["y_in"] != 0).sum()) > 0, f"level {level}: y_in is all zeros")
        err = (got["x_hat"] - ref["x_hat"]).abs().max().item()
        check(torch.allclose(got["x_hat"], ref["x_hat"], rtol=1e-4, atol=1e-4),
              f"level {level}: x_hat max diff {err:.3e}")
        tails, rel = rates_close(f"level {level}", got, ref)
        print(f"  {cls.__name__} level {level}: {note}; on the card's latents x_hat within "
              f"{err:.2e}, entropy parameters agree, the card's rate is the plain mixture's on "
              f"its parameters ({tails} tail latents), bits {rel:.2e} apart; bpp "
              f"{rd_loss(got, x, LAMBDA)['bpp_total'].item():.5f}", flush=True)


def fold_check(dev, model, levels, x):
    """On the card: the model folded at each level against its gained
    forward; the rounding, then x_hat and the rates on the gained forward's
    rounded latents. Returns the flips a level."""
    flips = {}
    for level in levels:
        want = model(x, training=False, level=level)
        fm = folded_at(model, level)
        got = fm(x, training=False)
        note = same_rounding(f"fold at {level}", got, want)
        flips[level] = int((got["y_in"] != want["y_in"]).sum() + (got["z_in"] != want["z_in"]).sum())
        with given_latents([want["z_in"], want["y_in"]]):
            same = fm(x, training=False)
        err = (same["x_hat"] - want["x_hat"]).abs().max().item()
        check(err <= 1e-4, f"fold at {level}: x_hat differs by {err:.3e}")
        tails, rel = rates_close(f"fold at {level}", same, want)
        print(f"  fold at level {level}: {note}; on the gained latents x_hat within {err:.2e}, "
              f"entropy parameters agree, bits {rel:.2e} apart ({tails} tail latents)",
              flush=True)
    return flips


def gained_step_runs(dev, dtype, x, seed, steps, timed):
    """``steps`` level-sampled steps of a fresh gained model (after
    TRAIN_WARMUP when ``timed``), each launching PER_STEP; returns the
    losses, the levels drawn (replayed from the generator's state before
    each step, after the run), the host times and the peak memory above
    what was allocated before the model was built (phase 10 keeps its
    other models on the card)."""
    resident = torch.cuda.memory_allocated(dev)
    model = variable_rate_model(dev, dtype, seed=seed)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(model, opt, rd_loss, LAMBDA, levels=model.levels)
    gen = torch.Generator(device=dev).manual_seed(200 + seed)
    if timed:
        for _ in range(TRAIN_WARMUP):
            step(x, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    losses, times, states = [], [], []
    for _ in range(steps):
        states.append(gen.get_state())
        before = launch_counts()
        t0 = time.perf_counter()
        losses.append(step(x, gen)["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        check(launched == PER_STEP, f"one gained step launched {launched}, not {PER_STEP}")
    peak = (torch.cuda.max_memory_allocated(dev) - resident) / 2 ** 30
    drawn = []
    for state in states:
        replay = torch.Generator(device=dev)
        replay.set_state(state)
        drawn.append(int(torch.randint(0, len(model.levels), (1,), device=dev,
                                       generator=replay)[0]))
    return torch.stack(losses).cpu(), drawn, times, peak


def gained_train(dev, card, flagship):
    """make_train_step(levels=...) at batch 16 of 256^2, bf16 and f32:
    steps/s, MFU and peak memory over GAINED_TIMED steps (every level drawn
    there), and the loss falling over TRAIN_CONVERGE steps on one batch at
    each level drawn both early and late."""
    x = torch.rand((TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
                   generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    flops_img = flops.train_step_flops(flops.joint_ar_eval_flops(M, K, TRAIN_SIZE,
                                                                 TRAIN_SIZE)["total"])
    steps, results = 0, {}
    for dtype, peak_name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        name = str(dtype).replace("torch.", "")
        losses, drawn, times, peak_mem = gained_step_runs(dev, dtype, x, 0, GAINED_TIMED, True)
        check(bool(torch.isfinite(losses).all()), f"{name}: a loss is not finite")
        counts = [drawn.count(n) for n in range(5)]
        check(min(counts) > 0, f"{name}: levels drawn {counts} times over {GAINED_TIMED} steps")
        conv, conv_drawn, _, _ = gained_step_runs(dev, dtype, x, 1, TRAIN_CONVERGE, False)
        check(bool(torch.isfinite(conv).all()), f"{name}: a loss is not finite")
        falls = {}
        for n in range(5):
            early = [conv[i].item() for i in range(10) if conv_drawn[i] == n]
            late = [conv[i].item() for i in range(20, 30) if conv_drawn[i] == n]
            if early and late:
                falls[n] = (statistics.mean(early), statistics.mean(late))
        # the levels' losses differ by their lambdas: the geometric mean of
        # each level's late-to-early ratio
        ratio = statistics.geometric_mean(b / a for a, b in falls.values()) if falls else 1.0
        check(len(falls) >= 2 and ratio < 1.0,
              f"{name}: mean loss by level, steps 1-10 against 21-30: {falls}")
        steps += TRAIN_WARMUP + GAINED_TIMED + TRAIN_CONVERGE
        ms = 1e3 * statistics.median(times)
        peak = flops.H100_PEAK_TFLOPS[peak_name]
        results[name] = dict(
            steps_per_s=1e3 / ms, ms_per_step=ms, peak_mem_gib=peak_mem,
            mfu=flops.mfu(1e3 / ms * TRAIN_BATCH, flops_img, peak),
            mfu_peak=f"{peak_name} {peak:g} TFLOP/s", levels_drawn_timed=counts,
            flagship_steps_per_s=flagship[name]["steps_per_s"],
            loss_falls_by_level={str(n): list(v) for n, v in falls.items()},
            loss_ratio_late_to_early=ratio)
        r = results[name]
        print(f"  {name}: {r['steps_per_s']:.3f} steps/s ({ms:.3f} ms a step; the flagship "
              f"{r['flagship_steps_per_s']:.3f} in phase 5), peak memory {peak_mem:.2f} GiB, MFU "
              f"{100 * r['mfu']:.2f}% of the {r['mfu_peak']} peak; levels drawn {counts} over "
              f"{GAINED_TIMED} timed steps; one batch, 30 steps, mean loss by level (1-10 -> "
              f"21-30): " + ", ".join(f"{n}: {a:.2f} -> {b:.2f}" for n, (a, b) in falls.items())
              + f" (geometric mean ratio {ratio:.4f}) [{card}]", flush=True)
    return steps, results


def gained_codec(total, models, refs, x, card):
    """JointARCodec on each folded model (f32 and bf16, GAINED_CODEC_LEVELS):
    codec_round_trip's checks, latency, and a longer stream at the higher
    level."""
    results = {}
    for (dname, level), fm in models.items():
        codec = JointARCodec(fm)
        data, _, _, _, xhat_note, ratio = codec_round_trip(total, codec, x, refs[dname, level],
                                                           dname, f"level {level}")
        r = dict(level=level, stream_bytes=len(data), bpp=8 * len(data) / (HEIGHT * WIDTH),
                 analytic_bpp=refs[dname, level]["bits"] / (HEIGHT * WIDTH),
                 stream_over_analytic=ratio,
                 encode_ms=family_median_ms(total, CODEC_PER_CALL, codec.compress, x),
                 decode_ms=family_median_ms(total, CODEC_PER_CALL, codec.decompress, data))
        results[f"{dname} level {level}"] = r
        print(f"  {dname} folded at level {level}: encode {r['encode_ms']:.2f} ms, decode "
              f"{r['decode_ms']:.2f} ms; {len(data)} bytes, {r['bpp']:.5f} bpp, {ratio:.5f} of "
              f"analytic; latents exact, x_hat {xhat_note} [{card}]", flush=True)
    for dname in ("float32", "bfloat16"):
        lo, hi = (results[f"{dname} level {lv}"]["stream_bytes"] for lv in GAINED_CODEC_LEVELS)
        check(hi > lo, f"{dname}: the stream at level {GAINED_CODEC_LEVELS[1]} ({hi} bytes) is "
                       f"not longer than at level {GAINED_CODEC_LEVELS[0]} ({lo})")
    return results


def gained_rate_control(total, model, x):
    """level_for_bpp on one image, at a target between the ladder's ends:
    its bpp within GAINED_RATE_TOL of the target; its probes counted."""
    xd = torch.from_numpy(x).to(model.gain_y.device)

    def bpp_at(level):
        out = model(xd, training=False, level=level)
        return rd_loss(out, xd, LAMBDA)["bpp_total"].item()

    (lo, hi), _ = counted(total, scaled(FORWARD, 2), lambda: (bpp_at(0), bpp_at(4)))
    target = (lo * hi) ** 0.5
    before = launch_counts()
    t0 = time.perf_counter()
    level, bpp = level_for_bpp(model, x, target, tol=GAINED_RATE_TOL)
    seconds = time.perf_counter() - t0
    after = launch_counts()
    got = {k: after[k] - before[k] for k in after}
    probes = got["gdn"] // GDN_PER_FORWARD
    check(got == scaled(FORWARD, probes), f"level_for_bpp launched {got}")
    for k, v in got.items():
        total[k] += v
    check(0 < level < 4 and abs(bpp - target) <= GAINED_RATE_TOL * target,
          f"level_for_bpp: level {level}, bpp {bpp} against {target}")
    print(f"  level_for_bpp: target {target:.5f} bpp (between {lo:.5f} at level 0 and {hi:.5f} "
          f"at 4) -> level {level:.6f}, {bpp:.5f} bpp in {probes} probes, {1e3 * seconds:.1f} ms",
          flush=True)
    return dict(target_bpp=target, bpp_level_0=lo, bpp_level_4=hi, level=level, bpp=bpp,
                probes=probes, ms=1e3 * seconds)


def gained_curve(total, model, card):
    """gained_rd_curve over GAINED_CURVE_IMAGES random 768x512 images at
    GAINED_CURVE_LEVELS: bpp rises with the level."""
    rng = np.random.default_rng(GAINED_SEED + 5)
    imgs = [rng.uniform(size=(1, HEIGHT, WIDTH, 3)).astype(np.float32)
            for _ in range(GAINED_CURVE_IMAGES)]
    expect = scaled(FORWARD, len(GAINED_CURVE_LEVELS) * GAINED_CURVE_IMAGES)
    points, seconds = counted(total, expect, gained_rd_curve, model, imgs, GAINED_CURVE_LEVELS)
    check([p["level"] for p in points] == sorted(float(v) for v in GAINED_CURVE_LEVELS),
          f"bpp does not rise with the level: {points}")
    check(all(np.isfinite(p[k]) for p in points for k in ("bpp", "psnr", "msssim")),
          f"curve: {points}")
    print(f"  gained_rd_curve, {GAINED_CURVE_IMAGES} images {HEIGHT}x{WIDTH}, levels "
          f"{GAINED_CURVE_LEVELS}: " + ", ".join(f"{p['level']:g}: {p['bpp']:.4f} bpp "
                                               f"{p['psnr']:.3f} dB" for p in points)
          + f"; {seconds:.2f} s [{card}]", flush=True)
    return dict(points=points, seconds=seconds)


def gained_trainer(dev, total, card):
    """A Trainer on the gained model: each step's launches (PER_STEP), each
    validation forward and the diagnostic forward (FORWARD); validation at
    the middle level and its lambda, its last logged loss recomputed."""
    patches, val = trainer_data()
    model = variable_rate_model(dev, seed=TRAINER_SEED)
    mid = len(model.levels) // 2
    calls = {}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = instrument(Trainer(model, trainer_loader(patches), val_loader=val,
                                     max_steps=GAINED_TRAINER_STEPS,
                                     val_interval=GAINED_TRAINER_VAL_INTERVAL,
                                     log_interval=10 ** 9, img_interval=10 ** 9, log_dir=tmp,
                                     checkpoint_path=None), total, calls)
        check(trainer._val_kwargs == {"level": mid} and trainer._val_lambda == model.levels[mid],
              f"validation at {trainer._val_kwargs}, lambda {trainer._val_lambda}")
        t0 = time.perf_counter()
        trainer.train()
        seconds = time.perf_counter() - t0
        logged = [r["value"] for r in jsonl(os.path.join(tmp, "metrics.jsonl"))
                  if r["tag"] == "validation/validation_loss"]
    val_steps = list(range(0, GAINED_TRAINER_STEPS, GAINED_TRAINER_VAL_INTERVAL))
    check(calls == {"step": GAINED_TRAINER_STEPS, "validation": len(val_steps),
                    "diagnostics": 1} and len(logged) == len(val_steps), f"calls {calls}")

    def recomputed():
        losses = []
        for v in val:
            xv = torch.from_numpy(v).to(dev)
            losses.append(rd_loss(model(xv, training=False, level=mid), xv,
                                  model.levels[mid])["loss"].item())
        return statistics.mean(losses)

    want, _ = counted(total, scaled(FORWARD, len(val)), recomputed)
    check(abs(logged[-1] - want) <= 1e-5 * abs(want),
          f"validation loss {logged[-1]} against {want} at level {mid}")
    print(f"  Trainer: {GAINED_TRAINER_STEPS} steps in {seconds:.2f} s, validation at steps "
          f"{val_steps} at level {mid} (lambda {model.levels[mid]}): {logged}, the last "
          f"recomputed {want:.5f}; launches a step {PER_STEP}, a validation forward and the "
          f"diagnostic forward {FORWARD} [{card}]", flush=True)
    return dict(seconds=seconds, validation_loss=logged, validation_level=mid)


def sibling_main_path(dev, total, family, model, fm, ref, x, card):
    """A sibling's folded model through its own codec (exact latents), then
    SIBLING_STEPS level-sampled steps, each launching PER_STEP."""
    codec_cls = GAINED_SIBLINGS[family][1]
    data, _, _, _, xhat_note, ratio = codec_round_trip(total, codec_cls(fm), x, ref, "float32",
                                                       f"{family} level {SIBLING_CODEC_LEVEL}")
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = make_train_step(model, opt, rd_loss, LAMBDA, levels=model.levels)
    gen = torch.Generator(device=dev).manual_seed(300)
    xt = torch.rand((TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
                    generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    losses = [counted(total, PER_STEP, step, xt, gen)[0]["loss"].item()
              for _ in range(SIBLING_STEPS)]
    check(all(np.isfinite(losses)), f"{family}: losses {losses}")
    print(f"  {family}: folded at level {SIBLING_CODEC_LEVEL}, {codec_cls.__name__}: "
          f"{len(data)} bytes, {ratio:.5f} of analytic, latents exact, x_hat {xhat_note}; "
          f"{SIBLING_STEPS} steps with levels: losses "
          + ", ".join(f"{v:.3f}" for v in losses) + f" [{card}]", flush=True)
    return dict(stream_bytes=len(data), stream_over_analytic=ratio, losses=losses)


def gained_phase(dev, card, flagship_serve, flagship_train):
    """GainedJointAR at M=128, K=3 (the default ladder), random weights and
    gains from seeds: card against CPU at GAINED_PARITY_LEVELS, the fold on
    the card at GAINED_FOLD_LEVELS, and the three siblings' parity; then the
    main path with its launches counted from 0: serve (the gained forward at
    level 2 and its fold), train with levels, the codec on the folds at
    levels 1 and 3, rate control, the RD curve, a Trainer, and each
    sibling's codec and steps. Returns (the main path's launches, results)."""
    t0 = time.perf_counter()
    print(f"  -- card against CPU, eval forward 2x256x256 at levels {GAINED_PARITY_LEVELS}",
          flush=True)
    gained_parity(dev, GainedJointAR, GAINED_PARITY_LEVELS)
    model = variable_rate_model(dev)
    x_fold = torch.from_numpy(np.random.default_rng(GAINED_SEED + 1).uniform(
        size=(2, 256, 256, 3)).astype(np.float32)).to(dev)
    print(f"  -- the fold on the card at levels {GAINED_FOLD_LEVELS}", flush=True)
    fold_flips = fold_check(dev, model, GAINED_FOLD_LEVELS, x_fold)
    for family, (cls, _) in GAINED_SIBLINGS.items():
        print(f"  -- {cls.__name__}: card against CPU at level {SIBLING_LEVEL}", flush=True)
        gained_parity(dev, cls, (SIBLING_LEVEL,))
    x = codec_images()["float32"]
    models = {(dname, level): folded_at(variable_rate_model(dev, dtype), level)
              for dname, dtype in (("float32", None), ("bfloat16", torch.bfloat16))
              for level in GAINED_CODEC_LEVELS}
    refs = {key: codec_references(dev, {key[0]: fm}, {"float32": x})[key[0], "float32"]
            for key, fm in models.items()}
    siblings = {}
    for family, (cls, _) in GAINED_SIBLINGS.items():
        sib = variable_rate_model(dev, cls=cls)
        fm = folded_at(sib, SIBLING_CODEC_LEVEL)
        siblings[family] = (sib, fm, codec_references(dev, {"float32": fm},
                                                      {"float32": x})["float32", "float32"])
    reset_launch_counts()
    results = dict(fold_flips=fold_flips)
    print(f"  -- serve {HEIGHT}x{WIDTH}: the gained forward at level {GAINED_SERVE_LEVEL}",
          flush=True)
    factory = lambda m, k, dtype=None, device=None, seed=0: AtLevel(  # noqa: E731
        variable_rate_model(device, dtype), GAINED_SERVE_LEVEL)
    forwards, results["serve_gained"] = serve_phase(dev, card, factory)
    print(f"  -- serve {HEIGHT}x{WIDTH}: the model folded at level {GAINED_SERVE_LEVEL}",
          flush=True)
    folded_factory = lambda m, k, dtype=None, device=None, seed=0: folded_at(  # noqa: E731
        variable_rate_model(device, dtype), GAINED_SERVE_LEVEL)
    n, results["serve_folded"] = serve_phase(dev, card, folded_factory)
    forwards += n
    for kind in ("serve_gained", "serve_folded"):
        for dname, r in results[kind].items():
            r["over_flagship"] = r["img_per_s"] / flagship_serve[dname]["img_per_s"]
            print(f"  {kind} {dname}: {r['over_flagship']:.4f}x the flagship's img/s (phase 4), "
                  f"batch-1 latency {r['batch1_latency_ms']:.3f} ms against "
                  f"{flagship_serve[dname]['batch1_latency_ms']:.3f}", flush=True)
    print(f"  -- train, batch {TRAIN_BATCH} of {TRAIN_SIZE}x{TRAIN_SIZE}, levels sampled",
          flush=True)
    steps, results["train"] = gained_train(dev, card, flagship_train)
    total = added(scaled(FORWARD, forwards), scaled(PER_STEP, steps))
    check(launch_counts() == total, f"gained: serve and train launched {launch_counts()}, "
                                    f"not {total} ({forwards} forwards, {steps} steps)")
    print(f"  -- codec: JointARCodec on the folds at levels {GAINED_CODEC_LEVELS}, one "
          f"{HEIGHT}x{WIDTH} image", flush=True)
    results["codec"] = gained_codec(total, models, refs, x, card)
    results["rate_control"] = gained_rate_control(total, model, x)
    results["curve"] = gained_curve(total, model, card)
    results["trainer"] = gained_trainer(dev, total, card)
    results["siblings"] = {family: sibling_main_path(dev, total, family, *siblings[family], x,
                                                     card)
                           for family in GAINED_SIBLINGS}
    launches = launch_counts()
    check(launches == total, f"gained: launches {launches}, its calls counted {total}")
    seconds = time.perf_counter() - t0
    print(f"main path (gained): {forwards} serve forwards, {steps} steps, the codec's, rate "
          f"control's, the curve's, the Trainer's and the siblings' calls: launches {launches} "
          f"(a forward {FORWARD}, a step {PER_STEP}); phase 10 took {seconds:.1f} s")
    results.update(seconds=seconds, launches_per_forward=FORWARD, launches_per_step=PER_STEP,
                   M=M, K=K, levels=list(model.levels))
    return launches, results


# --- phase 11: scalable two-layer coding and vision distillation ------------------

# the reference's scalable configuration (examples/train_eval_scalable.py:40-48):
# M = 192, M1 = 128, K = 1 (and a K = 3 variant at the same widths), the
# LatentSpaceTransform's (2, 1, 1, 1), lambda 0.01 on the raw MSE, gamma 1
# against a frozen YOLOv5 teacher of width M1 / 2 cut at layer 3 (its P3
# stage: 2 M1 channels on the H/8 grid, F_tilde's), random weights from a seed
SC_M, SC_M1 = 192, 128
SC_WIDTHS = {1: (SC_M, SC_M1, 1), 3: (SC_M, SC_M1, 3)}
SC_LAMBDA, SC_GAMMA, SC_CUT, SC_TEACHER_SEED = 0.01, 1.0, 3, 42
SC_TEACHER_WIDTH = SC_M1 // 2
# the LatentSpaceTransform's three IGDN (one at M1 channels, two at 2 M1) run
# on the H/8 grid: its rows at serve, in the train step and in decompress_base
SC_LST_ROWS = {"serve": BATCH * (HEIGHT // 8) * (WIDTH // 8),
               "train": TRAIN_BATCH * (TRAIN_SIZE // 8) ** 2,
               "decompress_base": (HEIGHT // 8) * (WIDTH // 8)}
# card against CPU: a seed and gains whose y and z keep a rounding margin
# (on a CPU 2.0e-5 and 1.2e-4 at M=192, 2x256x256; y and z take 5 values)
SC_PARITY_SEED, SC_GAINS = 15, (8.0, 12.0)
# card-vs-CPU gradients of the LST's leaves: its residual blocks' leaky
# ReLUs make them ill-conditioned at random init (pre-activations near 0
# switch slope under float32 rounding). On one CPU, scaling every weight by
# 1 + 1e-6 N(0, 1) moves them by up to 2.9e-3 of their largest value (the
# other leaves' median 2.9e-6). Card against CPU on an H100: up to 1.6e-3
# in one run, 1.6e-6 in another of the same code. Every other leaf keeps
# GRAD_LEAF_TOL.
SC_LST_GRAD_TOL = 1e-2
# launches (GDN / backward / mixture / backward): 3 GDN and 3 IGDN in the
# transforms, the LST's 3 IGDN; with the vision term every IGDN is in the
# loss, without it (gamma 0, no teacher) the LST gets no backward; K = 3
# adds each layer's mixture
SC_FORWARD = dict(NO_LAUNCHES, gdn=9)
SC_STEP = dict(SC_FORWARD, gdn_backward=9, gdn_backward_params=9)
SC_STEP_NO_TEACHER = dict(SC_FORWARD, gdn_backward=6, gdn_backward_params=6)
SC_K3_FORWARD = dict(SC_FORWARD, gmm_logp=2)
SC_K3_STEP = dict(SC_STEP, gmm_logp=2, gmm_logp_backward=2)
SC_K3_STEPS = 3
SC_LATENCY_ITERS = 3
# the layered stream: header, three rANS flushes (z, y1, y2; the base
# stream two); refine's eval forward runs the LST too
SC_FIXED_BYTES, SC_BASE_FIXED_BYTES = 26 + 3 * 4, 26 + 2 * 4
SC_REFINE = dict(NO_LAUNCHES, gdn=9 + 3 * REFINE_STEPS + 3, gdn_backward=3 * REFINE_STEPS)
SC_EVAL_IMAGES = 2


def teacher_flops(width, h, w):
    """One image's forward FLOPs of the YOLOv5 teacher's layers 0-3 (Conv 6x6
    s2, Conv 3x3 s2, C3 with one bottleneck, Conv 3x3 s2): its input
    gradient, which distillation runs too, costs about as much again."""
    c = flops._conv
    return (c(h // 2, w // 2, 6, 3, width) + c(h // 4, w // 4, 3, width, 2 * width)
            + 2 * c(h // 4, w // 4, 1, 2 * width, width) + c(h // 4, w // 4, 1, width, width)
            + c(h // 4, w // 4, 3, width, width) + c(h // 4, w // 4, 1, 2 * width, 2 * width)
            + c(h // 8, w // 8, 3, 2 * width, 4 * width))


def scalable_teacher(device):
    """(frozen_activation, V): the seeded YOLOv5 backbone of width M1 / 2,
    float32, cut at layer 3."""
    return distillation_targets(build_yolo_backbone(SC_TEACHER_WIDTH, device=device,
                                                    seed=SC_TEACHER_SEED), SC_CUT)


def vision_objective(teacher):
    """vision_rd_loss with the vision term (gamma 1) against ``teacher``,
    or without one (gamma 0) when it is None."""
    if teacher is None:
        return functools.partial(vision_rd_loss, gamma=0.0)
    act, V = teacher
    return functools.partial(vision_rd_loss, gamma=SC_GAMMA, frozen_activation=act, V=V)


def scalable_kernel_cases(dev):
    """The GDN kernel at the LatentSpaceTransform's sites, C = M1 and 2 M1
    (IGDN alone, as the LST runs it): the forward at the serve's, the train
    step's and decompress_base's H/8 rows, the backward with dgamma/dbeta
    at the train step's."""
    rng = np.random.default_rng(50)
    records = []
    for c in (SC_M1, 2 * SC_M1):
        gamma_t, beta_t = gdn_params(c, rng, dev)
        tag = f" C={c} LST"
        for path, rows in SC_LST_ROWS.items():
            records += gdn_site_records(path, {"H/8": rows}, rng, gamma_t, beta_t, dev, tag,
                                        inverses=(True,))
        records += gdn_backward_site_records("train", {"H/8": SC_LST_ROWS["train"]}, rng,
                                             gamma_t, beta_t, dev, inverses=(True,), tag=tag)
    for r in records:
        r["families"] = ["scalable"]
    return records


def scalable_parity(dev):
    """The eval forward, K = 1 and 3, and one float32 step's gradients
    with the vision term (K = 1), the card against the CPU."""
    for k in (1, 3):
        print(f"  -- eval forward 2x256x256, K={k}", flush=True)
        parity(dev, ScalableImageCoding, SC_WIDTHS[k], SC_PARITY_SEED, SC_GAINS,
               loss=vision_rd_loss)
    print("  -- one float32 step's gradients with the vision term, 1x256x256", flush=True)
    grad_parity(dev, lambda device: ScalableImageCoding(*SC_WIDTHS[1], device=device,
                                                        seed=GRAD_SEED),
                lambda device: vision_objective(scalable_teacher(device)), SC_LAMBDA, SC_M,
                lambda name: SC_LST_GRAD_TOL if name.startswith("LST.") else GRAD_LEAF_TOL)


def scalable_references(dev, models, x):
    """The eval forward of each model on x: the latents, F_tilde, the
    clipped x_hat, the analytic bits of the full and the base stream."""
    refs = {}
    xd = torch.from_numpy(x).to(dev)
    for dname, model in models.items():
        out = model(xd, training=False)
        rates = vision_rd_loss(out, xd, SC_LAMBDA)
        refs[dname] = dict(
            y_in=out["y_in"][0].cpu().numpy(), z_in=out["z_in"][0].cpu().numpy(),
            y1=out["y1"][0].cpu().numpy(), F_tilde=out["F_tilde"].cpu().numpy(),
            x_hat=torch.clamp(out["x_hat"], 0.0, 1.0).cpu().numpy(),
            bits=rates["bits_total"].item(),
            base_bits=(rates["bits_y1"] + rates["bits_z"]).item())
    return refs


def scalable_codec_case(total, codec, x, ref, dname, card):
    """ScalableCodec on one image: exact latents (y1, y2, z), decompress
    against x_hat, truncate_base -> decompress_base (y1 exact, F_tilde
    against the forward's: float32 within CODEC_F32_XHAT_TOL, bfloat16
    within one bf16 step), a truncated stream refused by decompress, full
    and base bits against the analytic rates, then latency by stage."""
    data, _ = counted(total, CODEC_PER_CALL, codec.compress, x)
    (y_q, z_q), _ = counted(total, NO_LAUNCHES, codec.decode_latents, data)
    check(np.array_equal(y_q, ref["y_in"]) and np.array_equal(z_q, ref["z_in"]),
          f"{dname}: decoded latents differ from the eval forward's "
          f"({int((y_q != ref['y_in']).sum())} y, {int((z_q != ref['z_in']).sum())} z)")
    check(min(len(np.unique(y_q[..., :SC_M1])), len(np.unique(y_q[..., SC_M1:]))) >= 3,
          f"{dname}: a layer's latents take fewer than 3 values")
    x_hat, _ = counted(total, CODEC_PER_CALL, codec.decompress, data)
    base = codec.truncate_base(data)
    (y1, f_tilde), _ = counted(total, CODEC_PER_CALL, codec.decompress_base, base)
    check(np.array_equal(y1, ref["y1"]), f"{dname}: the base stream's y1 differs")
    errs = {"x_hat": float(np.abs(x_hat - ref["x_hat"]).max()),
            "F_tilde": float(np.abs(f_tilde - ref["F_tilde"]).max())}
    for key, got in (("x_hat", x_hat), ("F_tilde", f_tilde)):
        if dname == "float32":
            scale = max(1.0, float(np.abs(ref[key]).max()))
            check(errs[key] <= CODEC_F32_XHAT_TOL * scale, f"{dname}: {key} differs by "
                                                          f"{errs[key]:.3e}")
        else:
            steps = int(bf16_steps_apart(torch.from_numpy(got).bfloat16(),
                                         torch.from_numpy(ref[key]).bfloat16()).max().item())
            check(steps <= 1, f"{dname}: {key} {steps} bf16 steps from the eval forward's")
    try:
        counted(total, NO_LAUNCHES, codec.decompress, base)
        fail(f"{dname}: decompress accepted a truncated stream")
    except ValueError as e:
        check("enhancement stream missing" in str(e), f"{dname}: {e}")
    bits, base_bits = 8 * len(data), 8 * len(base)
    check(bits <= ref["bits"] * CODEC_RATE_SLACK + 8 * SC_FIXED_BYTES,
          f"{dname}: {bits} stream bits against {ref['bits']:.1f} analytic")
    check(base_bits <= ref["base_bits"] * CODEC_RATE_SLACK + 8 * SC_BASE_FIXED_BYTES,
          f"{dname}: {base_bits} base-stream bits against {ref['base_bits']:.1f} analytic")

    img_h, img_w, y_s, z_s, psi = counted(total, CODEC_PER_CALL, codec._analyse_image, x)[0]
    y1_bytes, y2_bytes, psi_d, _, h, w, _ = codec._decode_common(data)
    stages = dict(
        encode_analysis_psi=family_median_ms(total, CODEC_PER_CALL, codec._analyse_image, x),
        encode_host_z_and_layers=family_median_ms(total, NO_LAUNCHES, codec._encode_from, y_s,
                                                  z_s, psi, img_h, img_w),
        decode_z_and_psi=family_median_ms(total, NO_LAUNCHES, codec._decode_common, data),
        decode_psi=family_median_ms(total, NO_LAUNCHES, codec._psi, z_q[None]),
        decode_host_layers=family_median_ms(total, NO_LAUNCHES, codec._decode_layers, y1_bytes,
                                            y2_bytes, psi_d, h, w, False),
        decode_synthesis=family_median_ms(total, CODEC_PER_CALL, codec._synthesize, y_q[None],
                                          HEIGHT, WIDTH),
        base_host_y1=family_median_ms(total, NO_LAUNCHES, codec._decode_layer, 1, y1_bytes,
                                      psi_d, h, w, False),
        base_lst=family_median_ms(total, CODEC_PER_CALL, codec._lst, y_q[..., :SC_M1]))
    r = dict(encode_ms=family_median_ms(total, CODEC_PER_CALL, codec.compress, x),
             decode_ms=family_median_ms(total, CODEC_PER_CALL, codec.decompress, data),
             base_decode_ms=family_median_ms(total, CODEC_PER_CALL, codec.decompress_base, base),
             stages_ms=stages, stream_bytes=len(data), base_bytes=len(base),
             bpp=bits / (HEIGHT * WIDTH), base_bpp=base_bits / (HEIGHT * WIDTH),
             stream_over_analytic=bits / ref["bits"],
             base_over_analytic=base_bits / ref["base_bits"],
             x_hat_max_abs_diff=errs["x_hat"], f_tilde_max_abs_diff=errs["F_tilde"])
    # the z decode is what _decode_common adds to psi
    host_z = stages["decode_z_and_psi"] - stages["decode_psi"]
    r.update(encode_device_ms=stages["encode_analysis_psi"],
             encode_host_ms=stages["encode_host_z_and_layers"],
             decode_device_ms=stages["decode_psi"] + stages["decode_synthesis"],
             decode_host_ms=host_z + stages["decode_host_layers"],
             base_decode_device_ms=stages["decode_psi"] + stages["base_lst"],
             base_decode_host_ms=host_z + stages["base_host_y1"])
    print(f"  {dname}: encode {r['encode_ms']:.2f} ms (device {r['encode_device_ms']:.2f}, host "
          f"{r['encode_host_ms']:.2f}), decode {r['decode_ms']:.2f} ms (device "
          f"{r['decode_device_ms']:.2f}, host {r['decode_host_ms']:.2f}), base decode "
          f"{r['base_decode_ms']:.2f} ms (device {r['base_decode_device_ms']:.2f}, host "
          f"{r['base_decode_host_ms']:.2f}); {r['bpp']:.5f} bpp ({r['stream_over_analytic']:.5f} "
          f"of analytic), base {r['base_bpp']:.5f} bpp ({r['base_over_analytic']:.5f}); latents "
          f"exact, x_hat {errs['x_hat']:.3e}, F_tilde {errs['F_tilde']:.3e} from the forward's "
          f"[{card}, {os.cpu_count()} host cores]", flush=True)
    return r


def scalable_numerics_check(total, model, x, dname):
    """Compress with TF32 and cuDNN autotuning on, decode with both off:
    the decoded latents re-encode to the same bytes."""
    set_fast_numerics(True)
    try:
        data, _ = counted(total, CODEC_PER_CALL, ScalableCodec(model).compress, x)
        check(torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.benchmark
              and torch.backends.cuda.matmul.allow_tf32,
              f"{dname}: the codec did not restore the caller's numerics settings")
    finally:
        set_fast_numerics(False)
    plain = ScalableCodec(model)
    (y_q, z_q), _ = counted(total, NO_LAUNCHES, plain.decode_latents, data)
    again, _ = counted(total, NO_LAUNCHES, plain.compress_latents, y_q, z_q, HEIGHT, WIDTH)
    check(again == data, f"{dname}: the TF32-on stream's latents re-encode to other bytes")
    print(f"  {dname}: TF32 + autotuned compress decodes exactly with both off ({len(data)} "
          f"bytes re-encoded)", flush=True)


def scalable_portable_case(total, model, x, ref, float_bytes):
    """A card pair built here, saved as one file and loaded (same hashes);
    compress_portable's latents exact, its base stream's y1 exact; rate
    against the float stream's, latency of one call each."""
    t0 = time.perf_counter()
    cards, _ = counted(total, NO_LAUNCHES, ScalableCodec(model).portable_cards)
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cards.npz")
        save_scalable_cards(path, cards)
        loaded = load_scalable_cards(path)
    check([c.hash for c in loaded] == [c.hash for c in cards], "loaded cards' hashes differ")
    codec = ScalableCodec(model, portable_cards=loaded)
    data, encode_s = counted(total, CODEC_PER_CALL, codec.compress_portable, x)
    (y_q, z_q), decode_s = counted(total, NO_LAUNCHES, codec.decode_latents, data)
    check(np.array_equal(y_q, ref["y_in"]) and np.array_equal(z_q, ref["z_in"]),
          "portable: decoded latents differ from the eval forward's")
    (y1, _), _ = counted(total, CODEC_PER_CALL, codec.decompress_base, codec.truncate_base(data))
    check(np.array_equal(y1, ref["y1"]), "portable: the base stream's y1 differs")
    r = dict(card_hashes=[c.hash.hex() for c in cards], cards_build_s=build_s,
             stream_bytes=len(data), bpp=8 * len(data) / (HEIGHT * WIDTH),
             over_float=len(data) / float_bytes, encode_ms=1e3 * encode_s,
             decode_latents_ms=1e3 * decode_s)
    print(f"  float32 portable: cards built in {build_s:.2f} s, saved and loaded (same hashes); "
          f"{r['bpp']:.5f} bpp, {r['over_float']:.5f}x the float stream; encode "
          f"{r['encode_ms']:.2f} ms, decode {r['decode_latents_ms']:.2f} ms (one call each); "
          f"latents exact, base y1 exact", flush=True)
    return r


def scalable_refine_case(total, model, codec, x, dev):
    """One REFINE_STEPS-step refine call (scalable mode): the loss falls,
    the refined latents round trip and truncate."""
    refine = make_refiner(model, SC_LAMBDA, steps=REFINE_STEPS, lr=REFINE_LR)
    (y_q, z_q, m), seconds = counted(total, SC_REFINE, refine, torch.from_numpy(x).to(dev))
    pre, post = m["pre_loss"].item(), m["post_loss"].item()
    check(np.isfinite(pre) and np.isfinite(post) and post <= pre, f"refine: loss {pre} -> {post}")
    data, _ = counted(total, NO_LAUNCHES, codec.compress_latents, y_q, z_q, HEIGHT, WIDTH)
    y_d, _ = counted(total, NO_LAUNCHES, codec.decode_latents, data)[0]
    check(np.array_equal(y_d, y_q[0].cpu().numpy()), "refine: the refined latents do not "
                                                       "round trip")
    (y1, _), _ = counted(total, CODEC_PER_CALL, codec.decompress_base, codec.truncate_base(data))
    check(np.array_equal(y1, y_q[0, ..., :SC_M1].cpu().numpy()), "refine: base y1 differs")
    r = dict(pre_loss=pre, post_loss=post, pre_bpp=m["pre_bpp_total"].item(),
             post_bpp=m["post_bpp_total"].item(), refine_ms=1e3 * seconds,
             launches_per_call=SC_REFINE)
    print(f"  float32 refine {REFINE_STEPS} steps (lr {REFINE_LR}): loss {pre:.5f} -> {post:.5f}, "
          f"bpp {r['pre_bpp']:.5f} -> {r['post_bpp']:.5f}; {r['refine_ms']:.2f} ms a call (the "
          f"first); round trip and truncation exact; launches {SC_REFINE}", flush=True)
    return r


def scalable_evaluator_case(total, model, teacher, card):
    """VisionCompressionEvaluator.evaluate with the teacher on
    SC_EVAL_IMAGES 768x512 images: per-layer bpp, the vision MSE, seconds
    an image."""
    rng = np.random.default_rng(CODEC_SEED + 3)
    images = [rng.uniform(size=(1, HEIGHT, WIDTH, 3)).astype(np.float32)
              for _ in range(SC_EVAL_IMAGES)]
    act, V = teacher
    with tempfile.TemporaryDirectory() as tmp:
        ev = VisionCompressionEvaluator(model, images, SC_LAMBDA, SC_GAMMA, tmp)
        loss = functools.partial(vision_rd_loss, frozen_activation=act, V=V)
        counted(total, scaled(SC_FORWARD, SC_EVAL_IMAGES), ev.evaluate, loss)  # warm-up
        (metrics, _, _), seconds = counted(total, scaled(SC_FORWARD, SC_EVAL_IMAGES), ev.evaluate,
                                           loss)
    check("VisionMSE" in metrics and all(np.isfinite(v) for v in metrics.values()),
          f"evaluator: {metrics}")
    r = dict(metrics=metrics, s_per_image=seconds / SC_EVAL_IMAGES)
    print(f"  VisionCompressionEvaluator.evaluate: {r['s_per_image']:.4f} s an image, BPP "
          f"{metrics['BPP']:.5f} (y1 {metrics['BPP(y1)']:.5f}, y2 {metrics['BPP(y2)']:.5f}, z "
          f"{metrics['BPP(z)']:.5f}), VisionMSE {metrics['VisionMSE']:.5f} [{card}]", flush=True)
    return r


def scalable_phase(dev, card):
    """ScalableImageCoding at M=192, M1=128 (K=1, and K=3 where named):
    card against CPU, then the main path with its launches counted from 0:
    serve (K=1 and 3), train (the vision term with the teacher, and gamma 0
    without it; K=3 a few steps), ScalableCodec (f32 and bf16, base-layer
    truncation, TF32 on at encode), portable, refine, the evaluator.
    Returns (the main path's launches, results)."""
    t0 = time.perf_counter()
    scalable_parity(dev)
    x = codec_images()["float32"]
    models = {"float32": gained_model(dev, None, ScalableImageCoding, SC_WIDTHS[1],
                                      SC_PARITY_SEED, SC_GAINS),
              "bfloat16": gained_model(dev, torch.bfloat16, ScalableImageCoding, SC_WIDTHS[1],
                                       SC_PARITY_SEED, SC_GAINS)}
    refs = scalable_references(dev, models, x)
    teacher = scalable_teacher(dev)
    reset_launch_counts()
    results = {}
    print(f"  -- serve {HEIGHT}x{WIDTH}, K=1 and K=3", flush=True)
    forwards, results["serve"] = serve_phase(dev, card, ScalableImageCoding, 0,
                                             widths=SC_WIDTHS[1],
                                             latency_iters=SC_LATENCY_ITERS, gdn_per_forward=9)
    forwards3, results["serve_k3"] = serve_phase(dev, card, ScalableImageCoding, 2,
                                                 widths=SC_WIDTHS[3],
                                                 latency_iters=SC_LATENCY_ITERS,
                                                 gdn_per_forward=9)
    extra = 2 * teacher_flops(SC_TEACHER_WIDTH, TRAIN_SIZE, TRAIN_SIZE)
    print(f"  -- train, batch {TRAIN_BATCH} of {TRAIN_SIZE}x{TRAIN_SIZE}, lambda {SC_LAMBDA}, "
          f"gamma {SC_GAMMA} with the width-{SC_TEACHER_WIDTH} teacher", flush=True)
    steps, results["train"] = train_phase(dev, card, ScalableImageCoding,
                                          flops.scalable_eval_flops, SC_STEP, SC_WIDTHS[1],
                                          vision_objective(teacher), SC_LAMBDA, extra)
    print("  -- train, gamma 0, no teacher", flush=True)
    steps0, results["train_gamma0"] = train_phase(dev, card, ScalableImageCoding,
                                                  flops.scalable_eval_flops, SC_STEP_NO_TEACHER,
                                                  SC_WIDTHS[1], vision_objective(None), SC_LAMBDA)
    xt = torch.rand((TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
                    generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    k3_losses, k3_times, _ = train_run(dev, torch.float32, xt, 2, SC_K3_STEPS,
                                       cls=ScalableImageCoding, per_step=SC_K3_STEP,
                                       widths=SC_WIDTHS[3], loss=vision_objective(teacher),
                                       lam=SC_LAMBDA)
    check(bool(torch.isfinite(k3_losses).all()), f"K=3 losses {k3_losses}")
    results["train_k3_f32_ms"] = [1e3 * t for t in k3_times]
    print(f"  K=3 float32 steps with the vision term: {', '.join(f'{1e3 * t:.1f}' for t in k3_times)}"
          f" ms, {SC_K3_STEP} launches each", flush=True)
    total = added(scaled(SC_FORWARD, forwards), scaled(SC_K3_FORWARD, forwards3),
                  scaled(SC_STEP, steps), scaled(SC_STEP_NO_TEACHER, steps0),
                  scaled(SC_K3_STEP, SC_K3_STEPS))
    check(launch_counts() == total, f"scalable: serve and train launched {launch_counts()}, not "
                                    f"{total}")
    print(f"  -- ScalableCodec, one {HEIGHT}x{WIDTH} image", flush=True)
    codec = {}
    for dname, model in models.items():
        cod = ScalableCodec(model)
        codec[dname] = scalable_codec_case(total, cod, x, refs[dname], dname, card)
        scalable_numerics_check(total, model, x, dname)
    model, ref = models["float32"], refs["float32"]
    codec["float32"]["portable"] = scalable_portable_case(total, model, x, ref,
                                                          codec["float32"]["stream_bytes"])
    results["codec"] = codec
    results["refine"] = scalable_refine_case(total, model, ScalableCodec(model), x, dev)
    results["evaluator"] = scalable_evaluator_case(total, model, teacher, card)
    launches = launch_counts()
    check(launches == total, f"scalable: launches {launches}, its calls counted {total}")
    seconds = time.perf_counter() - t0
    print(f"main path (scalable): {forwards} + {forwards3} (K=3) forwards, {steps} + {steps0} "
          f"(gamma 0) + {SC_K3_STEPS} (K=3) steps, the codec's, refine's and the evaluator's "
          f"calls: launches {launches} (a forward {SC_FORWARD}, a step {SC_STEP}, without the "
          f"teacher {SC_STEP_NO_TEACHER}); phase 11 took {seconds:.1f} s")
    results.update(seconds=seconds, M=SC_M, M1=SC_M1, K=1, lambda_rd=SC_LAMBDA, gamma=SC_GAMMA,
                   teacher_width=SC_TEACHER_WIDTH, cut=SC_CUT, teacher_step_flops=extra,
                   launches_per_forward=SC_FORWARD, launches_per_step=SC_STEP,
                   launches_per_step_gamma0=SC_STEP_NO_TEACHER)
    return launches, results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    parser.add_argument("--phase", type=int, action="append", choices=range(2, 12),
                        help="run phase 1 and this phase (repeatable; phases 7 and 10 bring "
                             "4 and 5, whose results they read); default: every phase. The "
                             "kernels' record then covers the phases run")
    phases = set(parser.parse_args(argv).phase or range(2, 12))
    if phases & {7, 10}:
        phases |= {4, 5}
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
    with ThreadPoolExecutor(1) as pool:  # g++ for the rANS coder beside the nvcc builds
        rans = pool.submit(rans_backend.build, True)
        _build.build(verbose=True)
        rans_lib = rans.result()
    print(f"kernels and the rANS coder ({rans_lib.name}) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    torch.set_num_threads(8)
    # each main path's launches (none for a phase not run)
    launches = {}
    records = []

    if 2 in phases:
        print("== phase 2: kernels against their plain versions", flush=True)
        records += (gdn_cases(dev) + gmm_cases(dev) + gdn_backward_cases(dev)
                    + gmm_backward_cases(dev))

    if 3 in phases:
        print("== phase 3: card against CPU, M=128 K=3: eval forward 2x256x256, "
              "train-step gradients 1x256x256", flush=True)
        parity(dev)
        grad_parity(dev)

    if 4 in phases:
        print(f"== phase 4: serve, M={M} K={K}, {HEIGHT}x{WIDTH} [{card}]", flush=True)
        reset_launch_counts()
        forwards, serve_results = serve_phase(dev, card)
        launches["serve"] = launch_counts()
        check(launches["serve"] == scaled(FORWARD, forwards),
              f"serve launches {launches['serve']} over {forwards} forwards")
        print(f"main path (serve): {forwards} forwards, launches {launches['serve']}")
        print(json.dumps({"serve": serve_results, "card": card}))

    if 5 in phases:
        print(f"== phase 5: train, M={M} K={K}, batch {TRAIN_BATCH} of {TRAIN_SIZE}x{TRAIN_SIZE} "
              f"[{card}]", flush=True)
        reset_launch_counts()
        steps, train_results = train_phase(dev, card)
        launches["train"] = launch_counts()
        check(launches["train"] == scaled(PER_STEP, steps),
              f"train launches {launches['train']} over {steps} steps")
        print(f"main path (train): {steps} steps, launches {launches['train']}")
        print(json.dumps({"train": train_results, "card": card}))

    if 6 in phases:
        print(f"== phase 6: codec, M={M} K={K}, one {HEIGHT}x{WIDTH} image [{card}]", flush=True)
        records += gdn_codec_cases(dev) + refine_kernel_cases(dev)
        launches["codec"], codec_results = codec_phase(dev, card)
        check(launches["codec"]["gdn"] > 0, "the codec launched no GDN kernel")
        print(f"main path (codec): launches {launches['codec']}")
        print(json.dumps({"codec": codec_results, "card": card, "cpu_count": os.cpu_count()}))

    if 7 in phases:
        print(f"== phase 7: Trainer and evaluator, M={M} K={K} [{card}]", flush=True)
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer_total, trainer_results = trainer_phase(dev, card, train_results)
        launches["trainer"] = launch_counts()
        print(f"phase 7 took {time.perf_counter() - t0:.1f} s")
        check(launches["trainer"] == trainer_total,
              f"phase 7 launches {launches['trainer']}, its calls counted {trainer_total}")
        print(f"main path (Trainer and evaluator): launches {launches['trainer']}")
        print(json.dumps({"trainer": trainer_results, "card": card}))

    if 8 in phases:
        print(f"== phase 8: the other families, M={M} (K={K} with a mixture) [{card}]",
              flush=True)
        for family in FAMILIES:
            launches[family], family_results = family_phase(dev, card, family)
            print(json.dumps({family: family_results, "card": card,
                              "cpu_count": os.cpu_count()}))

    if 9 in phases:
        print(f"== phase 9: the residual family, HierarchicalMixtureResidual M={RES_M} "
              f"K={RES_K} (transform res3x3) [{card}]", flush=True)
        records += residual_kernel_cases(dev)
        launches["residual"], residual_results = residual_phase(dev, card)
        print(json.dumps({"residual": residual_results, "card": card,
                          "cpu_count": os.cpu_count()}))

    if 10 in phases:
        print(f"== phase 10: the variable-rate families, GainedJointAR M={M} K={K} and its "
              f"three siblings [{card}]", flush=True)
        launches["gained"], gained_results = gained_phase(dev, card, serve_results,
                                                          train_results)
        print(json.dumps({"gained": gained_results, "card": card, "cpu_count": os.cpu_count()}))

    if 11 in phases:
        print(f"== phase 11: scalable two-layer coding, ScalableImageCoding M={SC_M} M1={SC_M1} "
              f"K=1 (and 3), the width-{SC_TEACHER_WIDTH} YOLOv5 teacher [{card}]", flush=True)
        records += scalable_kernel_cases(dev)
        launches["scalable"], scalable_results = scalable_phase(dev, card)
        print(json.dumps({"scalable": scalable_results, "card": card,
                          "cpu_count": os.cpu_count()}))

    for r in records:
        r["launches"] = sum(path[r["name"]] for path in launches.values())
        # every family runs the GDN kernels at these shapes, the mixture
        # kernels only the families with a mixture, the gained families (the
        # flagship's shapes) all of them; phase 9's (C=192) and phase 11's
        # (the LST's) records carry their own
        r.setdefault("families", ["joint_ar"] + (
            [f for f, fam in FAMILIES.items() if fam.mixture or r["name"].startswith("gdn")]
            + ["gained_" + f for f in ("joint_ar", *GAINED_SIBLINGS)]
            if r.get("path") in ("serve", "train", "codec", "refine") else []))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
