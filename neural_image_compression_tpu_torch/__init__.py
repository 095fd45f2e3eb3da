"""PyTorch/CUDA port of neural_image_compression_tpu.

The JAX package beside it is the reference; this package mirrors its module
paths and class names. Public tensors keep the JAX layout: images are
(B, H, W, 3) in [0, 1], latents (B, h, w, M), mixture parameters
(B, h, w, K, M). Inside, convolutions run on NCHW-logical tensors held in
``channels_last`` memory, which has NHWC's bytes.

Entry points put their tensors on ``cuda`` unless the caller passes
``device="cpu"``, and raise when no CUDA device is present. On a CUDA tensor
every kernel wrapper launches its hand-written kernel (``csrc/``); the plain
PyTorch version of each kernel runs only for tensors on the CPU. The GDN
and mixture-likelihood kernels have backward kernels, so the flagship
trains on the card (``parallel.make_train_step``). ``coding.JointARCodec``
writes and reads real bitstreams (single images, batches, interleaved and
tiled streams, portable integer streams), and ``coding.make_refiner``
refines latents before coding: the transforms run on the model's device,
the rANS, wavefront and portable coders on the host (C++, built with g++
at first use). ``train.Trainer`` runs training (schedulers, checkpoints,
resume, validation, TensorBoard/JSONL metrics) and
``evaluation.CompressionEvaluator`` measures a model (PSNR, MS-SSIM, the
analytic and the real bitstream rate) on the model's device.

This package imports torch and numpy (and scipy's ``ndtr`` for a portable
card's tables, where it is installed; tensorboard, PIL and matplotlib where
metrics, images and figures are written): never jax, flax or the JAX
package.
"""

from neural_image_compression_tpu_torch import config
from neural_image_compression_tpu_torch.config import Config, build_model
from neural_image_compression_tpu_torch import (
    coding, data, entropy, evaluation, models, ops, parallel, serving, train, utils,
)

__all__ = ["coding", "data", "entropy", "evaluation", "models", "ops", "parallel", "serving",
           "train", "utils", "config", "Config", "build_model"]
