"""PyTorch/CUDA port of neural_image_compression_tpu.

The JAX package beside it is the reference; this package mirrors its module
paths and class names. Public tensors keep the JAX layout: images are
(B, H, W, 3) in [0, 1], latents (B, h, w, M), mixture parameters
(B, h, w, K, M). Inside, convolutions run on NCHW-logical tensors held in
``channels_last`` memory, which has NHWC's bytes.

Entry points put their tensors on ``cuda`` unless the caller passes
``device="cpu"``, and raise when no CUDA device is present. On a CUDA tensor
every kernel wrapper launches its hand-written kernel (``csrc/``); the plain
PyTorch version of each kernel runs only for tensors on the CPU.

This package imports torch and numpy only: never jax, flax or the JAX
package.
"""

from neural_image_compression_tpu_torch import entropy, models, ops, serving, train, utils

__all__ = ["entropy", "models", "ops", "serving", "train", "utils"]
