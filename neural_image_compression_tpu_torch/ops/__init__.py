from neural_image_compression_tpu_torch.ops import kernels
from neural_image_compression_tpu_torch.ops.blocks import (
    ResidualBlock, ResidualBlockUpsample, ResidualBlockWithStride, leaky_relu,
)
from neural_image_compression_tpu_torch.ops.bound import (
    PEDESTAL, lower_bound, nonneg, nonneg_init, upper_bound,
)
from neural_image_compression_tpu_torch.ops.conv import (
    Conv2d, Deconv2d, SubpelConv3x3, TransposedDeconv3x3, conv2d, deconv2d, pixel_shuffle,
)
from neural_image_compression_tpu_torch.ops.gdn import GDN
from neural_image_compression_tpu_torch.ops.masked_conv import (
    ContextModel, MaskedConv2d, causal_mask, causal_positions,
)
from neural_image_compression_tpu_torch.ops.math import LOG2, gaussian_cdf, nats_to_bits

__all__ = ["kernels", "leaky_relu", "ResidualBlock", "ResidualBlockUpsample",
           "ResidualBlockWithStride", "PEDESTAL", "lower_bound", "upper_bound", "nonneg",
           "nonneg_init", "Conv2d", "Deconv2d", "SubpelConv3x3", "TransposedDeconv3x3", "conv2d",
           "deconv2d", "pixel_shuffle", "GDN", "ContextModel", "MaskedConv2d", "causal_mask",
           "causal_positions", "LOG2", "gaussian_cdf", "nats_to_bits"]
