from neural_image_compression_tpu_torch.ops import kernels
from neural_image_compression_tpu_torch.ops.blocks import leaky_relu
from neural_image_compression_tpu_torch.ops.bound import (
    PEDESTAL, lower_bound, nonneg, nonneg_init, upper_bound,
)
from neural_image_compression_tpu_torch.ops.conv import Conv2d, Deconv2d
from neural_image_compression_tpu_torch.ops.gdn import GDN
from neural_image_compression_tpu_torch.ops.masked_conv import (
    ContextModel, MaskedConv2d, causal_mask,
)
from neural_image_compression_tpu_torch.ops.math import LOG2, gaussian_cdf

__all__ = ["kernels", "leaky_relu", "PEDESTAL", "lower_bound", "upper_bound",
           "nonneg", "nonneg_init", "Conv2d", "Deconv2d", "GDN", "ContextModel",
           "MaskedConv2d", "causal_mask", "LOG2", "gaussian_cdf"]
