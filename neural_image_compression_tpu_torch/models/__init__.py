from neural_image_compression_tpu_torch.models.channel_cb import (
    ChannelCheckerboardHierarchical, default_groups,
)
from neural_image_compression_tpu_torch.models.checkerboard import (
    CB_CTX_POSITIONS, CheckerboardContext, CheckerboardHierarchical, checkerboard_mask,
)
from neural_image_compression_tpu_torch.models.components import (
    Decoder3x3, Decoder5x5, Encoder3x3, Encoder5x5, HyperDecoder3x3, HyperDecoder5x5,
    HyperEncoder3x3, HyperEncoder5x5,
)
from neural_image_compression_tpu_torch.models.factorized_prior import FactorizedPrior
from neural_image_compression_tpu_torch.models.hyperprior import MeanScaleHyperprior
from neural_image_compression_tpu_torch.models.joint_ar import (
    HierarchicalMixtureResidual, HierarchicalModel, JointAutoregressiveHierarchical,
    noise_quantize, quantize, round_quantize,
)
from neural_image_compression_tpu_torch.models.parameters import EntropyParameters

__all__ = ["CB_CTX_POSITIONS", "ChannelCheckerboardHierarchical", "CheckerboardContext",
           "CheckerboardHierarchical", "checkerboard_mask", "default_groups", "Decoder3x3",
           "Decoder5x5", "Encoder3x3", "Encoder5x5", "FactorizedPrior", "HyperDecoder3x3",
           "HyperDecoder5x5", "HyperEncoder3x3", "HyperEncoder5x5",
           "HierarchicalMixtureResidual", "HierarchicalModel", "JointAutoregressiveHierarchical",
           "MeanScaleHyperprior", "EntropyParameters", "noise_quantize", "quantize",
           "round_quantize"]
