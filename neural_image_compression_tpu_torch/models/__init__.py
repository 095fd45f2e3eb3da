from neural_image_compression_tpu_torch.models.backbones import (
    C3, SPPF, Concat, ConvBNSiLU, build_yolo_backbone, distillation_targets,
    frozen_activation_from_conv, load_backbone, save_backbone,
)
from neural_image_compression_tpu_torch.models.channel_cb import (
    ChannelCheckerboardHierarchical, default_groups,
)
from neural_image_compression_tpu_torch.models.checkerboard import (
    CB_CTX_POSITIONS, CheckerboardContext, CheckerboardHierarchical, checkerboard_mask,
)
from neural_image_compression_tpu_torch.models.components import (
    Decoder3x3, Decoder5x5, Encoder3x3, Encoder5x5, HyperDecoder3x3, HyperDecoder5x5,
    HyperEncoder3x3, HyperEncoder5x5, LatentSpaceTransform,
)
from neural_image_compression_tpu_torch.models.factorized_prior import FactorizedPrior
from neural_image_compression_tpu_torch.models.gained import (
    GainedChannelCheckerboard, GainedCheckerboard, GainedHyperprior, GainedJointAR, fold_gains,
    folded_model, interp_gain, level_for_bpp,
)
from neural_image_compression_tpu_torch.models.hyperprior import MeanScaleHyperprior
from neural_image_compression_tpu_torch.models.joint_ar import (
    HierarchicalMixtureResidual, HierarchicalModel, JointAutoregressiveHierarchical,
    noise_quantize, quantize, round_quantize,
)
from neural_image_compression_tpu_torch.models.parameters import EntropyParameters
from neural_image_compression_tpu_torch.models.scalable import ScalableImageCoding
from neural_image_compression_tpu_torch.models.vision import (
    FirstHalf, FrozenActivationBlock, GraphBackbone, SecondHalf,
)

__all__ = ["CB_CTX_POSITIONS", "ChannelCheckerboardHierarchical", "CheckerboardContext",
           "CheckerboardHierarchical", "checkerboard_mask", "default_groups", "Decoder3x3",
           "Decoder5x5", "Encoder3x3", "Encoder5x5", "FactorizedPrior", "HyperDecoder3x3",
           "HyperDecoder5x5", "HyperEncoder3x3", "HyperEncoder5x5",
           "HierarchicalMixtureResidual", "HierarchicalModel", "JointAutoregressiveHierarchical",
           "MeanScaleHyperprior", "EntropyParameters", "GainedJointAR", "GainedHyperprior",
           "GainedCheckerboard", "GainedChannelCheckerboard", "fold_gains", "folded_model",
           "interp_gain", "level_for_bpp", "noise_quantize", "quantize", "round_quantize",
           "LatentSpaceTransform", "ScalableImageCoding", "FirstHalf", "SecondHalf",
           "GraphBackbone", "FrozenActivationBlock", "ConvBNSiLU", "C3", "SPPF", "Concat",
           "build_yolo_backbone", "frozen_activation_from_conv", "save_backbone",
           "load_backbone", "distillation_targets"]
