from neural_image_compression_tpu_torch.models.channel_cb import (
    ChannelCheckerboardHierarchical, default_groups,
)
from neural_image_compression_tpu_torch.models.checkerboard import (
    CB_CTX_POSITIONS, CheckerboardContext, CheckerboardHierarchical, checkerboard_mask,
)
from neural_image_compression_tpu_torch.models.components import (
    Decoder5x5, Encoder5x5, HyperDecoder5x5, HyperEncoder5x5,
)
from neural_image_compression_tpu_torch.models.factorized_prior import FactorizedPrior
from neural_image_compression_tpu_torch.models.hyperprior import MeanScaleHyperprior
from neural_image_compression_tpu_torch.models.joint_ar import (
    HierarchicalModel, JointAutoregressiveHierarchical,
)
from neural_image_compression_tpu_torch.models.parameters import EntropyParameters

__all__ = ["CB_CTX_POSITIONS", "ChannelCheckerboardHierarchical", "CheckerboardContext",
           "CheckerboardHierarchical", "checkerboard_mask", "default_groups", "Decoder5x5",
           "Encoder5x5", "FactorizedPrior", "HyperDecoder5x5", "HyperEncoder5x5",
           "HierarchicalModel", "JointAutoregressiveHierarchical", "MeanScaleHyperprior",
           "EntropyParameters"]
