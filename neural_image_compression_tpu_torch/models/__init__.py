from neural_image_compression_tpu_torch.models.components import (
    Decoder5x5, Encoder5x5, HyperDecoder5x5, HyperEncoder5x5,
)
from neural_image_compression_tpu_torch.models.joint_ar import JointAutoregressiveHierarchical
from neural_image_compression_tpu_torch.models.parameters import EntropyParameters

__all__ = ["Decoder5x5", "Encoder5x5", "HyperDecoder5x5", "HyperEncoder5x5",
           "JointAutoregressiveHierarchical", "EntropyParameters"]
