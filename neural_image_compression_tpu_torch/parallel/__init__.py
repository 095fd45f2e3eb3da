from neural_image_compression_tpu_torch.parallel.train_step import (
    clip_by_global_norm, make_train_step,
)

__all__ = ["clip_by_global_norm", "make_train_step"]
