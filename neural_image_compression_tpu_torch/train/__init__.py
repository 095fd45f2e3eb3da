from neural_image_compression_tpu_torch.parallel.train_step import make_train_step
from neural_image_compression_tpu_torch.train.loss import rd_loss

__all__ = ["make_train_step", "rd_loss"]
