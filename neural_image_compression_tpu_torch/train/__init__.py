from neural_image_compression_tpu_torch.parallel.train_step import make_train_step
from neural_image_compression_tpu_torch.train import loss
from neural_image_compression_tpu_torch.train.loss import msssim_rd_loss, rd_loss, vision_rd_loss
from neural_image_compression_tpu_torch.train.metrics_logger import MetricsLogger, NullLogger
from neural_image_compression_tpu_torch.train.schedulers import ReduceLROnPlateau, cosine_lr
from neural_image_compression_tpu_torch.train.sweep import (
    gained_rd_curve, interp_lambda, lambda_sweep, plot_rd_curve, vmapped_lambda_sweep,
)
from neural_image_compression_tpu_torch.train.trainer import Trainer

__all__ = ["loss", "make_train_step", "rd_loss", "msssim_rd_loss", "vision_rd_loss", "Trainer",
           "ReduceLROnPlateau", "cosine_lr", "MetricsLogger", "NullLogger", "gained_rd_curve",
           "interp_lambda", "lambda_sweep", "plot_rd_curve", "vmapped_lambda_sweep"]
