from neural_image_compression_tpu_torch.train.loss import rd_loss

__all__ = ["rd_loss"]
