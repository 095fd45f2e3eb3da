from neural_image_compression_tpu_torch.parallel.train_step import make_train_step

__all__ = ["make_train_step"]
