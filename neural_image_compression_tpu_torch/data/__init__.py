from neural_image_compression_tpu_torch.data.datasets import (
    BatchLoader, ImageFolderDataset, KodakDataset, PreprocessedDataset,
    center_crop, load_image, pad_to_multiple, shard_for_process,
)

__all__ = ["BatchLoader", "ImageFolderDataset", "KodakDataset", "PreprocessedDataset",
           "center_crop", "load_image", "pad_to_multiple", "shard_for_process"]
