from neural_image_compression_tpu_torch.data.datasets import (
    BatchLoader, ImageFolderDataset, KodakDataset, PreprocessedDataset,
    center_crop, load_image, pad_to_multiple, shard_for_process,
)
from neural_image_compression_tpu_torch.data.preprocess import (
    add_quantization_noise, is_saturated, preprocess_images, random_downsample_crop,
)
from neural_image_compression_tpu_torch.data.coco import download_coco_subset

__all__ = ["BatchLoader", "ImageFolderDataset", "KodakDataset", "PreprocessedDataset",
           "center_crop", "load_image", "pad_to_multiple", "shard_for_process",
           "add_quantization_noise", "is_saturated", "preprocess_images",
           "random_downsample_crop", "download_coco_subset"]
