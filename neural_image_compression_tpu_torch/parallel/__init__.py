from neural_image_compression_tpu_torch.parallel.mesh import (
    Sharding, batch_sharding, init_distributed, make_mesh, mesh_shape, process_count,
    process_index, replicated, spatial_sharding,
)
from neural_image_compression_tpu_torch.parallel.tp import shard_params, tp_shardings
from neural_image_compression_tpu_torch.parallel.train_step import (
    clip_by_global_norm, make_eval_step, make_train_step, replicate, shard_batch,
)

__all__ = ["make_mesh", "init_distributed", "batch_sharding", "spatial_sharding", "replicated",
           "make_train_step", "make_eval_step", "shard_batch", "replicate",
           "shard_params", "tp_shardings", "clip_by_global_norm", "mesh_shape", "Sharding",
           "process_index", "process_count"]
