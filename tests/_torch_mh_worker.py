"""Worker of tests/test_torch_multiprocess.py: one rank of an N-rank gloo
group on the CPU (the port only; no JAX).

Each rank joins the group (``parallel.init_distributed``), then

1. trains ``FactorizedPrior(8)`` with the Trainer over a data mesh on its
   rows of each global batch (3 steps, validation every 2 on its rows of
   the validation batches, preemption-safe), and resumes 2 more steps from
   the checkpoint that rank 0 wrote;
2. records the noise ``RowShardNoise`` gives its rows;
3. with a mesh of "model" N (data 1): 2 tensor-parallel steps of
   ``make_train_step`` on the whole batch, the optimizer state's shard
   shapes and its gathered whole state, and ``make_eval_step``; then a
   tensor-parallel Trainer for 2 steps and a 1-step resume (whole optimizer
   state in the checkpoint, shards again after the load);
4. with a mesh of "spatial" N: ``make_eval_step(spatial=True)`` on its
   H-slab of an eval batch.

It writes ``result_<rank>.json`` and ``arrays_<rank>.npz`` under workdir.

Usage: python tests/_torch_mh_worker.py <rank> <nprocs> <port> <workdir>
"""

import json
import os
import sys

import numpy as np
import torch

from neural_image_compression_tpu_torch.models import FactorizedPrior, RowShardNoise
from neural_image_compression_tpu_torch.parallel import (
    init_distributed, make_eval_step, make_mesh, make_train_step, shard_batch, spatial_sharding,
)
from neural_image_compression_tpu_torch.train import Trainer, rd_loss, trainer as trainer_module
from neural_image_compression_tpu_torch.train.metrics_logger import NullLogger

M = 8
GLOBAL_BATCH = 8
TRAIN_STEPS, RESUME_STEPS = 3, 2


def global_batches():
    """The global training and validation batches (every rank makes them
    alike, then keeps its rows)."""
    rng = np.random.RandomState(0)
    train = rng.rand(3, GLOBAL_BATCH, 32, 32, 3).astype(np.float32)
    val = rng.rand(2, 4, 32, 32, 3).astype(np.float32)
    return list(train), list(val)


def trainer_kwargs(workdir, log_name):
    return dict(learning_rate=1e-4, seed=7, val_interval=2, preemption_safe=True,
                log_dir=os.path.join(workdir, log_name),
                checkpoint_path=os.path.join(workdir, "ckpt.pt"))


def tp_trainer_kwargs(workdir):
    return dict(learning_rate=1e-3, seed=8, log_dir=os.path.join(workdir, "runs_tp"),
                checkpoint_path=os.path.join(workdir, "ckpt_tp.pt"))


def tp_batch():
    return np.random.RandomState(1).rand(4, 32, 32, 3).astype(np.float32)


def eval_batch():
    return np.random.RandomState(2).rand(2, 64, 32, 3).astype(np.float32)


def tp_run(model, mesh, steps=2):
    """``steps`` clipped tensor-parallel (or, without a mesh, plain) steps
    with an EMA on tp_batch(); returns the step and the metrics."""
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(model, opt, rd_loss, 0.01, ema_decay=0.9, clip_grad_norm=1.0,
                           mesh=mesh)
    gen = torch.Generator().manual_seed(9)
    for _ in range(steps):
        metrics = step(tp_batch(), gen)
    return step, opt, metrics


def main():
    rank, nprocs, port, workdir = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                   sys.argv[4])
    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", nprocs, rank)
    init_distributed()  # a second call does nothing
    writes = []
    save = trainer_module.save_checkpoint
    trainer_module.save_checkpoint = lambda *a, **k: (writes.append(a[0]), save(*a, **k))

    mesh = make_mesh()
    train, val = global_batches()
    local_train = [shard_batch(b, mesh) for b in train]
    local_val = [shard_batch(b, mesh) for b in val]
    trainer = Trainer(FactorizedPrior(M, device="cpu"), local_train, val_loader=local_val,
                      max_steps=TRAIN_STEPS, mesh=mesh,
                      **trainer_kwargs(workdir, f"runs_{rank}"))
    null_logger = isinstance(trainer.logger, NullLogger)
    trainer.train()
    trainer = Trainer(FactorizedPrior(M, device="cpu", seed=1), local_train,
                      val_loader=local_val, max_steps=RESUME_STEPS, mesh=mesh, resume=True,
                      **trainer_kwargs(workdir, f"runs_{rank}"))
    trainer.train()
    arrays = {f"dp/{k}": v.numpy() for k, v in trainer.model.state_dict().items()}
    dp_step, dp_writes = trainer.step, len(writes)

    probe = torch.empty(2, 2, 2, M)
    arrays["noise"] = RowShardNoise(torch.Generator().manual_seed(3), rank, nprocs).draw(
        probe).numpy()

    mesh_tp = make_mesh(model=nprocs)
    model = FactorizedPrior(M, device="cpu", seed=2)
    step, opt, metrics = tp_run(model, mesh_tp)
    names = [n for n, _ in model.named_parameters()]
    shard_shapes = {n: list(opt.state[s]["exp_avg"].shape)
                    for n, s in zip(names, step.tensor_parallel.shards)}
    whole = step.tensor_parallel.optimizer_state_dict(opt)["state"]
    arrays.update({f"tp/{k}": v.numpy() for k, v in model.state_dict().items()})
    arrays.update({f"tp_ema/{k}": v.numpy() for k, v in step.ema_params.items()})
    arrays.update({f"tp_exp_avg/{n}": whole[i]["exp_avg"].numpy() for i, n in enumerate(names)})
    arrays["tp_loss"] = metrics["loss"].numpy()
    arrays["tp_x_hat"] = make_eval_step(model, mesh_tp)(tp_batch())["x_hat"].numpy()
    for steps, resume in ((2, False), (1, True)):
        trainer = Trainer(FactorizedPrior(M, device="cpu", seed=5), [tp_batch()], max_steps=steps,
                          resume=resume, mesh=mesh_tp, **tp_trainer_kwargs(workdir))
        trainer.train()
    arrays.update({f"tp_trainer/{k}": v.numpy() for k, v in trainer.model.state_dict().items()})

    mesh_sp = make_mesh(spatial=nprocs)
    model = FactorizedPrior(M, device="cpu", seed=4)
    slab = spatial_sharding(mesh_sp).local(torch.from_numpy(eval_batch()))
    out = make_eval_step(model, mesh_sp, spatial=True)(slab)
    arrays["sp_x_hat"] = out["x_hat"].numpy()
    arrays["sp_logp_y"] = out["logp_y"].numpy()

    np.savez(os.path.join(workdir, f"arrays_{rank}.npz"), **arrays)
    with open(os.path.join(workdir, f"result_{rank}.json"), "w") as f:
        json.dump({"rank": rank, "final_step": dp_step, "null_logger": null_logger,
                   "checkpoint_writes": dp_writes, "slab_shape": list(slab.shape),
                   "tp_shard_shapes": shard_shapes,
                   "mesh_dims": [list(mesh_tp.mesh_dim_names), list(mesh_sp.mesh_dim_names)]}, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
