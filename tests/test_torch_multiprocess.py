"""PyTorch port, data and tensor parallelism across real processes: two
ranks of a gloo group on the CPU (tests/_torch_mh_worker.py), each on its
share of every global batch, held against one process on the whole batch:

* the Trainer over a data mesh, 3 steps and a 2-step resume, equals the
  one-process Trainer on the global batches (Adam at the default 1e-4):
  every leaf within rel 1e-5 in L2 norm (JAX's test_multiprocess.py holds
  its runs' squared norm to rel 1e-5). The GDN gammas come closest (1.7e-6;
  at lr 1e-3, 1.5e-5, and 6e-8 for every other leaf): their off-diagonal
  entries sit at the reparametrization's lower bound, whose straight-through
  gate follows the sign of a gradient near 0, which the half batches' sums
  round otherwise; rank 1 logs nothing and writes no checkpoint, rank 0 writes and
  logs, both end at step 5, and the validation loss and bpp rank 0 logs
  equal the one-process run's (rel 1e-5);
* each rank's noise is its slice of the global batch's noise (exact);
* with a "model" dimension of 2, two clipped tensor-parallel steps with an
  EMA equal the unsharded steps (loss, weights, EMA and Adam's first moment
  gathered whole, each leaf within rel 1e-5 in L2 norm), each rank holds
  half of every leaf whose channels divide, the eval step equals the
  unsharded forward (rel 1e-5 of the largest value), and a tensor-parallel
  Trainer with a resume equals the one-process Trainer (rel 1e-5 in L2);
* with a "spatial" dimension of 2, the eval step on each rank's H-slab
  equals the unsharded forward (rel 1e-5 of the largest value).

Gloo's TCP connect deadline is not configurable from Python and a loaded
box can miss it: the run is retried once on those messages, never on a
wrong result.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_mh_worker as worker
from neural_image_compression_tpu_torch.models import FactorizedPrior
from neural_image_compression_tpu_torch.train import Trainer

torch.set_num_threads(1)

NPROCS = 2
_WORKER = os.path.join(os.path.dirname(__file__), "_torch_mh_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TRANSIENT = ("Connect timeout", "DEADLINE_EXCEEDED", "Gloo context initialization failed",
              "Connection reset by peer", "address already in use")
REL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(workdir, timeout=300, retries=1):
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for attempt in range(retries + 1):
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, _WORKER, str(rank), str(NPROCS), str(port),
                                   str(workdir)],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for rank in range(NPROCS)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0].decode())
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        if all(p.returncode == 0 for p in procs):
            break
        transient = any(t in out for out in outs for t in _TRANSIENT)
        if attempt == retries or not transient:
            for p, out in zip(procs, outs):
                assert p.returncode == 0, out
        for name in os.listdir(workdir):
            path = os.path.join(workdir, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
    results, arrays = {}, {}
    for rank in range(NPROCS):
        with open(os.path.join(workdir, f"result_{rank}.json")) as f:
            results[rank] = json.load(f)
        arrays[rank] = dict(np.load(os.path.join(workdir, f"arrays_{rank}.npz")))
    return results, arrays


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ranks")
    results, arrays = _run_workers(str(workdir))
    return str(workdir), results, arrays


def _close(got, want, msg=""):
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale, err_msg=msg)


def _leaf_close(got, want, msg=""):
    assert np.linalg.norm(got - want) <= REL * np.linalg.norm(want), msg


def _validation(log_dir):
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"].startswith("validation/"):
                out[(rec["tag"], rec["step"])] = rec["value"]
    return out


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The one-process Trainer on the global batches, 3 steps and a 2-step
    resume."""
    workdir = str(tmp_path_factory.mktemp("one"))
    train, val = worker.global_batches()
    kwargs = worker.trainer_kwargs(workdir, "runs")
    Trainer(FactorizedPrior(worker.M, device="cpu"), train, val_loader=val,
            max_steps=worker.TRAIN_STEPS, **kwargs).train()
    trainer = Trainer(FactorizedPrior(worker.M, device="cpu"), train, val_loader=val,
                      max_steps=worker.RESUME_STEPS, resume=True, **kwargs)
    trainer.train()
    return workdir, trainer


def test_two_rank_trainer_matches_one_process(ranks, one_process):
    _, results, arrays = ranks
    _, trainer = one_process
    for k, v in trainer.model.state_dict().items():
        for rank in range(NPROCS):
            _leaf_close(arrays[rank][f"dp/{k}"], v.numpy(), f"rank {rank}: {k}")
    assert [results[r]["final_step"] for r in range(NPROCS)] == [5, 5] and trainer.step == 5


def test_two_rank_logging_and_checkpoints(ranks, one_process):
    workdir, results, _ = ranks
    assert not results[0]["null_logger"] and results[1]["null_logger"]
    assert results[0]["checkpoint_writes"] == 2 and results[1]["checkpoint_writes"] == 0
    assert os.path.isfile(os.path.join(workdir, "ckpt.pt"))
    assert os.path.isdir(os.path.join(workdir, "runs_0"))
    assert not os.path.exists(os.path.join(workdir, "runs_1"))
    got, want = _validation(os.path.join(workdir, "runs_0")), _validation(
        os.path.join(one_process[0], "runs"))
    keys = [k for k in want if not k[0].endswith("psnr")]  # the ranks' mean PSNR is not global
    assert len(keys) == 6 and set(got) == set(want)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=REL, err_msg=str(k))


def test_each_rank_noise_is_its_slice_of_the_global_noise(ranks):
    _, _, arrays = ranks
    b = arrays[0]["noise"].shape[0]
    whole = torch.empty(b * NPROCS, *arrays[0]["noise"].shape[1:]).uniform_(
        -0.5, 0.5, generator=torch.Generator().manual_seed(3)).numpy()
    for rank in range(NPROCS):
        np.testing.assert_array_equal(arrays[rank]["noise"], whole[rank * b:(rank + 1) * b])
    assert not np.array_equal(arrays[0]["noise"], arrays[1]["noise"])


@pytest.fixture(scope="module")
def unsharded_tp():
    model = FactorizedPrior(worker.M, device="cpu", seed=2)
    step, opt, metrics = worker.tp_run(model, None)
    x_hat = model(torch.from_numpy(worker.tp_batch()), training=False)["x_hat"]
    return model, step, opt, metrics, x_hat


def test_tensor_parallel_train_matches_unsharded(ranks, unsharded_tp):
    _, results, arrays = ranks
    model, step, opt, metrics, _ = unsharded_tp
    assert results[0]["mesh_dims"][0] == ["data", "model"]
    for rank in range(NPROCS):
        a = arrays[rank]
        _close(a["tp_loss"], metrics["loss"].numpy(), "loss")
        for k, v in model.state_dict().items():
            _leaf_close(a[f"tp/{k}"], v.numpy(), k)
        for k, v in step.ema_params.items():
            _leaf_close(a[f"tp_ema/{k}"], v.numpy(), f"ema {k}")
        for k, p in model.named_parameters():
            _leaf_close(a[f"tp_exp_avg/{k}"], opt.state[p]["exp_avg"].numpy(), f"exp_avg {k}")


def test_tensor_parallel_trainer_resumes_as_one_process(ranks, tmp_path):
    """The checkpoint holds the whole optimizer state; each rank takes its
    shards of it, and of the weights, again on resume."""
    _, _, arrays = ranks
    for steps, resume in ((2, False), (1, True)):
        trainer = Trainer(FactorizedPrior(worker.M, device="cpu", seed=5), [worker.tp_batch()],
                          max_steps=steps, resume=resume,
                          **worker.tp_trainer_kwargs(str(tmp_path)))
        trainer.train()
    assert trainer.step == 3
    for k, v in trainer.model.state_dict().items():
        for rank in range(NPROCS):
            _leaf_close(arrays[rank][f"tp_trainer/{k}"], v.numpy(), f"rank {rank}: {k}")


def test_tensor_parallel_keeps_shards(ranks, unsharded_tp):
    _, results, _ = ranks
    model = unsharded_tp[0]
    shapes = results[0]["tp_shard_shapes"]
    assert shapes == results[1]["tp_shard_shapes"]
    whole = {k: list(p.shape) for k, p in model.named_parameters()}
    assert shapes["encoder.Conv2d_0.weight"] == [worker.M // 2, 3, 5, 5]  # output channels
    assert shapes["encoder.GDN_0.gamma"] == [worker.M, worker.M // 2]     # output columns
    assert shapes["decoder.Deconv2d_0.weight"] == [worker.M, worker.M // 2, 5, 5]
    assert shapes["decoder.Deconv2d_3.weight"] == whole["decoder.Deconv2d_3.weight"]  # RGB
    bottleneck = [k for k in shapes if k.startswith("factorized_entropy_model.")]
    assert bottleneck and all(shapes[k][0] == worker.M // 2 for k in bottleneck)


def test_tensor_parallel_eval_matches_unsharded(ranks, unsharded_tp):
    _, _, arrays = ranks
    for rank in range(NPROCS):
        _close(arrays[rank]["tp_x_hat"], unsharded_tp[4].numpy(), "x_hat")


def test_spatial_eval_matches_unsharded(ranks):
    _, results, arrays = ranks
    b, h, w, _ = worker.eval_batch().shape
    assert results[0]["mesh_dims"][1] == ["data", "spatial"]
    assert results[0]["slab_shape"] == [b, h // NPROCS, w, 3]
    want = FactorizedPrior(worker.M, device="cpu", seed=4)(
        torch.from_numpy(worker.eval_batch()), training=False)
    for rank in range(NPROCS):
        _close(arrays[rank]["sp_x_hat"], want["x_hat"].numpy(), "x_hat")
        _close(arrays[rank]["sp_logp_y"], want["logp_y"].numpy(), "logp_y")
