"""PyTorch port, ``parallel`` in one process (CPU): the mesh's shape and
errors, ``init_distributed``, the layouts, the tensor-parallel rule
against the JAX package's (``parallel/tp.py``'s ``_leaf_spec``) leaf by
leaf, a one-rank gloo mesh step against the step without a mesh (bit for
bit: the all-reduce of one rank is a copy), the one-rank eval step,
``data.shard_for_process`` against JAX's, and the Trainer's and
``lambda_sweep``'s mesh plumbing. The two-rank runs are in
test_torch_multiprocess.py.
"""

import datetime
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from neural_image_compression_tpu.data.datasets import shard_for_process as jshard_for_process
from neural_image_compression_tpu.parallel.mesh import make_mesh as jmake_mesh
from neural_image_compression_tpu.parallel.tp import _leaf_spec as jleaf_spec
from neural_image_compression_tpu_torch.data import shard_for_process
from neural_image_compression_tpu_torch.models import (
    FactorizedPrior, JointAutoregressiveHierarchical,
)
from neural_image_compression_tpu_torch.parallel import (
    batch_sharding, init_distributed, make_eval_step, make_mesh, make_train_step, mesh,
    mesh_shape, replicate, replicated, shard_batch, shard_params, spatial_sharding, tp,
    tp_shardings,
)
from neural_image_compression_tpu_torch.train import Trainer, rd_loss, sweep, trainer
from neural_image_compression_tpu_torch.utils.weights import _to_jax

torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# --- before any process group -----------------------------------------------

@pytest.mark.parametrize("n,spatial,model", [(8, 1, 1), (8, 2, 1), (8, 1, 2), (8, 2, 2),
                                             (8, 4, 2), (1, 1, 1), (6, 3, 1)])
def test_mesh_shape_matches_jax(n, spatial, model):
    want = jmake_mesh(n_devices=None, spatial=spatial, model=model,
                      devices=[object()] * n)
    shape, names = mesh_shape(n, spatial, model)
    assert names == tuple(want.axis_names)
    assert shape == tuple(want.devices.shape)


def test_mesh_shape_raises_as_jax_does():
    with pytest.raises(ValueError, match="not divisible") as port:
        mesh_shape(6, 4)
    with pytest.raises(ValueError, match="not divisible") as jax_error:
        jmake_mesh(spatial=4, devices=[object()] * 6)
    assert str(port.value) == str(jax_error.value)


def test_without_a_group():
    assert not dist.is_initialized()
    init_distributed()  # no WORLD_SIZE in the environment: one process, nothing to join
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh()
    with pytest.raises(ValueError, match="go together"):
        init_distributed("localhost:1234")


def test_explicit_coordinator_that_never_answers_raises(monkeypatch):
    """Rank 1 of 2 with no rank 0 listening: the connect fails and raises
    (a rank must not go on alone)."""
    monkeypatch.setattr(mesh, "INIT_TIMEOUT", datetime.timedelta(seconds=2))
    with pytest.raises((RuntimeError, dist.DistError)):
        init_distributed(f"localhost:{_free_port()}", 2, 1)
    assert not dist.is_initialized()


def test_shard_for_process_matches_jax():
    items = [f"img_{i}.png" for i in range(11)]
    arr = np.arange(22).reshape(11, 2)

    class Dataset:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return i * 10

    for pc in (1, 2, 3):
        for pi in range(pc):
            assert shard_for_process(items, pi, pc) == jshard_for_process(items, pi, pc)
            np.testing.assert_array_equal(shard_for_process(arr, pi, pc),
                                          jshard_for_process(arr, pi, pc))
            got, want = shard_for_process(Dataset(), pi, pc), jshard_for_process(Dataset(), pi, pc)
            assert len(got) == len(want) and [got[i] for i in range(len(got))] == [
                want[i] for i in range(len(want))]
    # no group: rank 0 of 1, as JAX's one process
    assert shard_for_process(items) == jshard_for_process(items) == items
    for bad in ((2, 2), (-1, 2)):
        with pytest.raises(ValueError) as port:
            shard_for_process(items, *bad)
        with pytest.raises(ValueError) as jax_error:
            jshard_for_process(items, *bad)
        assert str(port.value) == str(jax_error.value)


def _value_axis(t: np.ndarray):
    """The one axis along which t varies (None if it is constant)."""
    axes = [a for a in range(t.ndim) if t.shape[a] > 1
            and not np.all(np.diff(t, axis=a) == 0)]
    assert len(axes) <= 1
    return axes[0] if axes else None


@pytest.mark.parametrize("family", ["joint_ar", "factorized"])
def test_channel_axis_is_the_jax_rules_axis(family):
    """Each leaf's sharded axis, read in the port's layout, is the axis the
    JAX rule shards in JAX's layout: a leaf filled with its index along the
    port's axis varies, once carried to the JAX layout, along JAX's."""
    model = (JointAutoregressiveHierarchical(8, 3, device="cpu") if family == "joint_ar"
             else FactorizedPrior(8, device="cpu"))
    checked = 0
    for key, p in model.named_parameters():
        axis = tp.channel_axis(key, p.shape)
        port_sharded = axis is not None and p.shape[axis] % 2 == 0
        index = np.zeros(p.shape, np.float32)
        if axis is not None:
            shape = [1] * p.dim()
            shape[axis] = p.shape[axis]
            index = index + np.arange(p.shape[axis], dtype=np.float32).reshape(shape)
        _, jax_value = _to_jax(key, index)
        path = key.replace(".", "/")
        spec = tuple(jleaf_spec(path, jax_value.shape, 2))
        jax_axis = spec.index("model") if "model" in spec else None
        assert port_sharded == (jax_axis is not None), key
        if jax_axis is not None:
            assert _value_axis(jax_value) == jax_axis, key
            checked += 1
    assert checked > 10


def test_trainer_refuses_many_processes_without_a_mesh(monkeypatch):
    monkeypatch.setattr(trainer, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="needs a mesh"):
        Trainer(FactorizedPrior(4, device="cpu"), [np.zeros((1, 16, 16, 3), np.float32)],
                checkpoint_path=None, log_dir="unused")


def test_lambda_sweep_passes_the_mesh(monkeypatch):
    seen = []

    class Stop(Exception):
        pass

    def fake_trainer(*args, **kwargs):
        seen.append(kwargs["mesh"])
        raise Stop

    monkeypatch.setattr(trainer, "Trainer", fake_trainer)
    sentinel = object()
    with pytest.raises(Stop):
        sweep.lambda_sweep(lambda: None, [], [], [0.01], 1, mesh=sentinel, out_dir="unused")
    assert seen == [sentinel]


# --- a one-rank gloo group ----------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    init_distributed(f"localhost:{_free_port()}", 1, 0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_and_layouts(one_rank):
    init_distributed(f"localhost:{_free_port()}", 1, 0)  # a second call does nothing
    assert dist.get_backend() == "gloo" and one_rank.mesh_dim_names == ("data",)
    assert make_mesh(n_devices=1).mesh_dim_names == ("data",)
    with pytest.raises(ValueError, match="one device each"):
        make_mesh(n_devices=2)
    assert batch_sharding(one_rank).placements == (Shard(0),)
    assert spatial_sharding(one_rank).placements == (Shard(0),)  # no "spatial": the batch only
    assert replicated(one_rank).placements == (Replicate(),)
    batch = np.arange(24, dtype=np.float32).reshape(2, 2, 2, 3)
    np.testing.assert_array_equal(shard_batch(batch, one_rank).numpy(), batch)
    state = FactorizedPrior(4, device="cpu").state_dict()
    layouts = tp_shardings(state, one_rank)  # no "model" dimension: all replicated
    assert all(s.placements == (Replicate(),) for s in layouts.values())
    shards = shard_params(state, one_rank)
    assert all(torch.equal(shards[k], v) for k, v in state.items())


def test_replicate_keeps_rank_zeros_weights(one_rank):
    model = FactorizedPrior(4, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert replicate(model, one_rank) is model
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("levels", [None, (0.002, 0.02)], ids=["fixed", "gained"])
def test_one_rank_mesh_step_equals_step_without_mesh(one_rank, levels):
    """Bit for bit: clipping, EMA and Adam over 3 steps (a gained model
    draws its level from the shared generator too)."""
    from neural_image_compression_tpu_torch.models import GainedJointAR

    def build():
        if levels is None:
            return JointAutoregressiveHierarchical(8, 3, device="cpu", seed=1)
        return GainedJointAR(8, 3, levels, device="cpu", seed=1)

    rng = np.random.default_rng(0)
    batches = [rng.uniform(size=(2, 64, 64, 3)).astype(np.float32) for _ in range(3)]
    runs = []
    for mesh_arg in (None, one_rank):
        model = build()
        opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
        step = make_train_step(model, opt, rd_loss, 0.01, ema_decay=0.9, clip_grad_norm=0.5,
                               levels=levels, mesh=mesh_arg)
        gen = torch.Generator().manual_seed(5)
        metrics = [step(b, gen) for b in batches]
        runs.append((model, step, metrics))
    (m0, s0, metrics0), (m1, s1, metrics1) = runs
    for k, v in m0.state_dict().items():
        assert torch.equal(m1.state_dict()[k], v), k
    for k, v in s0.ema_params.items():
        assert torch.equal(s1.ema_params[k], v), k
    for a, b in zip(metrics0, metrics1):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_mesh_step_needs_the_generator(one_rank):
    model = FactorizedPrior(4, device="cpu")
    step = make_train_step(model, torch.optim.Adam(model.parameters()), rd_loss, 0.01,
                           mesh=one_rank)
    with pytest.raises(ValueError, match="noise generator"):
        step(np.zeros((1, 16, 16, 3), np.float32))


@pytest.mark.parametrize("spatial", [False, True])
def test_one_rank_eval_step(one_rank, spatial):
    model = FactorizedPrior(4, device="cpu")
    x = np.random.default_rng(1).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    got = make_eval_step(model, one_rank, spatial=spatial)(shard_batch(x, one_rank))
    want = model(torch.from_numpy(x), training=False)
    for k in ("x_hat", "y_in", "logp_y"):
        assert torch.equal(got[k], want[k]), k
    assert got["training"] is False
    u8 = (x * 255).astype(np.uint8)
    torch.testing.assert_close(make_eval_step(model)(u8)["x_hat"],
                               model(torch.from_numpy(u8).float() / 255.0,
                                     training=False)["x_hat"], rtol=0, atol=0)


def test_one_rank_trainer_with_mesh(one_rank, tmp_path):
    """A one-rank mesh Trainer equals the Trainer without a mesh (bit for
    bit) and keeps the one-process diagnostics and logging."""
    rng = np.random.default_rng(2)
    train = [rng.uniform(size=(2, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    models = []
    for name, mesh_arg in (("plain", None), ("mesh", one_rank)):
        t = Trainer(FactorizedPrior(4, device="cpu"), train, max_steps=3, seed=3,
                    preemption_safe=True, mesh=mesh_arg, log_dir=str(tmp_path / name),
                    checkpoint_path=str(tmp_path / f"{name}.pt"))
        assert not isinstance(t.logger, trainer.NullLogger)
        models.append(t.train())
    for k, v in models[0].state_dict().items():
        assert torch.equal(models[1].state_dict()[k], v), k
    assert (tmp_path / "mesh.pt").is_file()
