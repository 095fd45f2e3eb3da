"""PyTorch port, the flagship's training step, held against the JAX package's
on the same weights (carried across with load_jax_params) and the same
noise (CPU, M=16, 64x128): the training forward, rd_loss and every
parameter's gradient, Adam, a 3-step trajectory of make_train_step, its EMA,
and its batch contract.

JAX draws its noise inside the model from make_rng("noise"), split into
(rng_z, rng_y) (models/joint_ar.py:114-117). The test draws the same numbers
from the same key and hands them to the port by replacing the port's
noise_quantize, so both packages see one noise."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_image_compression_tpu.models import JointAutoregressiveHierarchical as JModel
from neural_image_compression_tpu.parallel.train_step import make_train_step as jmake_train_step
from neural_image_compression_tpu.train.loss import rd_loss as jrd_loss
from neural_image_compression_tpu_torch.models import JointAutoregressiveHierarchical, joint_ar
from neural_image_compression_tpu_torch.parallel import make_train_step
from neural_image_compression_tpu_torch.train import rd_loss
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_state_from_jax, load_jax_params,
)
from test_torch_joint_ar import _assert_forward_close, _gained

torch.set_num_threads(1)

M = 16
SEED = 0
LAMBDA = 0.005
SHAPE = (2, 64, 128, 3)
TRAJECTORY_STEPS = 3
EMA_DECAY = 0.99


def _batch():
    return np.random.default_rng(SEED).uniform(size=SHAPE).astype(np.float32)


def _jax_noise(jmodel, params, key, x):
    """The (z, y) noise the JAX model draws in a training apply with
    rngs={"noise": key}, as numpy arrays, in the port's draw order."""
    rng = jmodel.bind({"params": params}, rngs={"noise": key}).make_rng("noise")
    rng_z, rng_y = jax.random.split(rng)
    b, h, w, _ = x.shape
    z = jax.random.uniform(rng_z, (b, h // 64, w // 64, M), jnp.float32, -0.5, 0.5)
    y = jax.random.uniform(rng_y, (b, h // 16, w // 16, M), jnp.float32, -0.5, 0.5)
    return [np.asarray(z), np.asarray(y)]


def _feed_noise(monkeypatch, noises):
    """The port's noise_quantize adds the given arrays, in order."""
    it = iter(noises)
    monkeypatch.setattr(joint_ar, "noise_quantize",
                        lambda v, generator=None: v + torch.tensor(next(it), device=v.device))
    return it


def _port_model(K, params):
    model = JointAutoregressiveHierarchical(M, K, device="cpu")
    return load_jax_params(model, params)


def _torch_adam(model):
    return torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)


@pytest.fixture(scope="module", params=[1, 3], ids=["K1", "K3"])
def jax_grads(request):
    """(K, x, params, noise, JAX training outputs, rd_loss metrics, grads)."""
    K = request.param
    x = _batch()
    jmodel = JModel(latent_channels=M, K=K)
    key = jax.random.PRNGKey(SEED)
    params = _gained(jmodel.init({"params": key, "noise": key}, jnp.asarray(x),
                                 training=True)["params"])
    noise_key = jax.random.PRNGKey(SEED + 1)

    @jax.jit
    def value_and_grad(p, xb):
        def loss_fn(q):
            out = jmodel.apply({"params": q}, xb, training=True, rngs={"noise": noise_key})
            metrics = jrd_loss(out, xb, LAMBDA)
            return metrics["loss"], (metrics, out)
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (_, (metrics, out)), grads = value_and_grad(params, jnp.asarray(x))
    noise = _jax_noise(jmodel, params, noise_key, x)
    out = {k: np.asarray(v) for k, v in out.items() if k != "training"}
    # the noise reproduces the JAX model's: z_in = z + noise exactly
    np.testing.assert_array_equal(out["z"].astype(np.float32) + noise[0], out["z_in"])
    np.testing.assert_array_equal(out["y"].astype(np.float32) + noise[1], out["y_in"])
    return (K, x, params, noise, out, {k: np.asarray(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def _port_forward_backward(monkeypatch, K, x, params, noise):
    model = _port_model(K, params)
    _feed_noise(monkeypatch, noise)
    xt = torch.from_numpy(x)
    out = model(xt, training=True)
    metrics = rd_loss(out, xt, LAMBDA)
    metrics["loss"].backward()
    return model, out, metrics


def test_training_forward_matches_jax(monkeypatch, jax_grads):
    K, x, params, noise, want, _, _ = jax_grads
    _, out, _ = _port_forward_backward(monkeypatch, K, x, params, noise)
    assert out["training"] is True
    got = {k: v.detach().numpy() for k, v in out.items() if k != "training"}
    assert set(got) == set(want)
    for k in ("y_in", "z_in", "logp_y", "logp_z"):
        assert got[k].dtype == np.float32, k
    _assert_forward_close(got, want, K, rounded=False)


def test_rd_loss_and_every_gradient_match_jax(monkeypatch, jax_grads):
    """rtol 1e-3 and atol 1e-5 * max|leaf|: the float32 sums of the forward
    and backward run in other orders through about 20 layers."""
    K, x, params, noise, _, want_metrics, want_grads = jax_grads
    model, _, metrics = _port_forward_backward(monkeypatch, K, x, params, noise)
    for k in ("loss", "bpp_y", "bpp_z", "mse"):
        np.testing.assert_allclose(metrics[k].item(), float(want_metrics[k]), rtol=1e-5,
                                   err_msg=k)
    want = joint_ar_state_from_jax(want_grads)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert p.grad is not None, f"{name}: no gradient reached it"
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3, atol=1e-5 * scale, err_msg=name)


def test_adam_matches_optax():
    rng = np.random.default_rng(3)
    shapes = [(5, 3), (7,), (2, 3, 4)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(scale=10.0 ** rng.uniform(-6, 1), size=s).astype(np.float32)
              for s in shapes] for _ in range(3)]
    tx = optax.adam(1e-4)
    jparams = [jnp.asarray(a) for a in init]
    state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = torch.optim.Adam(tparams, lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    for step_grads in grads:
        updates, state = tx.update([jnp.asarray(g) for g in step_grads], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, step_grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, w in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-5)


@pytest.fixture(scope="module")
def jax_trajectory():
    """JAX's make_train_step (with its EMA) for 3 steps at K=3: the losses,
    the EMA after step 1, and each step's noise."""
    x = _batch()
    jmodel = JModel(latent_channels=M, K=3)
    key = jax.random.PRNGKey(SEED)
    params = _gained(jmodel.init({"params": key, "noise": key}, jnp.asarray(x),
                                 training=True)["params"])
    tx = optax.adam(1e-4)
    step = jmake_train_step(jmodel, tx, jrd_loss, LAMBDA, donate=False, ema_decay=EMA_DECAY)
    p, opt_state, ema = params, tx.init(params), jax.tree.map(jnp.array, params)
    losses, noises, ema_after_1 = [], [], None
    for i in range(TRAJECTORY_STEPS):
        rng = jax.random.PRNGKey(100 + i)
        noises += _jax_noise(jmodel, p, rng, x)
        p, opt_state, ema, metrics = step(p, opt_state, ema, jnp.asarray(x), rng)
        losses.append(float(metrics["loss"]))
        if i == 0:
            ema_after_1 = jax.tree.map(np.asarray, ema)
    return x, params, noises, losses, ema_after_1


def test_train_step_trajectory_matches_jax(monkeypatch, jax_trajectory):
    x, params, noises, want_losses, _ = jax_trajectory
    model = _port_model(3, params)
    step = make_train_step(model, _torch_adam(model), rd_loss, LAMBDA)
    _feed_noise(monkeypatch, noises)
    losses = []
    for _ in range(TRAJECTORY_STEPS):
        metrics = step(x)
        assert not metrics["loss"].requires_grad
        assert all(p.grad is None for p in model.parameters())  # zero_grad(set_to_none)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert losses[-1] != losses[0]


def test_train_step_ema_matches_jax(monkeypatch, jax_trajectory):
    x, params, noises, _, want_ema = jax_trajectory
    model = _port_model(3, params)
    step = make_train_step(model, _torch_adam(model), rd_loss, LAMBDA, ema_decay=EMA_DECAY)
    before = {k: v.clone() for k, v in step.ema_params.items()}
    _feed_noise(monkeypatch, noises)
    step(x)
    want = joint_ar_state_from_jax(want_ema)
    assert set(step.ema_params) == set(want)
    moved = 0
    for name, e in step.ema_params.items():
        # after one Adam step |p - p0| <= 1e-4, so the EMA moves by at most
        # 1e-6: held to 1e-9 beside it
        np.testing.assert_allclose(e.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
        moved += int(not torch.equal(e, before[name]))
        param = dict(model.named_parameters())[name]
        expected = before[name] + (1 - EMA_DECAY) * (param.detach() - before[name])
        torch.testing.assert_close(e, expected, rtol=1e-6, atol=1e-9)
    assert moved > 0.9 * len(want)


@pytest.mark.parametrize("decay", [0.0, 1.0, -0.5, 1.5])
def test_ema_decay_outside_open_unit_interval_raises(decay):
    model = JointAutoregressiveHierarchical(8, 3, device="cpu")
    with pytest.raises(ValueError, match="ema_decay"):
        make_train_step(model, _torch_adam(model), rd_loss, LAMBDA, ema_decay=decay)


def test_train_step_accepts_uint8_batches(monkeypatch):
    x8 = np.random.default_rng(4).integers(0, 256, size=(1, 64, 64, 3), dtype=np.uint8)
    noise_rng = np.random.default_rng(5)
    noise = [noise_rng.uniform(-0.5, 0.5, size=s).astype(np.float32)
             for s in ((1, 1, 1, 8), (1, 4, 4, 8))]
    results = []
    for batch in (x8, x8.astype(np.float32) / 255.0):
        model = JointAutoregressiveHierarchical(8, 3, device="cpu", seed=1)
        step = make_train_step(model, _torch_adam(model), rd_loss, LAMBDA)
        _feed_noise(monkeypatch, noise)
        results.append((step(batch), [p.detach().clone() for p in model.parameters()]))
    (m8, p8), (mf, pf) = results
    for k in ("loss", "bpp_total", "mse"):
        torch.testing.assert_close(m8[k], mf[k], rtol=1e-6, atol=0)
    for a, b in zip(p8, pf):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
