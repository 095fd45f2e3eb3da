"""PyTorch port, the hand kernels' wrappers under ``torch.func`` and
``train.vmapped_lambda_sweep`` (CPU, where the wrappers run their plain
versions):

* ``torch.func.vmap(torch.func.grad(...))`` through ``gdn`` and
  ``gmm_logp`` against a loop over the replicas, with gamma/beta shared and
  batched, and how many times the vmap rules call the kernel entry
  (one call with the rows folded, or one a replica);
* the sweep against the JAX package's ``vmapped_lambda_sweep`` on
  ``FactorizedPrior(latent_channels=4)`` for 2 steps, JAX's stacked init
  carried over (``utils.weights.stacked_state_from_jax``) and its noise and
  flip bits fed in, plain, with clipping, and with ``augment`` on square and
  non-square batches;
* each replica of the sweep against its own ``make_train_step`` run from
  the same weights and noise (the flagship family at M=8, K=3).

Tolerances: vmap against the loop 1e-6 relative (the same float32 ops in
another batching); the sweep's losses against JAX rtol 1e-4 as
test_torch_train.py's trajectory; its parameters' updates (about
lr * sign(g) an element and step, Adam's first steps) all within 0.2 lr of
JAX's and all but one in a thousand within 2e-3 lr, two float32 steps of a
weight near 1: where a gradient is near 0, the two packages' sums in other
orders move its update more (0.1 lr for one element of one replica here);
each replica against its separate run rel 1e-5 of the leaf's largest
value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the JAX sweep's optimizer)
import pytest
import torch
from torch.func import grad, vmap

from neural_image_compression_tpu.models import FactorizedPrior as JFactorized
from neural_image_compression_tpu.train.sweep import vmapped_lambda_sweep as jvmapped_lambda_sweep
from neural_image_compression_tpu_torch.models import (
    FactorizedPrior, JointAutoregressiveHierarchical,
)
from neural_image_compression_tpu_torch.ops.kernels import gdn_kernel, gmm_kernel
from neural_image_compression_tpu_torch.parallel import make_train_step
from neural_image_compression_tpu_torch.train import rd_loss, sweep, vmapped_lambda_sweep
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_state_from_jax, stacked_state_from_jax, stacked_state_to_jax,
)

torch.set_num_threads(1)

L, N, C, K = 3, 40, 12, 3
LAMBDAS = (0.002, 0.02, 0.2)
LR = 1e-4
SWEEP_STEPS = 2


def _rel_close(got, want, rel):
    scale = float(want.abs().max()) or 1.0
    torch.testing.assert_close(got, want, rtol=0, atol=rel * scale)


def _gdn_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(L, N, C)).astype(np.float32))
    gamma = torch.from_numpy(np.abs(rng.normal(0, 0.1, (L, C, C))).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(0.5, 1.5, (L, C)).astype(np.float32))
    return x, gamma, beta


def _count_calls(monkeypatch, module, name):
    calls = []
    inner = getattr(module, name)

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return inner(*args)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("inverse", [False, True])
def test_vmap_grad_through_gdn_with_batched_gamma(monkeypatch, inverse):
    x, gamma, beta = _gdn_inputs()
    fwd = _count_calls(monkeypatch, gdn_kernel, "_forward")
    bwd = _count_calls(monkeypatch, gdn_kernel, "gdn_backward")

    def loss(x, gamma, beta):
        return (gdn_kernel.gdn(x, gamma, beta, inverse) ** 2).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2)))(x, gamma, beta)
    # one kernel call a replica, forward and backward: each has its own gamma/beta
    assert fwd == [(N, C)] * L and bwd == [(N, C)] * L
    for i in range(L):
        want = grad(loss, argnums=(0, 1, 2))(x[i], gamma[i], beta[i])
        for g, w in zip(got, want):
            _rel_close(g[i], w, 1e-6)


@pytest.mark.parametrize("inverse", [False, True])
def test_vmap_grad_through_gdn_with_shared_gamma(monkeypatch, inverse):
    """Shared gamma/beta and dx alone: the replicas' rows fold into one call
    each way."""
    x, gamma, beta = _gdn_inputs(1)
    fwd = _count_calls(monkeypatch, gdn_kernel, "_forward")
    bwd = _count_calls(monkeypatch, gdn_kernel, "gdn_backward")

    def loss(x):
        return (gdn_kernel.gdn(x, gamma[0], beta[0], inverse) ** 3).sum()

    got = vmap(grad(loss))(x)
    assert fwd == [(L * N, C)] and bwd == [(L * N, C)]
    for i in range(L):
        _rel_close(got[i], grad(loss)(x[i]), 1e-6)


def test_vmap_grad_of_shared_gamma_is_per_replica(monkeypatch):
    """Per-replica gradients of a shared gamma (a replica axis on x only):
    the backward runs once a replica, so no replica's dgamma sums another's."""
    x, gamma, beta = _gdn_inputs(2)
    bwd = _count_calls(monkeypatch, gdn_kernel, "gdn_backward")

    def loss(gamma, x):
        return gdn_kernel.gdn(x, gamma, beta[0]).sum()

    got = vmap(grad(loss), in_dims=(None, 0))(gamma[0], x)
    assert bwd == [(N, C)] * L
    for i in range(L):
        _rel_close(got[i], grad(loss)(gamma[0], x[i]), 1e-6)


def _mixture_inputs(seed=3):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(np.round(rng.normal(0, 2, (L, N, C))).astype(np.float32))
    w = torch.softmax(torch.from_numpy(rng.normal(size=(L, N, K, C)).astype(np.float32)), 2)
    mus = torch.from_numpy(rng.normal(0, 2, (L, N, K, C)).astype(np.float32))
    sigmas = torch.from_numpy(rng.uniform(0.2, 3.0, (L, N, K, C)).astype(np.float32))
    return y, w, mus, sigmas


def test_vmap_grad_through_gmm_folds_replicas(monkeypatch):
    y, w, mus, sigmas = _mixture_inputs()
    fwd = _count_calls(monkeypatch, gmm_kernel, "_forward")
    bwd = _count_calls(monkeypatch, gmm_kernel, "_launch_backward")

    def loss(y, w, mus, sigmas):
        return gmm_kernel.gmm_logp(y, w, mus, sigmas).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2, 3)))(y, w, mus, sigmas)
    assert fwd == [(L * N, C)] and bwd == [(L * N, C)]  # one call for all replicas
    for i in range(L):
        want = grad(loss, argnums=(0, 1, 2, 3))(y[i], w[i], mus[i], sigmas[i])
        for g, ww in zip(got, want):
            _rel_close(g[i], ww, 1e-6)


def test_vmap_gmm_with_shared_parameters():
    """An input without a replica axis is expanded to every replica."""
    y, w, mus, sigmas = _mixture_inputs(4)
    got = vmap(gmm_kernel.gmm_logp, in_dims=(0, None, None, None))(y, w[0], mus[0], sigmas[0])
    for i in range(L):
        _rel_close(got[i], gmm_kernel.gmm_logp(y[i], w[0], mus[0], sigmas[0]), 1e-6)


def test_kernel_wrappers_refuse_tensor_subclasses():
    """The kernels take plain tensors: a subclass (a DTensor, say) raises."""
    class Sub(torch.Tensor):
        pass

    x, gamma, beta = _gdn_inputs()
    with pytest.raises(TypeError, match="plain tensors"):
        gdn_kernel.gdn(x[0].as_subclass(Sub), gamma[0], beta[0])
    y, w, mus, sigmas = _mixture_inputs()
    with pytest.raises(TypeError, match="plain tensors"):
        gmm_kernel.gmm_logp(y[0], w[0].as_subclass(Sub), mus[0], sigmas[0])


def test_vmap_rule_checks_the_rows_shape():
    x, gamma, beta = _gdn_inputs()
    with pytest.raises(ValueError, match=r"\(N, C\) rows"):
        vmap(lambda t: gdn_kernel.gdn(t, gamma[0], beta[0]))(x[:, :, None, :])


def test_stacked_weights_round_trip():
    models = [FactorizedPrior(4, device="cpu", seed=s) for s in range(2)]
    tree = stacked_state_to_jax([m.state_dict() for m in models])
    back = stacked_state_from_jax(tree)
    for m, state in zip(models, back):
        for k, v in m.state_dict().items():
            torch.testing.assert_close(state[k], v, rtol=0, atol=0)


# --- the sweep against JAX's ------------------------------------------------

SWEEP_CASES = {"plain": (32, 32, None, False), "clip": (32, 32, 0.05, False),
               "augment_square": (32, 32, None, True), "augment_wide": (32, 64, None, True)}


def _sweep_batches(h, w):
    rng = np.random.default_rng(11)
    return [rng.uniform(size=(2, h, w, 3)).astype(np.float32) for _ in range(SWEEP_STEPS)]


def _jax_sweep_inputs(jmodel, batches, seed, augment):
    """JAX's stacked init, each step's per-replica noise and flip bits, as
    its vmapped_lambda_sweep draws them."""
    keys = jax.random.split(jax.random.PRNGKey(seed), len(LAMBDAS))
    init = jax.jit(jax.vmap(lambda k: jmodel.init({"params": k, "noise": k},
                                                  jnp.asarray(batches[0]),
                                                  training=True)["params"]))(keys)
    init = jax.tree.map(np.asarray, init)
    rng = jax.random.PRNGKey(seed + 1)
    noises, bits = [], []
    b, h, w, _ = batches[0].shape
    for _ in range(SWEEP_STEPS):
        rng, sub = jax.random.split(rng)
        step_rngs = jax.random.split(sub, len(LAMBDAS))
        if augment:
            rng, aug_key = jax.random.split(rng)
            bits.append([bool(v) for v in np.asarray(jax.random.bernoulli(aug_key, 0.5, (3,)))])
        shape = (b, h // 16, w // 16, 4)  # only a square batch is transposed
        replica = []
        for r in step_rngs:
            key = jmodel.bind({"params": jax.tree.map(lambda a: a[0], init)},
                              rngs={"noise": r}).make_rng("noise")
            replica.append(np.asarray(jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5)))
        noises.append(np.stack(replica))
    return init, noises, bits


@pytest.fixture(scope="module", params=sorted(SWEEP_CASES))
def jax_sweep(request):
    h, w, clip, augment = SWEEP_CASES[request.param]
    jmodel = JFactorized(latent_channels=4)
    batches = _sweep_batches(h, w)
    seed = 5
    per_lambda, losses = jvmapped_lambda_sweep(jmodel, LAMBDAS, batches, SWEEP_STEPS,
                                               learning_rate=LR, seed=seed,
                                               clip_grad_norm=clip, augment=augment)
    init, noises, bits = _jax_sweep_inputs(jmodel, batches, seed, augment)
    return (batches, seed, clip, augment, init, noises, bits,
            [jax.tree.map(np.asarray, p) for p in per_lambda], np.asarray(losses))


def test_sweep_matches_jax(monkeypatch, jax_sweep):
    batches, seed, clip, augment, init, noises, bits, want_params, want_losses = jax_sweep
    fed_noise, fed_bits = iter(noises), iter(bits)
    monkeypatch.setattr(sweep, "_replica_noise",
                        lambda shapes, generators, device: [torch.from_numpy(next(fed_noise))])
    monkeypatch.setattr(sweep, "_flip_bits", lambda generator: next(fed_bits))
    init_states = stacked_state_from_jax(init)
    states, losses = vmapped_lambda_sweep(FactorizedPrior(4, device="cpu"), LAMBDAS, batches,
                                          SWEEP_STEPS, learning_rate=LR, seed=seed,
                                          clip_grad_norm=clip, augment=augment,
                                          init_states=init_states)
    assert next(fed_noise, None) is None and next(fed_bits, None) is None
    assert losses.shape == (len(LAMBDAS),)
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-4)
    for state, start, want in zip(states, init_states, want_params):
        want = joint_ar_state_from_jax(want)
        diff = torch.cat([((state[k] - start[k]) - (v - start[k])).abs().flatten()
                          for k, v in want.items()])
        assert float(diff.max()) <= 0.2 * LR
        assert int((diff > 2e-3 * LR).sum()) <= 1e-3 * diff.numel()


def test_sweep_replicas_match_separate_runs():
    """Each replica equals make_train_step from the same weights, with the
    generator seeded seed + 1 + i (the sweep's noise for replica i)."""
    def model():
        return JointAutoregressiveHierarchical(8, 3, device="cpu", seed=3)

    rng = np.random.default_rng(2)
    batches = [rng.uniform(size=(2, 64, 64, 3)).astype(np.float32) for _ in range(2)]
    seed, clip, lr = 4, 0.5, 1e-3
    logged = []
    states, losses = vmapped_lambda_sweep(model(), LAMBDAS, batches, 3, learning_rate=lr,
                                          seed=seed, clip_grad_norm=clip, log_every=2,
                                          log_fn=logged.append)
    assert len(logged) == 2  # steps 0 and 2
    for i, lam in enumerate(LAMBDAS):
        m = model()
        opt = torch.optim.Adam(m.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        step = make_train_step(m, opt, rd_loss, lam, clip_grad_norm=clip)
        gen = torch.Generator().manual_seed(seed + 1 + i)
        for b in (batches + batches)[:3]:
            metrics = step(b, gen)
        np.testing.assert_allclose(float(losses[i]), float(metrics["loss"]), rtol=1e-5)
        for k, v in m.state_dict().items():
            _rel_close(states[i][k], v, 1e-5)


def test_sweep_checks_its_initial_states():
    with pytest.raises(ValueError, match="initial states"):
        vmapped_lambda_sweep(FactorizedPrior(4, device="cpu"), LAMBDAS, _sweep_batches(32, 32), 1,
                             init_states=[{}])
