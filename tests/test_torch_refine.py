"""PyTorch port, encode-time latent refinement (``coding.refine``), held
against the JAX package's coding/refine.py ``make_refiner`` on the same
weights (JAX-initialised, carried across with load_jax_params; CPU, M=16,
64x128, 3 Adam steps).

JAX's refiner returns rounded latents only; the float latents before the
rounding come from a step-by-step replica of its loop (its body, rd_loss and
optax.adam), itself held against make_refiner's rounded output and metrics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_image_compression_tpu.coding.refine import _ste_round as jax_ste_round
from neural_image_compression_tpu.coding.refine import make_refiner as jax_make_refiner
from neural_image_compression_tpu.entropy.gaussian import gaussian_likelihood, mixture_likelihood
from neural_image_compression_tpu.models import JointAutoregressiveHierarchical as JModel
from neural_image_compression_tpu.train.loss import rd_loss as jax_rd_loss
from neural_image_compression_tpu_torch.coding import JointARCodec, make_refiner, refine
from neural_image_compression_tpu_torch.models import JointAutoregressiveHierarchical
from neural_image_compression_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(1)

M = 16
GAIN_Y, GAIN_Z = 12.0, 30.0  # spread y and z over several integers (test_torch_codec.py)
LAMBDA, STEPS, LR = 0.01, 3, 0.05
METRICS = ("loss", "bpp_total", "bpp_y", "bpp_z", "psnr", "mse")
# tolerances: the metrics are float32 sums over the image in other orders
# (relative); the latents move by Adam steps of about LR from values of
# order 10, through float32 gradients summed in other orders (absolute)
METRIC_RTOL, LATENT_ATOL = 1e-5, 1e-4
HALF_MARGIN = 1e-4  # where a latent may round either way


def _gained(params):
    params = jax.tree.map(np.array, params)
    for path, gain in ((("encoder", "Conv2d_3"), GAIN_Y), (("hyper_encoder", "Conv2d_2"), GAIN_Z)):
        leaf = params[path[0]][path[1]]
        leaf["kernel"] = leaf["kernel"] * gain
        leaf["bias"] = leaf["bias"] * gain
    return params


def _jax_float_latents(jmodel, params, x):
    """JAX refine.py's loop, unrolled: the float latents after STEPS steps."""
    variables = {"params": params}

    def body(mdl, y_in, z_in):
        params_t = mdl.entropy_params_from_latents(y_in, z_in)
        if mdl.K == 1:
            p_y = gaussian_likelihood(y_in, *params_t)
        else:
            p_y = mixture_likelihood(y_in, *params_t)
        return {"x_hat": mdl.decoder(y_in, False).astype(jnp.float32), "logp_y": jnp.log(p_y),
                "logp_z": jnp.log(mdl.factorized_entropy_model(z_in))}

    def loss_fn(latents):
        y, z = latents
        out = jmodel.apply(variables, jax_ste_round(y), jax_ste_round(z), method=body)
        return jax_rd_loss(out, x, LAMBDA)["loss"]

    grad = jax.jit(jax.grad(loss_fn))
    out0 = jmodel.apply(variables, x, training=False)
    latents = (out0["y"].astype(jnp.float32), out0["z"].astype(jnp.float32))
    tx = optax.adam(LR)
    state = tx.init(latents)
    for _ in range(STEPS):
        updates, state = tx.update(grad(latents), state)
        latents = optax.apply_updates(latents, updates)
    return [np.asarray(v) for v in latents]


@pytest.fixture(scope="module", params=[1, 3], ids=["K1", "K3"])
def refined(request):
    """K, the port's model, x, the port's (y, z, metrics) and the JAX
    package's (y_q, z_q, metrics, float y, float z)."""
    K = request.param
    jmodel = JModel(latent_channels=M, K=K)
    key = jax.random.PRNGKey(20 + K)
    params = _gained(jmodel.init({"params": key, "noise": key},
                                 jnp.zeros((1, 64, 64, 3)), training=False)["params"])
    model = load_jax_params(JointAutoregressiveHierarchical(M, K, device="cpu"), params)
    x = np.random.default_rng(K).uniform(size=(1, 64, 128, 3)).astype(np.float32)
    ours = refine._refine(model, x, LAMBDA, STEPS, LR)
    y_q, z_q, metrics = jax_make_refiner(jmodel, {"params": params}, LAMBDA, STEPS, LR)(
        jnp.asarray(x))
    theirs = (np.asarray(y_q), np.asarray(z_q), {k: float(v) for k, v in metrics.items()},
              *_jax_float_latents(jmodel, params, jnp.asarray(x)))
    return K, model, x, ours, theirs


def _near_half(v):
    f = np.abs(np.asarray(v, np.float64))
    return np.abs(f - np.floor(f) - 0.5) < HALF_MARGIN


def test_metrics_match_jax(refined):
    _, _, _, (_, _, metrics), (_, _, want, _, _) = refined
    for when in ("pre_", "post_"):
        for k in METRICS:
            np.testing.assert_allclose(float(metrics[when + k]), want[when + k],
                                       rtol=METRIC_RTOL, err_msg=when + k)


def test_float_latents_match_jax(refined):
    _, _, _, (y, z, _), (y_q, z_q, _, y_f, z_f) = refined
    # the replica of JAX's loop is JAX's refiner, up to the rounding boundary
    for q, f in ((y_q, y_f), (z_q, z_f)):
        clear = ~_near_half(f)
        np.testing.assert_array_equal(q[clear], np.round(f)[clear])
    np.testing.assert_allclose(y.numpy(), y_f, rtol=0, atol=LATENT_ATOL)
    np.testing.assert_allclose(z.numpy(), z_f, rtol=0, atol=LATENT_ATOL)
    # the steps moved the latents
    assert float(np.abs(y_f - np.round(y_f)).max()) > 0


def test_rounded_latents_match_jax(refined):
    K, model, x, (y, z, _), (y_q, z_q, _, y_f, z_f) = refined
    for ours, want, f in ((torch.round(y).numpy(), y_q, y_f), (torch.round(z).numpy(), z_q, z_f)):
        differ = ours != want
        assert not (differ & ~_near_half(f)).any()
        assert differ.mean() < 1e-3


def test_refined_latents_round_trip(refined):
    _, model, x, _, _ = refined
    y_q, z_q, _ = make_refiner(model, LAMBDA, STEPS, LR)(x)
    assert y_q.shape == (1, 4, 8, M) and z_q.shape == (1, 1, 2, M)
    cod = JointARCodec(model)
    y_d, z_d = cod.decode_latents(cod.compress_latents(y_q, z_q, 64, 128))
    np.testing.assert_array_equal(y_d, y_q[0].numpy())
    np.testing.assert_array_equal(z_d, z_q[0].numpy())


def test_refinement_lowers_the_loss_and_freezes_nothing(refined):
    _, model, x, _, _ = refined
    flags = [p.requires_grad for p in model.parameters()]
    _, _, m = make_refiner(model, LAMBDA, steps=20, lr=LR)(torch.from_numpy(x))
    assert float(m["post_loss"]) < float(m["pre_loss"])
    assert [p.requires_grad for p in model.parameters()] == flags
    assert all(p.grad is None for p in model.parameters())


def test_refine_checks_its_inputs(refined):
    _, model, _, _, _ = refined
    with pytest.raises(ValueError, match="multiples of 64"):
        make_refiner(model, LAMBDA, steps=1)(np.zeros((1, 64, 100, 3), np.float32))
    assert all(p.requires_grad for p in model.parameters())
    with pytest.raises(NotImplementedError, match="Linear"):
        make_refiner(torch.nn.Linear(2, 2), LAMBDA)
