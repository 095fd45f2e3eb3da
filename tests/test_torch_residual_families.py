"""PyTorch port, ``transform="res3x3"`` in every family: the joint-AR model
(``HierarchicalMixtureResidual``), MeanScaleHyperprior,
CheckerboardHierarchical, ChannelCheckerboardHierarchical (K=1 and K=3)
and FactorizedPrior, each held against the JAX model of the same family
and transform on the same weights (JAX-initialised, gains on the last
analysis convs so that y and z spread over several integers, carried across
with load_jax_params; CPU, M=16, 64x128): the eval forward, and the
training forward and its rd_loss with the JAX model's own noise draw fed to
the port.

Tolerances are test_torch_joint_ar.py's (latents 2e-5 and exact once
rounded, x_hat and the likelihoods 1e-4, total bits 1e-4 relative) and
test_torch_factorized_prior.py's for the factorized prior; rd_loss within
1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.models import (
    ChannelCheckerboardHierarchical as JChannelCB, CheckerboardHierarchical as JCheckerboard,
    FactorizedPrior as JFactorized, JointAutoregressiveHierarchical as JJointAR,
    MeanScaleHyperprior as JHyperprior,
)
from neural_image_compression_tpu.train.loss import rd_loss as jrd_loss
from neural_image_compression_tpu_torch.models import (
    ChannelCheckerboardHierarchical, CheckerboardHierarchical, FactorizedPrior,
    HierarchicalMixtureResidual, MeanScaleHyperprior,
)
from neural_image_compression_tpu_torch.train import rd_loss
from neural_image_compression_tpu_torch.utils.weights import load_jax_params
from test_torch_factorized_prior import _assert_close as _assert_factorized_close
from test_torch_joint_ar import _assert_forward_close, _rounding_margin
from test_torch_train import _feed_noise, _jax_noise

torch.set_num_threads(1)

M, SEED, LAMBDA = 16, 0, 0.005
SHAPE = (2, 64, 128, 3)
# Random residual transforms give |y| ~ 0.15 and |z| ~ 0.05. These gains on
# the bottleneck convs spread them over several integers at the 5x5 suites'
# spread (y's std 0.59 against their 0.55), and this seed's latents keep a
# rounding margin above 8e-4. Wider, p_y falls below 2e-3 at some symbols,
# where it is the difference of two float32 CDF values above 0.5 in both
# packages: their erf's last bits (1.2e-7 a value) then exceed the
# tolerance's absolute 1e-7.
GAIN_Y, GAIN_Z = 5.0, 30.0


def _factorized(latent_channels, K, **kw):
    return FactorizedPrior(latent_channels, transform="res3x3", **kw)


def _residual(cls):
    return lambda latent_channels, K, **kw: cls(latent_channels, K, transform="res3x3", **kw)


# family -> (the JAX model's class, the port's constructor (M, K, **kw))
FAMILIES = {
    "joint_ar": (JJointAR, HierarchicalMixtureResidual),
    "hyperprior": (JHyperprior, _residual(MeanScaleHyperprior)),
    "checkerboard": (JCheckerboard, _residual(CheckerboardHierarchical)),
    "channel_cb": (JChannelCB, _residual(ChannelCheckerboardHierarchical)),
    "factorized": (JFactorized, _factorized),
}
CASES = [(f, K) for f in FAMILIES for K in ((1,) if f == "factorized" else (1, 3))]


def _gained_res(params):
    """The gains on the residual transforms' bottleneck convs: the
    analysis' Conv2d_0 and the hyper-analysis' Conv2d_4."""
    params = jax.tree.map(np.array, params)
    for path, gain in ((("encoder", "Conv2d_0"), GAIN_Y),
                       (("hyper_encoder", "Conv2d_4"), GAIN_Z)):
        if path[0] in params:  # the factorized prior has no hyper-analysis
            leaf = params[path[0]][path[1]]
            leaf["kernel"], leaf["bias"] = leaf["kernel"] * gain, leaf["bias"] * gain
    return params


@pytest.fixture(scope="module", params=CASES, ids=[f"{f}-K{k}" for f, k in CASES])
def pair(request):
    """(family, K, JAX model, gained JAX params, the port's model with them,
    the batch, the JAX eval outputs)."""
    family, K = request.param
    jcls, ctor = FAMILIES[family]
    kw = {} if family == "factorized" else {"K": K}
    x = np.random.default_rng(SEED).uniform(size=SHAPE).astype(np.float32)
    jmodel = jcls(latent_channels=M, transform="res3x3", **kw)
    key = jax.random.PRNGKey(SEED)
    params = _gained_res(jmodel.init({"params": key, "noise": key}, jnp.asarray(x),
                                     training=False)["params"])
    want = {k: np.asarray(v) for k, v in jmodel.apply({"params": params}, jnp.asarray(x),
                                                      training=False).items()
            if k != "training"}
    model = load_jax_params(ctor(M, K, device="cpu"), params)
    assert model.transform == "res3x3"
    return family, K, jmodel, params, model, x, want


def _assert_close(family, K, got, want, rounded=True):
    if family == "factorized":
        _assert_factorized_close(got, want, rounded)
    else:
        _assert_forward_close(got, want, K, rounded)


def test_eval_forward_matches_jax(pair):
    family, K, _, _, model, x, want = pair
    # clear of the rounding boundary by more than the two frameworks'
    # difference, so y_in and z_in must be equal
    assert _rounding_margin(want["y"]) > 1e-4
    if family != "factorized":
        assert _rounding_margin(want["z"]) > 1e-4
        assert len(np.unique(want["z_in"])) >= 3
    assert np.count_nonzero(want["y_in"]) > 0.05 * want["y_in"].size
    got = model(torch.from_numpy(x), training=False)
    assert got["training"] is False
    _assert_close(family, K, {k: v.numpy() for k, v in got.items() if k != "training"}, want)


def test_training_forward_matches_jax(pair, monkeypatch):
    """The JAX model's noise (z then y; y alone for the factorized prior)
    fed to the port through noise_quantize."""
    family, K, jmodel, params, model, x, _ = pair
    key = jax.random.PRNGKey(SEED + 1)
    out = jmodel.apply({"params": params}, jnp.asarray(x), training=True, rngs={"noise": key})
    want_metrics = {k: float(v) for k, v in jrd_loss(out, jnp.asarray(x), LAMBDA).items()
                    if np.ndim(v) == 0}
    want = {k: np.asarray(v) for k, v in out.items() if k != "training"}
    if family == "factorized":
        rng = jmodel.bind({"params": params}, rngs={"noise": key}).make_rng("noise")
        noise = [np.asarray(jax.random.uniform(rng, want["y"].shape, jnp.float32, -0.5, 0.5))]
    else:
        noise = _jax_noise(jmodel, params, key, x)
        np.testing.assert_array_equal(np.asarray(want["z"], np.float32) + noise[0],
                                      want["z_in"])
    np.testing.assert_array_equal(np.asarray(want["y"], np.float32) + noise[-1], want["y_in"])
    drawn = _feed_noise(monkeypatch, noise)
    xt = torch.from_numpy(x)
    got = model(xt, training=True)
    assert next(drawn, None) is None  # every draw used, none more
    metrics = rd_loss(got, xt, LAMBDA)
    _assert_close(family, K, {k: v.detach().numpy() for k, v in got.items()
                              if k != "training"}, want, rounded=False)
    for k in ("loss", "bpp_y", "bpp_z", "mse"):
        np.testing.assert_allclose(metrics[k].item(), want_metrics[k], rtol=1e-5, err_msg=k)
