"""PyTorch port, flagship model: EntropyParameters and the joint-AR eval
forward, held against the JAX forward on the same weights (carried across
with load_jax_params) and against the reference's golden fixtures (CPU,
M=16, 64x128)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.models import JointAutoregressiveHierarchical as JModel
from neural_image_compression_tpu.models.parameters import EntropyParameters as JEntropyParameters
from neural_image_compression_tpu.utils.torch_import import joint_ar_params_from_torch
from neural_image_compression_tpu_torch.models import (
    EntropyParameters, JointAutoregressiveHierarchical,
)
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_params_to_jax, joint_ar_state_from_jax, load_jax_params,
)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
M = 16
# Random-init encoders give |y| < 0.3, which rounds to all zeros; these gains
# on the last analysis convs spread y and z over several integers so the
# rounding and the rates are exercised.
GAIN_Y, GAIN_Z = 12.0, 30.0
SEED = 0  # its rounding margin (checked below) clears the forwards' difference


def _nchw_to_nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


def _rounding_margin(v):
    f = np.abs(np.asarray(v, np.float64))
    return float(np.min(np.abs(f - np.floor(f) - 0.5)))


def _gained(params):
    params = jax.tree.map(np.array, params)
    for path, gain in ((("encoder", "Conv2d_3"), GAIN_Y), (("hyper_encoder", "Conv2d_2"), GAIN_Z)):
        leaf = params[path[0]][path[1]]
        leaf["kernel"] = leaf["kernel"] * gain
        leaf["bias"] = leaf["bias"] * gain
    return params


def _assert_forward_close(got, want, K, rounded=True):
    """Tolerances of tests/test_golden_parity.py's full-model parity. With
    rounded=False (the training forward: y + noise, z + noise) y_in and z_in
    are held at y's and z's tolerance instead of exactly."""
    np.testing.assert_allclose(got["y"], want["y"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["z"], want["z"], rtol=2e-5, atol=2e-5)
    if rounded:
        np.testing.assert_array_equal(got["y_in"], want["y_in"])
        np.testing.assert_array_equal(got["z_in"], want["z_in"])
    else:
        np.testing.assert_allclose(got["y_in"], want["y_in"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["z_in"], want["z_in"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["x_hat"], want["x_hat"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["p_z"], want["p_z"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got["p_y"], want["p_y"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got["logp_y"], want["logp_y"], rtol=1e-4, atol=1e-4)
    if K == 1:
        np.testing.assert_allclose(got["mu"], want["mu"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got["weights"], want["weights"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["mus"], want["mus"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["sigmas"], want["sigmas"], rtol=1e-4, atol=1e-5)
    bits_want = -(np.sum(want["logp_y"], dtype=np.float64) + np.sum(want["logp_z"], dtype=np.float64))
    bits_got = -(np.sum(got["logp_y"], dtype=np.float64) + np.sum(got["logp_z"], dtype=np.float64))
    assert abs(bits_got - bits_want) / bits_want < 1e-4


def _port_out(out):
    return {k: v.numpy() for k, v in out.items() if k != "training"}


@pytest.mark.parametrize("K", [1, 3])
def test_entropy_parameters_match_jax(K):
    rng = np.random.default_rng(K)
    combined = rng.normal(size=(2, 3, 5, 4 * M)).astype(np.float32)
    jmod = JEntropyParameters(latent_channels=M, hyper_latent_channels=M, K=K)
    params = jmod.init(jax.random.PRNGKey(K), jnp.asarray(combined))["params"]
    want = jmod.apply({"params": params}, jnp.asarray(combined))
    mod = EntropyParameters(M, M, K, device="cpu")
    load_jax_params(mod, jax.tree.map(np.asarray, params))
    got = mod(torch.from_numpy(combined).permute(0, 3, 1, 2))
    assert len(got) == len(want) == (2 if K == 1 else 3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("K", [1, 3])
def test_entropy_parameters_golden(K):
    fx = np.load(os.path.join(GOLDEN, "context_ep_ref.npz"))
    m = fx["y"].shape[1]
    mod = EntropyParameters(m, m, K, device="cpu")
    with torch.no_grad():  # the reference's OIHW 1x1 weights
        for li in range(3):
            conv = getattr(mod, f"Conv2d_{li}")
            conv.weight.copy_(torch.from_numpy(fx[f"ep{K}_w{li}"]))
            conv.bias.copy_(torch.from_numpy(fx[f"ep{K}_b{li}"]))
        got = mod(torch.from_numpy(fx["combined"]))
    if K == 1:
        want = (_nchw_to_nhwc(fx["ep1_mu"]), _nchw_to_nhwc(fx["ep1_sigma"]))
    else:
        want = tuple(np.transpose(fx[f"ep3_{n}"], (0, 3, 4, 1, 2)) for n in ("w", "mu", "sigma"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=[1, 3], ids=["K1", "K3"])
def jax_pair(request):
    """(K, x, gained JAX params, JAX eval outputs) on one seeded input."""
    K = request.param
    x = np.random.default_rng(SEED).uniform(size=(2, 64, 128, 3)).astype(np.float32)
    jmodel = JModel(latent_channels=M, K=K)
    key = jax.random.PRNGKey(SEED)
    params = _gained(jmodel.init({"params": key, "noise": key}, jnp.asarray(x),
                                 training=False)["params"])
    out = jmodel.apply({"params": params}, jnp.asarray(x), training=False)
    want = {k: np.asarray(v) for k, v in out.items() if k != "training"}
    return K, x, params, want


def test_eval_forward_matches_jax(jax_pair):
    K, x, params, want = jax_pair
    # the latents must sit clear of the rounding boundary by more than the
    # two frameworks' difference (~1e-6 here), or y_in could differ honestly
    assert _rounding_margin(want["y"]) > 1e-4
    assert _rounding_margin(want["z"]) > 1e-4
    assert np.count_nonzero(want["y_in"]) > 0.05 * want["y_in"].size
    assert np.count_nonzero(want["z_in"]) > 0
    model = JointAutoregressiveHierarchical(M, K, device="cpu")
    load_jax_params(model, params)
    got = _port_out(model(torch.from_numpy(x), training=False))
    assert set(got) == set(want)
    _assert_forward_close(got, want, K)


def test_state_bridge_uses_every_leaf_once(jax_pair):
    K, _, params, _ = jax_pair
    state = joint_ar_state_from_jax(params)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(state) == n_leaves
    model = JointAutoregressiveHierarchical(M, K, device="cpu")
    assert set(state) == set(model.state_dict())
    # deconv kernels come back in torch's (in, out, kh, kw) layout, unflipped
    k = np.asarray(params["decoder"]["Deconv2d_3"]["kernel"])  # (5, 5, M, 3)
    w = state["decoder.Deconv2d_3.weight"].numpy()
    assert w.shape == (M, 3, 5, 5)
    np.testing.assert_array_equal(w[:, :, 0, 0], k[4, 4])


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_params_to_jax_inverts_the_loader(jax_pair, dtype):
    # a bf16 model keeps float32 parameters (ops/conv.py casts at compute)
    K, _, params, _ = jax_pair
    model = JointAutoregressiveHierarchical(M, K, dtype=dtype, device="cpu")
    back = joint_ar_params_to_jax(load_jax_params(model, params))
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.flags.c_contiguous, path
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))


def test_load_rejects_missing_and_unexpected_keys(jax_pair):
    K, _, params, _ = jax_pair
    model = JointAutoregressiveHierarchical(M, K, device="cpu")
    partial = {k: v for k, v in params.items() if k != "context_model"}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(model, partial)
    extra = dict(params, stray={"Conv2d_0": {"kernel": np.zeros((1, 1, 1, 1), np.float32)}})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(model, extra)
    with pytest.raises(KeyError, match="unknown parameter"):
        joint_ar_state_from_jax({"encoder": {"Conv2d_0": {"scale": np.ones(3)}}})


@pytest.mark.parametrize("name,K", [("joint5x5_k1", 1), ("joint5x5_k3", 3)])
def test_eval_forward_golden(name, K):
    fx = np.load(os.path.join(GOLDEN, f"fullmodel_{name}.npz"))
    sd = {k[3:]: fx[k] for k in fx.files if k.startswith("sd_")}
    model = JointAutoregressiveHierarchical(16, K, device="cpu")
    load_jax_params(model, joint_ar_params_from_torch(sd, "conv5x5"))
    got = _port_out(model(torch.from_numpy(_nchw_to_nhwc(fx["x"]).copy()), training=False))

    def ref(k):
        v = fx["out_" + k]
        if v.ndim == 4:
            return _nchw_to_nhwc(v)
        if v.ndim == 5:  # (B, K, M, H, W) -> (B, H, W, K, M)
            return np.transpose(v, (0, 3, 4, 1, 2))
        return v

    want = {k[4:]: ref(k[4:]) for k in fx.files if k.startswith("out_")}
    _assert_forward_close(got, want, K)


def test_training_forward_and_bad_resolution_raise():
    # the training forward is the default and runs (it raised before the
    # training slice); a bad resolution raises in both modes
    model = JointAutoregressiveHierarchical(8, 2, device="cpu")
    out = model(torch.zeros(1, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    assert out["training"] is True and out["x_hat"].requires_grad
    noise = (out["y_in"] - out["y"]).detach()
    assert 0 < noise.abs().max().item() <= 0.5
    for training in (True, False):
        with pytest.raises(ValueError, match="multiples of 64"):
            model(torch.zeros(1, 96, 64, 3), training=training)


def test_bf16_transforms_keep_entropy_math_f32():
    model = JointAutoregressiveHierarchical(8, 3, dtype=torch.bfloat16, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).uniform(size=(1, 64, 64, 3)).astype(np.float32))
    out = model(x, training=False)
    assert out["y"].dtype == torch.bfloat16
    for k in ("x_hat", "y_in", "z_in", "p_y", "logp_y", "p_z", "logp_z", "weights", "mus", "sigmas"):
        assert out[k].dtype == torch.float32, k
        assert torch.isfinite(out[k]).all(), k
