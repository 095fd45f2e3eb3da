"""PyTorch port, ops: bound/nonneg, GDN and its kernel's plain versions
(forward and backward, the module's gradients too), conv and deconv, the
masked-conv context model, each held against the JAX package on the same
numpy inputs (CPU, small shapes)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from neural_image_compression_tpu.ops import bound as jbound
from neural_image_compression_tpu.ops.conv import Conv2d as JConv2d, Deconv2d as JDeconv2d
from neural_image_compression_tpu.ops.gdn import GDN as JGDN
from neural_image_compression_tpu.ops.masked_conv import (
    ContextModel as JContextModel, causal_mask as jcausal_mask,
)
from neural_image_compression_tpu.ops.pallas.gdn_kernel import _gdn_reference, fused_gdn
from neural_image_compression_tpu_torch.ops import bound
from neural_image_compression_tpu_torch.ops.conv import Conv2d, Deconv2d
from neural_image_compression_tpu_torch.ops.gdn import GDN
from neural_image_compression_tpu_torch.ops.kernels import gdn_kernel
from neural_image_compression_tpu_torch.ops.masked_conv import ContextModel, causal_mask
from neural_image_compression_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _nchw_to_nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


def _to_port(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> (B, C, H, W) tensor in channels_last memory (a view)."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _from_port(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


def _raw_gdn_params(rng, c):
    """Raw (sqrt-form) params, some below the bound so lower_bound acts."""
    beta = rng.uniform(-0.2, 1.5, size=(c,)).astype(np.float32)
    gamma = rng.uniform(-0.05, 0.4, size=(c, c)).astype(np.float32)
    return beta, gamma


@pytest.mark.parametrize("minimum", [0.0, 1e-6])
def test_nonneg_matches_jax(minimum):
    raw = np.random.default_rng(0).uniform(-0.5, 1.0, size=(64,)).astype(np.float32)
    want = np.asarray(jbound.nonneg(jnp.asarray(raw), minimum=minimum))
    got = bound.nonneg(torch.from_numpy(raw), minimum=minimum).numpy()
    np.testing.assert_array_equal(got, want)
    init = np.abs(raw)
    np.testing.assert_array_equal(bound.nonneg_init(torch.from_numpy(init)).numpy(),
                                  np.asarray(jbound.nonneg_init(jnp.asarray(init))))


@pytest.mark.parametrize("which", ["lower", "upper"])
def test_bound_straight_through_grad_matches_jax(which):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, size=(128,)).astype(np.float32)
    g = rng.normal(size=(128,)).astype(np.float32)
    jfn = jbound.lower_bound if which == "lower" else jbound.upper_bound
    tfn = bound.lower_bound if which == "lower" else bound.upper_bound
    want_y, vjp = jax.vjp(lambda v: jfn(v, 0.1), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tfn(xt, 0.1)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_module_matches_jax(inverse):
    rng = np.random.default_rng(2)
    c = 16
    x = rng.normal(size=(2, 5, 7, c)).astype(np.float32)
    beta, gamma = _raw_gdn_params(rng, c)
    jmod = JGDN(inverse=inverse, use_pallas=False)
    want = np.asarray(jmod.apply({"params": {"beta": jnp.asarray(beta),
                                             "gamma": jnp.asarray(gamma)}},
                                 jnp.asarray(x)))
    mod = GDN(c, inverse=inverse, device="cpu")
    load_jax_params(mod, {"beta": beta, "gamma": gamma})
    got = _from_port(mod(_to_port(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_reference_matches_pallas_interpret(inverse):
    rng = np.random.default_rng(3)
    n, c = 700, 32  # 700 rows: not a multiple of the Pallas kernel's 512-row tile
    x = rng.normal(size=(n, c)).astype(np.float32)
    gamma = np.abs(rng.normal(0.0, 0.05, size=(c, c))).astype(np.float32)
    beta = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    want = np.asarray(fused_gdn(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                                inverse=inverse, interpret=True))
    got = gdn_kernel.gdn(torch.from_numpy(x), torch.from_numpy(gamma),
                         torch.from_numpy(beta), inverse)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_golden_forward(inverse):
    fx = np.load(os.path.join(GOLDEN, "gdn_ref.npz"))
    tag = "igdn" if inverse else "gdn"
    x = _nchw_to_nhwc(fx[f"{tag}_x"])
    mod = GDN(x.shape[-1], inverse=inverse, device="cpu")
    # the reference stores gamma as torch's (C_out, C_in); the port keeps (C_in, C_out)
    load_jax_params(mod, {"beta": fx[f"{tag}_beta_raw"], "gamma": fx[f"{tag}_gamma_raw"].T})
    got = _from_port(mod(_to_port(x)))
    np.testing.assert_allclose(got, _nchw_to_nhwc(fx[f"{tag}_y"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c", [6, 16, 128, 192, 256])
def test_gdn_backward_reference_matches_jax_vjp(c, inverse):
    """The plain backward (the kernel's formula) against jax.vjp of the
    JAX package's _gdn_reference, which its gdn_fused_op's backward is."""
    rng = np.random.default_rng(20 + c)
    n = 257
    x = rng.normal(size=(n, c)).astype(np.float32)
    gamma = np.abs(rng.normal(0.0, 0.05, size=(c, c))).astype(np.float32)
    beta = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    g = rng.normal(size=(n, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, d: _gdn_reference(a, b, d, inverse),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want = vjp(jnp.asarray(g))
    got = gdn_kernel.gdn_backward_reference(torch.from_numpy(x), torch.from_numpy(gamma),
                                            torch.from_numpy(beta), torch.from_numpy(g),
                                            inverse)
    for name, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_golden_grads(inverse):
    """The module's gradients to x and to its raw beta and gamma (through
    nonneg's lower bound, which the fixture's perturbed params reach) at the
    tolerances of tests/test_golden_parity.py's GDN gradients."""
    fx = np.load(os.path.join(GOLDEN, "gdn_ref.npz"))
    tag = "igdn" if inverse else "gdn"
    x = _to_port(_nchw_to_nhwc(fx[f"{tag}_x"])).clone().requires_grad_(True)
    mod = GDN(x.shape[1], inverse=inverse, device="cpu")
    # the reference stores gamma as torch's (C_out, C_in); the port keeps (C_in, C_out)
    load_jax_params(mod, {"beta": fx[f"{tag}_beta_raw"], "gamma": fx[f"{tag}_gamma_raw"].T})
    mod(x).backward(_to_port(_nchw_to_nhwc(fx[f"{tag}_cotangent"])))
    np.testing.assert_allclose(_from_port(x.grad), _nchw_to_nhwc(fx[f"{tag}_grad_x"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mod.beta.grad.numpy(), fx[f"{tag}_grad_beta"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mod.gamma.grad.numpy().T, fx[f"{tag}_grad_gamma"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_module_grads_match_jax(inverse):
    rng = np.random.default_rng(12)
    c = 16
    x = rng.normal(size=(2, 5, 7, c)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    beta, gamma = _raw_gdn_params(rng, c)
    jmod = JGDN(inverse=inverse, use_pallas=False)
    _, vjp = jax.vjp(lambda p, a: jmod.apply({"params": p}, a),
                     {"beta": jnp.asarray(beta), "gamma": jnp.asarray(gamma)}, jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(cot))
    mod = GDN(c, inverse=inverse, device="cpu")
    load_jax_params(mod, {"beta": beta, "gamma": gamma})
    xt = _to_port(x).clone().requires_grad_(True)
    mod(xt).backward(_to_port(cot))
    np.testing.assert_allclose(_from_port(xt.grad), np.asarray(want_x), rtol=1e-5, atol=1e-6)
    for name in ("beta", "gamma"):
        w = np.asarray(want_p[name])
        np.testing.assert_allclose(getattr(mod, name).grad.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


def _single(module: nn.Module, name: str) -> nn.Module:
    holder = nn.Module()
    holder.add_module(name, module)
    return holder


def test_conv2d_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(2, 16, 24, 4)).astype(np.float32)
    jmod = JConv2d(8, 5, 2, 2)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    holder = _single(Conv2d(4, 8, 5, 2, 2, device="cpu"), "Conv2d_0")
    load_jax_params(holder, {"Conv2d_0": jax.tree.map(np.asarray, params)})
    got = _from_port(holder.Conv2d_0(_to_port(x)))
    assert got.shape == want.shape == (2, 8, 12, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("features", [8, 3])
def test_deconv2d_matches_jax(features):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 6, 5, 8)).astype(np.float32)
    jmod = JDeconv2d(features, 5, 2, 2, 1)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    holder = _single(Deconv2d(8, features, 5, 2, 2, 1, device="cpu"), "Deconv2d_0")
    load_jax_params(holder, {"Deconv2d_0": jax.tree.map(np.asarray, params)})
    got = _from_port(holder.Deconv2d_0(_to_port(x)))
    assert got.shape == want.shape == (2, 12, 10, features)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mask_type", ["A", "B"])
def test_causal_mask_matches_jax(mask_type):
    np.testing.assert_array_equal(causal_mask(5, mask_type), jcausal_mask(5, mask_type))


def test_context_model_matches_jax():
    rng = np.random.default_rng(7)
    m = 8
    y = np.round(rng.normal(0, 2, size=(2, 6, 7, m))).astype(np.float32)
    jmod = JContextModel(latent_channels=m)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(y))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(y)))
    mod = ContextModel(m, device="cpu")
    load_jax_params(mod, jax.tree.map(np.asarray, params))
    got = _from_port(mod(_to_port(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_context_model_golden():
    fx = np.load(os.path.join(GOLDEN, "context_ep_ref.npz"))
    m = fx["y"].shape[1]
    mod = ContextModel(m, device="cpu")
    with torch.no_grad():  # the reference's OIHW weight, unmasked or not
        mod.MaskedConv2d_0.weight.copy_(torch.from_numpy(fx["ctx_w"]))
        mod.MaskedConv2d_0.bias.copy_(torch.from_numpy(fx["ctx_b"]))
    got = _from_port(mod(_to_port(_nchw_to_nhwc(fx["y"]))))
    np.testing.assert_allclose(got, _nchw_to_nhwc(fx["phi"]), rtol=1e-5, atol=1e-5)
