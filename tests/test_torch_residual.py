"""PyTorch port, the 3x3 residual transforms: ``pixel_shuffle``,
``SubpelConv3x3``, ``TransposedDeconv3x3`` (upsample 2 and 1), the
functional ``conv2d`` / ``deconv2d``, the three residual blocks and the four
3x3 transforms, each held against the JAX module on the same weights
(JAX-initialised, carried across with load_jax_params) and numpy-seeded
inputs; ``HierarchicalMixtureResidual`` against the reference's golden
fixture through the port's own importer (``utils.torch_import``, no JAX
package on that path), ``load_reference_checkpoint`` on a .pth, the
weights' round trip both ways, a training step's gradients against
jax.grad and the FLOP count (CPU, the golden sizes: M=16, 64x128).

Tolerances: a module's output within 1e-5 (float32 sums in other orders
through a few convs), the full model at test_torch_joint_ar.py's
(tests/test_golden_parity.py's): latents 2e-5 and exact once rounded,
x_hat and the likelihoods 1e-4, total bits 1e-4 relative."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.models import components as jcomponents
from neural_image_compression_tpu.models import JointAutoregressiveHierarchical as JModel
from neural_image_compression_tpu.ops import blocks as jblocks
from neural_image_compression_tpu.ops import conv as jconv
from neural_image_compression_tpu.train.loss import rd_loss as jrd_loss
from neural_image_compression_tpu.utils import flops as jflops
from neural_image_compression_tpu_torch.models import (
    Decoder3x3, Encoder3x3, HierarchicalMixtureResidual, HyperDecoder3x3, HyperEncoder3x3,
    JointAutoregressiveHierarchical,
)
from neural_image_compression_tpu_torch.ops import (
    ResidualBlock, ResidualBlockUpsample, ResidualBlockWithStride, SubpelConv3x3,
    TransposedDeconv3x3, conv2d, deconv2d, pixel_shuffle,
)
from neural_image_compression_tpu_torch.train import rd_loss
from neural_image_compression_tpu_torch.utils import flops
from neural_image_compression_tpu_torch.utils.torch_import import (
    joint_ar_params_from_torch, load_reference_checkpoint,
)
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_params_to_jax, joint_ar_state_from_jax, load_jax_params,
)
from test_torch_joint_ar import _assert_forward_close, _nchw_to_nhwc, _port_out
from test_torch_train import _feed_noise, _jax_noise

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
M = 16
MODULE_TOL = 1e-5


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _jax_module(jmod, x, seed, **call):
    """(params as numpy, the JAX output) of a flax module on x (NHWC)."""
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x), **call)["params"]
    return jax.tree.map(np.asarray, params), np.asarray(jmod.apply({"params": params},
                                                                   jnp.asarray(x), **call))


def _assert_module_matches(jmod, mod, x, seed, **call):
    params, want = _jax_module(jmod, x, seed, **call)
    load_jax_params(mod, params)
    got = _nhwc(mod(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=MODULE_TOL, atol=MODULE_TOL)


def _input(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# --- ops ---------------------------------------------------------------------

@pytest.mark.parametrize("factor", [2, 3])
def test_pixel_shuffle_matches_jax_and_torch(factor):
    x = _input((2, 3, 5, 4 * factor * factor), factor)
    got = pixel_shuffle(torch.from_numpy(x), factor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jconv.pixel_shuffle(jnp.asarray(x),
                                                                              factor)))
    # channel c_out * r^2 + i * r + j -> (i, j): torch's NCHW pixel_shuffle
    np.testing.assert_array_equal(
        got.numpy(), _nhwc(torch.nn.functional.pixel_shuffle(_nchw(x), factor)))


@pytest.mark.parametrize("upsample", [1, 2])
def test_subpel_conv_matches_jax(upsample):
    x = _input((2, 4, 6, 8), 10 + upsample)
    _assert_module_matches(jconv.SubpelConv3x3(features=5, upsample=upsample),
                           SubpelConv3x3(8, 5, upsample, device="cpu"), x, upsample)


@pytest.mark.parametrize("upsample", [1, 2])
def test_transposed_deconv_matches_jax(upsample):
    x = _input((2, 4, 6, 8), 20 + upsample)
    mod = TransposedDeconv3x3(8, 5, upsample, device="cpu")
    _assert_module_matches(jconv.TransposedDeconv3x3(features=5, upsample=upsample), mod, x,
                           upsample)
    assert _nhwc(mod(_nchw(x))).shape == (2, 4 * upsample, 6 * upsample, 5)


@pytest.mark.parametrize("stride,padding,output_padding", [(1, 1, 0), (2, 1, 1), (2, 2, 1)])
def test_functional_conv_and_deconv_match_jax(stride, padding, output_padding):
    rng = np.random.default_rng(stride + padding)
    x = rng.normal(size=(2, 6, 8, 4)).astype(np.float32)
    kernel = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, kernel, bias)]
    jargs = [jnp.asarray(a) for a in (x, kernel, bias)]
    np.testing.assert_allclose(conv2d(*args, stride, padding).numpy(),
                               np.asarray(jconv.conv2d(*jargs, stride, padding)),
                               rtol=MODULE_TOL, atol=MODULE_TOL)
    np.testing.assert_allclose(
        deconv2d(*args, stride, padding, output_padding).numpy(),
        np.asarray(jconv.deconv2d(*jargs, stride, padding, output_padding)),
        rtol=MODULE_TOL, atol=MODULE_TOL)


# name -> (the JAX block, the port's block, its input channels, its submodules):
# the skip conv only where the stride or the width changes
BLOCKS = {
    "with_stride_2": (lambda: jblocks.ResidualBlockWithStride(8, 2),
                      lambda: ResidualBlockWithStride(4, 8, 2, device="cpu"), 4,
                      {"Conv2d_0", "Conv2d_1", "GDN_0", "Conv2d_2"}),
    "with_stride_1_same_width": (lambda: jblocks.ResidualBlockWithStride(8, 1),
                                 lambda: ResidualBlockWithStride(8, 8, 1, device="cpu"), 8,
                                 {"Conv2d_0", "Conv2d_1", "GDN_0"}),
    "upsample_2": (lambda: jblocks.ResidualBlockUpsample(8, 2),
                   lambda: ResidualBlockUpsample(6, 8, 2, device="cpu"), 6,
                   {"TransposedDeconv3x3_0", "Conv2d_0", "GDN_0", "TransposedDeconv3x3_1"}),
    "upsample_1": (lambda: jblocks.ResidualBlockUpsample(8, 1),
                   lambda: ResidualBlockUpsample(8, 8, 1, device="cpu"), 8,
                   {"TransposedDeconv3x3_0", "Conv2d_0", "GDN_0", "TransposedDeconv3x3_1"}),
    "plain_width_change": (lambda: jblocks.ResidualBlock(8),
                           lambda: ResidualBlock(5, 8, device="cpu"), 5,
                           {"Conv2d_0", "Conv2d_1", "Conv2d_2"}),
    "plain_same_width": (lambda: jblocks.ResidualBlock(8),
                         lambda: ResidualBlock(8, 8, device="cpu"), 8,
                         {"Conv2d_0", "Conv2d_1"}),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_residual_blocks_match_jax(name):
    jfactory, factory, cin, names = BLOCKS[name]
    mod = factory()
    assert {n for n, _ in mod.named_children()} == names
    x = np.abs(_input((2, 8, 12, cin), len(name)))  # GDN's norm on a spread of values
    _assert_module_matches(jfactory(), mod, x, len(name))


TRANSFORMS = {
    "Encoder3x3": (jcomponents.Encoder3x3, Encoder3x3, (2, 64, 128, 3), (2, 4, 8, M)),
    "Decoder3x3": (jcomponents.Decoder3x3, Decoder3x3, (2, 4, 8, M), (2, 64, 128, 3)),
    "HyperEncoder3x3": (jcomponents.HyperEncoder3x3, HyperEncoder3x3, (2, 4, 8, M),
                        (2, 1, 2, M)),
    "HyperDecoder3x3": (jcomponents.HyperDecoder3x3, HyperDecoder3x3, (2, 1, 2, M),
                        (2, 4, 8, 2 * M)),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transforms_match_jax(name):
    jcls, cls, shape, out_shape = TRANSFORMS[name]
    x = np.random.default_rng(len(name)).uniform(-2, 2, size=shape).astype(np.float32)
    params, want = _jax_module(jcls(latent_channels=M), x, len(name))
    assert want.shape == out_shape
    mod = load_jax_params(cls(M, device="cpu"), params)
    np.testing.assert_allclose(_nhwc(mod(_nchw(x))), want, rtol=MODULE_TOL, atol=MODULE_TOL)


# --- the model ---------------------------------------------------------------------

def _golden(name):
    fx = np.load(os.path.join(GOLDEN, f"fullmodel_{name}.npz"))
    return fx, {k[3:]: fx[k] for k in fx.files if k.startswith("sd_")}


def _golden_ref(fx):
    def ref(k):
        v = fx["out_" + k]
        if v.ndim == 4:
            return _nchw_to_nhwc(v)
        if v.ndim == 5:  # (B, K, M, H, W) -> (B, H, W, K, M)
            return np.transpose(v, (0, 3, 4, 1, 2))
        return v
    return {k[4:]: ref(k[4:]) for k in fx.files if k.startswith("out_")}


def test_eval_forward_golden_through_the_ports_importer():
    fx, sd = _golden("res3x3_k1")
    model = HierarchicalMixtureResidual(16, K=1, device="cpu")
    load_jax_params(model, joint_ar_params_from_torch(sd, "res3x3"))
    got = _port_out(model(torch.from_numpy(_nchw_to_nhwc(fx["x"]).copy()), training=False))
    _assert_forward_close(got, _golden_ref(fx), 1)


@pytest.mark.parametrize("name,transform", [("res3x3_k1", "res3x3"),
                                            ("joint5x5_k1", "conv5x5")])
def test_load_reference_checkpoint_file(tmp_path, name, transform):
    """A reference Trainer .pth ({'model_state_dict', 'step'}) and a bare
    state_dict load to the direct mapping's tree, which fits the model."""
    _, sd = _golden(name)
    want = joint_ar_params_from_torch(sd, transform)
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    for i, blob in enumerate(({"model_state_dict": tensors, "step": 123}, tensors)):
        path = str(tmp_path / f"ref{i}.pth")
        torch.save(blob, path)
        got = load_reference_checkpoint(path, transform=transform)
        got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
        want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (p, a), (_, b) in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(a, b, err_msg=str(p))
    load_jax_params(JointAutoregressiveHierarchical(16, 1, transform, device="cpu"), got)
    with pytest.raises(KeyError):  # scalable=True: the scalable model's mapping, whose
        load_reference_checkpoint(path, scalable=True)  # keys a joint-AR checkpoint lacks


def test_importer_matches_the_jax_packages():
    from neural_image_compression_tpu.utils.torch_import import (
        joint_ar_params_from_torch as jax_params_from_torch,
    )

    _, sd = _golden("res3x3_k1")
    got = jax.tree_util.tree_flatten_with_path(joint_ar_params_from_torch(sd, "res3x3"))[0]
    want = jax.tree_util.tree_flatten_with_path(jax_params_from_torch(sd, "res3x3"))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_weights_round_trip_both_ways():
    """The JAX res3x3 tree -> the port's state_dict -> the tree again,
    exactly; and the port's own weights -> the tree -> a second model."""
    jmodel = JModel(latent_channels=M, K=3, transform="res3x3")
    key = jax.random.PRNGKey(4)
    params = jax.tree.map(np.asarray, jmodel.init({"params": key, "noise": key},
                                                  jnp.zeros((1, 64, 64, 3)),
                                                  training=False)["params"])
    model = HierarchicalMixtureResidual(M, 3, device="cpu", seed=1)
    assert set(joint_ar_state_from_jax(params)) == set(model.state_dict())
    load_jax_params(model, params)
    back = jax.tree_util.tree_flatten_with_path(joint_ar_params_to_jax(model))[0]
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in back] == [p for p, _ in want]
    for (p, a), (_, b) in zip(back, want):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    assert any("TransposedDeconv3x3_1" in jax.tree_util.keystr(p) for p, _ in back)
    other = HierarchicalMixtureResidual(M, 3, device="cpu", seed=2)
    load_jax_params(other, joint_ar_params_to_jax(HierarchicalMixtureResidual(M, 3, device="cpu",
                                                                              seed=3)))
    for (name, a), (_, b) in zip(other.state_dict().items(),
                                 HierarchicalMixtureResidual(M, 3, device="cpu",
                                                             seed=3).state_dict().items()):
        assert torch.equal(a, b), name


def test_training_gradients_match_jax(monkeypatch):
    """One training forward, rd_loss and every parameter's gradient of the
    residual model (K=1) against jax.grad, the JAX model's noise fed to the
    port; test_torch_train.py's tolerances (rtol 1e-3, atol 1e-5 of the
    leaf's largest value: float32 sums in other orders through about 40
    layers). On the CPU this also runs the strided skips' backward."""
    x = np.random.default_rng(5).uniform(size=(2, 64, 128, 3)).astype(np.float32)
    jmodel = JModel(latent_channels=M, K=1, transform="res3x3")
    key, noise_key = jax.random.PRNGKey(5), jax.random.PRNGKey(6)
    params = jmodel.init({"params": key, "noise": key}, jnp.asarray(x), training=False)["params"]

    @jax.jit
    def value_and_grad(p):
        def loss_fn(q):
            out = jmodel.apply({"params": q}, jnp.asarray(x), training=True,
                               rngs={"noise": noise_key})
            return jrd_loss(out, jnp.asarray(x), 0.005)["loss"]
        return jax.value_and_grad(loss_fn)(p)

    loss, grads = value_and_grad(params)
    _feed_noise(monkeypatch, _jax_noise(jmodel, params, noise_key, x))
    model = load_jax_params(HierarchicalMixtureResidual(M, 1, device="cpu"),
                            jax.tree.map(np.asarray, params))
    got = rd_loss(model(torch.from_numpy(x), training=True), torch.from_numpy(x), 0.005)["loss"]
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    want = joint_ar_state_from_jax(jax.tree.map(np.asarray, grads))
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert p.grad is not None and scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3, atol=1e-5 * scale, err_msg=name)


def test_flops_match_jax():
    for t in ("conv5x5", "res3x3"):
        for args in ((192, 1, 512, 768), (M, 3, 64, 128), (128, 3, 256, 256)):
            assert flops.joint_ar_eval_flops(*args, t) == jflops.joint_ar_eval_flops(*args, t)
            assert flops.hyperprior_eval_flops(*args, t) == \
                jflops.hyperprior_eval_flops(*args, t)
            assert flops.channel_cb_eval_flops(*args, transform=t) == \
                jflops.channel_cb_eval_flops(*args, transform=t)
    assert round(flops.joint_ar_eval_flops(192, 1, 512, 768, "res3x3")["total"] / 1e9, 3) \
        == 619.345


def test_residual_model_defaults_and_transform_lookup():
    model = HierarchicalMixtureResidual(device="cpu")
    assert (model.latent_channels, model.K, model.transform) == (192, 1, "res3x3")
    assert isinstance(model.encoder, Encoder3x3) and isinstance(model.decoder, Decoder3x3)
    assert isinstance(model.hyper_encoder, HyperEncoder3x3)
    assert isinstance(model.hyper_decoder, HyperDecoder3x3)
    assert model.distribution == "Mean-Scale Gaussian"
    with pytest.raises(KeyError):  # as the JAX package's _TRANSFORMS lookup
        JointAutoregressiveHierarchical(M, 1, "res5x5", device="cpu")


def test_importer_and_residual_model_load_no_jax():
    """The reference-checkpoint importer and the residual model need no JAX
    package (the JAX importer imported here in the test process does)."""
    code = (
        "import sys\n"
        "from neural_image_compression_tpu_torch.utils.torch_import import "
        "load_reference_checkpoint\n"
        "from neural_image_compression_tpu_torch.models import HierarchicalMixtureResidual\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'neural_image_compression_tpu')"
        "\n             or m.startswith(('jax.', 'jaxlib', 'flax', 'neural_image_compression_tpu.')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
