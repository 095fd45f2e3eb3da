"""PyTorch port, scalable two-layer coding: ``LatentSpaceTransform``,
``ScalableImageCoding``'s eval and training forwards, ``vision_rd_loss``, a
vision step's gradients, the weights' and the importer's trees, serving,
the train step and the Trainer, and ``scalable_eval_flops``, each held
against the JAX package on the same weights (JAX-initialised, carried
across with load_jax_params) and numpy-seeded inputs, and the model
against the reference's golden fixtures through the port's own importer
(CPU, the golden sizes: M=16, M1=10, 64x128).

Tolerances: a module's output within 1e-5 (float32 sums in other orders
through a few convs); the full model at tests/test_golden_parity.py's:
y and z within 2e-5 and exact once rounded, x_hat, F_tilde and the
likelihoods 1e-4, the entropy parameters 1e-4 / 1e-5 / 1e-6; the losses
1e-5 relative (the golden loss 1e-4, as the JAX package's own golden
test); gradients test_torch_train.py's (1e-3 relative plus 1e-5 of the
leaf's largest value: float32 sums in other orders through about 40
layers and the teacher).
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.models import ScalableImageCoding as JScalable
from neural_image_compression_tpu.models import build_yolo_backbone as jbuild_yolo_backbone
from neural_image_compression_tpu.models import components as jcomponents
from neural_image_compression_tpu.models import distillation_targets as jdistillation_targets
from neural_image_compression_tpu.serving import make_serving_fn as jmake_serving_fn
from neural_image_compression_tpu.train.loss import vision_rd_loss as jvision_rd_loss
from neural_image_compression_tpu.utils import flops as jflops
from neural_image_compression_tpu.utils.torch_import import (
    scalable_params_from_torch as jscalable_params_from_torch,
)
from neural_image_compression_tpu_torch.models import (
    LatentSpaceTransform, ScalableImageCoding, build_yolo_backbone, distillation_targets,
)
from neural_image_compression_tpu_torch.parallel import make_train_step
from neural_image_compression_tpu_torch.serving import make_serving_fn
from neural_image_compression_tpu_torch.train import MetricsLogger, Trainer, vision_rd_loss
from neural_image_compression_tpu_torch.train import trainer as trainer_module
from neural_image_compression_tpu_torch.utils import flops
from neural_image_compression_tpu_torch.utils.torch_import import (
    load_reference_checkpoint, scalable_params_from_torch,
)
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_params_to_jax, joint_ar_state_from_jax, load_jax_params, variables_to_jax,
)
from test_torch_train import _feed_noise, _jax_noise

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
M, M1 = 16, 10
# the teacher: P3 channels 4 * width == 2 * M1, on the /8 grid of F_tilde
TEACHER_WIDTH, CUT = 5, 3
GAIN_Y, GAIN_Z = 12.0, 30.0  # spread y and z over several integers (test_torch_codec.py)
LAMBDA, GAMMA = 0.01, 1.0
MODULE_TOL = 1e-5


def _nchw_to_nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


def _gained(params):
    params = jax.tree.map(np.array, params)
    for path, gain in ((("encoder", "Conv2d_3"), GAIN_Y), (("hyper_encoder", "Conv2d_2"), GAIN_Z)):
        leaf = params[path[0]][path[1]]
        leaf["kernel"] = leaf["kernel"] * gain
        leaf["bias"] = leaf["bias"] * gain
    return params


def _image(seed=0, batch=1):
    return np.random.default_rng(seed).uniform(size=(batch, 64, 128, 3)).astype(np.float32)


EVAL_X, TRAIN_X = _image(1, batch=2), _image(4, batch=2)
NOISE_KEY = jax.random.PRNGKey(5)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module", params=[1, 3], ids=["K1", "K3"])
def pair(request):
    """(K, JAX model, gained params (the flax tree of a seeded port model),
    the port's model with them)."""
    K = request.param
    jmodel = JScalable(latent_channels=M, base_channels=M1, K=K)
    params = _gained(joint_ar_params_to_jax(ScalableImageCoding(M, M1, K, device="cpu", seed=K)))
    model = load_jax_params(ScalableImageCoding(M, M1, K, device="cpu"), params)
    return K, jmodel, params, model


@pytest.fixture(scope="module")
def teacher():
    """(JAX (activation, V), the port's (activation, V)) of one width-5
    backbone cut at layer 3, the JAX one on the port's variables."""
    bb = build_yolo_backbone(TEACHER_WIDTH, device="cpu", seed=42)
    variables = _jax_tree(variables_to_jax(bb))
    return jdistillation_targets(jbuild_yolo_backbone(width=TEACHER_WIDTH), variables, CUT), \
        distillation_targets(bb, CUT)


@pytest.fixture(scope="module")
def jax_runs(pair, teacher):
    """The JAX package on the pair's weights, two jitted programs: the eval
    forward with vision_rd_loss (with and without the teacher) and the
    serving function's rates on EVAL_X; the training forward, its
    vision_rd_loss with the teacher and jax.grad of it on TRAIN_X with the
    noise of NOISE_KEY."""
    _, jmodel, params, _ = pair
    (jact, jV), _ = teacher
    serve = jmake_serving_fn(jmodel, params)

    @jax.jit
    def evaluate(p, x):
        out = jmodel.apply({"params": p}, x, training=False)
        return (out, jvision_rd_loss(out, x, LAMBDA, GAMMA, jact, jV),
                jvision_rd_loss(out, x, LAMBDA, GAMMA), serve(x))

    @jax.jit
    def train(p, x):
        def loss_fn(q):
            out = jmodel.apply({"params": q}, x, training=True, rngs={"noise": NOISE_KEY})
            return jvision_rd_loss(out, x, LAMBDA, GAMMA, jact, jV)["loss"], out
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    host = functools.partial(jax.tree.map, np.asarray)
    out, with_teacher, without, served = host(evaluate(_jax_tree(params), jnp.asarray(EVAL_X)))
    (loss, train_out), grads = host(train(_jax_tree(params), jnp.asarray(TRAIN_X)))
    return dict(eval=out, losses={True: with_teacher, False: without}, serve=served,
                train=train_out, loss=loss, grads=grads)


def _port_out(out):
    return {k: v.detach().numpy() for k, v in out.items() if k != "training"}


def _assert_forward_close(got, want, K, rounded=True):
    """tests/test_golden_parity.py's tolerances, for both layers. With
    rounded=False (the training forward) y_in and z_in are held at y's
    and z's tolerance."""
    for key in ("y", "z"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-5, atol=2e-5, err_msg=key)
    for key in ("y_in", "z_in", "y1", "y2"):
        if rounded:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=2e-5, atol=2e-5, err_msg=key)
    for key in ("x_hat", "F_tilde"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
    np.testing.assert_allclose(got["p_z"], want["p_z"], rtol=1e-4, atol=1e-7)
    bits_got = bits_want = 0.0
    for layer in ("1", "2"):
        np.testing.assert_allclose(got["p_y" + layer], want["p_y" + layer], rtol=1e-4,
                                   atol=1e-7, err_msg="p_y" + layer)
        if K == 1:
            tols = {"mu": 1e-5, "sigma": 1e-5}
        else:
            tols = {"weights": 1e-6, "mus": 1e-5, "sigmas": 1e-5}
        for key, atol in tols.items():
            np.testing.assert_allclose(got[key + layer], want[key + layer], rtol=1e-4,
                                       atol=atol, err_msg=key + layer)
        bits_got -= np.sum(np.log(got["p_y" + layer]), dtype=np.float64)
        bits_want -= np.sum(np.log(want["p_y" + layer]), dtype=np.float64)
    assert abs(bits_got - bits_want) / bits_want < 1e-4


# --- the LatentSpaceTransform ---------------------------------------------------

@pytest.mark.parametrize("ups", [(2, 1, 1, 1), (2, 2, 1, 2)])
def test_latent_space_transform_matches_jax(ups):
    """The widths grow by each stage's factor: the default, and a schedule
    that grows them twice and in the last conv."""
    x = np.random.default_rng(sum(ups)).normal(size=(2, 4, 8, M1)).astype(np.float32)
    mod = LatentSpaceTransform(M1, ups, device="cpu", generator=torch.Generator().manual_seed(1))
    jmod = jcomponents.LatentSpaceTransform(latent_channels=M1, upsampling_factors=ups)
    params = _jax_tree(joint_ar_params_to_jax(mod))
    assert jax.tree.structure(params) == jax.tree.structure(
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x)))
    got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    scale = int(np.prod(ups[:3]))
    assert got.shape == want.shape == (2, 4 * scale, 8 * scale, M1 * scale * ups[3])
    np.testing.assert_allclose(got, want, rtol=MODULE_TOL, atol=MODULE_TOL)


def test_lst_default_widths():
    """(2, 1, 1, 1): the first stage's IGDN at M1, the next two at 2 M1, the
    second stage's block bridging M1 -> 2 M1 through its 1x1 skip."""
    lst = LatentSpaceTransform(128, device="cpu")
    assert [lst.get_submodule(f"ResidualBlockUpsample_{i}.GDN_0").beta.shape[0]
            for i in range(3)] == [128, 256, 256]
    assert not hasattr(lst.ResidualBlock_0, "Conv2d_2")
    assert tuple(lst.ResidualBlock_1.Conv2d_2.weight.shape) == (256, 128, 1, 1)
    assert tuple(lst.Conv2d_0.weight.shape) == (256, 256, 3, 3)


# --- the model -------------------------------------------------------------------

def test_eval_forward_matches_jax(pair, jax_runs):
    K, _, _, model = pair
    want = {k: v for k, v in jax_runs["eval"].items() if k != "training"}
    got = _port_out(model(torch.from_numpy(EVAL_X), training=False))
    assert set(got) == set(want)
    assert len(np.unique(got["y1"])) >= 3 and len(np.unique(got["y2"])) >= 3
    _assert_forward_close(got, want, K)
    np.testing.assert_array_equal(got["y1"], got["y_in"][..., :M1])
    np.testing.assert_array_equal(got["y2"], got["y_in"][..., M1:])


def test_training_forward_matches_jax(pair, jax_runs, monkeypatch):
    K, jmodel, params, model = pair
    want = {k: v for k, v in jax_runs["train"].items() if k != "training"}
    _feed_noise(monkeypatch, _jax_noise(jmodel, _jax_tree(params), NOISE_KEY, TRAIN_X))
    out = model(torch.from_numpy(TRAIN_X), training=True)
    assert out["training"] is True and out["x_hat"].requires_grad
    _assert_forward_close(_port_out(out), want, K, rounded=False)


def _golden(K):
    fx = np.load(os.path.join(GOLDEN, f"fullmodel_scalable_k{K}.npz"))
    sd = {k[3:]: fx[k] for k in fx.files if k.startswith("sd_")}

    def ref(k):
        v = fx["out_" + k]
        if v.ndim == 4:
            return _nchw_to_nhwc(v)
        if v.ndim == 5:  # (B, K, M, H, W) -> (B, H, W, K, M)
            return np.transpose(v, (0, 3, 4, 1, 2))
        return v

    return fx, sd, {k[4:]: ref(k[4:]) for k in fx.files if k.startswith("out_")}


@pytest.mark.parametrize("K", [1, 3])
def test_eval_forward_golden_through_the_ports_importer(K):
    """The reference's fixture (LST upsampling (1, 1, 1, 1), as it was
    exported) through utils.torch_import: latents exact, the rest within
    the golden tolerances (the fixture has no K=3 mus/sigmas beyond
    weights' companions, which are checked too)."""
    fx, sd, want = _golden(K)
    model = load_jax_params(ScalableImageCoding(M, M1, K, lst_upsampling=(1, 1, 1, 1),
                                                device="cpu"), scalable_params_from_torch(sd))
    got = _port_out(model(torch.from_numpy(_nchw_to_nhwc(fx["x"]).copy()), training=False))
    np.testing.assert_allclose(got["y"], want["y"], rtol=2e-5, atol=2e-5)
    for key in ("y_in", "z_in", "y1", "y2"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("x_hat", "F_tilde"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
    np.testing.assert_allclose(got["p_z"], want["p_z"], rtol=1e-4, atol=1e-7)
    for layer in ("1", "2"):
        np.testing.assert_allclose(got["p_y" + layer], want["p_y" + layer], rtol=1e-4, atol=1e-7)
        keys = {"mu": 1e-5, "sigma": 1e-5} if K == 1 else {"weights": 1e-6, "mus": 1e-5,
                                                            "sigmas": 1e-5}
        for key, atol in keys.items():
            np.testing.assert_allclose(got[key + layer], want[key + layer], rtol=1e-4, atol=atol,
                                       err_msg=key + layer)


def test_importer_and_checkpoint_match_the_jax_packages(tmp_path):
    _, sd, _ = _golden(3)
    got = jax.tree_util.tree_flatten_with_path(scalable_params_from_torch(sd))[0]
    want = jax.tree_util.tree_flatten_with_path(jscalable_params_from_torch(sd))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    path = str(tmp_path / "scalable.pth")
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                "step": 7}, path)
    loaded = jax.tree_util.tree_flatten_with_path(load_reference_checkpoint(path, scalable=True))
    assert [p for p, _ in loaded[0]] == [p for p, _ in got]
    for (p, a), (_, b) in zip(loaded[0], got):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_weights_round_trip_both_ways(pair):
    """The flax tree (context_model_1/2, entropy_parameters_1/2, LST: the
    JAX model's own structure) -> the port's state_dict -> the tree again,
    exactly."""
    _, jmodel, params, model = pair
    init = jax.eval_shape(lambda k: jmodel.init({"params": k, "noise": k},
                                                jnp.zeros((1, 64, 64, 3)), training=False),
                          jax.random.PRNGKey(0))["params"]
    assert jax.tree.structure(_jax_tree(params)) == jax.tree.structure(init)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(init)):
        assert a.shape == b.shape
    assert set(joint_ar_state_from_jax(params)) == set(model.state_dict())
    back = jax.tree_util.tree_flatten_with_path(joint_ar_params_to_jax(model))[0]
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in back] == [p for p, _ in want]
    for (p, a), (_, b) in zip(back, want):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    names = {jax.tree_util.keystr(p) for p, _ in back}
    for part in ("context_model_2", "entropy_parameters_1", "LST"):
        assert any(part in n for n in names)


def test_model_checks_raise():
    for m1 in (0, M, M + 1):
        with pytest.raises(ValueError, match="0 < M1 < M"):
            ScalableImageCoding(M, m1, device="cpu")
    model = ScalableImageCoding(M, M1, device="cpu")
    with pytest.raises(ValueError, match="multiples of 64"):
        model(torch.zeros(1, 64, 96, 3), training=False)
    assert (model.M1, model.M2, model.K, model.latent_channels) == (M1, M - M1, 1, M)
    default = ScalableImageCoding(device="cpu")
    assert (default.latent_channels, default.base_channels, default.lst_upsampling) == \
        (192, 128, (2, 1, 1, 1))


# --- the loss and a vision step ----------------------------------------------------

def test_vision_rd_loss_golden():
    """The reference's oracle: V its seeded 1x1 conv, the activation SiLU."""
    fx = np.load(os.path.join(GOLDEN, "vision_rd_loss_ref.npz"))
    out = {k: torch.from_numpy(_nchw_to_nhwc(fx[k]).copy())
           for k in ("x_hat", "F_tilde", "logp_y1", "logp_y2", "logp_z")}
    w, b = torch.from_numpy(fx["V_w"][:, :, 0, 0]), torch.from_numpy(fx["V_b"])
    res = vision_rd_loss(out, torch.from_numpy(_nchw_to_nhwc(fx["x"]).copy()), 0.02, gamma=0.7,
                         frozen_activation=torch.nn.functional.silu,
                         V=lambda img: torch.einsum("bhwc,oc->bhwo", img, w) + b)
    np.testing.assert_allclose(float(res["loss"]), float(fx["loss"]), rtol=1e-5)
    for k in ("bpp_y1", "bpp_y2", "bpp_y", "bpp_z", "bpp_total", "mse", "reconstruction_mse",
              "psnr", "vision_mse", "bits_total"):
        np.testing.assert_allclose(float(res[k]), float(fx[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(res["mse_per_image"].numpy(), fx["mse_per_image"], rtol=1e-4)


@pytest.mark.parametrize("distil", [True, False], ids=["teacher", "no_teacher"])
def test_vision_rd_loss_matches_jax(pair, teacher, jax_runs, distil):
    _, _, _, model = pair
    _, (act, V) = teacher
    want = jax_runs["losses"][distil]
    out = model(torch.from_numpy(EVAL_X), training=False)
    got = vision_rd_loss(out, torch.from_numpy(EVAL_X), LAMBDA, GAMMA,
                         *((act, V) if distil else (None, None)))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert (float(got["vision_mse"]) > 0) == distil


def test_vision_step_gradients_match_jax(pair, teacher, jax_runs, monkeypatch):
    """One training forward, vision_rd_loss with the teacher (gamma 1) and
    every parameter's gradient against jax.grad, the JAX noise fed to the
    port; the teacher takes none."""
    K, jmodel, params, _ = pair
    _, (act, V) = teacher
    _feed_noise(monkeypatch, _jax_noise(jmodel, _jax_tree(params), NOISE_KEY, TRAIN_X))
    model = load_jax_params(ScalableImageCoding(M, M1, K, device="cpu"), params)
    x = torch.from_numpy(TRAIN_X)
    got = vision_rd_loss(model(x, training=True), x, LAMBDA, GAMMA, act, V)["loss"]
    got.backward()
    np.testing.assert_allclose(got.item(), float(jax_runs["loss"]), rtol=1e-5)
    want = joint_ar_state_from_jax(jax_runs["grads"])
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert p.grad is not None and scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3, atol=1e-5 * scale, err_msg=name)
    assert all(p.grad is None and not p.requires_grad for p in V.parameters())


def test_train_step_and_trainer_run_the_vision_loss(pair, teacher, tmp_path, monkeypatch):
    """make_train_step with vision_rd_loss bound to the teacher lowers the
    loss on one batch; the Trainer validates with it and logs the two
    layers' streams (the JAX Trainer's y1/y2 scalar tags; no y stream)."""
    K, _, params, _ = pair
    _, (act, V) = teacher
    loss = functools.partial(vision_rd_loss, gamma=GAMMA, frozen_activation=act, V=V)
    model = load_jax_params(ScalableImageCoding(M, M1, K, device="cpu"), params)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(model, opt, loss, LAMBDA)
    x = torch.from_numpy(_image(6, batch=2))
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(x, gen)["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    # the JSONL sink alone: the scalars are what is checked
    monkeypatch.setattr(trainer_module, "MetricsLogger",
                        functools.partial(MetricsLogger, tensorboard=False))
    trainer = Trainer(model, [_image(7, batch=2)], val_loader=[_image(8)], rd_loss=loss,
                      lambda_val=LAMBDA, max_steps=2, val_interval=1, log_interval=1,
                      img_interval=1, log_dir=str(tmp_path / "runs"), checkpoint_path=None)
    trainer.train()
    tags = {json.loads(line)["tag"] for line in open(tmp_path / "runs" / "metrics.jsonl")}
    want = {"losses/bpp_y1", "losses/bpp_y2", "losses/vision_mse", "validation/validation_loss",
            "validation/validation_bpp", "activity/y1_dead_channels_by_entropy",
            "activity/y2_dead_channels_by_entropy", "probability/logp_y2_mean",
            "entropy/entropy_y1_mean", "entropy/entropy_z_mean"}
    if K > 1:
        want |= {"entropy_params/used_components_mean1", "entropy_params/used_components_mean2"}
    assert want <= tags, sorted(want - tags)
    assert not any(t.endswith(("_y_mean", "/y_dead_channels_by_entropy")) for t in tags)


def test_serving_matches_jax(pair, jax_runs):
    """make_serving_fn's y rate sums both layers, as the JAX package's."""
    _, _, _, model = pair
    got = make_serving_fn(model)(EVAL_X)
    for k in ("bpp_y", "bpp_z", "bpp_total", "x_hat"):
        np.testing.assert_allclose(got[k].numpy(), jax_runs["serve"][k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_flops_match_jax():
    for args in ((192, 128, 1, 512, 768), (192, 128, 3, 512, 768), (M, M1, 3, 64, 128),
                 (192, 128, 1, 256, 256)):
        for ups in ((2, 1, 1, 1), (1, 1, 1, 1)):
            assert flops.scalable_eval_flops(*args, ups) == jflops.scalable_eval_flops(*args, ups)
    gflop = {k: round(flops.scalable_eval_flops(192, 128, k, 512, 768)["total"] / 1e9, 3)
             for k in (1, 3)}
    assert gflop == {1: 254.945, 3: 257.647}
    assert round(flops.scalable_eval_flops(192, 128, 1, 512, 768)["lst"] / 1e9, 3) == 96.435
    assert round(flops.scalable_eval_flops(192, 128, 1, 256, 256)["total"] / 1e9, 3) == 42.491


def test_scalable_modules_load_no_jax():
    code = (
        "import sys\n"
        "import neural_image_compression_tpu_torch.models.scalable\n"
        "import neural_image_compression_tpu_torch.models.vision\n"
        "import neural_image_compression_tpu_torch.models.backbones\n"
        "from neural_image_compression_tpu_torch.coding import ScalableCodec\n"
        "from neural_image_compression_tpu_torch.evaluation import VisionCompressionEvaluator\n"
        "from neural_image_compression_tpu_torch.train import vision_rd_loss\n"
        "from neural_image_compression_tpu_torch.utils import yolo_backbone_variables_from_torch\n"
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
