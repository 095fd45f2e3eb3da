"""PyTorch port, the three other variable-rate families
(``GainedHyperprior``, ``GainedCheckerboard``, ``GainedChannelCheckerboard``)
held against the JAX package's on the same weights (CPU, M=16, K=2,
64x128, the gains of test_torch_gained.py): the eval forward, the fold
(against the gained forward and against JAX's fold_gains), the folded
model's family, a round trip through the family's own codec, and a
level-sampled train step."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.models import (
    GainedChannelCheckerboard as JGainedChannelCheckerboard,
)
from neural_image_compression_tpu.models import GainedCheckerboard as JGainedCheckerboard
from neural_image_compression_tpu.models import GainedHyperprior as JGainedHyperprior
from neural_image_compression_tpu.models import fold_gains as jfold_gains
from neural_image_compression_tpu_torch.coding import (
    ChannelCheckerboardCodec, CheckerboardCodec, MeanScaleHyperpriorCodec,
)
from neural_image_compression_tpu_torch.models import (
    ChannelCheckerboardHierarchical, CheckerboardHierarchical, GainedChannelCheckerboard,
    GainedCheckerboard, GainedHyperprior, MeanScaleHyperprior, fold_gains, folded_model,
    level_for_bpp,
)
from neural_image_compression_tpu_torch.parallel import make_train_step
from neural_image_compression_tpu_torch.train import rd_loss
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_params_to_jax, load_jax_params,
)
from test_torch_gained import (
    GAIN_KEYS, LEVELS, SHAPE, assert_latents_match, assert_rates_close, image, jax_out,
    port_out, randomized_gains,
)

torch.set_num_threads(1)

M, K = 16, 2
# family -> (JAX class, port class, fixed-rate class, codec)
FAMILIES = {
    "hyperprior": (JGainedHyperprior, GainedHyperprior, MeanScaleHyperprior,
                   MeanScaleHyperpriorCodec),
    "checkerboard": (JGainedCheckerboard, GainedCheckerboard, CheckerboardHierarchical,
                     CheckerboardCodec),
    "channel_cb": (JGainedChannelCheckerboard, GainedChannelCheckerboard,
                   ChannelCheckerboardHierarchical, ChannelCheckerboardCodec),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def rig(request):
    """(family, params, jitted JAX eval forward at a traced level, port model)."""
    family = request.param
    jcls, cls, _, _ = FAMILIES[family]
    jmodel = jcls(latent_channels=M, K=K, levels=LEVELS)
    key = jax.random.PRNGKey(0)
    params = randomized_gains(jmodel.init({"params": key, "noise": key},
                                          jnp.zeros(SHAPE), training=False)["params"])
    forward = jax.jit(lambda p, x, lv: jmodel.apply({"params": p}, x, training=False, level=lv))
    model = load_jax_params(cls(M, K, levels=LEVELS, device="cpu"), params)
    return family, params, forward, model


def folded(model, level):
    fm = folded_model(model)
    fm.load_state_dict(fold_gains(model.state_dict(), level))
    return fm


@pytest.mark.parametrize("level", [0, 1.3])
def test_forward_matches_jax(rig, level):
    """The tolerances of test_torch_gained.py's (tail-aware rates, tie-only
    latent flips)."""
    _, params, forward, model = rig
    x = image()
    want = jax_out(forward, params, x, level)
    got = port_out(model, x, level=level)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["y"], want["y"], rtol=2e-5, atol=3e-6)
    np.testing.assert_allclose(got["z"], want["z"], rtol=2e-5, atol=3e-6)
    assert_latents_match(got, want, "y_in", "y")
    assert_latents_match(got, want, "z_in", "z")
    assert np.count_nonzero(want["y_in"]) > 0.05 * want["y_in"].size
    np.testing.assert_allclose(got["x_hat"], want["x_hat"], rtol=1e-4, atol=1e-4)
    assert_rates_close(got, want)
    for k in ("weights", "mus", "sigmas"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("level", [0, 1.3])
def test_fold_matches_gained_forward(rig, level):
    """The JAX test's tolerances (tests/test_gained_family.py)."""
    _, _, _, model = rig
    x = image(3)
    want = port_out(model, x, level=level)
    got = port_out(folded(model, level), x)
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["z"], want["z"], rtol=1e-5, atol=1e-5)
    assert_latents_match(got, want, "y_in", "y")
    assert_latents_match(got, want, "z_in", "z")
    np.testing.assert_allclose(got["x_hat"], want["x_hat"], atol=2e-5)
    np.testing.assert_allclose(got["p_y"], want["p_y"], rtol=1e-5, atol=2e-7)
    np.testing.assert_allclose(got["p_z"], want["p_z"], rtol=1e-5, atol=2e-7)


def test_fold_gains_matches_jax_leaf_by_leaf(rig):
    """rtol 1e-6: the same products, the gains one float32 exp/log rounding
    apart at most."""
    _, params, _, model = rig
    got = joint_ar_params_to_jax(folded(model, 1.3))
    want = jax.tree.map(np.asarray, jfold_gains(params, 1.3))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=jax.tree_util.keystr(path))


def test_folded_model_type(rig):
    family, _, _, model = rig
    _, cls, fixed, _ = FAMILIES[family]
    fm = folded_model(model)
    assert type(fm) is fixed and (fm.latent_channels, fm.K) == (M, K)
    assert set(fm.state_dict()) == set(model.state_dict()) - set(GAIN_KEYS)
    if family == "channel_cb":
        assert fm.group_sizes == model.group_sizes == (2, 2, 4, 8)
        uneven = cls(M, K, groups=(4, 4, 8), levels=LEVELS, device="cpu")
        assert folded_model(uneven).group_sizes == (4, 4, 8)
        with pytest.raises(ValueError, match="groups"):
            cls(M, K, groups=(4, 4), levels=LEVELS, device="cpu")
    with pytest.raises(ValueError, match="ascending"):
        cls(M, K, levels=(0.02, 0.01), device="cpu")


def test_codec_round_trip_on_folded_model(rig):
    """The folded model through its family's own codec: the stream decodes
    to the gained forward's latents (no tie here) and x_hat."""
    family, _, _, model = rig
    codec_cls = FAMILIES[family][3]
    level = 1
    x = image(8)
    codec = codec_cls(folded(model, level))
    data = codec.compress(x)
    y_dec, z_dec = codec.decode_latents(data)
    want = port_out(model, x, level=level)
    got = {"y_in": y_dec[None], "z_in": z_dec[None]}
    assert assert_latents_match(got, want, "y_in", "y") == 0
    assert assert_latents_match(got, want, "z_in", "z") == 0
    assert len(np.unique(y_dec)) >= 3
    np.testing.assert_allclose(codec.decompress(data), np.clip(want["x_hat"], 0, 1), atol=2e-5)
    with pytest.raises(TypeError, match="variable-rate"):
        codec_cls(model)


def test_train_step_with_levels(rig):
    """A step's loss is rd_loss at levels[n] of the model before it (n and
    the noise redrawn from a clone of the generator), and every gain table
    moves over 4 steps."""
    _, _, _, model = rig
    model = copy.deepcopy(model)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3), rd_loss, 1.0,
                           levels=model.levels)
    x = torch.from_numpy(image(5, (2, 64, 64, 3)))
    gen = torch.Generator().manual_seed(11)
    before = {k: getattr(model, k).detach().clone() for k in GAIN_KEYS}
    for _ in range(4):
        replay = torch.Generator()
        replay.set_state(gen.get_state())
        snapshot = copy.deepcopy(model)
        loss = step(x, gen)["loss"].item()
        n = int(torch.randint(0, len(LEVELS), (1,), generator=replay)[0])
        want = rd_loss(snapshot(x, training=True, generator=replay, level=n), x, LEVELS[n])
        assert loss == pytest.approx(want["loss"].item(), rel=1e-6)
    for k in GAIN_KEYS:
        assert not torch.equal(getattr(model, k).detach(), before[k]), k


def test_level_for_bpp(rig):
    """Rate control on the family: a target between the ends is met within
    tol, at a level whose eval forward gives that bpp."""
    _, _, _, model = rig
    x = image(4)
    xt = torch.from_numpy(x)

    def bpp_at(level):
        return rd_loss(model(xt, training=False, level=level), xt, 0.005)["bpp_total"].item()

    target = bpp_at(0.7)
    lvl, b = level_for_bpp(model, x, target, tol=0.005)
    assert bpp_at(0.0) < b < bpp_at(2.0)
    assert abs(b - target) <= 0.005 * target and b == pytest.approx(bpp_at(lvl), rel=1e-6)
