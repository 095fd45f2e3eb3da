"""PyTorch port, the variable-rate flagship: ``models.GainedJointAR``, gain
folding, rate control, level-sampled training and the Trainer's level
wiring, held against the JAX package's ``models/gained.py`` on the same
weights (JAX-initialised, carried across with load_jax_params) and against
the port's own fixed-rate model and codec (CPU, M=16, K=1 and 2, 64x128).

The gains are drawn as the JAX package's tests draw them: all-ones gains
make every level the same model and the fold trivially exact, so each
table is 0.3 + 2U, and gain_y / gain_z grow 4x a level so that higher
levels code more bits at random init. The last analysis and hyper-analysis
convs are also scaled by 4 and 12 (as ``chip_smoke.py`` does), so that y
spreads over several integers at level 0 too."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.models import GainedJointAR as JGained
from neural_image_compression_tpu.models import fold_gains as jfold_gains
from neural_image_compression_tpu.models import interp_gain as jinterp_gain
from neural_image_compression_tpu.models import level_for_bpp as jlevel_for_bpp
from neural_image_compression_tpu_torch.coding import JointARCodec
from neural_image_compression_tpu_torch.models import (
    GainedJointAR, JointAutoregressiveHierarchical, fold_gains, folded_model, interp_gain,
    joint_ar, level_for_bpp,
)
from neural_image_compression_tpu_torch.parallel import make_train_step
from neural_image_compression_tpu_torch.train import Trainer, rd_loss
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_params_to_jax, joint_ar_state_from_jax, load_jax_params,
)

torch.set_num_threads(1)

M = 16
LEVELS = (0.001, 0.005, 0.02)
SHAPE = (1, 64, 128, 3)
GAIN_KEYS = ("gain_y", "igain_y", "gain_z", "igain_z")
# Where p_y lies within a few float32 steps of 0, it is the difference of
# two CDF values that round to neighbouring floats near 1, and the two
# packages' erf implementations round them differently: p_y agrees to two
# float32 steps of 1 (2.4e-7) everywhere, logp_y where p_y > 1e-3 (there
# the rounding moves it by less than 1e-4). At level 2 (16x gains) 4 of
# 512 latents of the K=1 model sit in such a tail.
P_Y_ATOL, LOGP_BODY = 2.4e-7, 1e-3
# y and z before rounding agree to 3e-6 here (2.8e-6 measured at level 2,
# |y| up to 4); a rounded latent may differ only where its pre-round value
# lies within 1e-4 of a .5 tie.
TIE_TOL = 1e-4


# the scales on encoder.Conv2d_3 and hyper_encoder.Conv2d_2 (kernel and bias)
CONV_GAINS = {"encoder": ("Conv2d_3", 4.0), "hyper_encoder": ("Conv2d_2", 12.0)}


def randomized_gains(params, seed=1):
    """The JAX tests' gains (tests/test_gained.py _randomize_gains), and
    CONV_GAINS on the two bottleneck convs."""
    rng = np.random.RandomState(seed)
    out = jax.tree.map(np.array, params)
    for tree, (conv, gain) in CONV_GAINS.items():
        for leaf in ("kernel", "bias"):
            out[tree][conv][leaf] = out[tree][conv][leaf] * np.float32(gain)
    for k in GAIN_KEYS:
        r = 0.3 + rng.rand(*out[k].shape).astype(np.float32) * 2.0
        if k in ("gain_y", "gain_z"):
            r = r * (4.0 ** np.arange(r.shape[0], dtype=np.float32))[:, None]
        out[k] = r
    return out


def image(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.fixture(scope="module", params=[1, 2], ids=["K1", "K2"])
def rig(request):
    """(K, JAX model, params, jitted JAX eval forward at a traced level, port model)."""
    K = request.param
    jmodel = JGained(latent_channels=M, K=K, levels=LEVELS)
    key = jax.random.PRNGKey(0)
    params = randomized_gains(jmodel.init({"params": key, "noise": key},
                                          jnp.zeros(SHAPE), training=False)["params"])
    forward = jax.jit(lambda p, x, lv: jmodel.apply({"params": p}, x, training=False, level=lv))
    model = load_jax_params(GainedJointAR(M, K, LEVELS, device="cpu"), params)
    return K, jmodel, params, forward, model


def jax_out(forward, params, x, level):
    out = forward(params, jnp.asarray(x), jnp.float32(level))
    return {k: np.asarray(v) for k, v in out.items() if k != "training"}


def port_out(model, x, **kw):
    out = model(torch.from_numpy(x), training=False, **kw)
    return {k: v.numpy() for k, v in out.items() if k != "training"}


def assert_latents_match(got, want, rounded, pre):
    """The rounded latents equal, but where the pre-round value sits on a
    round() tie (within TIE_TOL of x.5), where they may be one step apart.
    Returns the number of such flips."""
    a, b = got[rounded], want[rounded]
    mism = a != b
    if mism.any():
        assert np.all(np.abs(a[mism] - b[mism]) <= 1.0), rounded
        pre_v = want[pre].astype(np.float32)[mism]
        assert np.all(np.abs(np.abs(pre_v - np.floor(pre_v)) - 0.5) < TIE_TOL), \
            f"{rounded}: a mismatch away from a tie"
    return int(mism.sum())


def assert_rates_close(got, want):
    np.testing.assert_allclose(got["p_y"], want["p_y"], rtol=1e-4, atol=P_Y_ATOL)
    body = want["p_y"] > LOGP_BODY
    np.testing.assert_allclose(got["logp_y"][body], want["logp_y"][body], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["p_z"], want["p_z"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got["logp_z"], want["logp_z"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("level", [0, 1, 2, 1.3])
def test_forward_matches_jax(rig, level):
    K, _, params, forward, model = rig
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
    for k in (("mu", "sigma") if K == 1 else ("weights", "mus", "sigmas")):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_levels_change_the_rate(rig):
    _, _, _, _, model = rig
    x = torch.from_numpy(image(2))
    bits = [rd_loss(model(x, training=False, level=lv), x, 0.005)["bpp_total"].item()
            for lv in (0, 1, 2)]
    assert bits[0] < bits[1] < bits[2]


def test_interp_gain_matches_jax():
    table = np.asarray([[1.0, 4.0], [2.0, 1.0]], np.float32)
    t = torch.from_numpy(table)
    np.testing.assert_allclose(interp_gain(t, 0).numpy(), [1.0, 4.0], rtol=1e-6)
    np.testing.assert_allclose(interp_gain(t, 1).numpy(), [2.0, 1.0], rtol=1e-6)
    np.testing.assert_allclose(interp_gain(t, 0.5).numpy(), [np.sqrt(2.0), 2.0], rtol=1e-6)
    np.testing.assert_allclose(interp_gain(t, 7.0).numpy(), [2.0, 1.0], rtol=1e-6)
    np.testing.assert_allclose(interp_gain(t, -3).numpy(), [1.0, 4.0], rtol=1e-6)
    # against JAX on a wider table, host levels and 0-dim tensor levels alike
    # (one float32 exp/log rounding apart at most)
    wide = 0.3 + np.random.RandomState(3).rand(5, 7).astype(np.float32) * 2
    for level in (0, 1, 2.5, 3.7, 4, 9, -1):
        want = np.asarray(jinterp_gain(jnp.asarray(wide), level))
        for lv in (level, torch.tensor(level)):
            got = interp_gain(torch.from_numpy(wide), lv)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, err_msg=f"level {level}")
            # a stack of tables gives each table's vector, bit for bit
            stacked = interp_gain(torch.from_numpy(np.stack([wide, 2 * wide])), lv)
            assert torch.equal(stacked[0], got)
            assert torch.equal(stacked[1], interp_gain(torch.from_numpy(2 * wide), lv))


@pytest.mark.parametrize("level", [0, 1, 2, 1.3])
def test_fold_matches_gained_forward(rig, level):
    """The folded fixed-rate model against the gained forward, the JAX
    test's tolerances (tests/test_gained.py test_fold_matches_gained_forward)."""
    _, _, _, _, model = rig
    x = image(3)
    want = port_out(model, x, level=level)
    fm = folded_model(model)
    fm.load_state_dict(fold_gains(model.state_dict(), level))
    got = port_out(fm, x)
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["z"], want["z"], rtol=1e-5, atol=1e-5)
    assert_latents_match(got, want, "y_in", "y")
    assert_latents_match(got, want, "z_in", "z")
    np.testing.assert_allclose(got["x_hat"], want["x_hat"], atol=2e-5)
    np.testing.assert_allclose(got["p_y"], want["p_y"], rtol=1e-5, atol=2e-7)
    np.testing.assert_allclose(got["p_z"], want["p_z"], rtol=1e-5, atol=2e-7)


@pytest.mark.parametrize("level", [2, 1.3])
def test_fold_gains_matches_jax_leaf_by_leaf(rig, level):
    """The port's folded state_dict, carried back to a flax tree, against
    JAX's fold_gains: the same products, the gains one float32 exp/log
    rounding apart at most (rtol 1e-6)."""
    _, _, params, _, model = rig
    fm = folded_model(model)
    fm.load_state_dict(fold_gains(model.state_dict(), level))
    got = joint_ar_params_to_jax(fm)
    want = jax.tree.map(np.asarray, jfold_gains(params, level))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=jax.tree_util.keystr(path))
    # the four boundary convolutions changed; nothing else did
    plain = joint_ar_params_to_jax(model)
    assert not np.array_equal(got["encoder"]["Conv2d_3"]["kernel"],
                              plain["encoder"]["Conv2d_3"]["kernel"])
    np.testing.assert_array_equal(got["decoder"]["Deconv2d_0"]["bias"],
                                  plain["decoder"]["Deconv2d_0"]["bias"])
    np.testing.assert_array_equal(got["context_model"]["MaskedConv2d_0"]["kernel"],
                                  plain["context_model"]["MaskedConv2d_0"]["kernel"])


def test_folded_model_and_the_errors(rig):
    K, _, _, _, model = rig
    fm = folded_model(model)
    assert type(fm) is JointAutoregressiveHierarchical
    assert (fm.latent_channels, fm.K, fm.dtype, fm.transform) == (M, K, None, "conv5x5")
    assert set(fm.state_dict()) == set(model.state_dict()) - set(GAIN_KEYS)
    plain = JointAutoregressiveHierarchical(8, 1, device="cpu")
    with pytest.raises(TypeError, match="not a gained model"):
        folded_model(plain)
    with pytest.raises(ValueError, match="not a gained model's state_dict"):
        fold_gains(plain.state_dict(), 0)
    with pytest.raises(ValueError, match="ascending"):
        GainedJointAR(8, levels=(0.01, 0.001), device="cpu")
    with pytest.raises(ValueError, match=">= 2"):
        GainedJointAR(8, levels=(0.01,), device="cpu")
    with pytest.raises(ValueError, match="K must be"):
        GainedJointAR(8, 0, device="cpu")


def test_gain_parameters(rig):
    """Gains are float32 (N, M) parameters, ones at init; the defaults are
    the JAX ladder and widths."""
    fresh = GainedJointAR(M, 1, device="cpu")
    assert fresh.levels == (0.0015, 0.0035, 0.0075, 0.015, 0.03)
    assert (fresh.latent_channels, fresh.K) == (M, 1)
    names = dict(fresh.named_parameters())
    for k in GAIN_KEYS:
        assert names[k].shape == (5, M) and names[k].dtype == torch.float32
        assert torch.equal(names[k], torch.ones(5, M))
    default = GainedJointAR(device="cpu")
    assert (default.latent_channels, default.K) == (192, 1)


class JaxBacked:
    """The JAX model at its params behind the port's model interface (the
    levels, the gains' device, the eval forward's logp tensors), so that
    the port's level_for_bpp bisects JAX's own rates."""

    def __init__(self, jmodel, params, forward):
        self.levels, self.gain_y = jmodel.levels, torch.ones(1)
        self._params, self._forward, self.probes = params, forward, []

    def __call__(self, x, training, level):
        assert training is False
        self.probes.append(level)
        out = self._forward(self._params, jnp.asarray(x.numpy()), jnp.float32(level))
        return {k: torch.from_numpy(np.asarray(out[k])) for k in ("logp_y", "logp_z")}


def test_level_for_bpp_matches_jax(rig):
    """The port's bisection over JAX's rates finds JAX's level and bpp (the
    same probes, clamping and early exit); over the port's own rates it
    finds a level whose bpp is within tol of the target. The two packages'
    rates differ by up to 1.5% here (each latent in the upper tail of its
    Gaussian costs 23 or 30 bits as float32 rounds its CDFs), so the two
    searches take different paths."""
    K, jmodel, params, forward, model = rig
    x = image(4)
    xt = torch.from_numpy(x)

    def bpp_at(level):
        return rd_loss(model(xt, training=False, level=level), xt, 0.005)["bpp_total"].item()

    def jbpp_at(level):
        out = forward(params, jnp.asarray(x), jnp.float32(level))
        return float(-(jnp.sum(out["logp_y"]) + jnp.sum(out["logp_z"])) / jnp.log(2.0) / (64 * 128))

    jtarget = jbpp_at(1.37)
    stub = JaxBacked(jmodel, params, forward)
    for target, tol in ((jtarget, 0.005), (jtarget, 0.01), (jbpp_at(0.0) * 0.5, 0.01),
                        (jbpp_at(2.0) * 2.0, 0.01)):
        stub.probes.clear()
        got = level_for_bpp(stub, x, target, tol=tol)
        want = jlevel_for_bpp(jmodel, params, jnp.asarray(x), target, tol=tol)
        # the same level; the bpp is JAX's forward's there, summed in
        # another order (rel 1e-5). JAX's level_for_bpp fuses its probe into
        # one program, which rounds the tail latents' CDFs otherwise: its
        # own bpp is up to 0.35% from its forward's here, so it is not held.
        assert got[0] == want[0], (target, tol, stub.probes)
        assert got[1] == pytest.approx(jbpp_at(got[0]), rel=1e-5)
    target = bpp_at(1.37)
    lvl, b = level_for_bpp(model, x, target, tol=0.005)
    assert 0.0 < lvl < 2.0 and abs(b - target) <= 0.005 * target
    assert b == pytest.approx(bpp_at(lvl), rel=1e-6)
    b_lo, b_hi = bpp_at(0.0), bpp_at(2.0)
    assert b_lo < target < b_hi
    lvl, b = level_for_bpp(model, x, b_lo * 0.5)
    assert lvl == 0.0 and b == pytest.approx(b_lo, rel=1e-6)
    lvl, b = level_for_bpp(model, x, b_hi * 2.0)
    assert lvl == 2.0 and b == pytest.approx(b_hi, rel=1e-6)
    with pytest.raises(ValueError, match="positive"):
        level_for_bpp(model, x, 0.0)
    with pytest.raises(ValueError, match="B, H, W"):
        level_for_bpp(model, x[0], 0.5)


def test_train_step_draws_a_level_and_weights_its_lambda(rig):
    """Each step's loss is rd_loss at levels[n] of the model before the
    step, forwarded at level n with the step's noise: n and the noise
    redrawn from a clone of the generator's state, level first. Over 8
    steps more than one level is drawn and every gain table moves."""
    K, _, params, _, _ = rig
    model = load_jax_params(GainedJointAR(M, K, LEVELS, device="cpu"), params)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(model, opt, rd_loss, 123.0, levels=model.levels)
    x = torch.from_numpy(image(5, (2, 64, 64, 3)))
    gen = torch.Generator().manual_seed(7)
    before = {k: getattr(model, k).detach().clone() for k in GAIN_KEYS}
    drawn = []
    for _ in range(8):
        replay = torch.Generator()
        replay.set_state(gen.get_state())
        snapshot = copy.deepcopy(model)
        loss = step(x, gen)["loss"].item()
        n = int(torch.randint(0, len(LEVELS), (1,), generator=replay)[0])
        want = rd_loss(snapshot(x, training=True, generator=replay, level=n), x, LEVELS[n])
        assert loss == pytest.approx(want["loss"].item(), rel=1e-6)
        assert torch.equal(replay.get_state(), gen.get_state())
        drawn.append(n)
    assert len(set(drawn)) > 1, drawn
    for k in GAIN_KEYS:
        assert not torch.equal(getattr(model, k).detach(), before[k]), k


def test_trainer_validates_at_the_middle_level(rig, tmp_path):
    K, _, params, _, _ = rig
    model = load_jax_params(GainedJointAR(M, K, LEVELS, device="cpu"), params)
    train = [image(6, (2, 64, 64, 3))]
    val = [image(7)]
    trainer = Trainer(model, train, val_loader=val, max_steps=2, val_interval=1,
                      log_interval=10 ** 6, img_interval=10 ** 6, lambda_val=0.5,
                      log_dir=str(tmp_path / "runs"), checkpoint_path=None)
    assert trainer._val_kwargs == {"level": 1}
    assert trainer._val_lambda == LEVELS[1]
    trainer.train()
    rows = [json.loads(line) for line in open(tmp_path / "runs" / "metrics.jsonl")]
    logged = [r["value"] for r in rows if r["tag"] == "validation/validation_loss"]
    assert len(logged) == 2
    xv = torch.from_numpy(val[0])
    want = rd_loss(model(xv, training=False, level=1), xv, LEVELS[1])["loss"].item()
    assert logged[-1] == pytest.approx(want, rel=1e-6)
    other = rd_loss(model(xv, training=False), xv, 0.5)["loss"].item()
    assert abs(other - want) > 1e-3 * want


def test_codec_round_trip_on_folded_model(rig):
    """A folded gained model drives the real codec unchanged: its stream
    decodes to the gained forward's latents and x_hat."""
    _, _, _, _, model = rig
    level = 1
    x = image(8)
    fm = folded_model(model)
    fm.load_state_dict(fold_gains(model.state_dict(), level))
    codec = JointARCodec(fm)
    data = codec.compress(x)
    y_dec, z_dec = codec.decode_latents(data)
    want = port_out(model, x, level=level)
    got = {"y_in": y_dec[None], "z_in": z_dec[None]}
    assert assert_latents_match(got, want, "y_in", "y") == 0
    assert assert_latents_match(got, want, "z_in", "z") == 0
    np.testing.assert_allclose(codec.decompress(data), np.clip(want["x_hat"], 0, 1), atol=2e-5)
    # the gained model itself is refused: the codec would code it without its gains
    with pytest.raises(TypeError, match="variable-rate"):
        JointARCodec(model)


def test_weight_walker_carries_the_gain_leaves(rig):
    """The four top-level (N, M) gain tables go across as they are, both
    ways, and the whole gained tree round-trips exactly."""
    _, _, params, _, model = rig
    state = joint_ar_state_from_jax(params)
    for k in GAIN_KEYS:
        assert state[k].shape == (len(LEVELS), M)
        np.testing.assert_array_equal(state[k].numpy(), params[k])
    back = joint_ar_params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_noise_order_is_z_then_y(rig, monkeypatch):
    """The training forward scales before the noise and draws z's noise
    first, then y's (JAX splits (rng_z, rng_y)): with the noise fed in, the
    port's y_in and z_in are the scaled latents plus that noise."""
    K, _, _, _, model = rig
    x = torch.from_numpy(image(9))
    b, h, w = 1, SHAPE[1] // 16, SHAPE[2] // 16
    noises = [torch.full((b, h // 4, w // 4, M), 0.25), torch.full((b, h, w, M), -0.125)]
    it = iter(noises)
    monkeypatch.setattr(joint_ar, "noise_quantize", lambda v, generator=None: v + next(it))
    out = model(x, training=True, level=1.5)
    torch.testing.assert_close(out["z_in"], out["z"].float() + 0.25, rtol=0, atol=0)
    torch.testing.assert_close(out["y_in"], out["y"].float() - 0.125, rtol=0, atol=0)
    eval_out = model(x, training=False, level=1.5)
    torch.testing.assert_close(out["y"], eval_out["y"], rtol=0, atol=0)
