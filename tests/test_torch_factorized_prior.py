"""PyTorch port, FactorizedPrior and FactorizedPriorCodec, held against the
JAX package on the same weights (JAX-initialised, a gain of 12 on the last
analysis conv so that y spreads over several integers, carried across with
load_jax_params; CPU, M=16, 64x128): the eval and training forwards and
every gradient, the weights' round trip, the FLOP count, the codec (exact
round trips, a ragged 70x100 image padded to 16, uint8 input, the rate
against the analytic bits, the float stream against the JAX codec's bytes
given the same tables, malformed streams), the portable card and streams
(byte-identical both ways with one JAX-built card), latent refinement's
"factorized" mode against JAX make_refiner, and the entry points that take
the family unchanged (serving, the train step, the Trainer, the
evaluator's codec path).

Tolerances are test_torch_joint_ar.py's (latents 2e-5, x_hat and logp
1e-4), test_torch_train.py's for the gradients (rtol 1e-3, atol 1e-5 of
the leaf's largest value) and test_torch_refine.py's for refinement. The
tables come from each package's own float PMF, so a count may round one
step apart (test_torch_codec.py): the float streams are compared given the
port's tables, and the cards' arrays within that step."""

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_image_compression_tpu.coding import codec as jcodec
from neural_image_compression_tpu.coding import portable as jportable
from neural_image_compression_tpu.coding.refine import _ste_round as jax_ste_round
from neural_image_compression_tpu.coding.refine import make_refiner as jax_make_refiner
from neural_image_compression_tpu.models.factorized_prior import FactorizedPrior as JFactorized
from neural_image_compression_tpu.train.loss import rd_loss as jrd_loss
from neural_image_compression_tpu.utils import flops as jflops
from neural_image_compression_tpu_torch.coding import (
    FactorizedCard, FactorizedPriorCodec, JointARCodec, codec, make_refiner, portable, refine,
)
from neural_image_compression_tpu_torch.evaluation import CompressionEvaluator
from neural_image_compression_tpu_torch.models import (
    FactorizedPrior, JointAutoregressiveHierarchical, joint_ar,
)
from neural_image_compression_tpu_torch.parallel import make_train_step
from neural_image_compression_tpu_torch.serving import make_serving_fn
from neural_image_compression_tpu_torch.train import Trainer, rd_loss
from neural_image_compression_tpu_torch.utils import flops
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_params_to_jax, joint_ar_state_from_jax, load_jax_params,
)
from test_torch_joint_ar import _rounding_margin
from test_torch_refine import HALF_MARGIN, LATENT_ATOL, METRIC_RTOL, METRICS

torch.set_num_threads(1)

M, SEED, LAMBDA, GAIN_Y = 16, 0, 0.005, 12.0
SHAPE = (2, 64, 128, 3)
IMAGES = {"64x128": (64, 128), "70x100": (70, 100)}
# stream bits against the analytic bits: 2% plus the 26-byte header and
# the one 4-byte rANS flush
RATE_SLACK, FIXED_BYTES = 1.02, 26 + 4
Y_CDF_TOL = 1  # a count may move by one step of 2^-16 (test_torch_codec.py)
REFINE_STEPS, REFINE_LR, REFINE_LAMBDA = 3, 0.05, 0.01


@pytest.fixture(scope="module")
def rig():
    """(JAX model, gained JAX params, the port's model with them, the batch,
    the JAX eval outputs)."""
    x = np.random.default_rng(SEED).uniform(size=SHAPE).astype(np.float32)
    jmodel = JFactorized(latent_channels=M)
    key = jax.random.PRNGKey(SEED)
    params = jax.tree.map(np.array, jmodel.init({"params": key, "noise": key}, jnp.asarray(x),
                                                training=False)["params"])
    leaf = params["encoder"]["Conv2d_3"]
    leaf["kernel"], leaf["bias"] = leaf["kernel"] * GAIN_Y, leaf["bias"] * GAIN_Y
    want = {k: np.asarray(v) for k, v in jmodel.apply({"params": params}, jnp.asarray(x),
                                                      training=False).items()
            if k != "training"}
    return jmodel, params, load_jax_params(FactorizedPrior(M, device="cpu"), params), x, want


def _assert_close(got, want, rounded=True):
    assert set(got) == set(want)
    np.testing.assert_allclose(got["y"], want["y"], rtol=2e-5, atol=2e-5)
    if rounded:
        np.testing.assert_array_equal(got["y_in"], want["y_in"])
    else:
        np.testing.assert_allclose(got["y_in"], want["y_in"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["x_hat"], want["x_hat"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["p_y"], want["p_y"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got["logp_y"], want["logp_y"], rtol=1e-4, atol=1e-4)
    for k in ("z", "z_in", "p_z", "logp_z"):  # the zero-rate placeholders, exactly
        assert got[k].shape == (SHAPE[0], 1, 1, 1), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- the model ------------------------------------------------------------------

def test_eval_forward_matches_jax(rig):
    _, _, model, x, want = rig
    assert _rounding_margin(want["y"]) > 1e-4
    assert np.count_nonzero(want["y_in"]) > 0.05 * want["y_in"].size
    got = model(torch.from_numpy(x), training=False)
    assert got["training"] is False
    _assert_close({k: v.numpy() for k, v in got.items() if k != "training"}, want)


def test_training_forward_and_gradients_match_jax(rig, monkeypatch):
    """The JAX model draws y's noise from make_rng("noise") alone (no z);
    the port adds the same draw through noise_quantize."""
    jmodel, params, _, x, _ = rig
    key = jax.random.PRNGKey(SEED + 1)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), training=True, rngs={"noise": key})
        metrics = jrd_loss(out, jnp.asarray(x), LAMBDA)
        return metrics["loss"], (metrics, out)

    (_, (want_metrics, want_out)), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    rng = jmodel.bind({"params": params}, rngs={"noise": key}).make_rng("noise")
    noise = np.asarray(jax.random.uniform(rng, want_out["y"].shape, jnp.float32, -0.5, 0.5))
    np.testing.assert_array_equal(np.asarray(want_out["y"]) + noise, want_out["y_in"])
    drawn = iter([noise])
    monkeypatch.setattr(joint_ar, "noise_quantize",
                        lambda v, generator=None: v + torch.tensor(next(drawn)))
    model = load_jax_params(FactorizedPrior(M, device="cpu"), params)
    xt = torch.from_numpy(x)
    out = model(xt, training=True)
    metrics = rd_loss(out, xt, LAMBDA)
    metrics["loss"].backward()
    assert next(drawn, None) is None  # one draw: y's
    _assert_close({k: v.detach().numpy() for k, v in out.items() if k != "training"},
                  {k: np.asarray(v) for k, v in want_out.items() if k != "training"},
                  rounded=False)
    for k in ("loss", "bpp_y", "bpp_z", "mse"):
        np.testing.assert_allclose(metrics[k].item(), float(want_metrics[k]), rtol=1e-5,
                                   err_msg=k)
    assert metrics["bpp_z"].item() == 0.0
    want = joint_ar_state_from_jax(jax.tree.map(np.asarray, want_grads))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert p.grad is not None and scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3, atol=1e-5 * scale, err_msg=name)


def test_weights_round_trip(rig):
    _, params, model, _, _ = rig
    assert set(joint_ar_state_from_jax(params)) == set(model.state_dict())
    back = joint_ar_params_to_jax(model)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))


def test_flops_match_jax():
    for h, w in ((512, 768), (176, 208)):
        assert flops.factorized_prior_eval_flops(128, h, w) == \
            jflops.factorized_prior_eval_flops(128, h, w)
    assert round(flops.factorized_prior_eval_flops(128, 512, 768)["total"] / 1e9, 3) == 65.098


def test_constructor_checks():
    # res3x3 builds the residual analysis and synthesis; an unknown name
    # raises KeyError, as the JAX package's transform lookup does
    res = FactorizedPrior(M, transform="res3x3", device="cpu")
    assert res.transform == "res3x3" and type(res.encoder).__name__ == "Encoder3x3"
    assert type(res.decoder).__name__ == "Decoder3x3"
    with pytest.raises(KeyError):
        FactorizedPrior(M, transform="res5x5", device="cpu")
    with pytest.raises(KeyError):
        JFactorized(latent_channels=8, transform="res5x5").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=False)
    with pytest.raises(ValueError, match="latent_channels"):
        FactorizedPrior(0, device="cpu")
    with pytest.raises(ValueError, match="multiples of 16"):
        FactorizedPrior(8, device="cpu")(torch.zeros(1, 64, 72, 3), training=False)
    m = FactorizedPrior(8, dtype=torch.bfloat16, device="cpu")
    out = m(torch.rand(1, 48, 80, 3, generator=torch.Generator().manual_seed(1)), training=False)
    assert out["y"].dtype == torch.bfloat16 and out["y"].shape == (1, 3, 5, 8)
    for k in ("x_hat", "y_in", "logp_y", "logp_z", "p_z"):
        assert out[k].dtype == torch.float32 and torch.isfinite(out[k]).all(), k


# --- the codec ------------------------------------------------------------------

@pytest.fixture(scope="module")
def coded(rig):
    """image -> (codec, x, stream, the port's eval forward on the padded x)."""
    model = rig[2]
    cod = FactorizedPriorCodec(model)
    built = {}

    def get(name):
        if name not in built:
            h, w = IMAGES[name]
            x = np.random.default_rng(3).uniform(size=(1, h, w, 3)).astype(np.float32)
            out = model(torch.from_numpy(codec._pad_input(x, 16)), training=False)
            built[name] = cod, x, cod.compress(x), {k: v.numpy() for k, v in out.items()
                                                    if k != "training"}
        return built[name]

    return get


@pytest.mark.parametrize("image", list(IMAGES))
def test_round_trip_exact(coded, image):
    cod, x, data, out = coded(image)
    h, w = IMAGES[image]
    y_q, z_q = cod.decode_latents(data)
    assert y_q.shape == (-(-h // 16), -(-w // 16), M) and z_q.shape == (0, 0, 0)
    np.testing.assert_array_equal(y_q, out["y_in"][0])
    assert len(np.unique(y_q)) >= 3
    x_hat = cod.decompress(data)
    assert x_hat.shape == (1, h, w, 3) and codec.stream_size(data) == (h, w)
    np.testing.assert_allclose(x_hat, np.clip(out["x_hat"], 0, 1)[:, :h, :w], atol=1e-5)
    x8 = cod.decompress(data, as_uint8=True)
    assert x8.dtype == np.uint8
    assert np.abs(x8.astype(int) - np.round(x_hat * 255).astype(int)).max() <= 1


def test_uint8_input_gives_the_same_stream(coded):
    cod = coded("70x100")[0]
    x8 = (np.random.default_rng(5).uniform(size=(1, 70, 100, 3)) * 255).astype(np.uint8)
    assert cod.compress(x8) == cod.compress(x8.astype(np.float32) / 255)


@pytest.mark.parametrize("image", list(IMAGES))
def test_stream_bits_track_analytic(coded, image):
    cod, x, data, out = coded(image)
    x_pad = torch.from_numpy(codec._pad_input(x, 16))
    analytic = float(rd_loss({k: torch.from_numpy(v) for k, v in out.items()}, x_pad,
                             LAMBDA)["bits_total"])
    assert len(data) * 8 <= analytic * RATE_SLACK + 8 * FIXED_BYTES, (len(data) * 8, analytic)


def test_stream_matches_jax_bytes(rig, coded):
    """Given the port's tables for the image's range, the JAX codec writes
    the port's bytes for the same latents, header and all, and decodes them
    to the same latents; the header is K 1, layout 0, y's range, len_z 0."""
    jmodel, params, _, _, _ = rig
    cod, x, data, _ = coded("70x100")
    head = struct.unpack(codec._HEADER, data[:codec._HEADER_SIZE])
    assert head[1:4] == (2, 1, M) and head[6] == 0 and head[9] == 0
    y_q, _ = cod.decode_latents(data)
    assert (head[7], head[8]) == (int(y_q.min()), int(y_q.max()))
    jc = jcodec.FactorizedPriorCodec(jmodel, {"params": params})
    jc._y_cache[(head[7], head[8])] = cod._tables(head[7], head[8])
    assert jc.compress_latents(y_q, 70, 100) == data
    assert cod.compress_latents(y_q, 70, 100) == data
    ours, theirs = cod._tables(head[7], head[8]), jcodec.factorized_tables(
        jmodel, {"params": params}, head[7], head[8])
    assert np.abs(ours[0].astype(np.int64) - theirs[0].astype(np.int64)).max() <= Y_CDF_TOL
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jc.decompress(data), jc.decompress(jc.compress(x)))


def test_compress_latents_call_shapes(coded):
    """The JAX signature (y_q, img_h, img_w, z_q=None), and the keywords
    the evaluator passes every codec; the refiner's empty z is ignored."""
    cod, _, data, _ = coded("70x100")
    y_q, z_q = cod.decode_latents(data)
    assert cod.compress_latents(y_q[None], 70, 100) == data
    assert cod.compress_latents(y_q, z_q=np.zeros((0, 0, 0)), img_h=70, img_w=100) == data
    with pytest.raises(ValueError, match="integer-valued"):
        cod.compress_latents(y_q + 0.25, 70, 100)
    with pytest.raises(ValueError, match="does not match"):
        cod.compress_latents(y_q, 64, 128)


def _with_header_field(data, index, value):
    fields = list(struct.unpack(codec._HEADER, data[:codec._HEADER_SIZE]))
    fields[index] = value
    return struct.pack(codec._HEADER, *fields) + data[codec._HEADER_SIZE:]


@pytest.mark.parametrize("case,match", [
    ("empty", "truncated"),
    ("cut_y", "truncated"),
    ("trailing", "header says"),
    ("bad_magic", "not a NIC1"),
    ("joint_ar_kind", "kind 1 is not a factorized"),
    ("other_m", "K=1, M=8"),
    ("lanes", "layout 0x8004"),
    ("y_corrupt", "corrupt or truncated"),
])
def test_malformed_streams_raise(coded, case, match):
    cod, _, data, _ = coded("64x128")
    bad = {
        "empty": lambda: b"",
        "cut_y": lambda: data[:-5],
        "trailing": lambda: data + b"\0",
        "bad_magic": lambda: b"NIC2" + data[4:],
        "joint_ar_kind": lambda: _with_header_field(data, 1, 1),
        "other_m": lambda: _with_header_field(data, 3, 8),
        "lanes": lambda: _with_header_field(data, 6, 0x8004),
        "y_corrupt": lambda: data[:-4] + bytes(4),
    }[case]()
    with pytest.raises(ValueError, match=match):
        cod.decode_latents(bad)


def test_other_families_streams_raise(rig, coded):
    cod, x, data, _ = coded("64x128")
    joint = JointARCodec(JointAutoregressiveHierarchical(M, 1, device="cpu"))
    with pytest.raises(ValueError, match="is not a joint-AR stream"):
        joint.decode_latents(data)
    with pytest.raises(ValueError, match="is not a factorized stream"):
        cod.decode_latents(joint.compress(x))


# --- portable streams -------------------------------------------------------------

@pytest.fixture(scope="module")
def cards(rig, tmp_path_factory):
    """(the JAX-built card, that card saved by JAX and loaded by the port,
    the port's own card)."""
    jmodel, params, model, _, _ = rig
    jcard = jportable.FactorizedCard.build(jmodel, {"params": params})
    path = str(tmp_path_factory.mktemp("card") / "card.npz")
    jcard.save(path)
    return jcard, FactorizedCard.load(path), FactorizedCard.build(model)


def test_port_card_matches_jax_card(cards):
    """The same range and layout; the tables within one count; the hash is
    the JAX package's function of the arrays (equal for the loaded card)."""
    jcard, loaded, card = cards
    assert (card.ymin, card.ymax) == (jcard.ymin, jcard.ymax) == (-256, 256)
    assert card.cdfs.shape == jcard.cdfs.shape == (M, 514 + 1)
    assert np.abs(card.cdfs.astype(np.int64) - jcard.cdfs.astype(np.int64)).max() <= Y_CDF_TOL
    np.testing.assert_array_equal(card.offsets, jcard.offsets)
    np.testing.assert_array_equal(card.sizes, jcard.sizes)
    assert loaded.hash == jcard.hash
    again = FactorizedCard(jcard.cdfs, jcard.offsets, jcard.sizes, jcard.ymin, jcard.ymax)
    assert again.hash == jcard.hash
    same_tables = jportable.FactorizedCard(card.cdfs, card.offsets, card.sizes, card.ymin,
                                           card.ymax)
    assert same_tables.hash == card.hash
    assert (card.hash == jcard.hash) == np.array_equal(card.cdfs, jcard.cdfs)


def test_portable_streams_match_across_packages(rig, cards):
    jmodel, params, model, _, _ = rig
    jcard, loaded, _ = cards
    ours = FactorizedPriorCodec(model, portable_card=loaded)
    theirs = jcodec.FactorizedPriorCodec(jmodel, {"params": params}, portable_card=jcard)
    x = np.random.default_rng(40).uniform(size=(1, 70, 100, 3)).astype(np.float32)
    data = ours.compress_portable(x)
    assert data[4] == 5 and data[codec._HEADER_SIZE:codec._HEADER_SIZE + 8] == jcard.hash
    y_q, _ = ours.decode_latents(data)
    assert len(np.unique(y_q)) >= 3
    assert theirs.compress_latents_portable(y_q, 70, 100) == data
    jdata = theirs.compress_portable(x)
    np.testing.assert_array_equal(ours.decode_latents(jdata)[0], y_q)
    assert ours.compress_latents_portable(y_q, 70, 100) == jdata
    np.testing.assert_array_equal(ours.decompress(jdata), ours.decompress(data))
    np.testing.assert_allclose(ours.decompress(data), theirs.decompress(data), atol=1e-4)


def test_portable_end_to_end(rig, cards, tmp_path):
    model = rig[2]
    card = cards[2]
    path = str(tmp_path / "card.npz")
    card.save(path)
    again = FactorizedCard.load(path)
    assert again.hash == card.hash
    cod = FactorizedPriorCodec(model, portable_card=again)
    x = np.random.default_rng(41).uniform(size=(1, 64, 128, 3)).astype(np.float32)
    data = cod.compress_portable(x)
    y_p, _ = cod.decode_latents(data)
    np.testing.assert_array_equal(y_p, cod.decode_latents(cod.compress(x))[0])
    far = y_p.copy()
    far[0, 0, 0] = card.ymax + 50
    assert cod.decode_latents(cod.compress_latents_portable(far, 64, 128))[0][0, 0, 0] == \
        card.ymax
    other = FactorizedCard.build(model, -16, 16)
    with pytest.raises(ValueError, match="different card"):
        FactorizedPriorCodec(model, portable_card=other).decode_latents(data)
    assert len(data) < len(cod.compress(x)) * 1.08 + 64
    assert portable.model_family(model) == "factorized"
    with pytest.raises(ValueError, match="FactorizedCard"):
        portable.PortableCard.build(model)


# --- refinement and the entry points ------------------------------------------------

def test_refine_matches_jax(rig, coded):
    """The "factorized" mode (y alone): metrics within 1e-5 relative, the
    float y within 1e-4 of an unrolled replica of the JAX loop, the rounded
    y equal to JAX make_refiner's away from a half; z_q the empty
    placeholder."""
    jmodel, params, model, _, _ = rig
    assert refine._mode(model) == "factorized"
    x = np.random.default_rng(7).uniform(size=(1, 64, 128, 3)).astype(np.float32)
    y, z, metrics = refine._refine(model, x, REFINE_LAMBDA, REFINE_STEPS, REFINE_LR)
    assert z is None
    y_q, z_q, want = jax_make_refiner(jmodel, {"params": params}, REFINE_LAMBDA, REFINE_STEPS,
                                      REFINE_LR)(jnp.asarray(x))
    assert z_q.shape == (1, 0, 0, 0)
    for when in ("pre_", "post_"):
        for k in METRICS:
            np.testing.assert_allclose(float(metrics[when + k]), float(want[when + k]),
                                       rtol=METRIC_RTOL, err_msg=when + k)

    def body(mdl, y_in):
        return {"x_hat": mdl.decoder(y_in, False).astype(jnp.float32),
                "logp_y": jnp.log(mdl.factorized_entropy_model(y_in)),
                "logp_z": jnp.zeros((y_in.shape[0], 1, 1, 1), jnp.float32)}

    def loss_fn(latents):
        out = jmodel.apply({"params": params}, jax_ste_round(latents[0]), method=body)
        return jrd_loss(out, jnp.asarray(x), REFINE_LAMBDA)["loss"]

    grad = jax.jit(jax.grad(loss_fn))
    latents = (jmodel.apply({"params": params}, jnp.asarray(x), training=False)["y"],)
    tx = optax.adam(REFINE_LR)
    state = tx.init(latents)
    for _ in range(REFINE_STEPS):
        updates, state = tx.update(grad(latents), state)
        latents = optax.apply_updates(latents, updates)
    y_f = np.asarray(latents[0])
    np.testing.assert_allclose(y.numpy(), y_f, rtol=0, atol=LATENT_ATOL)
    g = np.abs(y_f.astype(np.float64))
    near_half = np.abs(g - np.floor(g) - 0.5) < HALF_MARGIN
    assert not ((torch.round(y).numpy() != np.asarray(y_q)) & ~near_half).any()
    # the refined latents round trip through the codec, z_q as the refiner gives it
    cod = coded("64x128")[0]
    y_r, z_r, m = make_refiner(model, REFINE_LAMBDA, REFINE_STEPS, REFINE_LR)(x)
    assert z_r.shape == (1, 0, 0, 0)
    assert float(m["post_loss"]) < float(m["pre_loss"])
    data = cod.compress_latents(y_r[0], z_q=z_r[0], img_h=64, img_w=128)
    np.testing.assert_array_equal(cod.decode_latents(data)[0], y_r[0].numpy())


def test_evaluator_takes_the_codec(rig, coded, tmp_path):
    """evaluate_codec with the factorized codec, plain and refined, at
    192x192 and at 176x208 (multiples of 16, not of 64: the refined path
    pads as the codec does; MS-SSIM needs 161 px a side)."""
    model = rig[2]
    cod = coded("64x128")[0]
    for h, w in ((192, 192), (176, 208)):
        imgs = [np.random.default_rng(8).uniform(size=(1, h, w, 3)).astype(np.float32)]
        ev = CompressionEvaluator(model, imgs, LAMBDA, str(tmp_path))
        avg, _, _ = ev.evaluate()
        assert avg["BPP(z)"] == 0.0 and avg["BPP"] == avg["BPP(y)"]
        got = ev.evaluate_codec(cod)
        np.testing.assert_allclose(got["BPP(analytic)"], avg["BPP"], rtol=1e-5)
        np.testing.assert_allclose(got["PSNR(RGB)"], avg["PSNR(RGB)"], rtol=1e-5)
        assert got["BPP(bitstream)"] <= RATE_SLACK * got["BPP(analytic)"] + 8 * FIXED_BYTES / (
            h * w)
        refined = ev.evaluate_codec(cod, refine_steps=2, refine_lambda=LAMBDA, refine_lr=1e-2)
        assert all(np.isfinite(v) for v in refined.values())


def test_serving_train_step_and_trainer_take_the_family(rig, tmp_path):
    model = FactorizedPrior(M, device="cpu", seed=3)
    x = np.random.default_rng(9).uniform(size=(2, 48, 64, 3)).astype(np.float32)
    served = make_serving_fn(model)(x)
    assert served["x_hat"].shape == (2, 48, 64, 3)
    assert (served["bpp_z"] == 0).all() and torch.equal(served["bpp_total"], served["bpp_y"])
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(model, opt, rd_loss, LAMBDA, ema_decay=0.9, clip_grad_norm=1.0)
    losses = [float(step(x)["loss"]) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    patches = [np.random.default_rng(10 + i).integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
               for i in range(3)]
    trainer = Trainer(FactorizedPrior(M, device="cpu"), patches, val_loader=[x[:1]],
                      max_steps=3, log_interval=2, img_interval=2, val_interval=2,
                      log_dir=str(tmp_path / "runs"), checkpoint_path=str(tmp_path / "c.pt"))
    trainer.train()
    assert trainer.step == 3 and os.path.isfile(tmp_path / "c.pt")
    tags = {line.split('"tag": "')[1].split('"')[0]
            for line in open(tmp_path / "runs" / "metrics.jsonl")}
    assert {"losses/loss", "activity/y_dead_channels_by_entropy",
            "validation/validation_loss"} <= tags
