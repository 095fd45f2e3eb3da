"""PyTorch port, the parallel-decode families: MeanScaleHyperprior here,
CheckerboardHierarchical and ChannelCheckerboardHierarchical
(tests/test_torch_checkerboard.py and tests/test_torch_channel_cb.py run
this module's tests with FAMILY = "checkerboard" and "channel_cb"), held
against the JAX package
on the same weights (JAX-initialised, gains on the last analysis convs so
that y and z spread over several integers, carried across with
load_jax_params; CPU, M=16, 64x128, K=1 and K=3): the eval forward, the
training forward and every gradient, the weights' round trip, the FLOP
count, the codec (exact round trips in one stream and 4 lanes, a ragged
70x100 image, uint8 input, batches, the rate against the analytic bits, the
header and z stream against the JAX codec's, malformed streams), latent
refinement and the evaluator's codec path.

Tolerances are test_torch_joint_ar.py's (latents 2e-5, x_hat and logp 1e-4)
and test_torch_train.py's for the gradients; refinement's are
test_torch_refine.py's. Float y streams are per build (the entropy
parameters come from each package's own float programs), so across the
packages the header fields, the z stream (given the same z tables) and the
lanes' layout are compared, and the decoded latents."""

import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_image_compression_tpu.coding import codec as jcodec
from neural_image_compression_tpu.coding.refine import _ste_round as jax_ste_round
from neural_image_compression_tpu.coding.refine import make_refiner as jax_make_refiner
from neural_image_compression_tpu.entropy.gaussian import gaussian_likelihood, mixture_likelihood
from neural_image_compression_tpu.models.channel_cb import (
    ChannelCheckerboardHierarchical as JChannelCB,
)
from neural_image_compression_tpu.models.checkerboard import CheckerboardHierarchical as JCheckerboard
from neural_image_compression_tpu.models.hyperprior import MeanScaleHyperprior as JHyperprior
from neural_image_compression_tpu.train.loss import rd_loss as jrd_loss
from neural_image_compression_tpu.utils import flops as jflops
from neural_image_compression_tpu_torch.coding import (
    ChannelCheckerboardCodec, CheckerboardCodec, JointARCodec, MeanScaleHyperpriorCodec, codec,
    make_refiner, refine,
)
from neural_image_compression_tpu_torch.evaluation import CompressionEvaluator
from neural_image_compression_tpu_torch.models import (
    ChannelCheckerboardHierarchical, CheckerboardHierarchical, JointAutoregressiveHierarchical,
    MeanScaleHyperprior,
)
from neural_image_compression_tpu_torch.train import rd_loss
from neural_image_compression_tpu_torch.utils import flops
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_params_to_jax, joint_ar_state_from_jax, load_jax_params,
)
from test_torch_joint_ar import _assert_forward_close, _gained, _rounding_margin
from test_torch_refine import HALF_MARGIN, LATENT_ATOL, METRIC_RTOL, METRICS
from test_torch_train import _feed_noise, _jax_noise

torch.set_num_threads(1)

FAMILY = "hyperprior"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# family -> (JAX model, JAX codec, the port's model, the port's codec)
FAMILIES = {
    "hyperprior": (JHyperprior, jcodec.MeanScaleHyperpriorCodec, MeanScaleHyperprior,
                   MeanScaleHyperpriorCodec),
    "checkerboard": (JCheckerboard, jcodec.CheckerboardCodec, CheckerboardHierarchical,
                     CheckerboardCodec),
    "channel_cb": (JChannelCB, jcodec.ChannelCheckerboardCodec, ChannelCheckerboardHierarchical,
                   ChannelCheckerboardCodec),
}
M, SEED, LAMBDA = 16, 0, 0.005
SHAPE = (2, 64, 128, 3)
IMAGES = {"64x128": (64, 128), "70x100": (70, 100)}
# stream bits against the analytic bits: 2% (the rANS tables' 16-bit
# quantization, the float16 parameters) plus the 26-byte header, the two
# 4-byte rANS flushes and 8 bytes a lane (its length-table entry and flush)
RATE_SLACK, FIXED_BYTES, LANE_BYTES = 1.02, 26 + 2 * 4, 8
REFINE_STEPS, REFINE_LR, REFINE_LAMBDA = 3, 0.05, 0.01


def _family(request):
    return FAMILIES[request.module.FAMILY]


@pytest.fixture(scope="module", params=[1, 3], ids=["K1", "K3"])
def pair(request):
    """(K, JAX model, gained JAX params, the port's model with them, the
    batch, the JAX eval outputs)."""
    K = request.param
    jcls, _, cls, _ = _family(request)
    x = np.random.default_rng(SEED).uniform(size=SHAPE).astype(np.float32)
    jmodel = jcls(latent_channels=M, K=K)
    key = jax.random.PRNGKey(SEED)
    params = _gained(jmodel.init({"params": key, "noise": key}, jnp.asarray(x),
                                 training=False)["params"])
    want = {k: np.asarray(v) for k, v in jmodel.apply({"params": params}, jnp.asarray(x),
                                                      training=False).items()
            if k != "training"}
    model = load_jax_params(cls(M, K, device="cpu"), params)
    return K, jmodel, params, model, x, want


# --- the model ------------------------------------------------------------------

def test_eval_forward_matches_jax(pair):
    K, _, _, model, x, want = pair
    # the latents sit clear of the rounding boundary by more than the two
    # frameworks' difference, so y_in and z_in must be equal
    assert _rounding_margin(want["y"]) > 1e-4 and _rounding_margin(want["z"]) > 1e-4
    assert np.count_nonzero(want["y_in"]) > 0.05 * want["y_in"].size
    got = model(torch.from_numpy(x), training=False)
    assert got["training"] is False
    got = {k: v.numpy() for k, v in got.items() if k != "training"}
    assert set(got) == set(want)
    _assert_forward_close(got, want, K)


@pytest.fixture(scope="module")
def jax_grads(pair):
    """The JAX training forward, rd_loss and gradients with one noise key,
    and that noise (z, y) in the port's draw order."""
    K, jmodel, params, _, x, _ = pair
    noise_key = jax.random.PRNGKey(SEED + 1)

    @jax.jit
    def value_and_grad(p, xb):
        def loss_fn(q):
            out = jmodel.apply({"params": q}, xb, training=True, rngs={"noise": noise_key})
            metrics = jrd_loss(out, xb, LAMBDA)
            return metrics["loss"], (metrics, out)
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (_, (metrics, out)), grads = value_and_grad(params, jnp.asarray(x))
    noise = _jax_noise(jmodel, params, noise_key, x)
    np.testing.assert_array_equal(np.asarray(out["y"], np.float32) + noise[1], out["y_in"])
    return (noise, {k: np.asarray(v) for k, v in out.items() if k != "training"},
            {k: np.asarray(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, grads))


def test_training_forward_and_gradients_match_jax(pair, jax_grads, monkeypatch):
    """rtol 1e-3 and atol 1e-5 * max|leaf| on the gradients, as
    test_torch_train.py: float32 sums in other orders through about 20
    layers."""
    K, _, params, _, x, _ = pair
    noise, want_out, want_metrics, want_grads = jax_grads
    model = load_jax_params(type(pair[3])(M, K, device="cpu"), params)
    _feed_noise(monkeypatch, noise)
    xt = torch.from_numpy(x)
    out = model(xt, training=True)
    metrics = rd_loss(out, xt, LAMBDA)
    metrics["loss"].backward()
    _assert_forward_close({k: v.detach().numpy() for k, v in out.items() if k != "training"},
                          want_out, K, rounded=False)
    for k in ("loss", "bpp_y", "bpp_z", "mse"):
        np.testing.assert_allclose(metrics[k].item(), float(want_metrics[k]), rtol=1e-5,
                                   err_msg=k)
    want = joint_ar_state_from_jax(want_grads)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert p.grad is not None, f"{name}: no gradient reached it"
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3, atol=1e-5 * scale, err_msg=name)


def test_weights_round_trip(pair):
    _, _, params, model, _, _ = pair
    assert set(joint_ar_state_from_jax(params)) == set(model.state_dict())
    back = joint_ar_params_to_jax(model)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))


def test_flops_match_jax(request):
    for K in (1, 3):
        if request.module.FAMILY == "hyperprior":
            assert flops.hyperprior_eval_flops(128, K, 512, 768) == \
                jflops.hyperprior_eval_flops(128, K, 512, 768)
        elif request.module.FAMILY == "channel_cb":
            assert flops.channel_cb_eval_flops(128, K, 512, 768) == \
                jflops.channel_cb_eval_flops(128, K, 512, 768)
            assert flops.channel_cb_eval_flops(M, K, 64, 128, (2, 6, 8)) == \
                jflops.channel_cb_eval_flops(M, K, 64, 128, (2, 6, 8))
        else:  # the JAX docstring: the checkerboard's count is the joint-AR one
            assert flops.joint_ar_eval_flops(128, K, 512, 768) == \
                jflops.joint_ar_eval_flops(128, K, 512, 768)


def test_constructor_checks(request):
    cls = _family(request)[2]
    with pytest.raises(NotImplementedError, match="res3x3"):
        cls(M, 1, transform="res3x3", device="cpu")
    with pytest.raises(ValueError, match="K must be"):
        cls(M, 0, device="cpu")
    with pytest.raises(ValueError, match="multiples of 64"):
        cls(8, 1, device="cpu")(torch.zeros(1, 64, 96, 3), training=False)
    m = cls(8, 3, dtype=torch.bfloat16, device="cpu")
    out = m(torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1)), training=False)
    assert m.distribution == "Mixture of Gaussians" and out["y"].dtype == torch.bfloat16
    for k in ("x_hat", "y_in", "logp_y", "logp_z", "weights", "mus", "sigmas"):
        assert out[k].dtype == torch.float32 and torch.isfinite(out[k]).all(), k


# --- the codec ------------------------------------------------------------------

@pytest.fixture(scope="module")
def coded(pair, request):
    """image -> (codec, x, stream, the port's eval forward on the padded x)."""
    model = pair[3]
    cod_cls = _family(request)[3]
    built = {}

    def get(name):
        if name not in built:
            cod = cod_cls(model)
            h, w = IMAGES[name]
            x = np.random.default_rng(3).uniform(size=(1, h, w, 3)).astype(np.float32)
            out = model(torch.from_numpy(codec._pad_input(x, 64)), training=False)
            built[name] = cod, x, cod.compress(x), {k: v.numpy() for k, v in out.items()
                                                    if k != "training"}
        return built[name]

    return get


@pytest.mark.parametrize("n_streams", [1, 4])
@pytest.mark.parametrize("image", list(IMAGES))
def test_round_trip_exact(coded, image, n_streams):
    cod, x, data, out = coded(image)
    if n_streams > 1:
        lanes = cod.compress(x, n_streams=n_streams)
        assert len(lanes) <= len(data) + LANE_BYTES * n_streams
        data = lanes
    y_q, z_q = cod.decode_latents(data)
    np.testing.assert_array_equal(y_q, out["y_in"][0])
    np.testing.assert_array_equal(z_q, out["z_in"][0])
    assert len(np.unique(y_q)) >= 3 and len(np.unique(z_q)) >= 3
    h, w = IMAGES[image]
    x_hat = cod.decompress(data)
    assert x_hat.shape == (1, h, w, 3) and codec.stream_size(data) == (h, w)
    np.testing.assert_allclose(x_hat, np.clip(out["x_hat"], 0, 1)[:, :h, :w], atol=1e-5)
    x8 = cod.decompress(data, as_uint8=True)
    assert x8.dtype == np.uint8
    assert np.abs(x8.astype(int) - np.round(x_hat * 255).astype(int)).max() <= 1


def test_latents_match_jax_forward(pair, coded):
    _, jmodel, params, _, _, _ = pair
    cod, x, data, out = coded("70x100")
    y_q, z_q = cod.decode_latents(data)
    jout = jmodel.apply({"params": params}, jnp.asarray(codec._pad_input(x, 64)), training=False)
    for key, dec in (("y", y_q), ("z", z_q)):
        cont = np.asarray(jout[key])[0]
        f = np.abs(cont.astype(np.float64))
        clear = np.abs(f - np.floor(f) - 0.5) > np.abs(out[key][0] - cont).max()
        assert clear.mean() > 0.99
        np.testing.assert_array_equal(dec[clear], np.asarray(jout[key + "_in"])[0][clear])


def test_header_and_z_stream_match_jax(pair, coded, request):
    """The JAX codec, given the port's z tables (the two packages' float
    PMFs may round a count apart: test_torch_codec.py), writes the same
    header fields but len_y and the same z bytes for the same image."""
    _, jmodel, params, _, _, _ = pair
    cod, x, data, _ = coded("70x100")
    head = codec._read_header(data, cod.KINDS, cod.NAME)
    jc = _family(request)[1](jmodel, {"params": params})
    jc._z_cache[(head[7], head[8])] = cod._z_tables(head[7], head[8])
    for n in (1, 4):
        ours = cod.compress(x, n_streams=n)
        theirs = jc.compress(x, n_streams=n)
        ho, ht = (struct.unpack(codec._HEADER, d[:codec._HEADER_SIZE]) for d in (ours, theirs))
        assert ho[:10] == ht[:10]
        assert ho[6] == (0 if n == 1 else 0x8000 | n)
        z_end = codec._HEADER_SIZE + ho[9]
        assert ours[codec._HEADER_SIZE:z_end] == theirs[codec._HEADER_SIZE:z_end]
        # each package decodes its own stream to the same latents
        y_t, z_t = jc.decode_latents(theirs)
        y_o, z_o = cod.decode_latents(ours)
        np.testing.assert_array_equal(z_o, z_t)
        assert (y_o != y_t).mean() < 1e-3


@pytest.mark.parametrize("n", [2, 5])
def test_lanes_match_jax(n):
    """The lane layout: the port's lanes are the JAX codec's bytes for the
    same symbols and parameters, and decode block by block."""
    rng = np.random.default_rng(n)
    n_sym, n_a, K = 300, 157, 3
    mus = (rng.normal(size=(n_sym, K)) * 3).astype(np.float32)
    sigmas = (np.abs(rng.normal(size=(n_sym, K))) + 0.3).astype(np.float32)
    w = rng.uniform(size=(n_sym, K)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    sym = np.round(mus[:, 0]).astype(np.int32)
    data = codec._encode_lanes(sym, mus, sigmas, w, [0, n_a, n_sym], n)
    assert data == jcodec.CheckerboardCodec._encode_lanes(sym, mus, sigmas, w, n_a, n)
    # the hyperprior's one block: the JAX codec's call with an empty second block
    assert codec._encode_lanes(sym, mus, sigmas, w, [0, n_sym], n) == \
        jcodec.MeanScaleHyperpriorCodec._encode_lanes(sym, mus, sigmas, w, n_sym, n)
    decs = codec._open_lanes(data, 0x8000 | n)
    first = codec._decode_block_lanes(decs, mus[:n_a], sigmas[:n_a], w[:n_a])
    second = codec._decode_block_lanes(decs, mus[n_a:], sigmas[n_a:], w[n_a:])
    codec._finish(decs)
    np.testing.assert_array_equal(np.concatenate([first, second]), sym)


def test_uint8_input_gives_the_same_stream(coded):
    cod = coded("70x100")[0]
    x8 = (np.random.default_rng(5).uniform(size=(1, 70, 100, 3)) * 255).astype(np.uint8)
    assert cod.compress(x8) == cod.compress(x8.astype(np.float32) / 255)


def test_batch_equals_singles(coded):
    cod = coded("64x128")[0]
    xs = np.random.default_rng(6).uniform(size=(3, 64, 128, 3)).astype(np.float32)
    singles = [cod.compress(xs[b:b + 1], n_streams=1 + 2 * (b % 2)) for b in range(3)]
    assert cod.compress_batch(xs, workers=2) == [cod.compress(xs[b:b + 1]) for b in range(3)]
    assert cod.compress_batch(xs[1:2], n_streams=3) == [singles[1]]
    got = cod.decompress_batch(singles, workers=2)
    want = np.concatenate([cod.decompress(d) for d in singles])
    # one batched synthesis against batch-1 ones (test_torch_codec.py)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="one image size"):
        cod.decompress_batch([singles[0], cod.compress(xs[:1, :, :100])])


@pytest.mark.parametrize("image", list(IMAGES))
def test_stream_bits_track_analytic(coded, image):
    cod, x, data, out = coded(image)
    x_pad = torch.from_numpy(codec._pad_input(x, 64))
    analytic = float(rd_loss({k: torch.from_numpy(v) for k, v in out.items()}, x_pad,
                             LAMBDA)["bits_total"])
    assert len(data) * 8 <= analytic * RATE_SLACK + 8 * FIXED_BYTES, (len(data) * 8, analytic)
    n = 4
    assert len(cod.compress(x, n_streams=n)) * 8 <= (
        analytic * RATE_SLACK + 8 * (FIXED_BYTES + LANE_BYTES * n))


def test_compress_latents_reproduces_the_stream(coded):
    cod, _, data, _ = coded("70x100")
    y_q, z_q = cod.decode_latents(data)
    assert cod.compress_latents(y_q, z_q, 70, 100) == data
    assert cod.compress_latents(y_q[None], z_q[None], 70, 100) == data
    with pytest.raises(ValueError, match="integer-valued"):
        cod.compress_latents(y_q + 0.25, z_q, 70, 100)
    with pytest.raises(ValueError, match="1..255"):
        cod.compress_latents(y_q, z_q, 70, 100, n_streams=0)


def _with_header_field(data, index, value):
    fields = list(struct.unpack(codec._HEADER, data[:codec._HEADER_SIZE]))
    fields[index] = value
    return struct.pack(codec._HEADER, *fields) + data[codec._HEADER_SIZE:]


@pytest.mark.parametrize("case,match", [
    ("empty", "truncated"),
    ("cut_y", "truncated"),
    ("trailing", "header says"),
    ("bad_magic", "not a NIC1"),
    ("joint_ar_kind", "kind 1 is not a"),
    ("tiled_layout", "layout 0x0202"),
    ("lane_count_0", "stream count 0"),
    ("lane_table_overrun", "length table"),
    ("y_corrupt", "corrupt or truncated"),
])
def test_malformed_streams_raise(coded, case, match):
    cod, x, data, _ = coded("64x128")
    if case == "lane_table_overrun":
        lanes = cod.compress(x, n_streams=3)
        start = codec._HEADER_SIZE + struct.unpack(codec._HEADER,
                                                   lanes[:codec._HEADER_SIZE])[9]
        (first,) = struct.unpack("<I", lanes[start:start + 4])
        data = lanes[:start] + struct.pack("<I", first + 1) + lanes[start + 4:]
    bad = {
        "empty": lambda: b"",
        "cut_y": lambda: data[:-5],
        "trailing": lambda: data + b"\0",
        "bad_magic": lambda: b"NIC2" + data[4:],
        "joint_ar_kind": lambda: _with_header_field(data, 1, 1),
        "tiled_layout": lambda: _with_header_field(data, 6, 0x0202),
        "lane_count_0": lambda: _with_header_field(data, 6, 0x8000),
        "lane_table_overrun": lambda: data,
        "y_corrupt": lambda: data[:-4] + bytes(4),
    }[case]()
    with pytest.raises(ValueError, match=match):
        cod.decode_latents(bad)


def test_other_models_streams_raise(pair, coded, request):
    K = pair[0]
    cls, cod_cls = _family(request)[2:]
    _, x, data, _ = coded("64x128")
    for other in (cls(M, 2 if K == 1 else 1, device="cpu"), cls(8, K, device="cpu")):
        with pytest.raises(ValueError, match=f"K={K}, M={M}"):
            cod_cls(other).decode_latents(data)
    # the other parallel families' streams, and a joint-AR one
    grouped = ChannelCheckerboardHierarchical(M, K, device="cpu")
    for other_cls, model in ((MeanScaleHyperpriorCodec, pair[3]), (CheckerboardCodec, pair[3]),
                             (ChannelCheckerboardCodec, grouped)):
        if other_cls is not cod_cls:
            with pytest.raises(ValueError, match="is not a"):
                other_cls(model).decode_latents(data)
    joint = JointARCodec(JointAutoregressiveHierarchical(M, K, device="cpu"))
    with pytest.raises(ValueError, match="is not a joint-AR stream"):
        joint.decode_latents(data)
    with pytest.raises(ValueError, match="is not a"):
        cod_cls(pair[3]).decode_latents(joint.compress(x))


# --- refinement and evaluation ----------------------------------------------------

def _jax_float_latents(jmodel, params, x, mode):
    """JAX refine.py's loop for ``mode`` ("ctx" or "hyper"), unrolled: the
    float latents after REFINE_STEPS steps (its refiner returns them
    rounded)."""
    def body(mdl, y_in, z_in):
        params_t = (mdl.entropy_params_from_latents(y_in, z_in) if mode == "ctx"
                    else mdl.entropy_params_from_hyper(z_in))
        p_y = (gaussian_likelihood if mdl.K == 1 else mixture_likelihood)(y_in, *params_t)
        return {"x_hat": mdl.decoder(y_in, False).astype(jnp.float32), "logp_y": jnp.log(p_y),
                "logp_z": jnp.log(mdl.factorized_entropy_model(z_in))}

    def loss_fn(latents):
        y, z = latents
        out = jmodel.apply({"params": params}, jax_ste_round(y), jax_ste_round(z), method=body)
        return jrd_loss(out, x, REFINE_LAMBDA)["loss"]

    grad = jax.jit(jax.grad(loss_fn))
    out0 = jmodel.apply({"params": params}, x, training=False)
    latents = (out0["y"].astype(jnp.float32), out0["z"].astype(jnp.float32))
    tx = optax.adam(REFINE_LR)
    state = tx.init(latents)
    for _ in range(REFINE_STEPS):
        updates, state = tx.update(grad(latents), state)
        latents = optax.apply_updates(latents, updates)
    return [np.asarray(v) for v in latents]


def test_refine_matches_jax(pair, coded, request):
    """Metrics within 1e-5 relative, float latents within 1e-4, rounded
    latents equal but within HALF_MARGIN of a half (test_torch_refine.py)."""
    _, jmodel, params, model, _, _ = pair
    mode = "hyper" if request.module.FAMILY == "hyperprior" else "ctx"
    assert refine._mode(model) == mode
    x = np.random.default_rng(7).uniform(size=(1, 64, 128, 3)).astype(np.float32)
    y, z, metrics = refine._refine(model, x, REFINE_LAMBDA, REFINE_STEPS, REFINE_LR)
    y_q, z_q, want = jax_make_refiner(jmodel, {"params": params}, REFINE_LAMBDA, REFINE_STEPS,
                                      REFINE_LR)(jnp.asarray(x))
    for when in ("pre_", "post_"):
        for k in METRICS:
            np.testing.assert_allclose(float(metrics[when + k]), float(want[when + k]),
                                       rtol=METRIC_RTOL, err_msg=when + k)
    y_f, z_f = _jax_float_latents(jmodel, params, jnp.asarray(x), mode)
    np.testing.assert_allclose(y.numpy(), y_f, rtol=0, atol=LATENT_ATOL)
    np.testing.assert_allclose(z.numpy(), z_f, rtol=0, atol=LATENT_ATOL)
    for ours, theirs, f in ((torch.round(y).numpy(), np.asarray(y_q), y_f),
                            (torch.round(z).numpy(), np.asarray(z_q), z_f)):
        g = np.abs(f.astype(np.float64))
        near_half = np.abs(g - np.floor(g) - 0.5) < HALF_MARGIN
        assert not ((ours != theirs) & ~near_half).any()
    # the refined latents round trip through the family's codec
    cod = coded("64x128")[0]
    y_r, z_r, m = make_refiner(model, REFINE_LAMBDA, REFINE_STEPS, REFINE_LR)(x)
    assert float(m["post_loss"]) < float(m["pre_loss"])
    y_d, z_d = cod.decode_latents(cod.compress_latents(y_r, z_r, 64, 128, n_streams=2))
    np.testing.assert_array_equal(y_d, y_r[0].numpy())
    np.testing.assert_array_equal(z_d, z_r[0].numpy())


def test_evaluator_takes_the_codec(pair, coded, tmp_path):
    """evaluate_codec with this family's codec, plain and refined: the
    analytic rate is evaluate()'s, the stream tracks it, the decoded image
    is the eval forward's."""
    model = pair[3]
    cod = coded("64x128")[0]
    imgs = [np.random.default_rng(8).uniform(size=(1, 192, 192, 3)).astype(np.float32)]
    ev = CompressionEvaluator(model, imgs, LAMBDA, str(tmp_path))
    avg, _, _ = ev.evaluate()
    got = ev.evaluate_codec(cod, n_streams=2)
    np.testing.assert_allclose(got["BPP(analytic)"], avg["BPP"], rtol=1e-5)
    np.testing.assert_allclose(got["PSNR(RGB)"], avg["PSNR(RGB)"], rtol=1e-5)
    assert got["BPP(bitstream)"] <= RATE_SLACK * got["BPP(analytic)"] + 8 * (
        FIXED_BYTES + 2 * LANE_BYTES) / 192 ** 2
    refined = ev.evaluate_codec(cod, refine_steps=2, refine_lambda=LAMBDA, refine_lr=1e-2)
    assert all(np.isfinite(v) for v in refined.values())


def test_family_imports_load_no_jax():
    code = (
        "import sys\n"
        "import neural_image_compression_tpu_torch.models.hyperprior\n"
        "import neural_image_compression_tpu_torch.models.checkerboard\n"
        "from neural_image_compression_tpu_torch.coding import (\n"
        "    CheckerboardCodec, MeanScaleHyperpriorCodec)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'neural_image_compression_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax.', 'neural_image_compression_tpu.')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
