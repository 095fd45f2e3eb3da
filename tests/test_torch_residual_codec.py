"""PyTorch port, the residual model's bitstreams: ``coding.JointARCodec`` on
``HierarchicalMixtureResidual`` (exact latents against both packages'
eval forwards, decompress against the port's x_hat, the float stream's
bytes against the JAX package's ``JointARCodec`` on the same weights, in
one stream and 8 interleaved) and its portable card with the res3x3
integer hyper-decoder (conv, transposed conv, conv, transposed conv, conv):
port-built cards against JAX-built ones for the joint-AR, hyperprior and
channel-conditional families, and streams byte-identical across the two
packages, both ways, with one JAX-built card (CPU, M=16, 64x128 and a
ragged 70x100).

As in test_torch_codec.py, float streams are compared given the port's
z tables and psi (each package's own float programs may round a table
count or psi's last bit the other way); portable streams cross packages
as they are. Decompress against the eval forward: 1e-5, the JAX package's
tests/test_codec.py tolerance for this model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.coding import codec as jcodec
from neural_image_compression_tpu.coding import portable as jportable
from neural_image_compression_tpu.models import (
    ChannelCheckerboardHierarchical as JChannelCB, JointAutoregressiveHierarchical as JJointAR,
    MeanScaleHyperprior as JHyperprior,
)
from neural_image_compression_tpu_torch.coding import (
    JointARCodec, PortableCard, build_channel_cb_cards, codec,
)
from neural_image_compression_tpu_torch.coding.portable import (
    portable_ar_decode, portable_ar_encode,
)
from neural_image_compression_tpu_torch.models import (
    ChannelCheckerboardHierarchical, HierarchicalMixtureResidual, MeanScaleHyperprior,
)
from neural_image_compression_tpu_torch.utils.weights import load_jax_params
from test_torch_residual_families import _gained_res

torch.set_num_threads(1)

M, SEED = 16, 0
SHAPES = {"64x128": (64, 128), "70x100": (70, 100)}
ZMIN, ZMAX = -32, 32
Z_CDF_TOL = 1  # a count may move by one step of 2^-16 (test_torch_codec.py)
XHAT_TOL = 1e-5


def _jax_pair(jcls, K, **kw):
    jmodel = jcls(latent_channels=M, K=K, transform="res3x3", **kw)
    key = jax.random.PRNGKey(SEED)
    params = _gained_res(jmodel.init({"params": key, "noise": key}, jnp.zeros((1, 64, 64, 3)),
                                     training=False)["params"])
    return jmodel, params


@pytest.fixture(scope="module", params=[1, 3], ids=["K1", "K3"])
def pair(request):
    """(K, JAX model, gained JAX params, the port's residual model with them)."""
    K = request.param
    jmodel, params = _jax_pair(JJointAR, K)
    return K, jmodel, params, load_jax_params(HierarchicalMixtureResidual(M, K, device="cpu"),
                                              params)


def _image(shape, seed=0):
    h, w = SHAPES[shape]
    return np.random.default_rng(seed).uniform(size=(1, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_round_trip_exact_against_both_forwards(pair, shape):
    K, jmodel, params, model = pair
    cod = JointARCodec(model)
    x = _image(shape)
    data = cod.compress(x)
    y_q, z_q = cod.decode_latents(data)
    xp = codec._pad_input(x, 64)
    out = model(torch.from_numpy(xp), training=False)
    jout = jmodel.apply({"params": params}, jnp.asarray(xp), training=False)
    for got, key in ((y_q, "y_in"), (z_q, "z_in")):
        np.testing.assert_array_equal(got, out[key][0].numpy())
        np.testing.assert_array_equal(got, np.asarray(jout[key])[0])
    assert len(np.unique(y_q)) >= 3 and len(np.unique(z_q)) >= 3
    h, w = SHAPES[shape]
    x_hat = cod.decompress(data)
    assert x_hat.shape == (1, h, w, 3)
    np.testing.assert_allclose(x_hat, np.clip(out["x_hat"].numpy()[:, :h, :w], 0, 1),
                               atol=XHAT_TOL)


@pytest.mark.parametrize("n_streams", [1, 8])
def test_stream_bytes_match_jax(pair, n_streams):
    """The port's compress writes the JAX codec's bytes for the same latents,
    psi and z tables."""
    K, jmodel, params, model = pair
    cod = JointARCodec(model)
    x = _image("70x100", seed=1)
    img_h, img_w, y_q, z_q, psi = cod._analyse_image(x)
    data = cod.compress(x, n_streams=n_streams)
    jc = jcodec.JointARCodec(jmodel, {"params": params})
    zmin, zmax = int(z_q.min()), int(z_q.max())
    jc._z_cache[(zmin, zmax)] = cod._z_tables(zmin, zmax)
    assert data == jc._encode_from(y_q, z_q, psi, img_h, img_w, None, n_streams)
    # psi, the port's float32 hyper-synthesis fetched as float16 (both
    # packages' codecs fetch it so), against the JAX model's float32 psi:
    # within one float16 rounding (2^-11 relative) and float32 sums
    jpsi = jmodel.apply({"params": params}, jnp.asarray(z_q[None]),
                        method=lambda m, z: m.hyper_decoder(z))
    np.testing.assert_allclose(psi, np.asarray(jpsi)[0], rtol=2.0 ** -11 + 1e-4, atol=1e-5)


# --- portable streams ---------------------------------------------------------------

@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """(JAX model, params, the port's model, the JAX card, that card loaded
    by the port, the port's own card), K=1 (the residual model's default)."""
    jmodel, params = _jax_pair(JJointAR, 1)
    model = load_jax_params(HierarchicalMixtureResidual(M, 1, device="cpu"), params)
    jcard = jportable.PortableCard.build(jmodel, {"params": params}, zmin=ZMIN, zmax=ZMAX)
    path = str(tmp_path_factory.mktemp("card") / "card.npz")
    jcard.save(path)
    return (jmodel, params, model, jcard, PortableCard.load(path),
            PortableCard.build(model, ZMIN, ZMAX))


def _assert_card_arrays(got, want):
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.endswith("z_cdfs"):
            assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max() <= Z_CDF_TOL
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_card_holds_the_res3x3_hyper_decoder(rig):
    _, _, _, jcard, loaded, card = rig
    assert [(kind, geom) for kind, _, geom in card.hyper] == [
        ("conv", (1, 1)), ("deconv", (2, 1, 1)), ("conv", (1, 1)), ("deconv", (2, 1, 1)),
        ("conv", (1, 1))]
    _assert_card_arrays(dict(card._arrays()), dict(jcard._arrays()))
    assert loaded.hash == jcard.hash
    rng = np.random.default_rng(7)
    for hz, wz in ((1, 2), (2, 3), (3, 1)):
        z_q = rng.integers(-6, 7, (hz, wz, M)).astype(np.int32)
        got = card.hyper_forward(z_q)
        assert got.shape == (4 * hz, 4 * wz, 2 * M)
        np.testing.assert_array_equal(got, card.hyper_forward(z_q, native=False))
        np.testing.assert_array_equal(
            loaded.hyper_forward(z_q), jportable.PortableCard.hyper_forward(jcard, z_q,
                                                                            native=False))


def test_portable_streams_match_across_packages(rig):
    jmodel, params, model, jcard, loaded, _ = rig
    ours = JointARCodec(model, portable_card=loaded)
    theirs = jcodec.JointARCodec(jmodel, {"params": params}, portable_card=jcard)
    data = ours.compress_portable(_image("64x128", seed=40))
    y_q, z_q = ours.decode_latents(data)
    assert len(np.unique(y_q)) >= 3
    assert theirs.compress_latents_portable(y_q, z_q, 64, 128) == data
    for a, b in zip(theirs.decode_latents(data), (y_q, z_q)):
        np.testing.assert_array_equal(a, b)
    jy, jz = theirs.decode_latents(theirs.compress_latents_portable(y_q, z_q, 64, 128))
    assert ours.compress_latents_portable(jy, jz, 64, 128) == data
    # native = numpy bytes over the port's own card
    card = rig[5]
    psi_fix = card.hyper_forward(z_q)
    native = portable_ar_encode(card, y_q, psi_fix)
    assert native == portable_ar_encode(card, y_q, psi_fix, native=False)
    np.testing.assert_array_equal(portable_ar_decode(card, native, psi_fix, 4, 8), y_q)


@pytest.mark.parametrize("family", ["hyperprior", "channel_cb"])
def test_family_cards_match_jax(family):
    """The parallel families' cards carry the same res3x3 hyper-decoder."""
    if family == "hyperprior":
        jmodel, params = _jax_pair(JHyperprior, 1)
        model = load_jax_params(MeanScaleHyperprior(M, 1, "res3x3", device="cpu"), params)
        got = dict(PortableCard.build(model, ZMIN, ZMAX)._arrays())
        want = dict(jportable.PortableCard.build(jmodel, {"params": params}, zmin=ZMIN,
                                                 zmax=ZMAX, family="hyperprior")._arrays())
    else:
        jmodel, params = _jax_pair(JChannelCB, 1)
        model = load_jax_params(ChannelCheckerboardHierarchical(M, 1, transform="res3x3",
                                                                device="cpu"), params)
        got = dict(build_channel_cb_cards(model, ZMIN, ZMAX).cards[0]._arrays())
        want = dict(jportable.build_channel_cb_cards(jmodel, {"params": params}, zmin=ZMIN,
                                                     zmax=ZMAX).cards[0]._arrays())
    assert sum(name.endswith("_g") for name in got) == 5  # five hyper-decoder layers
    _assert_card_arrays(got, want)
