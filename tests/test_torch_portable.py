"""PyTorch port, portable (cross-machine) streams: ``coding.portable`` and
``csrc/rans/ar_portable.cc``, held against the JAX package's
coding/portable.py on the same weights (JAX-initialised, carried across with
load_jax_params; CPU, M=16, 64x128).

Portable streams are the one bitstream the two packages must share byte
for byte. A card built by each package from the same weights holds the same
integer arrays, except the z tables, whose float PMF may round a count the
other way (as in test_torch_codec.py): so the two cards' hashes may differ,
and the cross-package stream checks use one card, built by the JAX package
and loaded by the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.coding import codec as jcodec
from neural_image_compression_tpu.coding import portable as jportable
from neural_image_compression_tpu.models import JointAutoregressiveHierarchical as JModel
from neural_image_compression_tpu_torch.coding import JointARCodec, codec, portable
from neural_image_compression_tpu_torch.coding.portable import (
    PortableCard, portable_ar_decode, portable_ar_encode,
)
from neural_image_compression_tpu_torch.models import JointAutoregressiveHierarchical
from neural_image_compression_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(1)

M = 16
GAIN_Y, GAIN_Z = 12.0, 30.0  # spread y and z over several integers (test_torch_codec.py)
ZMIN, ZMAX = -32, 32
# the z tables: a count may move by one step of 2^-16 (test_torch_codec.py)
Z_CDF_TOL = 1


def _gained(params):
    params = jax.tree.map(np.array, params)
    for path, gain in ((("encoder", "Conv2d_3"), GAIN_Y), (("hyper_encoder", "Conv2d_2"), GAIN_Z)):
        leaf = params[path[0]][path[1]]
        leaf["kernel"] = leaf["kernel"] * gain
        leaf["bias"] = leaf["bias"] * gain
    return params


@pytest.fixture(scope="module", params=[1, 3], ids=["K1", "K3"])
def rig(request, tmp_path_factory):
    """(K, JAX model, params, the port's model, the JAX card, that card
    loaded by the port, the port's own card)."""
    K = request.param
    jmodel = JModel(latent_channels=M, K=K)
    key = jax.random.PRNGKey(10 + K)
    params = _gained(jmodel.init({"params": key, "noise": key},
                                 jnp.zeros((1, 64, 64, 3)), training=False)["params"])
    model = load_jax_params(JointAutoregressiveHierarchical(M, K, device="cpu"), params)
    jcard = jportable.PortableCard.build(jmodel, {"params": params}, zmin=ZMIN, zmax=ZMAX)
    path = str(tmp_path_factory.mktemp("card") / "card.npz")
    jcard.save(path)
    return (K, jmodel, params, model, jcard, PortableCard.load(path),
            PortableCard.build(model, ZMIN, ZMAX))


def _image(seed, h=64, w=128):
    return np.random.default_rng(seed).uniform(size=(1, h, w, 3)).astype(np.float32)


# --- cards ---------------------------------------------------------------------------

def test_port_card_matches_jax_card(rig):
    _, _, _, _, jcard, _, card = rig
    got, want = dict(card._arrays()), dict(jcard._arrays())
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "z_cdfs":
            assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max() <= Z_CDF_TOL
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_jax_card_loads_with_its_hash(rig, tmp_path):
    _, _, _, _, jcard, loaded, _ = rig
    assert loaded.hash == jcard.hash
    for (name, a), (_, b) in zip(loaded._arrays(), jcard._arrays()):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # and back: the port's save loads in the JAX package with the same hash
    path = str(tmp_path / "again.npz")
    loaded.save(path)
    assert jportable.PortableCard.load(path).hash == jcard.hash
    assert PortableCard.load(path).hash == jcard.hash


def test_out_of_spec_cards_raise(rig):
    card = rig[6]
    arrays = dict(card._arrays())
    arrays["meta"] = arrays["meta"].copy()
    arrays["meta"][5] = 3  # no such family (0 wavefront, 1 checkerboard, 2 hyperprior)
    with pytest.raises(ValueError, match="unknown card family 3"):
        PortableCard._from_mapping(arrays)
    # a checkerboard-family card loads, and the wavefront coder refuses it
    arrays["meta"][5] = 1
    y_q, psi_fix, _, _ = _latents(card, "plain", seed=5)
    with pytest.raises(ValueError, match="not a wavefront-family card"):
        portable_ar_encode(PortableCard._from_mapping(arrays), y_q, psi_fix)
    arrays["meta"][0] = 1
    with pytest.raises(ValueError, match="card version 1"):
        PortableCard._from_mapping(arrays)


# --- streams across the packages, with the JAX card -------------------------------------

def test_streams_match_across_packages(rig):
    K, jmodel, params, model, jcard, loaded, _ = rig
    ours = JointARCodec(model, portable_card=loaded)
    theirs = jcodec.JointARCodec(jmodel, {"params": params}, portable_card=jcard)
    x = _image(40)
    data = ours.compress_portable(x)
    y_q, z_q = ours.decode_latents(data)
    assert len(np.unique(y_q)) >= 3
    # the same latents, the same bytes in both directions
    assert theirs.compress_latents_portable(y_q, z_q, 64, 128) == data
    for a, b in zip(theirs.decode_latents(data), (y_q, z_q)):
        np.testing.assert_array_equal(a, b)
    jdata = theirs.compress_portable(x)
    jy, jz = theirs.decode_latents(jdata)
    for a, b in zip(ours.decode_latents(jdata), (jy, jz)):
        np.testing.assert_array_equal(a, b)
    assert ours.compress_latents_portable(jy, jz, 64, 128) == jdata


def test_portable_decode_matches_float_latents(rig):
    _, _, _, model, _, loaded, _ = rig
    cod = JointARCodec(model, portable_card=loaded)
    x = _image(41, 70, 100)
    data = cod.compress_portable(x)
    y_p, z_p = cod.decode_latents(data)
    y_f, z_f = cod.decode_latents(cod.compress(x))
    np.testing.assert_array_equal(y_p, y_f)
    np.testing.assert_array_equal(z_p, z_f)
    np.testing.assert_array_equal(cod.decompress(data), cod.decompress(cod.compress(x)))


# --- within the port ---------------------------------------------------------------

def _latents(card, case, seed):
    rng = np.random.default_rng(seed)
    h, w = 4, 6
    y_q = rng.integers(-9, 10, (h, w, card.M)).astype(np.float32)
    if case == "escapes":
        y_q[1, 2, 0] = 9000.0
        y_q[3, 5, card.M - 1] = -70000.0
    if case == "giant":
        y_q[0, 0, 0] = float(1 << 21)  # (y << F) beyond int32: the scalar GEMM path
    z_q = rng.integers(-4, 5, (1, 2, card.M)).astype(np.float32)
    return y_q, card.hyper_forward(z_q)[:h, :w], h, w


@pytest.mark.parametrize("case", ["plain", "escapes", "giant"])
def test_native_and_numpy_streams_identical(rig, case):
    card = rig[6]
    y_q, psi_fix, h, w = _latents(card, case, seed=2)
    native = portable_ar_encode(card, y_q, psi_fix)
    assert native == portable_ar_encode(card, y_q, psi_fix, native=False)
    for stream_native in (True, False):
        np.testing.assert_array_equal(
            portable_ar_decode(card, native, psi_fix, h, w, native=stream_native), y_q)
    # over the JAX card, the port's coder writes the JAX package's numpy bytes
    jcard, loaded = rig[4], rig[5]
    assert portable_ar_encode(loaded, y_q, psi_fix) == jportable.portable_ar_encode(
        jcard, y_q, psi_fix, native=False)


def test_native_hyper_and_psi_match_numpy(rig):
    card = rig[6]
    rng = np.random.default_rng(7)
    for hz, wz in ((2, 3), (1, 1), (5, 2), (3, 7)):
        z_q = rng.integers(-6, 7, (hz, wz, card.M)).astype(np.int32)
        got = card.hyper_forward(z_q)
        np.testing.assert_array_equal(got, card.hyper_forward(z_q, native=False))
        np.testing.assert_array_equal(got, jportable.PortableCard.hyper_forward(
            rig[4], z_q, native=False))
    for n in (1, 5, 64, 77):
        psi = rng.integers(-5000, 5000, (n, 2 * card.M)).astype(np.int64)
        np.testing.assert_array_equal(card.psi_precompute(psi),
                                      card.psi_precompute(psi, native=False))


def test_save_load_keeps_hash_and_streams(rig, tmp_path):
    card = rig[6]
    path = str(tmp_path / "card.npz")
    card.save(path)
    again = PortableCard.load(path)
    assert again.hash == card.hash
    y_q, psi_fix, _, _ = _latents(card, "plain", seed=3)
    assert portable_ar_encode(again, y_q, psi_fix) == portable_ar_encode(card, y_q, psi_fix)


def test_wrong_card_and_corrupt_streams_raise(rig):
    _, _, _, model, _, loaded, card = rig
    cod = JointARCodec(model, portable_card=loaded)
    data = cod.compress_portable(_image(42, 64, 64))
    other = JointARCodec(model, portable_card=PortableCard.build(model, -16, 16))
    with pytest.raises(ValueError, match="different card"):
        other.decompress(data)
    with pytest.raises(ValueError):
        cod.decompress(data[:-10])
    with pytest.raises(ValueError, match="corrupt or truncated"):
        cod.decode_latents(data[:-4] + bytes(4))
    with pytest.raises(ValueError, match="portable-spec bound"):
        y_q, psi_fix, _, _ = _latents(card, "plain", seed=4)
        y_q[0, 0, 0] = float(2 * portable.Y_ABS_MAX)
        portable_ar_encode(card, y_q, psi_fix)


def test_latents_portable_clips_z_to_the_card(rig):
    _, _, _, model, _, loaded, _ = rig
    cod = JointARCodec(model, portable_card=loaded)
    y_q, z_q = cod.decode_latents(cod.compress_portable(_image(43, 64, 64)))
    z_far = z_q.copy()
    z_far[0, 0, 0] = ZMAX + 50
    y_d, z_d = cod.decode_latents(cod.compress_latents_portable(y_q, z_far, 64, 64))
    np.testing.assert_array_equal(y_d, y_q)
    assert z_d[0, 0, 0] == ZMAX


def test_rate_overhead_vs_float_path(rig):
    # the bound of the JAX package's tests/test_portable.py
    _, _, _, model, _, _, card = rig
    rng = np.random.default_rng(4)
    h, w = 8, 12
    y_q = rng.integers(-9, 10, (h, w, card.M)).astype(np.float32)
    z_q = rng.integers(-4, 5, (2, 3, card.M)).astype(np.float32)
    ported = portable_ar_encode(card, y_q, card.hyper_forward(z_q))
    cod = JointARCodec(model)
    std = codec._ar_encode_latents(cod._host_nets, y_q, cod._psi(z_q[None]))
    assert len(ported) / len(std) - 1.0 < 0.05
