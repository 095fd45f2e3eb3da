"""PyTorch port, portable streams of the channel-conditional checkerboard:
the ``ChannelCBCards`` set (one checkerboard-family card a channel group,
whose ``hyper`` slot holds the group's channel-context convs; group 0's the
z hyper-decoder), ``build_channel_cb_cards`` and ``portable_ccb_*``, held
against the JAX package's coding/portable.py on the same weights
(JAX-initialised, gained, carried across with load_jax_params; CPU, M=16,
groups (2, 2, 4, 8), 64x128, K=1 and K=3).

As in test_torch_portable_families.py: a card set built by each package
holds the same integer arrays but the z tables (a count may round the other
way), so the cross-package stream checks use one JAX-built set, loaded by
the port, and the hashes are compared as functions of the arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.coding import codec as jcodec
from neural_image_compression_tpu.coding import portable as jportable
from neural_image_compression_tpu.models.channel_cb import (
    ChannelCheckerboardHierarchical as JChannelCB,
)
from neural_image_compression_tpu_torch.coding import (
    ChannelCBCards, ChannelCheckerboardCodec, build_channel_cb_cards, codec, portable,
)
from neural_image_compression_tpu_torch.models import ChannelCheckerboardHierarchical
from neural_image_compression_tpu_torch.utils.weights import load_jax_params
from test_torch_joint_ar import _gained

torch.set_num_threads(1)

M = 16
GROUPS = (2, 2, 4, 8)
ZMIN, ZMAX = -32, 32
Z_CDF_TOL = 1  # a count may move by one step of 2^-16 (test_torch_codec.py)


@pytest.fixture(scope="module", params=[1, 3], ids=["K1", "K3"])
def rig(request, tmp_path_factory):
    """(K, JAX model, params, the port's model, the JAX card set, that set
    loaded by the port, the port's own set)."""
    K = request.param
    jmodel = JChannelCB(latent_channels=M, K=K)
    key = jax.random.PRNGKey(50 + K)
    params = _gained(jmodel.init({"params": key, "noise": key}, jnp.zeros((1, 64, 64, 3)),
                                 training=False)["params"])
    model = load_jax_params(ChannelCheckerboardHierarchical(M, K, device="cpu"), params)
    jcards = jportable.build_channel_cb_cards(jmodel, {"params": params}, zmin=ZMIN, zmax=ZMAX)
    path = str(tmp_path_factory.mktemp("cards") / "cards.npz")
    jcards.save(path)
    return (K, jmodel, params, model, jcards, ChannelCBCards.load(path),
            build_channel_cb_cards(model, ZMIN, ZMAX))


def _image(seed, h=64, w=128):
    return np.random.default_rng(seed).uniform(size=(1, h, w, 3)).astype(np.float32)


def test_port_cards_match_jax_cards(rig):
    """Every sub-card's arrays equal the JAX set's but the z tables (within
    one count); the set's hash is the JAX package's function of the groups
    and the sub-cards' hashes."""
    _, _, _, _, jcards, loaded, cards = rig
    assert cards.groups == jcards.groups == GROUPS and cards.M == M
    assert (cards.zmin, cards.zmax) == (ZMIN, ZMAX)
    for i, (c, jc) in enumerate(zip(cards.cards, jcards.cards)):
        assert c.family == jc.family == 1 and c.M == GROUPS[i]
        assert len(c.hyper) == (3 if i == 0 else 2)
        got, want = dict(c._arrays()), dict(jc._arrays())
        assert list(got) == list(want)
        for name, w in want.items():
            g = got[name]
            assert g.dtype == w.dtype and g.shape == w.shape, (i, name)
            if name == "z_cdfs":
                assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max() <= Z_CDF_TOL
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"group {i} {name}")
    assert loaded.hash == jcards.hash
    assert [c.hash for c in loaded.cards] == [c.hash for c in jcards.cards]
    # the set hash of the port's own sub-cards, computed by either package
    assert jportable.ChannelCBCards(list(cards.cards), cards.groups).hash == cards.hash
    same_z = np.array_equal(cards.z_cdfs, jcards.z_cdfs)
    assert (cards.hash == jcards.hash) == same_z


def test_streams_match_across_packages(rig):
    _, jmodel, params, model, jcards, loaded, _ = rig
    ours = ChannelCheckerboardCodec(model, portable_card=loaded)
    theirs = jcodec.ChannelCheckerboardCodec(jmodel, {"params": params}, portable_card=jcards)
    x = _image(40)
    data = ours.compress_portable(x)
    assert data[4] == 12 and data[codec._HEADER_SIZE:codec._HEADER_SIZE + 8] == jcards.hash
    y_q, z_q = ours.decode_latents(data)
    assert len(np.unique(y_q)) >= 3
    assert theirs.compress_latents_portable(y_q, z_q, 64, 128) == data
    for a, b in zip(theirs.decode_latents(data), (y_q, z_q)):
        np.testing.assert_array_equal(a, b)
    jdata = theirs.compress_portable(x)
    jy, jz = theirs.decode_latents(jdata)
    for a, b in zip(ours.decode_latents(jdata), (jy, jz)):
        np.testing.assert_array_equal(a, b)
    assert ours.compress_latents_portable(jy, jz, 64, 128) == jdata


def _latents(cards, case, seed, h=4, w=6):
    rng = np.random.default_rng(seed)
    y_q = rng.integers(-9, 10, (h, w, cards.M)).astype(np.float32)
    if case == "escapes":
        y_q[1, 2, 0] = 2000.0  # group 0: feeds every channel context
        y_q[3, 5, cards.M - 1] = -70000.0
    z_q = rng.integers(-4, 5, (1, 2, cards.M)).astype(np.float32)
    return y_q, cards.hyper_forward(z_q)[:h, :w]


@pytest.mark.parametrize("case", ["plain", "escapes"])
def test_native_and_numpy_twins_identical(rig, case):
    _, _, _, _, jcards, loaded, cards = rig
    y_q, psi_fix = _latents(cards, case, seed=2)
    y_prev = y_q[..., :GROUPS[0] + GROUPS[1]]
    np.testing.assert_array_equal(cards.channel_forward(2, y_prev),
                                  cards.channel_forward(2, y_prev, native=False))
    native = portable.portable_ccb_encode(cards, y_q, psi_fix)
    assert native == portable.portable_ccb_encode(cards, y_q, psi_fix, native=False)
    for stream_native in (True, False):
        np.testing.assert_array_equal(
            portable.portable_ccb_decode(cards, native, psi_fix, 4, 6, native=stream_native), y_q)
    # over the JAX set, the port's coder writes the JAX package's numpy bytes
    y_j, psi_j = _latents(jcards, case, seed=2)
    assert portable.portable_ccb_encode(loaded, y_j, psi_j) == \
        jportable.portable_ccb_encode(jcards, y_j, psi_j, native=False)


def test_codec_portable_end_to_end(rig, tmp_path):
    _, _, _, model, _, _, cards = rig
    path = str(tmp_path / "cards.npz")
    cards.save(path)
    again = ChannelCBCards.load(path)
    assert again.hash == cards.hash and again.groups == cards.groups
    cod = ChannelCheckerboardCodec(model, portable_card=again)
    x = _image(41, 70, 100)
    data = cod.compress_portable(x)
    y_p, z_p = cod.decode_latents(data)
    y_f, z_f = cod.decode_latents(cod.compress(x))
    np.testing.assert_array_equal(y_p, y_f)
    np.testing.assert_array_equal(z_p, z_f)
    np.testing.assert_array_equal(cod.decompress(data), cod.decompress(cod.compress(x)))
    np.testing.assert_array_equal(cod.decompress_batch([data, data])[1:], cod.decompress(data))
    z_far = z_p.copy()
    z_far[0, 0, 0] = ZMAX + 50
    _, z_d = cod.decode_latents(cod.compress_latents_portable(y_p, z_far, 70, 100))
    assert z_d[0, 0, 0] == ZMAX
    other = build_channel_cb_cards(model, -16, 16)
    with pytest.raises(ValueError, match="different card"):
        ChannelCheckerboardCodec(model, portable_card=other).decode_latents(data)
    with pytest.raises(ValueError, match="truncated"):
        cod.decode_latents(data[:-4])
    with pytest.raises(ValueError, match="corrupt"):
        cod.decode_latents(data[:-4] + bytes(4))
    head = codec._read_header(data, cod.KINDS, cod.NAME)
    assert head[1] == 12 and head[6] == 0
    assert portable.model_family(model) == "channel_cb"
    with pytest.raises(ValueError, match="ChannelCBCards"):
        portable.PortableCard.build(model)


def test_rate_overhead_vs_float_path(rig):
    # the bound of the JAX package's tests/test_portable_channel_cb.py
    _, _, _, model, _, _, cards = rig
    cod = ChannelCheckerboardCodec(model, portable_card=cards)
    x = _image(42, 128, 128)
    assert len(cod.compress_portable(x)) < len(cod.compress(x)) * 1.08 + 64


def test_card_set_checks(rig, tmp_path):
    _, _, _, _, _, _, cards = rig
    with pytest.raises(ValueError, match="count mismatch"):
        ChannelCBCards(list(cards.cards[:3]), GROUPS)
    with pytest.raises(ValueError, match="family/width"):
        ChannelCBCards(list(cards.cards), (2, 2, 8, 4))
    path = str(tmp_path / "single.npz")
    cards.cards[0].save(path)
    with pytest.raises(ValueError, match="not a channel_cb card set"):
        ChannelCBCards.load(path)
    # a bare sub-card is not a set; it still codes its own group as a
    # checkerboard card
    y_q, psi_fix = _latents(cards, "plain", seed=3)
    with pytest.raises(AttributeError):
        portable.portable_ccb_encode(cards.cards[0], y_q, psi_fix)
    assert portable.portable_cb_encode(cards.cards[0], y_q[..., :2], psi_fix)


def test_int64_exactness_bound():
    """A channel context over more than 163 decoded channels could overflow
    the integer accumulators: the build refuses it."""
    model = ChannelCheckerboardHierarchical(165, 1, groups=(164, 1), device="cpu")
    with pytest.raises(ValueError, match="exactness bound"):
        build_channel_cb_cards(model)
