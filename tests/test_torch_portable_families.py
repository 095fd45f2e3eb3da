"""PyTorch port, portable streams of the parallel-decode families: the
checkerboard card (family 1, ``portable_cb_*``, ``arport_*_cb``) and the
hyperprior card (family 2, ``portable_hp_*``, ``arport_*_hp``), held
against the JAX package's coding/portable.py on the same weights
(JAX-initialised, gained, carried across with load_jax_params; CPU, M=16,
64x128, K=1 and K=3).

As in test_torch_portable.py: a card built by each package holds the same
integer arrays but the z tables (a count may round the other way), so the
cross-package stream checks use one JAX-built card, loaded by the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.coding import codec as jcodec
from neural_image_compression_tpu.coding import portable as jportable
from neural_image_compression_tpu.models.checkerboard import CheckerboardHierarchical as JCheckerboard
from neural_image_compression_tpu.models.hyperprior import MeanScaleHyperprior as JHyperprior
from neural_image_compression_tpu_torch.coding import (
    CheckerboardCodec, MeanScaleHyperpriorCodec, codec, portable,
)
from neural_image_compression_tpu_torch.coding.portable import PortableCard
from neural_image_compression_tpu_torch.models import CheckerboardHierarchical, MeanScaleHyperprior
from neural_image_compression_tpu_torch.utils.weights import load_jax_params
from test_torch_joint_ar import _gained

torch.set_num_threads(1)

M = 16
ZMIN, ZMAX = -32, 32
Z_CDF_TOL = 1  # a count may move by one step of 2^-16 (test_torch_codec.py)
# family -> (JAX model, JAX codec, the port's model and codec, card family
# number, the portable coder's functions (encode, decode) in both packages)
FAMILIES = {
    "checkerboard": (JCheckerboard, jcodec.CheckerboardCodec, CheckerboardHierarchical,
                     CheckerboardCodec, 1, (portable.portable_cb_encode, portable.portable_cb_decode),
                     (jportable.portable_cb_encode, jportable.portable_cb_decode)),
    "hyperprior": (JHyperprior, jcodec.MeanScaleHyperpriorCodec, MeanScaleHyperprior,
                   MeanScaleHyperpriorCodec, 2, (portable.portable_hp_encode,
                                                 portable.portable_hp_decode),
                   (jportable.portable_hp_encode, jportable.portable_hp_decode)),
}


@pytest.fixture(scope="module", params=[(f, k) for f in FAMILIES for k in (1, 3)],
                ids=[f"{f}-K{k}" for f in FAMILIES for k in (1, 3)])
def rig(request, tmp_path_factory):
    """(family, K, JAX model, params, the port's model, the JAX card, that
    card loaded by the port, the port's own card)."""
    family, K = request.param
    jcls, _, cls = FAMILIES[family][:3]
    jmodel = jcls(latent_channels=M, K=K)
    key = jax.random.PRNGKey(30 + K)
    params = _gained(jmodel.init({"params": key, "noise": key}, jnp.zeros((1, 64, 64, 3)),
                                 training=False)["params"])
    model = load_jax_params(cls(M, K, device="cpu"), params)
    jcard = jportable.PortableCard.build(jmodel, {"params": params}, zmin=ZMIN, zmax=ZMAX,
                                         family=family)
    path = str(tmp_path_factory.mktemp("card") / "card.npz")
    jcard.save(path)
    return (family, K, jmodel, params, model, jcard, PortableCard.load(path),
            PortableCard.build(model, ZMIN, ZMAX))


def _image(seed, h=64, w=128):
    return np.random.default_rng(seed).uniform(size=(1, h, w, 3)).astype(np.float32)


def test_port_card_matches_jax_card(rig):
    family, _, _, _, _, jcard, loaded, card = rig
    assert card.family == jcard.family == FAMILIES[family][4]
    got, want = dict(card._arrays()), dict(jcard._arrays())
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "z_cdfs":
            assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max() <= Z_CDF_TOL
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert loaded.hash == jcard.hash and loaded.family == jcard.family
    if family == "hyperprior":  # no context: the psi half carries layer 1
        assert card.ctx.wq.size == 0 and card.ep1_phi.wq.size == 0
        assert card.ep1_psi.wq.shape[0] == 2 * M


def test_streams_match_across_packages(rig):
    family, _, jmodel, params, model, jcard, loaded, _ = rig
    ours = FAMILIES[family][3](model, portable_card=loaded)
    theirs = FAMILIES[family][1](jmodel, {"params": params}, portable_card=jcard)
    x = _image(40)
    data = ours.compress_portable(x)
    assert data[4] == FAMILIES[family][4] * 2 + 6  # kinds 8 and 10
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


def _latents(card, case, seed, h=4, w=6):
    rng = np.random.default_rng(seed)
    y_q = rng.integers(-9, 10, (h, w, card.M)).astype(np.float32)
    if case == "escapes":
        y_q[1, 2, 0] = 9000.0
        y_q[3, 5, card.M - 1] = -70000.0
    z_q = rng.integers(-4, 5, (1, 2, card.M)).astype(np.float32)
    return y_q, card.hyper_forward(z_q)[:h, :w]


@pytest.mark.parametrize("case", ["plain", "escapes"])
def test_native_and_numpy_twins_identical(rig, case):
    family, _, _, _, _, jcard, loaded, card = rig
    (encode, decode), (jencode, _) = FAMILIES[family][5:]
    y_q, psi_fix = _latents(card, case, seed=2)
    native = encode(card, y_q, psi_fix)
    assert native == encode(card, y_q, psi_fix, native=False)
    for stream_native in (True, False):
        np.testing.assert_array_equal(decode(card, native, psi_fix, 4, 6, native=stream_native),
                                      y_q)
    # over the JAX card, the port's coder writes the JAX package's numpy bytes
    assert encode(loaded, y_q, psi_fix) == jencode(jcard, y_q, psi_fix, native=False)


def test_family_is_enforced(rig):
    family, _, _, _, _, _, _, card = rig
    y_q, psi_fix = _latents(card, "plain", seed=3)
    others = [fam for fam in FAMILIES if fam != family]
    for fam in others:
        encode, decode = FAMILIES[fam][5]
        with pytest.raises(ValueError, match=f"not a {fam}-family card"):
            encode(card, y_q, psi_fix)
        with pytest.raises(ValueError, match=f"not a {fam}-family card"):
            decode(card, b"\0" * 8, psi_fix, 4, 6)
    with pytest.raises(ValueError, match="not a wavefront-family card"):
        portable.portable_ar_encode(card, y_q, psi_fix)
    with pytest.raises(ValueError, match="portable-spec bound"):
        y_big = y_q.copy()
        y_big[0, 0, 0] = float(2 * portable.Y_ABS_MAX)
        FAMILIES[family][5][0](card, y_big, psi_fix)


def test_codec_portable_end_to_end(rig, tmp_path):
    family, _, _, _, model, _, _, card = rig
    path = str(tmp_path / "card.npz")
    card.save(path)
    again = PortableCard.load(path)
    assert again.hash == card.hash and again.family == card.family
    cod = FAMILIES[family][3](model, portable_card=again)
    x = _image(41, 70, 100)
    data = cod.compress_portable(x)
    y_p, z_p = cod.decode_latents(data)
    y_f, z_f = cod.decode_latents(cod.compress(x))
    np.testing.assert_array_equal(y_p, y_f)
    np.testing.assert_array_equal(z_p, z_f)
    np.testing.assert_array_equal(cod.decompress(data), cod.decompress(cod.compress(x)))
    # decompress_batch decodes portable streams one by one
    np.testing.assert_array_equal(cod.decompress_batch([data, data])[1:], cod.decompress(data))
    # the z grid is clipped to the card's range
    z_far = z_p.copy()
    z_far[0, 0, 0] = ZMAX + 50
    _, z_d = cod.decode_latents(cod.compress_latents_portable(y_p, z_far, 70, 100))
    assert z_d[0, 0, 0] == ZMAX
    other = PortableCard.build(model, -16, 16)
    with pytest.raises(ValueError, match="different card"):
        FAMILIES[family][3](model, portable_card=other).decode_latents(data)
    with pytest.raises(ValueError, match="truncated"):
        cod.decode_latents(data[:-4])
    with pytest.raises(ValueError, match="corrupt or truncated"):
        cod.decode_latents(data[:-4] + bytes(4))
    head = list(codec._read_header(data, cod.KINDS, cod.NAME))
    assert head[6] == 0  # the portable layout word, as the JAX codec writes it


def test_rate_overhead_vs_float_path(rig):
    # the bound of the JAX package's tests/test_portable_checkerboard.py
    family, _, _, _, model, _, _, card = rig
    cod = FAMILIES[family][3](model, portable_card=card)
    x = _image(42, 128, 128)
    assert len(cod.compress_portable(x)) < len(cod.compress(x)) * 1.08 + 64
