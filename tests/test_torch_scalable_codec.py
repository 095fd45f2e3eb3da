"""PyTorch port, the scalable model's layered bitstream (``coding.
ScalableCodec``), its portable card pairs, refinement's "scalable" mode and
``evaluation.VisionCompressionEvaluator``, held against the JAX package on
the same weights (a seeded port model's, carried to the JAX package with
joint_ar_params_to_jax) and against the port's own eval forward (CPU,
M=16, M1=10, 64x128 and a ragged 70x100).

Float streams are per build, as the joint-AR codec's: what must match
across the packages given the same inputs is checked instead, the bytes
the shared C++ coder writes for the same latents, psi and z tables, and
what truncation keeps. Portable streams cross: with one JAX-built card
pair, both packages write and read the same bytes.

Tolerances: decoded latents exact; decompress against the eval forward's
x_hat within 1e-6 and decompress_base's F_tilde against its F_tilde within
1e-6 (the same operations on the same latents); refinement's metrics 1e-5
relative and its rounded latents as test_torch_refine.py's; the evaluator's
metrics as test_torch_evaluator.py's (1e-5 relative, MS-SSIM also 1e-5
absolute).
"""

import functools
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.coding import codec as jcodec
from neural_image_compression_tpu.coding import portable as jportable
from neural_image_compression_tpu.coding.refine import make_refiner as jax_make_refiner
from neural_image_compression_tpu.evaluation import VisionCompressionEvaluator as JEvaluator
from neural_image_compression_tpu.models import ScalableImageCoding as JScalable
from neural_image_compression_tpu.models import build_yolo_backbone as jbuild_yolo_backbone
from neural_image_compression_tpu.models import distillation_targets as jdistillation_targets
from neural_image_compression_tpu.train.loss import vision_rd_loss as jvision_rd_loss
from neural_image_compression_tpu_torch.coding import (
    JointARCodec, PortableCard, ScalableCodec, codec, load_scalable_cards, make_refiner, refine,
    save_scalable_cards,
)
from neural_image_compression_tpu_torch.data import pad_to_multiple
from neural_image_compression_tpu_torch.evaluation import VisionCompressionEvaluator
from neural_image_compression_tpu_torch.models import (
    JointAutoregressiveHierarchical, ScalableImageCoding, build_yolo_backbone,
    distillation_targets,
)
from neural_image_compression_tpu_torch.train import vision_rd_loss
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_params_to_jax, load_jax_params, variables_to_jax,
)

torch.set_num_threads(1)

M, M1 = 16, 10
GAIN_Y, GAIN_Z = 12.0, 30.0  # spread y and z over several integers (test_torch_codec.py)
SHAPES = {"64x128": (64, 128), "70x100": (70, 100)}
ZMIN, ZMAX = -32, 32
Z_CDF_TOL = 2  # test_torch_portable.py's: the z tables come from each build's float PMF
LAMBDA, STEPS, LR = 0.01, 3, 0.05
METRICS = ("loss", "bpp_total", "bpp_y", "bpp_z", "psnr", "mse")
METRIC_RTOL, HALF_MARGIN = 1e-5, 1e-4  # test_torch_refine.py's
EVAL_SIZE, EVAL_RTOL, MSSSIM_ATOL = 192, 1e-5, 1e-5       # test_torch_evaluator.py's


def _gained(params):
    for path, gain in ((("encoder", "Conv2d_3"), GAIN_Y), (("hyper_encoder", "Conv2d_2"), GAIN_Z)):
        leaf = params[path[0]][path[1]]
        leaf["kernel"] = leaf["kernel"] * gain
        leaf["bias"] = leaf["bias"] * gain
    return params


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _image(shape, seed=0):
    h, w = SHAPES[shape]
    return np.random.default_rng(seed).uniform(size=(1, h, w, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=[1, 3], ids=["K1", "K3"])
def pair(request):
    """(K, JAX model, gained params (a seeded port model's flax tree), the
    port's model with them)."""
    K = request.param
    params = _gained(joint_ar_params_to_jax(ScalableImageCoding(M, M1, K, device="cpu",
                                                                seed=10 + K)))
    model = load_jax_params(ScalableImageCoding(M, M1, K, device="cpu"), params)
    return K, JScalable(latent_channels=M, base_channels=M1, K=K), params, model


@pytest.fixture(scope="module")
def coded(pair):
    """shape -> (codec, x, stream, the port's eval forward on the padded x)."""
    model = pair[3]
    built = {}

    def get(shape):
        if shape not in built:
            cod = ScalableCodec(model)
            x = _image(shape, seed=len(built))
            out = model(torch.from_numpy(pad_to_multiple(x, 64)), training=False)
            built[shape] = cod, x, cod.compress(x), {k: v.numpy() for k, v in out.items()
                                                     if k != "training"}
        return built[shape]

    return get


def _jax_codec(pair, **kw):
    _, jmodel, params, _ = pair
    return jcodec.ScalableCodec(jmodel, {"params": _jax_tree(params)}, **kw)


# --- the host nets and the float stream's bytes against the JAX package -------------

def test_host_nets_match_jax(pair):
    K, _, params, model = pair
    for layer, m in ((1, M1), (2, M - M1)):
        got = codec._HostParamNets(model, "wavefront", f"context_model_{layer}",
                                   f"entropy_parameters_{layer}", m)
        want = jcodec._HostParamNets(params[f"context_model_{layer}"],
                                     params[f"entropy_parameters_{layer}"], m, K)
        assert got.ctx_w.shape == (12 * m, 2 * m) and (got.M, got.K) == (m, K)
        np.testing.assert_array_equal(got.ctx_w, want.ctx_w)
        np.testing.assert_array_equal(got.ctx_bias, want.ctx_bias)
        for (gw, gb), (ww, wb) in zip(got.ep, want.ep):
            np.testing.assert_array_equal(gw, ww)
            np.testing.assert_array_equal(gb, wb)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_stream_bytes_match_jax(pair, coded, shape):
    """The same latents, psi and z tables give the JAX codec's bytes, and
    JAX's truncation keeps the same prefix."""
    cod, x, data, _ = coded(shape)
    img_h, img_w, y_q, z_q, psi = cod._analyse_image(x)
    jc = _jax_codec(pair)
    key = (int(z_q.min()), int(z_q.max()))
    jc._z_cache[key] = cod._z_tables(*key)
    assert jc._encode_from(y_q, z_q, psi, img_h, img_w) == data
    assert jc.truncate_base(data) == cod.truncate_base(data)
    header = struct.unpack(codec._HEADER, data[:codec._HEADER_SIZE])
    assert header[1] == 3 and header[6] == M1 and (header[4], header[5]) == SHAPES[shape]
    assert len(cod.truncate_base(data)) == codec._HEADER_SIZE + header[9] + header[10]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_round_trip_matches_the_forward(coded, shape):
    cod, x, data, out = coded(shape)
    y_q, z_q = cod.decode_latents(data)
    np.testing.assert_array_equal(y_q, out["y_in"][0])
    np.testing.assert_array_equal(z_q, out["z_in"][0])
    assert len(np.unique(y_q[..., :M1])) >= 3 and len(np.unique(y_q[..., M1:])) >= 3
    h, w = SHAPES[shape]
    x_hat = cod.decompress(data)
    assert x_hat.shape == (1, h, w, 3)
    np.testing.assert_allclose(x_hat, np.clip(out["x_hat"], 0, 1)[:, :h, :w], rtol=0, atol=1e-6)
    x8 = cod.decompress(data, as_uint8=True)
    assert x8.dtype == np.uint8 and np.abs(x8.astype(int) - np.round(x_hat * 255)).max() <= 1
    assert cod.compress_latents(y_q, z_q, h, w) == data


@pytest.mark.parametrize("shape", list(SHAPES))
def test_truncated_stream_decodes_the_base_layer(coded, shape):
    cod, _, data, out = coded(shape)
    base = cod.truncate_base(data)
    assert len(base) < len(data) and data.startswith(base)
    assert cod.truncate_base(base) == base
    for stream in (base, data):
        y1, f_tilde = cod.decompress_base(stream)
        np.testing.assert_array_equal(y1, out["y1"][0])
        assert f_tilde.shape == out["F_tilde"].shape
        np.testing.assert_allclose(f_tilde, out["F_tilde"], rtol=0, atol=1e-6)
    for fn in (cod.decompress, cod.decode_latents):
        with pytest.raises(ValueError, match="enhancement stream missing"):
            fn(base)


def _with_header_field(data, index, value):
    fields = list(struct.unpack(codec._HEADER, data[:codec._HEADER_SIZE]))
    fields[index] = value
    return struct.pack(codec._HEADER, *fields) + data[codec._HEADER_SIZE:]


@pytest.mark.parametrize("case,match", [
    ("empty", "truncated stream"),
    ("header_only", "truncated"),
    ("cut_base", "truncated"),
    ("bad_magic", "not a NIC1"),
    ("joint_ar_kind", "not a scalable stream"),
    ("other_m1", "M1=9"),
    ("zmin_above_zmax", "zmin"),
    ("empty_image", "image size"),
    ("y2_corrupt", "corrupt or truncated"),
    ("portable_other_cards", "different cards"),
])
def test_malformed_streams_raise(pair, coded, case, match):
    cod, x, data, _ = coded("64x128")
    if case == "portable_other_cards":
        data = cod.compress_portable(x)
        cod = ScalableCodec(pair[3], portable_cards=tuple(
            PortableCard.build(pair[3], -16, 16, "wavefront", f"context_model_{i}",
                               f"entropy_parameters_{i}", m) for i, m in ((1, M1), (2, M - M1))))
    header_end = codec._HEADER_SIZE
    bad = {
        "empty": lambda: b"",
        "header_only": lambda: data[:header_end],
        "cut_base": lambda: cod.truncate_base(data)[:-3],
        "bad_magic": lambda: b"NIC2" + data[4:],
        "joint_ar_kind": lambda: _with_header_field(data, 1, 1),
        "other_m1": lambda: _with_header_field(data, 6, M1 - 1),
        "zmin_above_zmax": lambda: _with_header_field(data, 7, 100),
        "empty_image": lambda: _with_header_field(data, 4, 0),
        "y2_corrupt": lambda: data[:-4] + bytes(4),
        "portable_other_cards": lambda: data,
    }[case]()
    with pytest.raises(ValueError, match=match):
        cod.decode_latents(bad)


def test_other_codecs_refuse_scalable_streams(pair, coded):
    _, _, data, _ = coded("64x128")
    with pytest.raises(ValueError, match="not a joint-AR stream"):
        JointARCodec(JointAutoregressiveHierarchical(M, pair[0], device="cpu")).decode_latents(data)
    other = ScalableCodec(ScalableImageCoding(M, M1 - 2, pair[0], device="cpu"))
    with pytest.raises(ValueError, match=f"M1={M1}"):
        other.decompress_base(data)


# --- portable card pairs ---------------------------------------------------------------

@pytest.fixture(scope="module")
def cards(pair, tmp_path_factory):
    """(the JAX-built card pair, that pair loaded by the port through one
    scalable card file, the port's own pair)."""
    K, jmodel, params, model = pair
    variables = {"params": _jax_tree(params)}
    jcards = tuple(jportable.PortableCard.build(jmodel, variables, ZMIN, ZMAX,
                                                ctx_name=f"context_model_{i}",
                                                ep_name=f"entropy_parameters_{i}", M=m)
                   for i, m in ((1, M1), (2, M - M1)))
    path = str(tmp_path_factory.mktemp("cards") / "pair.npz")
    jportable.save_scalable_cards(path, jcards)
    ours = tuple(PortableCard.build(model, ZMIN, ZMAX, ctx_name=f"context_model_{i}",
                                    ep_name=f"entropy_parameters_{i}", M=m)
                 for i, m in ((1, M1), (2, M - M1)))
    return jcards, load_scalable_cards(path), ours


def test_card_pair_matches_jax(cards, tmp_path):
    jcards, loaded, ours = cards
    for jc, lc, oc in zip(jcards, loaded, ours):
        assert lc.hash == jc.hash
        got, want = dict(oc._arrays()), dict(jc._arrays())
        assert list(got) == list(want)
        for name, w in want.items():
            if name == "z_cdfs":
                assert np.abs(got[name].astype(np.int64) - w.astype(np.int64)).max() <= Z_CDF_TOL
            else:
                np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert (jcards[0].M, jcards[1].M) == (M1, M - M1)
    path = str(tmp_path / "again.npz")
    save_scalable_cards(path, loaded)  # and back: the JAX package loads the port's file
    assert [c.hash for c in jportable.load_scalable_cards(path)] == [c.hash for c in jcards]
    np.savez(str(tmp_path / "single.npz"), **dict(jcards[0]._arrays()))
    with pytest.raises(ValueError, match="not a scalable card pair"):
        load_scalable_cards(str(tmp_path / "single.npz"))


def test_portable_streams_match_across_packages(pair, coded, cards):
    _, _, _, model = pair
    jcards, loaded, _ = cards
    ours = ScalableCodec(model, portable_cards=loaded)
    theirs = _jax_codec(pair, portable_cards=jcards)
    _, x, _, out = coded("64x128")
    data = ours.compress_portable(x)
    y_q, z_q = ours.decode_latents(data)
    np.testing.assert_array_equal(y_q, out["y_in"][0])
    # the same latents, the same bytes in both directions
    assert theirs.compress_latents_portable(y_q, z_q, 64, 128) == data
    assert ours.compress_latents_portable(y_q, z_q, 64, 128) == data
    y1_bytes, y2_bytes, psi, z_j, h, w, portable = theirs._decode_common(data)
    assert portable
    np.testing.assert_array_equal(z_j, z_q)
    np.testing.assert_array_equal(np.concatenate(
        [theirs._decode_layer(1, y1_bytes, psi, h, w, True),
         theirs._decode_layer(2, y2_bytes, psi, h, w, True)], -1), y_q)
    base = ours.truncate_base(data)
    assert theirs.truncate_base(data) == base
    y1, _ = ours.decompress_base(base)
    np.testing.assert_array_equal(y1, out["y1"][0])


# --- refinement ------------------------------------------------------------------------

def _near_half(v):
    f = np.abs(np.asarray(v, np.float64))
    return np.abs(f - np.floor(f) - 0.5) < HALF_MARGIN


def test_refinement_matches_jax():
    """3 Adam steps of the scalable mode (K=3: the mixture on both layers)
    against JAX make_refiner: its metrics before and after, and its rounded
    latents but where a float latent sits within HALF_MARGIN of a rounding
    boundary; the refined latents round trip through the codec and
    truncate."""
    K = 3
    params = _gained(joint_ar_params_to_jax(ScalableImageCoding(M, M1, K, device="cpu",
                                                                seed=20)))
    model = load_jax_params(ScalableImageCoding(M, M1, K, device="cpu"), params)
    jmodel = JScalable(latent_channels=M, base_channels=M1, K=K)
    x = _image("64x128", seed=20)
    y, z, metrics = refine._refine(model, x, LAMBDA, STEPS, LR)
    y_q, z_q, want = jax_make_refiner(jmodel, {"params": _jax_tree(params)}, LAMBDA, STEPS,
                                      LR)(jnp.asarray(x))
    for when in ("pre_", "post_"):
        for k in METRICS:
            np.testing.assert_allclose(float(metrics[when + k]), float(want[when + k]),
                                       rtol=METRIC_RTOL, err_msg=when + k)
    assert float(metrics["post_loss"]) < float(metrics["pre_loss"])
    for ours, q in ((y, y_q), (z, z_q)):
        differ = torch.round(ours).numpy() != np.asarray(q)
        assert not (differ & ~_near_half(ours.numpy())).any() and differ.mean() < 1e-3
    assert float((y - torch.round(y)).abs().max()) > 0  # the steps moved the latents
    ry, rz, _ = make_refiner(model, LAMBDA, STEPS, LR)(x)
    cod = ScalableCodec(model)
    data = cod.compress_latents(ry, rz, 64, 128)
    np.testing.assert_array_equal(cod.decode_latents(data)[0], ry[0].numpy())
    np.testing.assert_array_equal(cod.decompress_base(cod.truncate_base(data))[0],
                                  ry[0, ..., :M1].numpy())


# --- the evaluator ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def evaluators(pair, tmp_path_factory):
    """The JAX evaluator's and the port's evaluate() with the width-5
    teacher (P3 channels 20 == 2 M1) on two 192x192 images."""
    K, jmodel, params, model = pair
    rng = np.random.default_rng(K)
    images = [rng.uniform(size=(1, EVAL_SIZE, EVAL_SIZE, 3)).astype(np.float32)
              for _ in range(2)]
    bb = build_yolo_backbone(5, device="cpu", seed=7)
    jact, jV = jdistillation_targets(jbuild_yolo_backbone(width=5), _jax_tree(variables_to_jax(bb)),
                                     3)
    act, V = distillation_targets(bb, 3)
    jev = JEvaluator(jmodel, _jax_tree(params), images, LAMBDA, 1.0,
                     str(tmp_path_factory.mktemp("jax_eval")))
    want = jev.evaluate(functools.partial(jvision_rd_loss, frozen_activation=jact, V=jV))[0]
    ev = VisionCompressionEvaluator(model, images, LAMBDA, 1.0,
                                    str(tmp_path_factory.mktemp("eval")))
    got = ev.evaluate(functools.partial(vision_rd_loss, frozen_activation=act, V=V))
    return jev, want, ev, got


def test_evaluator_matches_jax(evaluators):
    _, want, _, (got, imgs, recons) = evaluators
    # the JAX evaluator's dict comes back from the device with sorted keys
    assert set(got) == set(want)
    assert list(got) == ["MSE(255)", "PSNR(RGB)", "MS-SSIM(RGB)", "PSNR(Y)", "MS-SSIM(Y)", "BPP",
                         "BPP(y)", "BPP(y1)", "BPP(y2)", "BPP(z)", "BPP(reference_reported)",
                         "VisionMSE"]
    for k in want:
        atol = MSSSIM_ATOL if k.startswith("MS-SSIM") else 0.0
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL, atol=atol, err_msg=k)
    np.testing.assert_allclose(got["BPP"], got["BPP(y1)"] + got["BPP(y2)"] + got["BPP(z)"],
                               rtol=1e-6)
    assert len(imgs) == len(recons) == 2


def test_evaluator_save_results_and_plots(evaluators):
    jev, want, ev, (got, imgs, recons) = evaluators
    paths = [e.save_results(want, 123, "Scalable16_M1-10") for e in (jev, ev)]
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    without = ev.evaluate()[0]  # no teacher: no VisionMSE field
    assert "VisionMSE" not in without and without["BPP"] == pytest.approx(got["BPP"], rel=1e-6)
    for layer in (1, 2):
        path = ev.plot_high_entropy_channel(imgs, latent_idx=layer, seed=0)
        assert os.path.exists(path) and f"high_entropy_channel_layer{layer}_" in path
    (sample,) = ev.plot_samples(imgs, recons, n=1, seed=0)
    assert os.path.exists(sample)
