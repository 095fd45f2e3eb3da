"""PyTorch port, evaluation.CompressionEvaluator, held against the JAX
package's on the same weights (JAX-initialised, gains on the last analysis
convolutions so that y and z spread over several integers, carried across
with load_jax_params) and the same images (CPU, M=16, K=3, two 192x192
images: the default MS-SSIM needs 161 px a side): compute_metrics,
evaluate(), save_results' bytes, evaluate_codec's analytic and stream rate,
a batch-2 loader, refinement, params applied through functional_call, and
the two plots.

Tolerances: every metric within 1e-5 relative, the MS-SSIM fields also
within 1e-5 absolute: a random model's reconstructions are nearly unrelated
to the images, its MS-SSIM is about 0.08 with per-level contrast terms near
0.01, and there float32 puts each package 3-4e-6 from a float64 evaluation
of the formula, on either side (test_torch_msssim.py holds the port to the
float64 value). The stream rate within 0.5% of JAX's (the z tables come from
float CDFs, and the two packages' may differ by one in a count)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.coding import JointARCodec as JCodec
from neural_image_compression_tpu.evaluation import CompressionEvaluator as JEvaluator
from neural_image_compression_tpu.evaluation import compute_metrics as jcompute_metrics
from neural_image_compression_tpu.models import JointAutoregressiveHierarchical as JModel
from neural_image_compression_tpu_torch.coding import JointARCodec
from neural_image_compression_tpu_torch.evaluation import CompressionEvaluator, compute_metrics
from neural_image_compression_tpu_torch.models import JointAutoregressiveHierarchical
from neural_image_compression_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(1)

M, K, SIZE, LAMBDA = 16, 3, 192, 0.005
GAIN_Y, GAIN_Z = 12.0, 30.0  # as test_torch_codec.py
RTOL, MSSSIM_ATOL = 1e-5, 1e-5
STREAM_RTOL = 5e-3


def _images(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(1, SIZE, SIZE, 3)).astype(np.float32) for _ in range(n)]


def _gained(params):
    params = jax.tree.map(np.array, params)
    for path, gain in ((("encoder", "Conv2d_3"), GAIN_Y), (("hyper_encoder", "Conv2d_2"), GAIN_Z)):
        leaf = params[path[0]][path[1]]
        leaf["kernel"] = leaf["kernel"] * gain
        leaf["bias"] = leaf["bias"] * gain
    return params


# compute_metrics' order, the reference's results file's
# (eval_results/eval_results_0.005_lambda_GM-Capacity128_K3-synthetic.txt);
# the JAX evaluator's dicts come back from the device with sorted keys
DISTORTION_KEYS = ["MSE(255)", "PSNR(RGB)", "MS-SSIM(RGB)", "PSNR(Y)", "MS-SSIM(Y)"]


def _assert_metrics_close(got, want):
    assert set(got) == set(want)
    for k in want:
        atol = MSSSIM_ATOL if k.startswith("MS-SSIM") else 0.0
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX evaluator's evaluate() and evaluate_codec() on the images,
    and its params."""
    jmodel = JModel(latent_channels=M, K=K)
    key = jax.random.PRNGKey(0)
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    params = _gained(jmodel.init({"params": key, "noise": key}, x, training=False)["params"])
    ev = JEvaluator(jmodel, params, _images(), LAMBDA, str(tmp_path_factory.mktemp("jax_eval")))
    metrics, imgs, recons = ev.evaluate()
    codec_metrics = ev.evaluate_codec(JCodec(jmodel, {"params": params}))
    return params, ev, metrics, np.stack([r for r in recons]), codec_metrics


def _evaluator(params, loader, tmp_path, **kw):
    model = load_jax_params(JointAutoregressiveHierarchical(M, K, device="cpu"), params)
    return CompressionEvaluator(model, loader, LAMBDA, str(tmp_path), **kw)


def test_compute_metrics_matches_jax():
    a, b = _images(2, seed=4)
    got = {k: float(v) for k, v in compute_metrics(torch.from_numpy(a),
                                                   torch.from_numpy(b)).items()}
    want = {k: float(v) for k, v in jcompute_metrics(jnp.asarray(a), jnp.asarray(b)).items()}
    _assert_metrics_close(got, want)


def test_evaluate_matches_jax(ref, tmp_path):
    params, _, want, want_recons, _ = ref
    ev = _evaluator(params, _images(), tmp_path)
    got, imgs, recons = ev.evaluate()
    _assert_metrics_close(got, want)
    assert list(got) == DISTORTION_KEYS + ["BPP", "BPP(y)", "BPP(z)", "BPP(reference_reported)"]
    assert got["BPP(reference_reported)"] == got["BPP(y)"]
    np.testing.assert_allclose(got["BPP"], got["BPP(y)"] + got["BPP(z)"], rtol=1e-6)
    y_in = ev.model(torch.from_numpy(_images()[0]), training=False)["y_in"]
    assert float((y_in != 0).float().mean()) > 0.2  # the gains spread y
    assert len(imgs) == len(recons) == 2 and recons[0].shape == (SIZE, SIZE, 3)
    np.testing.assert_allclose(np.stack(recons), want_recons, rtol=0, atol=1e-4)


def test_save_results_is_byte_identical(ref, tmp_path):
    params, jev, want, _, _ = ref
    ev = _evaluator(params, _images(), tmp_path)
    got_path = ev.save_results(want, 1234, "GM-Capacity16_K3")
    want_path = jev.save_results(want, 1234, "GM-Capacity16_K3")
    assert os.path.basename(got_path) == os.path.basename(want_path) == \
        "eval_results_0.005_lambda_GM-Capacity16_K3.txt"
    with open(got_path, "rb") as f, open(want_path, "rb") as g:
        assert f.read() == g.read()


def test_evaluate_codec_matches_jax(ref, tmp_path):
    params, _, evaluated, _, want = ref
    ev = _evaluator(params, _images(), tmp_path)
    got = ev.evaluate_codec(JointARCodec(ev.model))
    assert list(got) == DISTORTION_KEYS + ["BPP(bitstream)", "BPP(analytic)",
                                           "bitstream_overhead"]
    assert set(got) == set(want)
    np.testing.assert_allclose(got["BPP(analytic)"], want["BPP(analytic)"], rtol=RTOL)
    np.testing.assert_allclose(got["BPP(analytic)"], evaluated["BPP"], rtol=RTOL)
    np.testing.assert_allclose(got["BPP(bitstream)"], want["BPP(bitstream)"], rtol=STREAM_RTOL)
    _assert_metrics_close({k: got[k] for k in evaluated if k in got},
                          {k: want[k] for k in evaluated if k in want})
    assert got["BPP(bitstream)"] <= 1.02 * got["BPP(analytic)"] + 8 * 34 / SIZE ** 2


def test_evaluate_codec_batch_loader_codes_every_image(ref, tmp_path):
    """One batch of two images gives the two batch-1 images' metrics, and
    the codec sees each image once."""
    params, _, _, _, _ = ref
    imgs = _images()
    single = _evaluator(params, imgs, tmp_path)
    codec = JointARCodec(single.model)
    want = single.evaluate_codec(codec)
    calls = []
    compress = codec.compress
    codec.compress = lambda x, **kw: calls.append(x.shape) or compress(x, **kw)
    got = _evaluator(params, [np.concatenate(imgs)], tmp_path).evaluate_codec(codec)
    assert calls == [(1, SIZE, SIZE, 3)] * 2
    assert got == want


def test_evaluate_codec_with_refinement(ref, tmp_path):
    params, _, _, _, _ = ref
    ev = _evaluator(params, _images(1), tmp_path)
    codec = JointARCodec(ev.model)
    plain = ev.evaluate_codec(codec)
    refined = ev.evaluate_codec(codec, refine_steps=3, refine_lambda=LAMBDA, refine_lr=0.05)
    assert all(np.isfinite(v) for v in refined.values())
    assert refined["BPP(analytic)"] == plain["BPP(analytic)"]  # the eval forward's rate
    assert refined["BPP(bitstream)"] != plain["BPP(bitstream)"]  # other latents coded
    with pytest.raises(ValueError, match="refine_lambda"):
        ev.evaluate_codec(codec, refine_steps=3)


def test_params_apply_through_functional_call(ref, tmp_path):
    """Evaluating with params (e.g. a Trainer's EMA) equals evaluating a
    model that holds them, and leaves the given model as it was."""
    params, _, _, _, _ = ref
    ev = _evaluator(params, _images(1), tmp_path)
    shifted = {k: v.detach() * 1.01 for k, v in ev.model.named_parameters()}
    before = {k: v.detach().clone() for k, v in ev.model.named_parameters()}
    got, _, _ = CompressionEvaluator(ev.model, _images(1), LAMBDA, str(tmp_path),
                                     params=shifted).evaluate()
    holder = JointAutoregressiveHierarchical(M, K, device="cpu")
    holder.load_state_dict(shifted)
    want, _, _ = CompressionEvaluator(holder, _images(1), LAMBDA, str(tmp_path)).evaluate()
    assert got == want
    for k, v in ev.model.named_parameters():
        assert torch.equal(v, before[k]), k


def test_plots_write_pngs(ref, tmp_path):
    pytest.importorskip("matplotlib")
    params, _, _, _, _ = ref
    ev = _evaluator(params, _images(), tmp_path)
    _, imgs, recons = ev.evaluate()
    paths = ev.plot_samples(imgs, recons, n=2, seed=0)
    paths.append(ev.plot_high_entropy_channel(imgs, seed=0))
    assert len(paths) == 3
    for p in paths:
        assert os.path.exists(p) and p.endswith(".png") and os.path.getsize(p) > 0


def test_empty_loader_raises(tmp_path):
    model = JointAutoregressiveHierarchical(8, 3, device="cpu")
    with pytest.raises(ValueError, match="no images"):
        CompressionEvaluator(model, [], LAMBDA, str(tmp_path)).evaluate()
