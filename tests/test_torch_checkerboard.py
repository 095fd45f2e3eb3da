"""PyTorch port, CheckerboardHierarchical and CheckerboardCodec: the shared
suite of tests/test_torch_hyperprior.py (model, codec, refinement and
evaluation against the JAX package) with FAMILY = "checkerboard", and the
checkerboard's own: the two decode passes against the one-pass forward and
against the JAX passes, what each pass may see, and the anchor
convention."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.models import checkerboard as jcheckerboard
from neural_image_compression_tpu_torch.models import checkerboard
from test_torch_hyperprior import (  # noqa: F401  (fixtures and tests collected here)
    coded, jax_grads, pair, test_batch_equals_singles, test_compress_latents_reproduces_the_stream,
    test_constructor_checks, test_eval_forward_matches_jax, test_evaluator_takes_the_codec,
    test_flops_match_jax, test_header_and_z_stream_match_jax, test_latents_match_jax_forward,
    test_malformed_streams_raise, test_other_models_streams_raise, test_refine_matches_jax,
    test_round_trip_exact, test_stream_bits_track_analytic,
    test_training_forward_and_gradients_match_jax, test_uint8_input_gives_the_same_stream,
    test_weights_round_trip,
)

torch.set_num_threads(1)

FAMILY = "checkerboard"
M = 16


def _latents(seed, h=8, w=8):
    rng = np.random.default_rng(seed)
    y = np.round(rng.normal(size=(1, h, w, M)) * 3).astype(np.float32)
    z = np.round(rng.normal(size=(1, h // 4, w // 4, M)) * 2).astype(np.float32)
    return y, z


def _anchors_only(y):
    am = checkerboard.checkerboard_mask(*y.shape[1:3])
    return np.where(am[None, :, :, None], y, 0.0).astype(np.float32)


def test_anchor_convention_matches_jax():
    assert checkerboard.CB_CTX_POSITIONS == jcheckerboard.CB_CTX_POSITIONS
    for h, w in ((8, 8), (5, 7), (1, 3)):
        am = checkerboard.checkerboard_mask(h, w)
        np.testing.assert_array_equal(am, jcheckerboard.checkerboard_mask(h, w))
        dev = checkerboard._anchor_mask(h, w, torch.float32, "cpu")[0, 0].numpy()
        np.testing.assert_array_equal(dev, am.astype(np.float32))


def test_two_passes_equal_the_one_pass_forward(pair):
    """anchor_pass at the anchors and nonanchor_pass at the non-anchors give
    the one-pass forward's parameters (the entropy-parameter net is 1x1);
    the tolerance of the JAX package's test_checkerboard.py."""
    model = pair[3]
    y, z = _latents(5)
    am = checkerboard.checkerboard_mask(8, 8)
    with torch.no_grad():
        full = model.entropy_params_from_latents(torch.from_numpy(y), torch.from_numpy(z))
        psi, *first = model.anchor_pass(torch.from_numpy(z))
        second = model.nonanchor_pass(psi, torch.from_numpy(_anchors_only(y)))
    assert psi.shape == (1, 8, 8, 2 * M)
    assert len(full) == len(first) == len(second) == (2 if pair[0] == 1 else 3)
    for want, a, n in zip(full, first, second):
        w = want[0].numpy()
        np.testing.assert_allclose(a[0].numpy()[am], w[am], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(n[0].numpy()[~am], w[~am], rtol=1e-6, atol=1e-7)


def test_what_each_pass_sees(pair):
    """The anchors' parameters ignore every latent; the non-anchors' ignore
    the non-anchors (the decoder does not know them when it needs them)."""
    model = pair[3]
    y, z = _latents(6)
    am = checkerboard.checkerboard_mask(8, 8)
    other = y + np.where(am[None, :, :, None], 0.0, 7.0).astype(np.float32)
    scrambled = np.random.default_rng(7).permutation(y.reshape(-1)).reshape(y.shape)
    with torch.no_grad():
        def ep(yv):
            return [t[0].numpy() for t in model.entropy_params_from_latents(
                torch.from_numpy(yv), torch.from_numpy(z))]
        base, moved, anywhere = ep(y), ep(other), ep(scrambled)
    for b, m, s in zip(base, moved, anywhere):
        np.testing.assert_array_equal(m[~am], b[~am])
        np.testing.assert_array_equal(s[am], b[am])
        assert not np.array_equal(s[~am], b[~am])  # the context does reach the non-anchors


def test_passes_match_jax(pair):
    """Each pass against the JAX package's, on the same weights: the
    tolerances of test_torch_joint_ar.py's entropy parameters."""
    K, jmodel, params, model, _, _ = pair
    y, z = _latents(8)
    out = jmodel.apply({"params": params}, jnp.asarray(z), method=lambda m, zz: m.anchor_pass(zz))
    y_anchor = _anchors_only(y)
    jsecond = jmodel.apply({"params": params}, out[0], jnp.asarray(y_anchor),
                           method=lambda m, p, ya: m.nonanchor_pass(p, ya))
    with torch.no_grad():
        psi, *first = model.anchor_pass(torch.from_numpy(z))
        second = model.nonanchor_pass(psi, torch.from_numpy(y_anchor))
    np.testing.assert_allclose(psi.numpy(), np.asarray(out[0]), rtol=1e-4, atol=1e-5)
    for got, want in zip(list(first) + list(second), list(out[1:]) + list(jsecond)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_context_conv_is_named_like_jax(pair):
    params = pair[2]
    assert set(params["context_model"]) == {"Conv2d_0"}
    weight = pair[3].context_model.Conv2d_0.weight
    assert tuple(weight.shape) == (2 * M, M, 5, 5)
    np.testing.assert_array_equal(
        weight.detach().numpy(), np.transpose(params["context_model"]["Conv2d_0"]["kernel"],
                                              (3, 2, 0, 1)))


@pytest.mark.parametrize("n", [1, 3])
def test_codec_passes_see_one_input_layout(coded, n):
    """The codec's passes take fresh contiguous float32 inputs: z from the
    analysis (a channels_last view) and z uploaded from the host give the
    same rows, as do two calls."""
    cod, x, data, out = coded("64x128")
    z_view = torch.from_numpy(out["z_in"])  # (1, hz, wz, M)
    z_strided = z_view.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last
                                                      ).permute(0, 2, 3, 1)
    a = cod._anchor_device(z_view)
    b = cod._anchor_device(z_strided)
    for ra, rb in zip(a[1], b[1]):
        if ra is not None:
            assert torch.equal(ra, rb)
    assert cod.compress(x, n_streams=n) == cod.compress(x, n_streams=n)
