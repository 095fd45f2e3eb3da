"""PyTorch port, ChannelCheckerboardHierarchical and ChannelCheckerboardCodec:
the shared suite of tests/test_torch_hyperprior.py (model, codec,
refinement and evaluation against the JAX package at M=16, groups
(2, 2, 4, 8), 64x128, K=1 and K=3) with FAMILY = "channel_cb", and the
family's own: the groups, the per-group modules' names, the 2·G decode
passes against the one-program forward and against the JAX passes, what
each pass may see, the lanes over 2·G blocks against the JAX codec's, and
the passes' input layout.

Tolerances: the passes' parameters within 1e-6 relative (1e-7 absolute)
of the one-program forward (the JAX package's test_channel_cb.py), and
within test_torch_joint_ar.py's entropy-parameter tolerances (1e-4
relative, 1e-5 absolute) of the JAX passes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.coding import codec as jcodec
from neural_image_compression_tpu.models import channel_cb as jchannel_cb
from neural_image_compression_tpu_torch.coding import ChannelCheckerboardCodec, codec
from neural_image_compression_tpu_torch.models import ChannelCheckerboardHierarchical, channel_cb
from neural_image_compression_tpu_torch.models.checkerboard import checkerboard_mask
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

FAMILY = "channel_cb"
M = 16
GROUPS = (2, 2, 4, 8)


def _latents(seed, h=8, w=8):
    rng = np.random.default_rng(seed)
    y = np.round(rng.normal(size=(1, h, w, M)) * 3).astype(np.float32)
    z = np.round(rng.normal(size=(1, h // 4, w // 4, M)) * 2).astype(np.float32)
    return y, z


def _passes(model, y, z):
    """Every group's (anchor, non-anchor) parameters from the model's decode
    passes, given the full latents (the decoded groups at each pass)."""
    am = checkerboard_mask(*y.shape[1:3])
    out = []
    with torch.no_grad():
        psi = model.hyper_features(torch.from_numpy(z))
        off = 0
        for i, gi in enumerate(model.group_sizes):
            ch = model.group_channel_ctx(i, torch.from_numpy(y[..., :off]) if i else None)
            y_anchor = np.where(am[None, :, :, None], y[..., off:off + gi], 0.0)
            out.append((model.group_params(i, psi, ch, None),
                        model.group_params(i, psi, ch, torch.from_numpy(y_anchor))))
            off += gi
    return out


def test_default_groups_match_jax():
    for m in (1, 3, 4, 8, 16, 100, 128, 192, 320):
        assert channel_cb.default_groups(m) == jchannel_cb.default_groups(m)
    assert channel_cb.default_groups(128) == (16, 16, 32, 64)
    assert channel_cb.default_groups(M) == GROUPS
    with pytest.raises(ValueError, match="latent_channels"):
        channel_cb.default_groups(0)


def test_groups_checked_and_modules_named_like_jax(pair):
    K, _, params, model, _, _ = pair
    assert model.group_sizes == GROUPS and model.groups is None
    names = {n.split(".")[0] for n in model.state_dict()}
    assert names == set(params)  # spatial_ctx_0, channel_ctx_1.., entropy_parameters_3, ...
    assert "channel_ctx_0" not in names
    for i, gi in enumerate(GROUPS):
        ep = getattr(model, f"entropy_parameters_{i}")
        assert ep.input_channels == 4 * gi + 2 * M
        assert tuple(getattr(model, f"spatial_ctx_{i}").weight.shape) == (2 * gi, gi, 5, 5)
        if i:
            ctx = getattr(model, f"channel_ctx_{i}")
            assert tuple(ctx.Conv2d_0.weight.shape) == (max(2 * gi, 64), sum(GROUPS[:i]), 5, 5)
    np.testing.assert_array_equal(
        model.spatial_ctx_1.weight.detach().numpy(),
        np.transpose(params["spatial_ctx_1"]["kernel"], (3, 2, 0, 1)))
    custom = ChannelCheckerboardHierarchical(M, K, groups=(4, 12), device="cpu")
    assert custom.group_sizes == (4, 12) and custom.groups == (4, 12)
    for bad in ((4, 4), (0, 16), (-2, 18)):
        with pytest.raises(ValueError, match="sum to latent_channels"):
            ChannelCheckerboardHierarchical(M, K, groups=bad, device="cpu")


def test_group_passes_equal_the_one_program_forward(pair):
    """Each group's anchor pass at its anchors and non-anchor pass at its
    non-anchors give the one-program forward's parameters for its
    channels."""
    model = pair[3]
    y, z = _latents(5)
    am = checkerboard_mask(8, 8)
    with torch.no_grad():
        full = model.entropy_params_from_latents(torch.from_numpy(y), torch.from_numpy(z))
    assert len(full) == (2 if pair[0] == 1 else 3)
    off = 0
    for (first, second), gi in zip(_passes(model, y, z), GROUPS):
        for want, a, n in zip(full, first, second):
            w = want[0].numpy()[..., off:off + gi]
            assert a.shape[-1] == gi and a.shape[:3] == (1, 8, 8)
            np.testing.assert_allclose(a[0].numpy()[am], w[am], rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(n[0].numpy()[~am], w[~am], rtol=1e-6, atol=1e-7)
        off += gi


def test_what_each_pass_sees(pair):
    """Group i's anchor parameters see only the groups before it; its
    non-anchor parameters also see its own anchors, never its non-anchors
    or a later group (the decoder does not know them then)."""
    model = pair[3]
    y, z = _latents(6)
    am = checkerboard_mask(8, 8)
    base = _passes(model, y, z)
    off = 0
    for i, gi in enumerate(GROUPS):
        later = y.copy()
        later[..., off + gi:] += 5.0
        later[..., off:off + gi] += np.where(am[None, :, :, None], 0.0, 7.0)
        first, second = _passes(model, later, z)[i]
        moved = y.copy()
        moved[..., off:off + gi] += 3.0  # the group's anchors too
        first_m, second_m = _passes(model, moved, z)[i]
        for b_a, b_n, a, n, a_m, n_m in zip(*base[i], first, second, first_m, second_m):
            np.testing.assert_array_equal(a.numpy(), b_a.numpy())
            np.testing.assert_array_equal(n.numpy(), b_n.numpy())
            np.testing.assert_array_equal(a_m.numpy(), b_a.numpy())
            assert not np.array_equal(n_m.numpy(), b_n.numpy())  # the spatial context reaches
        if i:
            earlier = y.copy()
            earlier[..., :off] += 2.0
            a_e = _passes(model, earlier, z)[i][0]
            assert not np.array_equal(a_e[0].numpy(), base[i][0][0].numpy())
        off += gi


def test_passes_match_jax(pair):
    """hyper_features, group_channel_ctx and group_params of every pass
    against the JAX model's, on the same weights."""
    _, jmodel, params, model, _, _ = pair
    y, z = _latents(8)
    am = checkerboard_mask(8, 8)
    v = {"params": params}
    jpsi = jmodel.apply(v, jnp.asarray(z), method=lambda m, zz: m.hyper_features(zz))
    ours = _passes(model, y, z)
    with torch.no_grad():
        psi = model.hyper_features(torch.from_numpy(z))
    np.testing.assert_allclose(psi.numpy(), np.asarray(jpsi), rtol=1e-4, atol=1e-5)
    off = 0
    for i, gi in enumerate(GROUPS):
        jch = jmodel.apply(v, jnp.asarray(y[..., :off]),
                           method=lambda m, yp, i=i: m.group_channel_ctx(i, yp))
        if i:
            with torch.no_grad():
                ch = model.group_channel_ctx(i, torch.from_numpy(y[..., :off]))
            np.testing.assert_allclose(ch.numpy(), np.asarray(jch), rtol=1e-4, atol=1e-5)
        else:
            assert jch is None
        y_anchor = jnp.asarray(np.where(am[None, :, :, None], y[..., off:off + gi], 0.0))
        want = [jmodel.apply(v, jpsi, jch, ya, method=lambda m, p, c, a, i=i:
                             m.group_params(i, p, c, a)) for ya in (None, y_anchor)]
        for got, jwant in zip(ours[i], want):
            for g, w in zip(got, jwant):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
        off += gi


@pytest.mark.parametrize("n", [1, 3, 8])
def test_lanes_over_blocks_match_jax(n):
    """The lane layout over 2·G blocks: the port's lanes are the JAX
    ChannelCheckerboardCodec's bytes for the same symbols, parameters and
    block bounds, and decode block by block."""
    rng = np.random.default_rng(20 + n)
    bounds = [0, 20, 41, 41, 80, 123, 167, 250, 301]
    n_sym, K = bounds[-1], 3
    mus = (rng.normal(size=(n_sym, K)) * 3).astype(np.float32)
    sigmas = (np.abs(rng.normal(size=(n_sym, K))) + 0.3).astype(np.float32)
    w = rng.uniform(size=(n_sym, K)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    sym = np.round(mus[:, 0]).astype(np.int32)
    data = codec._encode_lanes(sym, mus, sigmas, w, bounds, n)
    jc = jcodec.ChannelCheckerboardCodec.__new__(jcodec.ChannelCheckerboardCodec)
    assert data == jc._encode_lanes_blocks(sym, mus, sigmas, w, bounds, n)
    decs = codec._open_lanes(data, 0x8000 | n)
    got = [codec._decode_block_lanes(decs, mus[b0:b1], sigmas[b0:b1], w[b0:b1])
           for b0, b1 in zip(bounds[:-1], bounds[1:])]
    codec._finish(decs)
    np.testing.assert_array_equal(np.concatenate(got), sym)


def test_stream_order_and_block_bounds(coded):
    """The symbols go group by group, anchors then non-anchors, row-major
    with channel fastest (the JAX layout), in 2·G blocks."""
    cod, x, data, out = coded("64x128")
    y_q, z_q = cod.decode_latents(data)
    sym, mus, sigmas, weights, bounds = cod._coder_args(y_q, cod._enqueue(z_q[None]))
    am = checkerboard_mask(*y_q.shape[:2])
    want, off = [], 0
    for gi in GROUPS:
        want += [y_q[..., off:off + gi][am].reshape(-1), y_q[..., off:off + gi][~am].reshape(-1)]
        off += gi
    np.testing.assert_array_equal(sym, np.concatenate(want).astype(np.int32))
    assert bounds == [0] + list(np.cumsum([b.size for b in want]))
    assert mus.shape[0] == sym.shape[0] and sigmas.shape == mus.shape


def test_three_lanes_round_trip_and_batch(coded):
    cod, x, data, out = coded("70x100")
    lanes = cod.compress(x, n_streams=3)
    y_q, z_q = cod.decode_latents(lanes)
    np.testing.assert_array_equal(y_q, out["y_in"][0])
    np.testing.assert_array_equal(z_q, out["z_in"][0])
    assert cod.compress_latents(y_q, z_q, 70, 100, n_streams=3) == lanes
    got = cod.decompress_batch([lanes, data, lanes], workers=2)
    np.testing.assert_allclose(got[1:2], cod.decompress(data), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], got[2], rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 3])
def test_codec_passes_see_one_input_layout(coded, n):
    """The passes take fresh contiguous float32 inputs: a strided z or a
    sliced y_prev give the same rows as contiguous ones, and two calls give
    equal streams."""
    cod, x, data, out = coded("64x128")
    y_q, z_q = cod.decode_latents(data)
    z_view = torch.from_numpy(z_q[None])
    z_strided = z_view.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last
                                                      ).permute(0, 2, 3, 1)
    psi_a, psi_b = cod._psi_device(z_view), cod._psi_device(z_strided)
    assert torch.equal(psi_a, psi_b)
    off = sum(GROUPS[:3])
    _, rows_view = cod._anchor_device(3, psi_a, y_q[None, ..., :off])
    _, rows_copy = cod._anchor_device(3, psi_a, np.ascontiguousarray(y_q[None, ..., :off]))
    for a, b in zip(rows_view, rows_copy):
        if a is not None:
            assert torch.equal(a, b)
    assert cod.compress(x, n_streams=n) == cod.compress(x, n_streams=n)


def test_card_set_groups_must_match(pair):
    model = pair[3]
    cod = ChannelCheckerboardCodec(model)
    other = ChannelCheckerboardHierarchical(M, pair[0], groups=(8, 8), device="cpu")
    with pytest.raises(ValueError, match="groups"):
        ChannelCheckerboardCodec(other, portable_card=cod.portable_card()).portable_card()
