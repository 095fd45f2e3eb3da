"""PyTorch port, real bitstreams: ``coding.JointARCodec`` (single images,
interleaved and tiled streams, batches) and what it drives, held against the
JAX package's coding modules on the same weights (JAX-initialised, carried
across with load_jax_params) and against the port's own eval forward (CPU,
M=16, 64x128 and a ragged 70x100). Portable streams: test_torch_portable.py.

Float streams are per build: no stream crosses between the packages. What
must match across them, given the same inputs, is checked instead: the
latents, the coder-layout weights, the z tables and the bytes the shared
C++ coder writes for the same symbols, distributions and layout.
"""

import filecmp
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.coding import backend as jbackend
from neural_image_compression_tpu.coding import cdf_tables as jcdf
from neural_image_compression_tpu.coding import codec as jcodec
from neural_image_compression_tpu.models import JointAutoregressiveHierarchical as JModel
from neural_image_compression_tpu_torch.coding import (
    JointARCodec, backend, bitstream_bpp, factorized_tables, quantize_pmf_rows, stream_size,
)
from neural_image_compression_tpu_torch.coding import PortableCard, codec
from neural_image_compression_tpu_torch.models import JointAutoregressiveHierarchical
from neural_image_compression_tpu_torch.train import rd_loss
from neural_image_compression_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 16
# Random-init encoders give |y| < 0.3, which rounds to all zeros; these gains
# on the last analysis convs spread y and z over several integers (as in
# test_torch_joint_ar.py).
GAIN_Y, GAIN_Z = 12.0, 30.0
SHAPES = {"64x128": (64, 128), "70x100": (70, 100)}
# The z tables: the two packages' grid_pmf differ in their last float bits,
# and quantize_pmf_rows floors pmf * budget, so a frequency can move by one
# step of 2^-16, and its cumulative row by the moves summed. Measured over
# the supports of test_factorized_tables_match_jax (M=16, K=1 and 3): at
# most 1 in any frequency and any cumulative entry, in at most 10 of 1,312
# frequencies. Tolerance: 1 a frequency, 2 a cumulative entry, 1% of the
# frequencies.
Z_TABLE_FREQ_TOL, Z_TABLE_CUM_TOL, Z_TABLE_DIFFERING_SHARE = 1, 2, 0.01


def _gained(params):
    params = jax.tree.map(np.array, params)
    for path, gain in ((("encoder", "Conv2d_3"), GAIN_Y), (("hyper_encoder", "Conv2d_2"), GAIN_Z)):
        leaf = params[path[0]][path[1]]
        leaf["kernel"] = leaf["kernel"] * gain
        leaf["bias"] = leaf["bias"] * gain
    return params


@pytest.fixture(scope="module", params=[1, 3], ids=["K1", "K3"])
def pair(request):
    """(K, JAX model, gained JAX params, the port's model with them)."""
    K = request.param
    jmodel = JModel(latent_channels=M, K=K)
    key = jax.random.PRNGKey(K)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = _gained(jmodel.init({"params": key, "noise": key}, x, training=False)["params"])
    model = load_jax_params(JointAutoregressiveHierarchical(M, K, device="cpu"), params)
    return K, jmodel, params, model


def _image(shape, seed=0):
    h, w = SHAPES[shape]
    return np.random.default_rng(seed).uniform(size=(1, h, w, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def coded(pair):
    """shape -> (codec, x, stream, the port's eval forward on the padded x),
    each built once for the pair's K."""
    model = pair[3]
    built = {}

    def get(shape):
        if shape not in built:
            cod = JointARCodec(model)
            x = _image(shape)
            out = model(torch.from_numpy(codec._pad_input(x, 64)), training=False)
            built[shape] = cod, x, cod.compress(x), {k: v.numpy() for k, v in out.items()
                                                     if k != "training"}
        return built[shape]

    return get


# --- the native coder ---------------------------------------------------------

@pytest.mark.parametrize("name", ["rans_core.h", "rans.cc", "ar_wavefront.cc", "ar_portable.cc"])
def test_native_sources_are_byte_copies(name):
    ours = backend.RANS_DIR / name
    theirs = os.path.join(REPO, "neural_image_compression_tpu", "coding", "rans", name)
    assert filecmp.cmp(ours, theirs, shallow=False)


def test_build_lands_in_the_ports_build_dir():
    path = backend.build()
    assert path.parent == backend.BUILD_DIR and path.name.startswith("librans-")
    assert path.exists() and backend.library_path() == path
    assert not list(backend.RANS_DIR.glob("*.so"))  # nothing written beside the sources


def test_missing_compiler_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        backend.library_path()


def test_quantize_pmf_rows_matches_jax():
    rng = np.random.default_rng(7)
    for c, L in ((4, 11), (16, 40), (3, 2)):
        pmf = rng.uniform(size=(c, L)) ** 3
        pmf[0, :] = 0.0  # an all-zero row
        got = quantize_pmf_rows(pmf)
        np.testing.assert_array_equal(got, jcdf.quantize_pmf_rows(pmf))
        assert got.dtype == np.uint32 and (got[:, -1] == backend.PROB_SCALE).all()
        assert (np.diff(got.astype(np.int64), axis=1) >= 1).all()


def test_encode_indexed_bytes_match_jax():
    rng = np.random.default_rng(3)
    C, L = 5, 13
    cdfs = quantize_pmf_rows(rng.uniform(size=(C, L)))
    offsets = np.full(C, -6, np.int32)
    sizes = np.full(C, L, np.int32)
    idx = rng.integers(0, C, 4000).astype(np.int32)
    sym = (rng.integers(0, L - 1, 4000) - 6).astype(np.int32)
    sym[::97] = 5000  # escapes
    data = backend.encode_indexed(sym, idx, cdfs, offsets, sizes)
    assert data == jbackend.encode_indexed(sym, idx, cdfs, offsets, sizes)
    np.testing.assert_array_equal(
        codec._decode_indexed_checked(data, idx, cdfs, offsets, sizes), sym)
    with pytest.raises(ValueError, match="corrupt or truncated"):
        codec._decode_indexed_checked(data[:-3], idx, cdfs, offsets, sizes)


def test_gaussian_coder_bytes_match_jax():
    rng = np.random.default_rng(4)
    n, K = 3000, 3
    mus = (rng.normal(size=(n, K)) * 3).astype(np.float32)
    sigmas = (np.abs(rng.normal(size=(n, K))) + 0.2).astype(np.float32)
    w = rng.uniform(size=(n, K)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    sym = np.round(mus[np.arange(n), rng.integers(0, K, n)]).astype(np.int32)
    data = backend.encode_gaussian(sym, mus, sigmas, w)
    assert data == jbackend.encode_gaussian(sym, mus, sigmas, w)
    dec = backend.RansDecoder(data)
    np.testing.assert_array_equal(dec.decode_gaussian(mus, sigmas, w), sym)
    dec.finish()


# --- host weights, tables, the wavefront coder against the JAX package ---------

def test_host_weights_match_jax(pair):
    K, _, params, model = pair
    got = codec._HostParamNets(model)
    want = jcodec._HostParamNets(params["context_model"], params["entropy_parameters"], M, K)
    assert got.ctx_w.shape == (12 * M, 2 * M)
    np.testing.assert_array_equal(got.ctx_w, want.ctx_w)
    np.testing.assert_array_equal(got.ctx_bias, want.ctx_bias)
    assert len(got.ep) == len(want.ep) == 3
    for (gw, gb), (ww, wb) in zip(got.ep, want.ep):
        assert gw.dtype == ww.dtype == np.float32
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(gb, wb)


def test_factorized_tables_match_jax(pair):
    K, jmodel, params, model = pair
    for zmin, zmax in ((-8, 8), (-2, 5), (0, 0), (-40, 40)):
        got = factorized_tables(model, zmin, zmax)
        want = jcdf.factorized_tables(jmodel, {"params": params}, zmin, zmax)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        cum_g, cum_w = got[0].astype(np.int64), want[0].astype(np.int64)
        assert np.abs(cum_g - cum_w).max() <= Z_TABLE_CUM_TOL
        freq_diff = np.abs(np.diff(cum_g, axis=1) - np.diff(cum_w, axis=1))
        assert freq_diff.max() <= Z_TABLE_FREQ_TOL
        assert (freq_diff > 0).mean() <= Z_TABLE_DIFFERING_SHARE
        assert (got[0][:, -1] == backend.PROB_SCALE).all()


def test_ar_coder_bytes_match_jax(pair):
    K, _, params, model = pair
    rng = np.random.default_rng(11 + K)
    h, w = 4, 8
    y_q = np.round(rng.normal(scale=2.0, size=(h, w, M))).astype(np.float32)
    psi = rng.normal(size=(h, w, 2 * M)).astype(np.float32)
    nets = codec._HostParamNets(model)
    data = codec._ar_encode_latents(nets, y_q, psi)
    jnets = jcodec._HostParamNets(params["context_model"], params["entropy_parameters"], M, K)
    assert data == jcodec._ar_encode_latents(jnets, y_q, psi)
    np.testing.assert_array_equal(codec._ar_decode_latents(nets, data, psi, h, w), y_q)


@pytest.mark.parametrize("n_streams", [2, 8])
def test_interleaved_coder_bytes_match_jax(pair, n_streams):
    K, _, params, model = pair
    rng = np.random.default_rng(21 + K + n_streams)
    h, w = 5, 7
    y_q = np.round(rng.normal(scale=2.0, size=(h, w, M))).astype(np.float32)
    psi = rng.normal(size=(h, w, 2 * M)).astype(np.float32)
    coder = codec._HostParamNets(model).native_coder()
    data = coder.encode_n(y_q, psi, n_streams)
    jnets = jcodec._HostParamNets(params["context_model"], params["entropy_parameters"], M, K)
    assert data == jnets.native_coder().encode_n(y_q, psi, n_streams)
    np.testing.assert_array_equal(coder.decode_n(data, psi, h, w, n_streams), y_q)
    # interleaving costs each stream a 4-byte length-table entry and a 4-byte
    # rANS state flush, the symbols nothing
    assert len(data) <= len(coder.encode(y_q, psi)) + 8 * n_streams


def test_param_sweep_checksum_matches_jax(pair):
    """arwave_param_sweep_time (the wavefront's parameter sweep alone, for
    profiling) returns the JAX binding's checksum on the same weights, y_q
    and psi; its arguments are checked like encode's."""
    K, _, params, model = pair
    rng = np.random.default_rng(31 + K)
    h, w = 6, 9
    y_q = np.round(rng.normal(scale=2.0, size=(h, w, M))).astype(np.float32)
    psi = rng.normal(size=(h, w, 2 * M)).astype(np.float32)
    coder = codec._HostParamNets(model).native_coder()
    got = backend.arwave_param_sweep_time(coder, y_q, psi)
    jnets = jcodec._HostParamNets(params["context_model"], params["entropy_parameters"], M, K)
    assert got == jbackend.arwave_param_sweep_time(jnets.native_coder(), y_q, psi)
    assert np.isfinite(got) and got != 0.0
    assert backend.arwave_param_sweep_time(coder, y_q + 1, psi) != got
    with pytest.raises(ValueError, match="psi"):
        backend.arwave_param_sweep_time(coder, y_q, psi[:, :-1])
    with pytest.raises(ValueError, match="y_q"):
        backend.arwave_param_sweep_time(coder, y_q[..., :-1], psi)


LAYOUTS = {"tiles2x2": dict(tiles=(2, 2)), "tiles1x3": dict(tiles=(1, 3)),
           "streams2": dict(n_streams=2), "streams8": dict(n_streams=8)}


def _jax_codec_with_tables(pair, cod, zmin, zmax):
    """The JAX codec on the pair's weights, given the port's z tables for
    [zmin, zmax] (the two packages' tables may differ by a count)."""
    _, jmodel, params, _ = pair
    jc = jcodec.JointARCodec(jmodel, {"params": params})
    jc._z_cache[(zmin, zmax)] = cod._z_tables(zmin, zmax)
    return jc


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_bytes_match_jax(pair, coded, layout):
    cod, x, _, _ = coded("70x100")
    img_h, img_w, y_q, z_q, psi = cod._analyse_image(x)
    kw = LAYOUTS[layout]
    data = cod._encode_from(y_q, z_q, psi, img_h, img_w, **kw)
    jc = _jax_codec_with_tables(pair, cod, int(z_q.min()), int(z_q.max()))
    assert data == jc._encode_from(y_q, z_q, psi, img_h, img_w, kw.get("tiles"),
                                   kw.get("n_streams", 1))
    assert data == cod.compress(x, **kw)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_layouts_round_trip(coded, shape, layout):
    cod, x, data, out = coded(shape)
    tiled = cod.compress(x, **LAYOUTS[layout])
    y_q, z_q = cod.decode_latents(tiled)
    np.testing.assert_array_equal(y_q, out["y_in"][0])
    np.testing.assert_array_equal(z_q, out["z_in"][0])
    np.testing.assert_array_equal(cod.decompress(tiled), cod.decompress(data))
    if "n_streams" in LAYOUTS[layout]:
        n = LAYOUTS[layout]["n_streams"]
        assert len(tiled) <= len(data) + 8 * n


def test_layout_limits_raise(coded):
    cod, x, _, _ = coded("64x128")
    for kw, match in ((dict(tiles=(2, 2), n_streams=2), "exclusive"),
                      (dict(n_streams=0), "1..255"), (dict(n_streams=256), "1..255"),
                      (dict(tiles=(128, 1)), "127 x 255"), (dict(tiles=(1, 256)), "127 x 255"),
                      (dict(tiles=(0, 1)), "127 x 255")):
        with pytest.raises(ValueError, match=match):
            cod.compress(x, **kw)


def _batch(n, seed):
    return np.random.default_rng(seed).uniform(size=(n, 64, 128, 3)).astype(np.float32)


@pytest.mark.parametrize("workers", [None, 2])
def test_compress_batch_matches_compress(pair, workers):
    cod = JointARCodec(pair[3])
    xs = _batch(3, seed=30)
    assert cod.compress_batch(xs, workers=workers) == [cod.compress(xs[b:b + 1])
                                                       for b in range(3)]


def test_decompress_batch_matches_decompress(pair):
    cod = JointARCodec(pair[3])
    xs = _batch(4, seed=31)
    datas = [cod.compress(xs[b:b + 1], n_streams=1 + 3 * (b % 2)) for b in range(4)]
    got = cod.decompress_batch(datas, workers=2)
    want = np.concatenate([cod.decompress(d) for d in datas])
    assert got.shape == want.shape == (4, 64, 128, 3)
    # one batched synthesis against four batch-1 ones: the CPU convolutions
    # sum in other orders (measured at most 3e-8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got8 = cod.decompress_batch(datas, as_uint8=True)
    want8 = np.concatenate([cod.decompress(d, as_uint8=True) for d in datas])
    assert got8.dtype == np.uint8 and np.abs(got8.astype(int) - want8.astype(int)).max() <= 1


def test_decompress_batch_rejects_tiled_and_mixed(coded):
    cod, x, data, _ = coded("64x128")
    with pytest.raises(ValueError, match="tiled streams with decompress"):
        cod.decompress_batch([data, cod.compress(x, tiles=(2, 2))])
    with pytest.raises(ValueError, match="one image size"):
        cod.decompress_batch([data, cod.compress(x[:, :, :100])])


# --- end to end ------------------------------------------------------------------

def _rounding_margin(v):
    f = np.abs(np.asarray(v, np.float64))
    return np.abs(f - np.floor(f) - 0.5)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_roundtrip_latents_match_forwards(pair, coded, shape):
    K, jmodel, params, _ = pair
    cod, x, data, out = coded(shape)
    y_dec, z_dec = cod.decode_latents(data)
    np.testing.assert_array_equal(y_dec, out["y_in"][0])
    np.testing.assert_array_equal(z_dec, out["z_in"][0])
    assert len(np.unique(y_dec)) >= 3 and len(np.unique(z_dec)) >= 3
    # the JAX forward, where each value's rounding margin clears the two
    # forwards' largest difference
    jout = jmodel.apply({"params": params}, jnp.asarray(codec._pad_input(x, 64)), training=False)
    for key, dec in (("y", y_dec), ("z", z_dec)):
        cont = np.asarray(jout[key])[0]
        clear = _rounding_margin(cont) > np.abs(out[key][0] - cont).max()
        assert clear.mean() > 0.99, clear.mean()
        np.testing.assert_array_equal(dec[clear], np.asarray(jout[key + "_in"])[0][clear])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_decompress_matches_forward_and_crops(coded, shape):
    cod, x, data, out = coded(shape)
    h, w = SHAPES[shape]
    assert stream_size(data) == (h, w)
    x_hat = cod.decompress(data)
    assert x_hat.shape == (1, h, w, 3) and x_hat.dtype == np.float32
    np.testing.assert_allclose(x_hat, np.clip(out["x_hat"], 0, 1)[:, :h, :w], atol=1e-5)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_stream_bits_track_analytic(coded, shape):
    cod, x, data, out = coded(shape)
    x_pad = torch.from_numpy(codec._pad_input(x, 64))
    analytic = float(rd_loss({k: torch.from_numpy(v) for k, v in out.items()}, x_pad,
                             0.005)["bits_total"])
    # header 26 bytes, two rANS state flushes and per-stream slack (as in
    # tests/test_codec.py)
    assert len(data) * 8 < analytic * 1.08 + 8 * 48, (len(data) * 8, analytic)
    h, w = SHAPES[shape]
    assert bitstream_bpp(data, h, w) == len(data) * 8 / (h * w)


def test_uint8_input_gives_float_latents(pair):
    K, _, _, model = pair
    cod = JointARCodec(model)
    x8 = (np.random.default_rng(5).uniform(size=(1, 70, 100, 3)) * 255).astype(np.uint8)
    data8 = cod.compress(x8)
    dataf = cod.compress(x8.astype(np.float32) / 255)
    for a, b in zip(cod.decode_latents(data8), cod.decode_latents(dataf)):
        np.testing.assert_array_equal(a, b)
    assert data8 == dataf


def test_uint8_output_within_one_level(coded):
    cod, _, data, _ = coded("70x100")
    x8 = cod.decompress(data, as_uint8=True)
    assert x8.dtype == np.uint8 and x8.shape == (1, 70, 100, 3)
    want = np.round(np.clip(cod.decompress(data), 0, 1) * 255)
    assert np.abs(x8.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_compress_latents_reproduces_the_stream(coded):
    cod, _, data, _ = coded("70x100")
    y_q, z_q = cod.decode_latents(data)
    assert cod.compress_latents(y_q, z_q, 70, 100) == data
    assert cod.compress_latents(y_q[None], z_q[None], 70, 100) == data


def test_int16_overflow_refetches_float32(pair, monkeypatch):
    _, _, _, model = pair
    x = _image("64x128")
    ref = JointARCodec(model).compress(x)
    cod = JointARCodec(model)
    real = cod._analysis_q
    monkeypatch.setattr(cod, "_analysis_q",
                        lambda xx: (torch.full_like(real(xx)[0], -32768), real(xx)[1]))
    assert cod.compress(x) == ref  # through the float32 analysis


def test_fetch_and_upload_helpers():
    ok = torch.tensor([[-32767, 5]], dtype=torch.int16)
    got = codec._fetch_y16(ok, lambda: pytest.fail("refetched"))
    assert got.dtype == np.float32 and got[0, 0] == -32767.0
    sentinel = np.zeros((2, 2), np.float32)
    assert codec._fetch_y16(torch.full((2, 2), -32768, dtype=torch.int16),
                            lambda: sentinel) is sentinel
    assert codec._latents_to_device(np.array([40000.0], np.float32), "cpu").dtype == torch.float32
    assert codec._latents_to_device(np.array([3.0, -7.0], np.float32), "cpu").dtype == torch.int16


# --- malformed and unsupported streams --------------------------------------------

def _with_header_field(data, index, value):
    fields = list(struct.unpack(codec._HEADER, data[:codec._HEADER_SIZE]))
    fields[index] = value
    return struct.pack(codec._HEADER, *fields) + data[codec._HEADER_SIZE:]


@pytest.mark.parametrize("case,match", [
    ("empty", "truncated"),
    ("header_only", "truncated"),
    ("cut_y", "truncated"),
    ("cut_z_and_y", "truncated"),
    ("trailing", "header says"),
    ("bad_magic", "not a NIC1"),
    ("interleaved_count_0", "stream count 0"),
    ("tiled_table_overrun", "length table"),
    ("portable_other_card", "different card"),
    ("factorized_kind", "kind 2"),
    ("zmin_above_zmax", "zmin"),
    ("empty_image", "image size"),
    ("y_corrupt", "corrupt or truncated"),
])
def test_malformed_streams_raise(pair, coded, case, match):
    cod, x, data, _ = coded("64x128")
    if case == "tiled_table_overrun":
        tiled = cod.compress(x, tiles=(2, 2))
        start = codec._HEADER_SIZE + codec._read_header(tiled)[9]
        (first,) = struct.unpack("<I", tiled[start:start + 4])
        data = tiled[:start] + struct.pack("<I", first + 1) + tiled[start + 4:]
    if case == "portable_other_card":
        data = cod.compress_portable(x)
        cod = JointARCodec(pair[3], portable_card=PortableCard.build(pair[3], -16, 16))
    bad = {
        "empty": lambda: b"",
        "header_only": lambda: data[:codec._HEADER_SIZE],
        "cut_y": lambda: data[:-5],
        "cut_z_and_y": lambda: data[:codec._HEADER_SIZE + 3],
        "trailing": lambda: data + b"\0",
        "bad_magic": lambda: b"NIC2" + data[4:],
        "interleaved_count_0": lambda: _with_header_field(data, 6, 0x8000),
        "tiled_table_overrun": lambda: data,
        "portable_other_card": lambda: data,
        "factorized_kind": lambda: _with_header_field(data, 1, 2),
        "zmin_above_zmax": lambda: _with_header_field(data, 7, 100),
        "empty_image": lambda: _with_header_field(data, 4, 0),
        # the header's lengths kept, the y payload's last bytes changed
        "y_corrupt": lambda: data[:-4] + bytes(4),
    }[case]()
    with pytest.raises(ValueError, match=match):
        cod.decode_latents(bad)


def test_other_model_streams_raise(pair, coded):
    K, _, _, _ = pair
    cod, _, data, _ = coded("64x128")
    other_k = JointARCodec(JointAutoregressiveHierarchical(M, 2 if K == 1 else 1, device="cpu"))
    with pytest.raises(ValueError, match=f"K={K}, M={M}"):
        other_k.decode_latents(data)
    other_m = JointARCodec(JointAutoregressiveHierarchical(8, K, device="cpu"))
    with pytest.raises(ValueError, match=f"K={K}, M={M}"):
        other_m.decompress(data)


def test_bad_latents_and_images_raise(coded):
    cod, _, data, _ = coded("64x128")
    y_q, z_q = cod.decode_latents(data)
    with pytest.raises(ValueError, match="integer-valued"):
        cod.compress_latents(y_q + 0.25, z_q, 64, 128)
    with pytest.raises(ValueError, match="integer-valued"):
        cod.compress_latents(y_q, np.where(z_q == 0, np.nan, z_q), 64, 128)
    with pytest.raises(ValueError, match="does not match"):
        cod.compress_latents(y_q, z_q, 128, 128)
    with pytest.raises(ValueError, match="one \\(1, H, W, 3\\) image"):
        cod.compress(np.zeros((2, 64, 64, 3), np.float32))


def test_coding_import_loads_no_jax():
    code = (
        "import sys\n"
        "import neural_image_compression_tpu_torch.coding\n"
        "import neural_image_compression_tpu_torch.coding.codec\n"
        "import neural_image_compression_tpu_torch.coding.portable\n"
        "import neural_image_compression_tpu_torch.coding.refine\n"
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
