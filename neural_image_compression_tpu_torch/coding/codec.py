"""Real bitstream codec for the joint autoregressive hierarchical model, port
of coding/codec.py's ``JointARCodec``.

  * z (hyper-latents): per-channel quantized CDF tables from the factorized
    bottleneck (``cdf_tables.factorized_tables``), one indexed rANS stream.
  * y (latents): coded under the per-symbol Gaussian (K=1) or Gaussian
    mixture that the hyper-synthesis psi and the masked 5x5 context
    predict, by the native wavefront codec (``csrc/rans/ar_wavefront.cc``):
    for the mask-A context, waves t = 3i + j are dependency-safe, so decode
    runs 3(h-1) + w waves of about w/3 pixels each. One stream, N streams
    interleaved symbol by symbol (``n_streams``: the exact context, each
    wave's streams decoded on threads), or independent tiles (``tiles``).
  * portable streams (kind 4): the integer path of ``coding.portable``, for
    streams that must decode on another machine or in the JAX package.

The analysis, hyper-synthesis and synthesis transforms run on the model's
device; the z tables' quantization, the rANS coder and the wavefront run on
the host, in C++. ``compress_batch`` / ``decompress_batch`` code images in
parallel host threads, with every device program on the calling thread.

Determinism contract: the coding parameters must be bit-identical at encode
and decode time. Both sides derive them in the same native host loop from
the same psi, and psi comes from one device program on the integer z, run
under fixed numerics (``utils.device.fixed_numerics``: deterministic cuDNN
algorithms, no TF32) and fetched as float16. The analysis and synthesis
results are the coded symbols and the reconstruction, not inputs to the
coder, so they run under the caller's settings. Float streams are
self-consistent per build and device: a stream of this package is not
expected to decode in the JAX package, or the reverse. Portable streams
are: with the same card, both packages write and read the same bytes.

Bitstream layout (version 1), the JAX package's:
  header ``<4sBBHHHHhhII``: magic 'NIC1', kind (1 float, 4 portable), K, M,
  H, W (the true image size), layout, zmin, zmax, len_z, len_y; for kind 4
  the card's 8-byte hash; then the z stream, then the y payload. Layout:
  (ta << 8) | tb for ta x tb tiles (1 x 1: one stream; more: a ``<nI``
  length table, then the tiles' streams in raster order), or 0x8000 | N
  for N interleaved streams.
"""

import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from neural_image_compression_tpu_torch.coding import backend
from neural_image_compression_tpu_torch.coding.cdf_tables import factorized_tables
from neural_image_compression_tpu_torch.coding.portable import (
    PortableCard, portable_ar_decode, portable_ar_encode,
)
from neural_image_compression_tpu_torch.data.datasets import pad_to_multiple
from neural_image_compression_tpu_torch.models.joint_ar import _nchw, _nhwc
from neural_image_compression_tpu_torch.ops.masked_conv import causal_positions
from neural_image_compression_tpu_torch.utils.device import fixed_numerics

_MAGIC = b"NIC1"
_HEADER = "<4sBBHHHHhhII"
_HEADER_SIZE = struct.calcsize(_HEADER)
_KIND_JOINT = 1
_KIND_JOINT_PORTABLE = 4
_LAYOUT_ONE_TILE = (1 << 8) | 1
_LAYOUT_INTERLEAVED = 0x8000
_CARD_HASH_SIZE = 8
# x16 analysis and x4 hyper-analysis downsampling
_MULTIPLE = 64
# psi crosses to the host in float16 (half the (h, w, 2M) download); encode
# and decode run the same program and upcast identically (exactly)
_PSI_FETCH = torch.float16

# Causal context of the 5x5 mask-A conv, derived from the model's own mask
# (raster order): the host weights below and the hard-coded gather offsets
# in csrc/rans/ar_wavefront.cc follow this order.
CTX_POSITIONS = tuple(causal_positions(5, "A"))
assert CTX_POSITIONS == tuple(
    [(r, c) for r in range(2) for c in range(5)] + [(2, 0), (2, 1)]), \
    "mask changed: the native coder's hard-coded gather offsets must follow"


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _pad_input(x, mult: int) -> np.ndarray:
    """Pad-code-crop: the image is edge-replicate-padded so H and W divide
    the model's downsampling, the latents of the padded grid are coded, the
    header records the true size and decompress crops back. uint8 stays
    uint8 (divided by 255 on the device); anything else becomes float32."""
    arr = np.asarray(x)
    if arr.dtype != np.uint8:
        arr = np.asarray(arr, np.float32)
    return pad_to_multiple(arr, mult)


def _analysis(model, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (1, H, W, 3) uint8 or float32 on the model's device -> (y, z_q):
    the encoder's unrounded latents in float32 and the rounded
    hyper-latents, NHWC. z derives from the unrounded y, as in the model's
    eval forward, so z_q equals its z_in."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    y = model.encoder(_nchw(x))
    z = model.hyper_encoder(y)
    return _nhwc(y).float(), torch.round(_nhwc(z).float())


def _fetch_y16(y16: torch.Tensor, refetch_f32) -> np.ndarray:
    """The analysis' int16 y latents on the host as float32, in one fetch.
    -32768 anywhere is the in-band overflow poison: some latent did not fit
    int16, so refetch through the float32 analysis (refetch_f32: () ->
    float32 array)."""
    arr = y16.cpu().numpy()
    if arr.size == 0 or int(arr.min()) != -32768:
        return arr.astype(np.float32)
    return refetch_f32()


def _psi_to_host(psi_dev: torch.Tensor) -> np.ndarray:
    """(1, h, w, 2M) float16 psi on the device -> (h, w, 2M) float32 on the
    host (the upcast is exact)."""
    return psi_dev.cpu().numpy()[0].astype(np.float32)


def _latents_to_device(y: np.ndarray, device) -> torch.Tensor:
    """Upload integer latents for synthesis: int16 where every value fits
    (half the float32 upload), float32 otherwise; synthesis casts to
    float32 first, so both give the same math."""
    if y.size and float(np.abs(y).max()) <= 32767.0:
        return torch.from_numpy(np.asarray(y, np.float32).astype(np.int16)).to(device)
    return torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(device)


def _as_latent_grids(y_q, z_q, img_h: int, img_w: int, M: int, mult: int = _MULTIPLE):
    """Validate caller-supplied integer latent grids: (h, w, M) or
    (1, h, w, M) matching the padded img_h x img_w geometry (x16 transform,
    x4 hyper), integer-valued (they are the coded symbols)."""
    ph, pw = _round_up(img_h, mult), _round_up(img_w, mult)

    def grid(a, shape, what):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
        a = np.asarray(a, np.float32)
        if a.ndim == 4:
            if a.shape[0] != 1:
                raise ValueError(f"{what}: one image at a time, got batch {a.shape[0]}")
            a = a[0]
        if a.shape != shape:
            raise ValueError(f"{what} shape {a.shape} does not match the padded "
                             f"{img_h}x{img_w} image's grid {shape}")
        backend._require_integral_latents(a)
        return a

    return (grid(y_q, (ph // 16, pw // 16, M), "y_q"),
            grid(z_q, (ph // 64, pw // 64, M), "z_q"))


def stream_size(data: bytes) -> Tuple[int, int]:
    """The true (unpadded) image size from a stream's header."""
    if len(data) < 12:
        raise ValueError(f"truncated stream: {len(data)} bytes, no header")
    _, _, _, _, img_h, img_w = struct.unpack("<4sBBHHH", data[:12])
    return img_h, img_w


def bitstream_bpp(data: bytes, img_h: int, img_w: int) -> float:
    return len(data) * 8.0 / (img_h * img_w)


class _HostParamNets:
    """The masked context conv and the entropy-parameter net in the native
    coder's layout, float32, from the model's parameters: ctx_w (12M, 2M)
    stacks the (M, 2M) input-by-output taps in ``CTX_POSITIONS`` order;
    each 1x1 layer is (in, out); for K > 1 the last layer's columns go from
    the model's (kind, k, m) order to (kind, m, k), so the mixture
    parameters come out (n, M, K)-contiguous."""

    def __init__(self, model):
        def host(t: torch.Tensor) -> np.ndarray:
            return t.detach().to("cpu", torch.float32).numpy()

        M, K = model.latent_channels, model.K
        ctx = model.context_model.MaskedConv2d_0
        kernel = host(ctx.weight)  # (2M, M, 5, 5)
        self.ctx_w = np.concatenate([kernel[:, :, r, c].T for (r, c) in CTX_POSITIONS], axis=0)
        self.ctx_bias = np.ascontiguousarray(host(ctx.bias))
        self.ep = []
        for name in ("Conv2d_0", "Conv2d_1", "Conv2d_2"):
            conv = getattr(model.entropy_parameters, name)
            self.ep.append((np.ascontiguousarray(host(conv.weight)[:, :, 0, 0].T),
                            np.ascontiguousarray(host(conv.bias))))
        self.M, self.K = M, K
        if K > 1:
            t_idx, k_idx, m_idx = np.meshgrid(np.arange(3), np.arange(K), np.arange(M),
                                              indexing="ij")
            src = t_idx * K * M + k_idx * M + m_idx           # (3, K, M)
            perm = src.transpose(0, 2, 1).reshape(-1)          # (3, M, K) order
            w3, b3 = self.ep[2]
            self.ep[2] = (np.ascontiguousarray(w3[:, perm]), np.ascontiguousarray(b3[perm]))
        self._native = None

    def native_coder(self) -> backend.ArWaveCoder:
        """The C++ wavefront codec over these weights (built at first use)."""
        if self._native is None:
            (w1, b1), (w2, b2), (w3, b3) = self.ep
            self._native = backend.ArWaveCoder(self.ctx_w, self.ctx_bias, w1, b1, w2, b2,
                                               w3, b3, self.M, self.K)
        return self._native


def _decode_indexed_checked(data: bytes, index, cdfs, offsets, sizes) -> np.ndarray:
    """One-shot indexed rANS decode that raises on a truncated or corrupt
    stream instead of returning wrong symbols."""
    dec = backend.RansDecoder(data)
    sym = dec.decode_indexed(index, cdfs, offsets, sizes)
    dec.finish()
    return sym


def _ar_encode_latents(nets: _HostParamNets, y_q: np.ndarray, psi: np.ndarray) -> bytes:
    """Encode one latent layer (h, w, M) under its masked-context AR model,
    given psi (h, w, 2M)."""
    return nets.native_coder().encode(y_q, psi)


def _ar_decode_latents(nets: _HostParamNets, data: bytes, psi: np.ndarray,
                       h: int, w: int) -> np.ndarray:
    """Wavefront-decode one latent layer; returns (h, w, M) float32."""
    return nets.native_coder().decode(data, psi, h, w)


def _read_header(data: bytes):
    """Parse and check a stream's header: kind 1 (float) or 4 (portable,
    one tile), the layout word, and a length that matches the header's
    (a portable stream carries its card's 8-byte hash after the header)."""
    if len(data) < _HEADER_SIZE:
        raise ValueError(f"truncated stream: {len(data)} bytes, header needs {_HEADER_SIZE}")
    header = struct.unpack(_HEADER, data[:_HEADER_SIZE])
    magic, kind, _, _, img_h, img_w, layout, zmin, zmax, len_z, len_y = header
    if magic != _MAGIC:
        raise ValueError(f"not a NIC1 stream (magic {magic!r})")
    if kind not in (_KIND_JOINT, _KIND_JOINT_PORTABLE):
        raise ValueError(f"stream kind {kind} is not a joint-AR stream (kind 1, or 4 portable)")
    if layout & _LAYOUT_INTERLEAVED and layout & 0xFF == 0:
        raise ValueError("corrupt header: interleaved stream count 0")
    if kind == _KIND_JOINT_PORTABLE and layout != _LAYOUT_ONE_TILE:
        raise ValueError(f"corrupt header: portable stream with layout {layout:#06x}")
    if img_h == 0 or img_w == 0:
        raise ValueError(f"corrupt header: image size {img_h}x{img_w}")
    if zmin > zmax:
        raise ValueError(f"corrupt header: zmin {zmin} > zmax {zmax}")
    expected = _body_start(header) + len_z + len_y
    if len(data) != expected:
        raise ValueError(f"stream is {len(data)} bytes, its header says {expected}"
                         + (" (truncated)" if len(data) < expected else ""))
    return header


def _body_start(header) -> int:
    """Offset of the z stream: after the header, and the card hash of a
    portable stream."""
    return _HEADER_SIZE + (_CARD_HASH_SIZE if header[1] == _KIND_JOINT_PORTABLE else 0)


def _check_layout(tiles, n_streams: int) -> None:
    if tiles is not None and n_streams != 1:
        raise ValueError("n_streams and tiles are exclusive")
    if not 1 <= n_streams <= 255:
        raise ValueError(f"n_streams must be in 1..255, got {n_streams}")
    # the layout word packs (ta << 8) | tb; bit 15 flags interleaved streams
    if tiles is not None and not (1 <= tiles[0] <= 127 and 1 <= tiles[1] <= 255):
        raise ValueError(f"tiles are limited to 127 x 255, got {tiles}")


def _tile_bounds(n: int, parts: int):
    edges = np.linspace(0, n, parts + 1).astype(int)
    return list(zip(edges[:-1], edges[1:]))


def _split_tiles(payload: bytes, n: int):
    """A tiled y payload's n streams: a ``<nI`` length table, then the
    streams back to back, which must fill the payload exactly."""
    if len(payload) < 4 * n:
        raise ValueError(f"corrupt tiled stream: {len(payload)} bytes hold no {n}-entry "
                         f"length table")
    lens = struct.unpack(f"<{n}I", payload[:4 * n])
    if 4 * n + sum(lens) != len(payload):
        raise ValueError(f"corrupt tiled stream: the length table covers {4 * n + sum(lens)} "
                         f"bytes of a {len(payload)}-byte payload")
    offs = np.cumsum([4 * n, *lens])
    return [payload[offs[i]:offs[i + 1]] for i in range(n)]


def _pool_size(jobs: int, workers=None) -> int:
    return workers or max(1, min(jobs, os.cpu_count() or 1))


class JointARCodec:
    """Real encode/decode for ``models.JointAutoregressiveHierarchical``. The
    device programs run where the model's parameters are (the card unless
    the model was built with ``device="cpu"``); the coders run on the host.
    portable_card: the ``portable.PortableCard`` for portable streams
    (built from the model at first use when none is given)."""

    def __init__(self, model, portable_card=None):
        self.model = model
        self.M, self.K = model.latent_channels, model.K
        self.device = next(model.parameters()).device
        self._host_nets = _HostParamNets(model)
        self._z_cache = {}
        self._portable_card = portable_card

    # -- device programs -------------------------------------------------
    def _analysis_q(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x on the device -> (y as int16, z_q float32). Legitimate values
        saturate to +-32767; if any |y| exceeded that, the whole y is
        -32768 (a value saturation never gives), so the host needs no
        separate check to know it must refetch in float32."""
        with torch.inference_mode():
            y_c, z_q = _analysis(self.model, x)
            y = torch.round(y_c)
            y16 = torch.clamp(y, -32767.0, 32767.0).to(torch.int16)
            y16 = torch.where(y.abs().amax() > 32767.0, torch.full_like(y16, -32768), y16)
        return y16, z_q

    def _analysis_f32(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Float32 y, for latents beyond int16 (run only after an overflow)."""
        with torch.inference_mode():
            y_c, z_q = _analysis(self.model, x)
            return torch.round(y_c), z_q

    def _psi_device(self, z_q) -> torch.Tensor:
        """Hyper-synthesis of integer z (1, hz, wz, M) -> psi (1, h, w, 2M)
        float16 on the device, under fixed numerics."""
        z = torch.as_tensor(z_q, dtype=torch.float32, device=self.device).contiguous()
        with torch.inference_mode(), fixed_numerics():
            return _nhwc(self.model.hyper_decoder(_nchw(z))).to(_PSI_FETCH)

    def _psi(self, z_q) -> np.ndarray:
        """psi (h, w, 2M) float32 on the host for z_q (1, hz, wz, M)."""
        return _psi_to_host(self._psi_device(z_q))

    def _synthesize(self, y_hat: np.ndarray, img_h: int, img_w: int,
                    as_uint8: bool = False) -> np.ndarray:
        """(B, h, w, M) integer latents -> (B, img_h, img_w, 3), clipped to
        [0, 1] (float32), or rounded to 0..255 on the device (uint8)."""
        y = _latents_to_device(y_hat, self.device)
        with torch.inference_mode():
            x_hat = _nhwc(self.model.decoder(_nchw(y.float()))).float()
            if as_uint8:
                x_u8 = torch.round(torch.clamp(x_hat, 0.0, 1.0) * 255.0).to(torch.uint8)
                return x_u8.cpu().numpy()[:, :img_h, :img_w]
            return np.clip(x_hat.cpu().numpy(), 0.0, 1.0)[:, :img_h, :img_w]

    def _z_tables(self, zmin: int, zmax: int):
        # encode and decode of every image use the same tables: build once
        key = (zmin, zmax)
        if key not in self._z_cache:
            self._z_cache[key] = factorized_tables(self.model, zmin, zmax)
        return self._z_cache[key]

    # -- encode ----------------------------------------------------------
    def _analyse_image(self, x):
        """The device half of compress: (img_h, img_w, y_q (h, w, M),
        z_q (hz, wz, M), psi (h, w, 2M)) on the host."""
        img_h, img_w, x_dev, y16, z_dev = self._analyse_device(x)
        # psi is enqueued on the device's z before any fetch: the integer z
        # values are the ones decode uploads, and the fetches overlap it
        psi_dev = self._psi_device(z_dev)
        y_q, z_q = self._fetch_latents(x_dev, y16, z_dev)
        return img_h, img_w, y_q, z_q, _psi_to_host(psi_dev)

    def _analyse_device(self, x):
        """Upload one padded image and enqueue the analysis: (img_h, img_w,
        x on the device, y16, z_q on the device)."""
        x = np.asarray(x)
        if x.ndim != 4 or x.shape[0] != 1 or x.shape[3] != 3:
            raise ValueError(f"x must be one (1, H, W, 3) image, got shape {x.shape}")
        x_dev = torch.from_numpy(np.ascontiguousarray(_pad_input(x, _MULTIPLE))).to(self.device)
        y16, z_dev = self._analysis_q(x_dev)
        return x.shape[1], x.shape[2], x_dev, y16, z_dev

    def _fetch_latents(self, x_dev, y16, z_dev):
        y_q = _fetch_y16(y16, lambda: self._analysis_f32(x_dev)[0].cpu().numpy())[0]
        return y_q, z_dev.cpu().numpy()[0]

    def compress(self, x, tiles=None, n_streams: int = 1) -> bytes:
        """x: (1, H, W, 3) float32 in [0, 1] or uint8, any size (padded to
        multiples of 64 here, cropped back by decompress). uint8 goes to the
        device as is and is divided by 255 there.

        n_streams=N (1..255): N-way interleaved rANS. Symbol s goes to stream
        s % N with the same entropy parameters and context, for at most 8
        more bytes a stream (its length-table entry and rANS flush), and
        decode pulls the N streams of each wave on N threads.

        tiles=(a, b) (at most 127 x 255): a x b independent AR tiles (the
        context resets at tile borders), each its own stream, decoded
        concurrently, with spatial random access; border pixels lose their
        causal context, so the rate grows. Exclusive with n_streams. For
        many images, compress_batch codes images in parallel at no rate
        cost."""
        _check_layout(tiles, n_streams)
        img_h, img_w, y_q, z_q, psi = self._analyse_image(x)
        return self._encode_from(y_q, z_q, psi, img_h, img_w, tiles, n_streams)

    def compress_latents(self, y_q, z_q, img_h: int, img_w: int, tiles=None,
                         n_streams: int = 1) -> bytes:
        """Encode given integer latent grids (numpy arrays or tensors, e.g.
        from ``coding.refine``) for an img_h x img_w image. The stream is
        compress()'s for the same latents: the coding parameters derive only
        from z_q (through the same psi program) and the coded y context."""
        _check_layout(tiles, n_streams)
        y_q, z_q = _as_latent_grids(y_q, z_q, img_h, img_w, self.M)
        return self._encode_from(y_q, z_q, self._psi(z_q[None]), img_h, img_w, tiles,
                                 n_streams)

    def _encode_z(self, z_q: np.ndarray, tables=None):
        """z_q (hz, wz, M) -> (zmin, zmax, bytes): one indexed rANS stream
        under the factorized tables for [zmin, zmax] (or the given ones)."""
        zmin, zmax = int(z_q.min()), int(z_q.max())
        cdfs, offsets, sizes = tables or self._z_tables(zmin, zmax)
        z_sym = z_q.reshape(-1).astype(np.int32)
        z_index = np.tile(np.arange(self.M, dtype=np.int32), z_sym.shape[0] // self.M)
        return zmin, zmax, backend.encode_indexed(z_sym, z_index, cdfs, offsets, sizes)

    def _encode_from(self, y_q: np.ndarray, z_q: np.ndarray, psi: np.ndarray,
                     img_h: int, img_w: int, tiles=None, n_streams: int = 1) -> bytes:
        """The host half of compress: the z stream, then the wavefront-
        ordered y stream (one, N interleaved, or one a tile). Calls no
        device program once the z tables for z_q's range are cached."""
        zmin, zmax, z_bytes = self._encode_z(z_q)
        if n_streams > 1:
            layout = _LAYOUT_INTERLEAVED | n_streams
            y_payload = self._host_nets.native_coder().encode_n(y_q, psi, n_streams)
        else:
            ta, tb = tiles or (1, 1)
            layout = (ta << 8) | tb
            h, w = y_q.shape[:2]
            streams = [_ar_encode_latents(self._host_nets, y_q[r0:r1, c0:c1], psi[r0:r1, c0:c1])
                       for r0, r1 in _tile_bounds(h, ta) for c0, c1 in _tile_bounds(w, tb)]
            y_payload = streams[0] if len(streams) == 1 else (
                struct.pack(f"<{len(streams)}I", *map(len, streams)) + b"".join(streams))
        header = struct.pack(_HEADER, _MAGIC, _KIND_JOINT, self.K, self.M, img_h, img_w,
                             layout, zmin, zmax, len(z_bytes), len(y_payload))
        return header + z_bytes + y_payload

    # -- portable streams ---------------------------------------------------
    def portable_card(self) -> PortableCard:
        """The card of this codec's portable streams (built from the model at
        first use). Save it with ``save`` and load it on the decoding
        machine: a card built there from the same weights need not be
        identical, because building one uses floats."""
        if self._portable_card is None:
            self._portable_card = PortableCard.build(self.model)
        return self._portable_card

    def compress_portable(self, x) -> bytes:
        """Encode one image on the integer path (``coding.portable``): the
        stream decodes bit-exactly on any machine and implementation that
        holds the same card. It costs the card's parameter quantization in
        rate."""
        img_h, img_w, x_dev, y16, z_dev = self._analyse_device(x)
        y_q, z_q = self._fetch_latents(x_dev, y16, z_dev)
        return self._encode_portable_from(y_q, z_q, img_h, img_w)

    def compress_latents_portable(self, y_q, z_q, img_h: int, img_w: int) -> bytes:
        """Encode given integer latent grids as a portable stream,
        compress_portable()'s for the same latents. z_q is clipped to the
        card's [zmin, zmax]: the clipped grid is what decode reconstructs."""
        card = self.portable_card()
        y_q, z_q = _as_latent_grids(y_q, z_q, img_h, img_w, self.M)
        return self._encode_portable_from(y_q, np.clip(z_q, card.zmin, card.zmax), img_h, img_w)

    def _encode_portable_from(self, y_q: np.ndarray, z_q: np.ndarray, img_h: int,
                              img_w: int) -> bytes:
        card = self.portable_card()
        _, _, z_bytes = self._encode_z(z_q, (card.z_cdfs, card.z_offsets, card.z_sizes))
        y_payload = portable_ar_encode(card, y_q, card.hyper_forward(z_q))
        header = struct.pack(_HEADER, _MAGIC, _KIND_JOINT_PORTABLE, self.K, self.M, img_h,
                             img_w, _LAYOUT_ONE_TILE, card.zmin, card.zmax, len(z_bytes),
                             len(y_payload))
        return header + card.hash + z_bytes + y_payload

    # -- decode ----------------------------------------------------------
    def _header(self, data: bytes):
        """The stream's header, checked against this codec's model (and a
        portable stream's hash against its card)."""
        header = _read_header(data)
        K, M = header[2], header[3]
        if (K, M) != (self.K, self.M):
            raise ValueError(f"stream is for K={K}, M={M}; this codec's model has "
                             f"K={self.K}, M={self.M}")
        if header[1] == _KIND_JOINT_PORTABLE and \
                data[_HEADER_SIZE:_HEADER_SIZE + _CARD_HASH_SIZE] != self.portable_card().hash:
            raise ValueError("portable stream was encoded with a different card — load the "
                             "encoder's card file (PortableCard.load) and pass it via "
                             "JointARCodec(portable_card=...)")
        return header

    def _decode_z(self, data: bytes, header) -> np.ndarray:
        """The host half of decode's first step: z_q (hz, wz, M) float32."""
        img_h, img_w, zmin, zmax, len_z = header[4], header[5], header[7], header[8], header[9]
        hz, wz = _round_up(img_h, _MULTIPLE) // 64, _round_up(img_w, _MULTIPLE) // 64
        if header[1] == _KIND_JOINT_PORTABLE:
            card = self.portable_card()
            cdfs, offsets, sizes = card.z_cdfs, card.z_offsets, card.z_sizes
        else:
            cdfs, offsets, sizes = self._z_tables(zmin, zmax)
        start = _body_start(header)
        z_index = np.tile(np.arange(self.M, dtype=np.int32), hz * wz)
        z_sym = _decode_indexed_checked(data[start:start + len_z], z_index, cdfs, offsets, sizes)
        return z_sym.reshape(hz, wz, self.M).astype(np.float32)

    def _decode_y(self, payload: bytes, psi: np.ndarray, h: int, w: int,
                  layout: int) -> np.ndarray:
        """A float stream's y payload -> (h, w, M) float32, by its layout:
        one stream, N interleaved ones, or independent tiles decoded
        concurrently (the native coder releases the GIL)."""
        coder = self._host_nets.native_coder()
        if layout & _LAYOUT_INTERLEAVED:
            return coder.decode_n(payload, psi, h, w, layout & 0xFF)
        ta, tb = max(1, layout >> 8), max(1, layout & 0xFF)
        if (ta, tb) == (1, 1):
            return coder.decode(payload, psi, h, w)
        bounds = [(r0, r1, c0, c1) for r0, r1 in _tile_bounds(h, ta)
                  for c0, c1 in _tile_bounds(w, tb)]
        tiles = _split_tiles(payload, len(bounds))

        def one(job):
            (r0, r1, c0, c1), tile = job
            return coder.decode(tile, np.ascontiguousarray(psi[r0:r1, c0:c1]), r1 - r0, c1 - c0)

        y_hat = np.empty((h, w, self.M), np.float32)
        with ThreadPoolExecutor(_pool_size(len(bounds))) as pool:
            for (r0, r1, c0, c1), block in zip(bounds, pool.map(one, zip(bounds, tiles))):
                y_hat[r0:r1, c0:c1] = block
        return y_hat

    def decode_latents(self, data: bytes) -> Tuple[np.ndarray, np.ndarray]:
        """(y_q (h, w, M), z_q (hz, wz, M)) float32 from a stream of any
        layout, float or portable."""
        header = self._header(data)
        img_h, img_w, layout, len_z = header[4], header[5], header[6], header[9]
        z_q = self._decode_z(data, header)
        h, w = _round_up(img_h, _MULTIPLE) // 16, _round_up(img_w, _MULTIPLE) // 16
        payload = data[_body_start(header) + len_z:]
        if header[1] == _KIND_JOINT_PORTABLE:
            card = self.portable_card()
            return portable_ar_decode(card, payload, card.hyper_forward(z_q), h, w), z_q
        return self._decode_y(payload, self._psi(z_q[None]), h, w, layout), z_q

    def decompress(self, data: bytes, as_uint8: bool = False) -> np.ndarray:
        """(1, H, W, 3) at the stream's true size: float32 clipped to
        [0, 1], or uint8 with as_uint8=True (clipped, scaled and rounded on
        the device, so only uint8 pixels cross to the host)."""
        y_hat, _ = self.decode_latents(data)
        img_h, img_w = stream_size(data)
        return self._synthesize(y_hat[None], img_h, img_w, as_uint8)

    # -- batches -----------------------------------------------------------
    def compress_batch(self, xs, workers=None) -> list:
        """B streams for xs (B, H, W, 3) (any size, padded here), each
        byte-identical to compress() of that image: every device program
        (analysis, psi, the z tables) runs batch-1 per image on the calling
        thread, as compress() runs it, and all of it finishes before the
        host coders run on ``workers`` threads (default: one per image, at
        most one per core). The device programs run there because
        ``utils.device.fixed_numerics`` flips process-wide flags."""
        xs = np.asarray(xs)
        if xs.ndim != 4 or xs.shape[3] != 3:
            raise ValueError(f"xs must be (B, H, W, 3) images, got shape {xs.shape}")
        analysed = [self._analyse_image(xs[b:b + 1]) for b in range(xs.shape[0])]
        for _, _, _, z_q, _ in analysed:  # the z tables are device programs too
            self._z_tables(int(z_q.min()), int(z_q.max()))
        self._host_nets.native_coder()

        def one(a):
            img_h, img_w, y_q, z_q, psi = a
            return self._encode_from(y_q, z_q, psi, img_h, img_w)

        with ThreadPoolExecutor(_pool_size(len(analysed), workers)) as pool:
            return list(pool.map(one, analysed))

    def decompress_batch(self, datas, workers=None, as_uint8: bool = False) -> np.ndarray:
        """(B, H, W, 3) from B float streams of one image size, untiled or
        interleaved: the z streams and psi (batch-1 per image, as decompress
        runs them) on the calling thread, the wavefronts on ``workers``
        threads, then one batched synthesis. Tiled and portable streams
        decode with decompress."""
        heads = [self._header(d) for d in datas]
        if not heads:
            raise ValueError("decompress_batch needs at least one stream")
        for head in heads:
            if head[1] != _KIND_JOINT:
                raise ValueError("decompress_batch decodes float (kind 1) streams; decode "
                                 "portable streams with decompress")
            if not head[6] & _LAYOUT_INTERLEAVED and head[6] != _LAYOUT_ONE_TILE:
                raise ValueError("decompress_batch decodes untiled and interleaved streams; "
                                 "decode tiled streams with decompress")
        img_h, img_w = heads[0][4], heads[0][5]
        if any((hd[4], hd[5]) != (img_h, img_w) for hd in heads):
            raise ValueError("decompress_batch needs streams of one image size")
        h, w = _round_up(img_h, _MULTIPLE) // 16, _round_up(img_w, _MULTIPLE) // 16
        psis = [self._psi(self._decode_z(d, hd)[None]) for d, hd in zip(datas, heads)]
        self._host_nets.native_coder()

        def one(b):
            hd = heads[b]
            payload = datas[b][_HEADER_SIZE + hd[9]:]
            return self._decode_y(payload, psis[b], h, w, hd[6])

        with ThreadPoolExecutor(_pool_size(len(datas), workers)) as pool:
            y_all = np.stack(list(pool.map(one, range(len(datas)))))
        return self._synthesize(y_all, img_h, img_w, as_uint8)
