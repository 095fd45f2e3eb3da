"""Real bitstream codecs of the model families, port of coding/codec.py's
``JointARCodec``, ``CheckerboardCodec``, ``MeanScaleHyperpriorCodec``,
``ChannelCheckerboardCodec``, ``FactorizedPriorCodec`` and
``ScalableCodec``.

  * z (hyper-latents), every family: per-channel quantized CDF tables from
    the factorized bottleneck (``cdf_tables.factorized_tables``), one
    indexed rANS stream.
  * y, scalable model (``ScalableCodec``): the base latents y1 and the
    enhancement latents y2 each as a joint-AR wavefront stream under their
    own context and entropy nets and the shared psi, one after the other;
    the enhancement stream can be cut off (``truncate_base``).
  * y (latents), joint-AR (``JointARCodec``): coded under the per-symbol
    Gaussian (K=1) or Gaussian mixture that the hyper-synthesis psi and the
    masked 5x5 context predict, by the native wavefront codec
    (``csrc/rans/ar_wavefront.cc``): for the mask-A context, waves
    t = 3i + j are dependency-safe, so decode runs 3(h-1) + w waves of about
    w/3 pixels each. One stream, N streams interleaved symbol by symbol
    (``n_streams``: the exact context, each wave's streams decoded on
    threads), or independent tiles (``tiles``).
  * y, checkerboard (``CheckerboardCodec``): two device passes give every
    entropy parameter (the anchors' from the hyperprior alone, then the
    non-anchors' from the context conv over the decoded anchors), and one
    rANS stream holds the anchors, then the non-anchors, each row-major,
    channel fastest.
  * y, hyperprior (``MeanScaleHyperpriorCodec``): one device pass gives
    every entropy parameter from z, and one rANS stream holds y row-major,
    channel fastest.
  * y, channel-conditional checkerboard (``ChannelCheckerboardCodec``): 2·G
    device passes, two a channel group (the group's anchors from psi and
    the channel context over the groups before it, then its non-anchors
    with the spatial context over its decoded anchors), and one rANS
    stream holds, group by group, the anchors, then the non-anchors, each
    row-major, channel fastest.
  * For these three parallel families, ``n_streams=N`` splits each block of
    symbols over N lanes (symbol s of a block to lane s % N): a partition,
    the entropy parameters unchanged, decoded on N threads.
  * y, factorized prior (``FactorizedPriorCodec``): no z and no device
    pass; one indexed rANS stream under the bottleneck's tables for y's
    range, as the z stream of the others.
  * portable streams (kinds 4, 5, 6, 8, 10, 12): the integer path of
    ``coding.portable``, for streams that must decode on another machine or
    in the JAX package.

The analysis, hyper-synthesis, parameter passes and synthesis run on the
model's device; the z tables' quantization, the rANS coder and the
wavefront run on the host, in C++. ``compress_batch`` /
``decompress_batch`` code images in parallel host threads, with every
device program on the calling thread.

Determinism contract: the coding parameters must be bit-identical at encode
and decode time. The joint-AR codec derives them in the same native host
loop from the same psi; the parallel families derive them on the device.
Either way every program that feeds the coder (psi, the parameter passes,
the z tables) runs batch-1, on a fresh contiguous float32 input built the
same way on both sides (z_q; the anchor-filled grid), under fixed numerics
(``utils.device.fixed_numerics``: deterministic cuDNN algorithms, no
autotuning, no TF32), and crosses to the host as float16 (exactly upcast).
The analysis and synthesis results are the coded symbols and the
reconstruction, not inputs to the coder, so they run under the caller's
settings. Float streams are self-consistent per build and device: a stream
of this package is not expected to decode in the JAX package, or the
reverse. Portable streams are: with the same card, both packages write and
read the same bytes.

Bitstream layout (version 1), the JAX package's:
  header ``<4sBBHHHHhhII``: magic 'NIC1', kind (1 joint-AR, 2 factorized,
  3 scalable, 7 checkerboard, 9 hyperprior, 11 channel-conditional
  checkerboard; 4, 5, 6, 8, 10 and 12 their portable streams), K, M, H, W
  (the true image size), layout, zmin, zmax, len_z, len_y; for a portable
  kind the card's 8-byte hash (the scalable stream's two cards': 16 bytes);
  then the z stream, then the y payload. The scalable stream puts M1 in
  the layout field and the base stream's length in len_y; the enhancement
  stream fills the rest. Layout, joint-AR:
  (ta << 8) | tb for ta x tb tiles (1 x 1: one stream, also of a portable
  stream; more: a ``<nI`` length table, then the tiles' streams in raster
  order), or 0x8000 | N for N interleaved streams. Checkerboard, hyperprior
  and channel-conditional checkerboard: 0 for one stream (also portable),
  or 0x8000 | N for N lanes (a ``<NI`` length table, then the lanes). The
  factorized prior writes K 1, layout 0, y's range in the z fields and
  len_z 0.
"""

import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from neural_image_compression_tpu_torch.coding import backend
from neural_image_compression_tpu_torch.coding.cdf_tables import factorized_tables
from neural_image_compression_tpu_torch.coding.portable import (
    FactorizedCard, PortableCard, build_channel_cb_cards, portable_ar_decode, portable_ar_encode,
    portable_cb_decode, portable_cb_encode, portable_ccb_decode, portable_ccb_encode,
    portable_hp_decode, portable_hp_encode,
)
from neural_image_compression_tpu_torch.data.datasets import pad_to_multiple
from neural_image_compression_tpu_torch.models.checkerboard import (
    CB_CTX_POSITIONS, checkerboard_mask,
)
from neural_image_compression_tpu_torch.models.joint_ar import _nchw, _nhwc
from neural_image_compression_tpu_torch.ops.masked_conv import causal_positions
from neural_image_compression_tpu_torch.utils.device import fixed_numerics

_MAGIC = b"NIC1"
_HEADER = "<4sBBHHHHhhII"
_HEADER_SIZE = struct.calcsize(_HEADER)
_KIND_JOINT = 1
_KIND_FACTORIZED = 2
_KIND_SCALABLE = 3
_KIND_JOINT_PORTABLE = 4
_KIND_FACTORIZED_PORTABLE = 5
_KIND_SCALABLE_PORTABLE = 6
_KIND_CHECKERBOARD = 7
_KIND_CHECKERBOARD_PORTABLE = 8
_KIND_HYPERPRIOR = 9
_KIND_HYPERPRIOR_PORTABLE = 10
_KIND_CHANNEL_CB = 11
_KIND_CHANNEL_CB_PORTABLE = 12
_PORTABLE_KINDS = (_KIND_JOINT_PORTABLE, _KIND_FACTORIZED_PORTABLE, _KIND_CHECKERBOARD_PORTABLE,
                   _KIND_HYPERPRIOR_PORTABLE, _KIND_CHANNEL_CB_PORTABLE)
_LAYOUT_ONE_TILE = (1 << 8) | 1
_LAYOUT_ONE_STREAM = 0  # the parallel families' single stream
_LAYOUT_INTERLEAVED = 0x8000
_CARD_HASH_SIZE = 8
# x16 analysis and x4 hyper-analysis downsampling (the factorized prior: x16)
_MULTIPLE = 64
# psi and the parallel families' entropy parameters cross to the host in
# float16 (half the download); encode and decode run the same program and
# upcast identically (exactly)
_PSI_FETCH = torch.float16
_PARAM_FETCH = torch.float16

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


def _analysis(model, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (1, H, W, 3) uint8 or float32 on the model's device -> (y, z_q):
    the encoder's unrounded latents in float32 and the rounded
    hyper-latents, NHWC (None for a model without a hyper-analysis, the
    factorized prior). z derives from the unrounded y, as in the model's
    eval forward, so z_q equals its z_in."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    y = model.encoder(_nchw(x))
    hyper_encoder = getattr(model, "hyper_encoder", None)
    z_q = None if hyper_encoder is None else torch.round(_nhwc(hyper_encoder(y)).float())
    return _nhwc(y).float(), z_q


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
    x4 hyper), integer-valued (they are the coded symbols). z_q None (the
    factorized prior's) passes through as None."""
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
            None if z_q is None else grid(z_q, (ph // 64, pw // 64, M), "z_q"))


def stream_size(data: bytes) -> Tuple[int, int]:
    """The true (unpadded) image size from a stream's header."""
    if len(data) < 12:
        raise ValueError(f"truncated stream: {len(data)} bytes, no header")
    _, _, _, _, img_h, img_w = struct.unpack("<4sBBHHH", data[:12])
    return img_h, img_w


def bitstream_bpp(data: bytes, img_h: int, img_w: int) -> float:
    return len(data) * 8.0 / (img_h * img_w)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


class _HostParamNets:
    """A family's context conv and entropy-parameter net in the native
    coders' layout, float32, from the model's parameters: ctx_w (12M, 2M)
    stacks the (M, 2M) input-by-output taps of the context's 12 live
    positions (``CTX_POSITIONS`` for the joint-AR wavefront,
    ``CB_CTX_POSITIONS`` for the checkerboard; empty (0, 0) for the
    context-free hyperprior); each 1x1 layer is (in, out); for K > 1 the
    last layer's columns go from the model's (kind, k, m) order to
    (kind, m, k), so the mixture parameters come out (n, M, K)-contiguous.
    The wavefront codec codes with these; the portable cards quantize them.
    ctx_name, ep_name and M pick the model's pair of nets and their latent
    width (the scalable model's ``context_model_1`` and
    ``entropy_parameters_1`` at M1, or its ``_2`` pair at M - M1).
    ``ep_only`` and ``context_taps`` build the parts from other modules (the
    channel-conditional model's per-group nets)."""

    def __init__(self, model, family: str = "wavefront", ctx_name: str = "context_model",
                 ep_name: str = "entropy_parameters", M: Optional[int] = None):
        if family == "hyperprior":
            self.ctx_w = np.zeros((0, 0), np.float32)
            self.ctx_bias = np.zeros((0,), np.float32)
        else:
            ctx_model = getattr(model, ctx_name)
            ctx, positions = ((ctx_model.MaskedConv2d_0, CTX_POSITIONS) if family == "wavefront"
                              else (ctx_model.Conv2d_0, CB_CTX_POSITIONS))
            self.ctx_w, self.ctx_bias = self.context_taps(ctx, positions)
        self._init_ep(getattr(model, ep_name), model.latent_channels if M is None else M,
                      model.K)

    @staticmethod
    def context_taps(conv, positions) -> Tuple[np.ndarray, np.ndarray]:
        """A 5x5 conv's (M -> 2M) live taps at ``positions`` stacked as
        (len(positions) * M, 2M), and its bias."""
        kernel = _host(conv.weight)  # (2M, M, 5, 5)
        return (np.concatenate([kernel[:, :, r, c].T for (r, c) in positions], axis=0),
                np.ascontiguousarray(_host(conv.bias)))

    @classmethod
    def ep_only(cls, entropy_parameters, M: int, K: int) -> "_HostParamNets":
        """The entropy-parameter net alone (no context: empty ctx_w), over
        M latent channels."""
        self = cls.__new__(cls)
        self.ctx_w = np.zeros((0, 0), np.float32)
        self.ctx_bias = np.zeros((0,), np.float32)
        self._init_ep(entropy_parameters, M, K)
        return self

    def _init_ep(self, entropy_parameters, M: int, K: int) -> None:
        self.ep = []
        for name in ("Conv2d_0", "Conv2d_1", "Conv2d_2"):
            conv = getattr(entropy_parameters, name)
            self.ep.append((np.ascontiguousarray(_host(conv.weight)[:, :, 0, 0].T),
                            np.ascontiguousarray(_host(conv.bias))))
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


def _read_header(data: bytes, kinds=(_KIND_JOINT, _KIND_JOINT_PORTABLE), name: str = "joint-AR"):
    """Parse and check a stream's header: its kind (one of ``kinds``: the
    family's float and portable kinds), the layout word's stream count, the
    image size, z's range and a length that matches the header's (a portable
    stream carries its card's 8-byte hash after the header)."""
    if len(data) < _HEADER_SIZE:
        raise ValueError(f"truncated stream: {len(data)} bytes, header needs {_HEADER_SIZE}")
    header = struct.unpack(_HEADER, data[:_HEADER_SIZE])
    magic, kind, _, _, img_h, img_w, layout, zmin, zmax, len_z, len_y = header
    if magic != _MAGIC:
        raise ValueError(f"not a NIC1 stream (magic {magic!r})")
    if kind not in kinds:
        raise ValueError(f"stream kind {kind} is not a {name} stream (kind {kinds[0]}, or "
                         f"{kinds[1]} portable)")
    if layout & _LAYOUT_INTERLEAVED and layout & 0xFF == 0:
        raise ValueError("corrupt header: interleaved stream count 0")
    if img_h == 0 or img_w == 0:
        raise ValueError(f"corrupt header: image size {img_h}x{img_w}")
    if zmin > zmax:
        raise ValueError(f"corrupt header: zmin {zmin} > zmax {zmax}")
    expected = _body_start(header) + len_z + len_y
    if len(data) != expected:
        raise ValueError(f"stream is {len(data)} bytes, its header says {expected}"
                         + (" (truncated)" if len(data) < expected else ""))
    return header


def _check_card_hash(data: bytes, card, codec_name: str) -> None:
    if data[_HEADER_SIZE:_HEADER_SIZE + _CARD_HASH_SIZE] != card.hash:
        raise ValueError(f"portable stream was encoded with a different card — load the "
                         f"encoder's card file ({type(card).__name__}.load) and pass it via "
                         f"{codec_name}(portable_card=...)")


def _body_start(header) -> int:
    """Offset of the z stream: after the header, and the card hash of a
    portable stream."""
    return _HEADER_SIZE + (_CARD_HASH_SIZE if header[1] in _PORTABLE_KINDS else 0)


def _check_layout(tiles, n_streams: int) -> None:
    if tiles is not None and n_streams != 1:
        raise ValueError("n_streams and tiles are exclusive")
    backend._check_streams(n_streams)
    # the layout word packs (ta << 8) | tb; bit 15 flags interleaved streams
    if tiles is not None and not (1 <= tiles[0] <= 127 and 1 <= tiles[1] <= 255):
        raise ValueError(f"tiles are limited to 127 x 255, got {tiles}")


def _tile_bounds(n: int, parts: int):
    edges = np.linspace(0, n, parts + 1).astype(int)
    return list(zip(edges[:-1], edges[1:]))


def _split_streams(payload: bytes, n: int, what: str = "tiled"):
    """A y payload's n streams (tiles or lanes): a ``<nI`` length table,
    then the streams back to back, which must fill the payload exactly."""
    if len(payload) < 4 * n:
        raise ValueError(f"corrupt {what} stream: {len(payload)} bytes hold no {n}-entry "
                         f"length table")
    lens = struct.unpack(f"<{n}I", payload[:4 * n])
    if 4 * n + sum(lens) != len(payload):
        raise ValueError(f"corrupt {what} stream: the length table covers {4 * n + sum(lens)} "
                         f"bytes of a {len(payload)}-byte payload")
    offs = np.cumsum([4 * n, *lens])
    return [payload[offs[i]:offs[i + 1]] for i in range(n)]


def _pool_size(jobs: int, workers=None) -> int:
    return workers or max(1, min(jobs, os.cpu_count() or 1))


def _pool_map(fn, jobs, workers=None) -> list:
    """fn over jobs on host threads (the native coders release the GIL)."""
    jobs = list(jobs)
    if _pool_size(len(jobs), workers) == 1:
        return [fn(j) for j in jobs]
    with ThreadPoolExecutor(_pool_size(len(jobs), workers)) as pool:
        return list(pool.map(fn, jobs))


def _fresh_f32(a, device) -> torch.Tensor:
    """A new contiguous float32 tensor on the device holding ``a`` (a numpy
    array or a tensor on any device). The programs that feed the coder
    take their inputs through this on both sides, so encode and decode
    give them one memory layout (a view with other strides could select
    another cuDNN algorithm)."""
    src = torch.as_tensor(a)
    out = torch.empty(tuple(src.shape), dtype=torch.float32, device=device)
    return out.copy_(src)


class _DeviceCodec:
    """What every codec shares: the model's device, the analysis and
    synthesis programs and the padding (``MULTIPLE``: the model's
    downsampling, to which compress pads an image)."""

    MULTIPLE = _MULTIPLE

    def __init__(self, model, portable_card=None):
        if hasattr(model, "levels"):  # the codec calls the transforms, which skip the gains
            raise TypeError(f"{type(model).__name__} is a variable-rate model: code its "
                            f"fixed-rate fold at a level (models.folded_model, fold_gains)")
        self.model = model
        self.M = model.latent_channels
        self.device = next(model.parameters()).device
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

    def _analyse_device(self, x):
        """Upload one padded image and enqueue the analysis: (img_h, img_w,
        x on the device, y16, z_q on the device or None)."""
        x = np.asarray(x)
        if x.ndim != 4 or x.shape[0] != 1 or x.shape[3] != 3:
            raise ValueError(f"x must be one (1, H, W, 3) image, got shape {x.shape}")
        x_dev = torch.from_numpy(np.ascontiguousarray(_pad_input(x, self.MULTIPLE))).to(
            self.device)
        y16, z_dev = self._analysis_q(x_dev)
        return x.shape[1], x.shape[2], x_dev, y16, z_dev

    def _fetch_latents(self, x_dev, y16, z_dev):
        y_q = _fetch_y16(y16, lambda: self._analysis_f32(x_dev)[0].cpu().numpy())[0]
        return y_q, None if z_dev is None else z_dev.cpu().numpy()[0]


class _Codec(_DeviceCodec):
    """What the hierarchical families' codecs share beyond the transforms:
    the z stream and its tables, the header and the portable streams. A
    family sets its kinds, its name, the layout word of its portable
    streams, its card's coder functions, and ``decode_latents``'s float half
    (``_decode_float``)."""

    KINDS: Tuple[int, int]
    NAME: str
    PORTABLE_LAYOUT: int

    def __init__(self, model, portable_card=None):
        super().__init__(model, portable_card)
        self.K = model.K
        self._z_cache = {}

    def _z_tables(self, zmin: int, zmax: int):
        # encode and decode of every image use the same tables: build once
        key = (zmin, zmax)
        if key not in self._z_cache:
            self._z_cache[key] = factorized_tables(self.model, zmin, zmax)
        return self._z_cache[key]

    # -- the z stream and the header -----------------------------------------
    def _encode_z(self, z_q: np.ndarray, tables=None):
        """z_q (hz, wz, M) -> (zmin, zmax, bytes): one indexed rANS stream
        under the factorized tables for [zmin, zmax] (or the given ones)."""
        zmin, zmax = int(z_q.min()), int(z_q.max())
        cdfs, offsets, sizes = tables or self._z_tables(zmin, zmax)
        z_sym = z_q.reshape(-1).astype(np.int32)
        z_index = np.tile(np.arange(self.M, dtype=np.int32), z_sym.shape[0] // self.M)
        return zmin, zmax, backend.encode_indexed(z_sym, z_index, cdfs, offsets, sizes)

    def _pack(self, kind: int, img_h: int, img_w: int, layout: int, zmin: int, zmax: int,
              z_bytes: bytes, y_payload: bytes, card_hash: bytes = b"") -> bytes:
        return struct.pack(_HEADER, _MAGIC, kind, self.K, self.M, img_h, img_w, layout, zmin,
                           zmax, len(z_bytes), len(y_payload)) + card_hash + z_bytes + y_payload

    def _header(self, data: bytes):
        """The stream's header, checked against this codec's family and
        model (and a portable stream's hash against its card)."""
        header = _read_header(data, self.KINDS, self.NAME)
        K, M = header[2], header[3]
        if (K, M) != (self.K, self.M):
            raise ValueError(f"stream is for K={K}, M={M}; this codec's model has "
                             f"K={self.K}, M={self.M}")
        self._check_layout_word(header[1], header[6])
        if header[1] == self.KINDS[1]:
            _check_card_hash(data, self.portable_card(), type(self).__name__)
        return header

    def _check_layout_word(self, kind: int, layout: int) -> None:
        if kind == self.KINDS[1] and layout != self.PORTABLE_LAYOUT:
            raise ValueError(f"corrupt header: portable stream with layout {layout:#06x}")

    def _decode_z(self, data: bytes, header) -> np.ndarray:
        """The host half of decode's first step: z_q (hz, wz, M) float32."""
        img_h, img_w, zmin, zmax, len_z = header[4], header[5], header[7], header[8], header[9]
        hz, wz = _round_up(img_h, _MULTIPLE) // 64, _round_up(img_w, _MULTIPLE) // 64
        if header[1] == self.KINDS[1]:
            card = self.portable_card()
            cdfs, offsets, sizes = card.z_cdfs, card.z_offsets, card.z_sizes
        else:
            cdfs, offsets, sizes = self._z_tables(zmin, zmax)
        start = _body_start(header)
        z_index = np.tile(np.arange(self.M, dtype=np.int32), hz * wz)
        z_sym = _decode_indexed_checked(data[start:start + len_z], z_index, cdfs, offsets, sizes)
        return z_sym.reshape(hz, wz, self.M).astype(np.float32)

    def _payload(self, data: bytes, header) -> bytes:
        return data[_body_start(header) + header[9]:]

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
        y_payload = self._portable_encode(card, y_q, card.hyper_forward(z_q))
        return self._pack(self.KINDS[1], img_h, img_w, self.PORTABLE_LAYOUT, card.zmin,
                          card.zmax, z_bytes, y_payload, card.hash)

    # -- decode ----------------------------------------------------------
    def decode_latents(self, data: bytes) -> Tuple[np.ndarray, np.ndarray]:
        """(y_q (h, w, M), z_q (hz, wz, M)) float32 from a stream of any
        layout, float or portable."""
        header = self._header(data)
        img_h, img_w = header[4], header[5]
        z_q = self._decode_z(data, header)
        h, w = _round_up(img_h, _MULTIPLE) // 16, _round_up(img_w, _MULTIPLE) // 16
        payload = self._payload(data, header)
        if header[1] == self.KINDS[1]:
            card = self.portable_card()
            return self._portable_decode(card, payload, card.hyper_forward(z_q), h, w), z_q
        return self._decode_float(payload, header, z_q, h, w), z_q

    def decompress(self, data: bytes, as_uint8: bool = False) -> np.ndarray:
        """(1, H, W, 3) at the stream's true size: float32 clipped to
        [0, 1], or uint8 with as_uint8=True (clipped, scaled and rounded on
        the device, so only uint8 pixels cross to the host)."""
        y_hat, _ = self.decode_latents(data)
        img_h, img_w = stream_size(data)
        return self._synthesize(y_hat[None], img_h, img_w, as_uint8)

    def _batch_headers(self, datas):
        """The checked headers of B float streams of one image size."""
        heads = [self._header(d) for d in datas]
        if not heads:
            raise ValueError("decompress_batch needs at least one stream")
        img_h, img_w = heads[0][4], heads[0][5]
        if any((hd[4], hd[5]) != (img_h, img_w) for hd in heads):
            raise ValueError("decompress_batch needs streams of one image size")
        return heads


class JointARCodec(_Codec):
    """Real encode/decode for ``models.JointAutoregressiveHierarchical``. The
    device programs run where the model's parameters are (the card unless
    the model was built with ``device="cpu"``); the coders run on the host.
    portable_card: the ``portable.PortableCard`` for portable streams
    (built from the model at first use when none is given)."""

    KINDS = (_KIND_JOINT, _KIND_JOINT_PORTABLE)
    NAME = "joint-AR"
    PORTABLE_LAYOUT = _LAYOUT_ONE_TILE
    _portable_encode = staticmethod(portable_ar_encode)
    _portable_decode = staticmethod(portable_ar_decode)

    def __init__(self, model, portable_card=None):
        super().__init__(model, portable_card)
        self._host_nets = _HostParamNets(model)

    # -- device programs -------------------------------------------------
    def _psi_device(self, z_q) -> torch.Tensor:
        """Hyper-synthesis of integer z (1, hz, wz, M) -> psi (1, h, w, 2M)
        float16 on the device, under fixed numerics."""
        z = _fresh_f32(z_q, self.device)
        with torch.inference_mode(), fixed_numerics():
            return _nhwc(self.model.hyper_decoder(_nchw(z))).to(_PSI_FETCH)

    def _psi(self, z_q) -> np.ndarray:
        """psi (h, w, 2M) float32 on the host for z_q (1, hz, wz, M)."""
        return _psi_to_host(self._psi_device(z_q))

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
        return self._pack(_KIND_JOINT, img_h, img_w, layout, zmin, zmax, z_bytes, y_payload)

    # -- decode ----------------------------------------------------------
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
        tiles = _split_streams(payload, len(bounds))

        def one(job):
            (r0, r1, c0, c1), tile = job
            return coder.decode(tile, np.ascontiguousarray(psi[r0:r1, c0:c1]), r1 - r0, c1 - c0)

        y_hat = np.empty((h, w, self.M), np.float32)
        for (r0, r1, c0, c1), block in zip(bounds, _pool_map(one, zip(bounds, tiles))):
            y_hat[r0:r1, c0:c1] = block
        return y_hat

    def _decode_float(self, payload: bytes, header, z_q: np.ndarray, h: int, w: int):
        return self._decode_y(payload, self._psi(z_q[None]), h, w, header[6])

    # -- batches -----------------------------------------------------------
    def compress_batch(self, xs, workers=None) -> list:
        """B streams for xs (B, H, W, 3) (any size, padded here), each
        byte-identical to compress() of that image: every device program
        (analysis, psi, the z tables) runs batch-1 per image on the calling
        thread, as compress() runs it, and all of it finishes before the
        host coders run on ``workers`` threads (default: one per image, at
        most one per core). The device programs run there because
        ``utils.device.fixed_numerics`` flips process-wide flags."""
        xs = _image_batch(xs)
        analysed = [self._analyse_image(xs[b:b + 1]) for b in range(xs.shape[0])]
        for _, _, _, z_q, _ in analysed:  # the z tables are device programs too
            self._z_tables(int(z_q.min()), int(z_q.max()))
        self._host_nets.native_coder()

        def one(a):
            img_h, img_w, y_q, z_q, psi = a
            return self._encode_from(y_q, z_q, psi, img_h, img_w)

        return _pool_map(one, analysed, workers)

    def decompress_batch(self, datas, workers=None, as_uint8: bool = False) -> np.ndarray:
        """(B, H, W, 3) from B float streams of one image size, untiled or
        interleaved: the z streams and psi (batch-1 per image, as decompress
        runs them) on the calling thread, the wavefronts on ``workers``
        threads, then one batched synthesis. Tiled and portable streams
        decode with decompress."""
        heads = self._batch_headers(datas)
        for head in heads:
            if head[1] != _KIND_JOINT:
                raise ValueError("decompress_batch decodes float (kind 1) streams; decode "
                                 "portable streams with decompress")
            if not head[6] & _LAYOUT_INTERLEAVED and head[6] != _LAYOUT_ONE_TILE:
                raise ValueError("decompress_batch decodes untiled and interleaved streams; "
                                 "decode tiled streams with decompress")
        img_h, img_w = heads[0][4], heads[0][5]
        h, w = _round_up(img_h, _MULTIPLE) // 16, _round_up(img_w, _MULTIPLE) // 16
        psis = [self._psi(self._decode_z(d, hd)[None]) for d, hd in zip(datas, heads)]
        self._host_nets.native_coder()

        def one(b):
            hd = heads[b]
            return self._decode_y(self._payload(datas[b], hd), psis[b], h, w, hd[6])

        y_all = np.stack(_pool_map(one, range(len(datas)), workers))
        return self._synthesize(y_all, img_h, img_w, as_uint8)


class ScalableCodec(_Codec):
    """Layered bitstream for ``models.ScalableImageCoding``: header | z |
    y1 (the base layer) | y2 (the enhancement layer). Each layer codes with
    the wavefront AR coder under its own context and entropy nets and the
    shared psi; the two layers encode and decode on two host threads.
    ``truncate_base`` drops y2: the base stream alone decodes to y1 and the
    LatentSpaceTransform's F_tilde (``decompress_base``), the input of a
    vision head; the full stream decodes to the image. Kind 3 (float, the
    parameters from the device's psi as ``JointARCodec``'s) and kind 6
    (portable: one ``PortableCard`` a layer, both hashes after the header).
    The header's layout field holds M1, len_y the base stream's length.
    portable_cards: the (base, enhancement) card pair (built from the model
    at first use when None; ``portable.save_scalable_cards`` /
    ``load_scalable_cards`` carry it). Devices as ``JointARCodec``'s."""

    KINDS = (_KIND_SCALABLE, _KIND_SCALABLE_PORTABLE)
    NAME = "scalable"

    def __init__(self, model, portable_cards=None):
        super().__init__(model)
        self.M1 = model.base_channels
        self.M2 = self.M - self.M1
        self._nets1 = _HostParamNets(model, "wavefront", "context_model_1",
                                     "entropy_parameters_1", self.M1)
        self._nets2 = _HostParamNets(model, "wavefront", "context_model_2",
                                     "entropy_parameters_2", self.M2)
        self._portable_cards = portable_cards

    # the joint-AR codec's device programs: the analysis and psi, one hyper-decoder
    _psi_device = JointARCodec._psi_device
    _psi = JointARCodec._psi
    _analyse_image = JointARCodec._analyse_image

    def portable_cards(self) -> Tuple[PortableCard, PortableCard]:
        """The (base, enhancement) cards of this codec's portable streams,
        built from the model at first use (see ``JointARCodec.portable_card``)."""
        if self._portable_cards is None:
            self._portable_cards = tuple(
                PortableCard.build(self.model, ctx_name=f"context_model_{i}",
                                   ep_name=f"entropy_parameters_{i}", M=m)
                for i, m in ((1, self.M1), (2, self.M2)))
        return self._portable_cards

    def _pack_layers(self, kind: int, img_h: int, img_w: int, zmin: int, zmax: int,
                     z_bytes: bytes, y1_bytes: bytes, y2_bytes: bytes,
                     hashes: bytes = b"") -> bytes:
        return struct.pack(_HEADER, _MAGIC, kind, self.K, self.M, img_h, img_w, self.M1, zmin,
                           zmax, len(z_bytes), len(y1_bytes)) + hashes + z_bytes + y1_bytes + y2_bytes

    # -- encode ----------------------------------------------------------
    def compress(self, x) -> bytes:
        """x: (1, H, W, 3) float32 in [0, 1] or uint8, any size (padded to
        multiples of 64 here, cropped back by decompress)."""
        img_h, img_w, y_q, z_q, psi = self._analyse_image(x)
        return self._encode_from(y_q, z_q, psi, img_h, img_w)

    def compress_latents(self, y_q, z_q, img_h: int, img_w: int) -> bytes:
        """Encode given integer latent grids (e.g. from ``coding.refine``'s
        scalable mode): compress()'s stream for the same latents, which
        truncates the same way."""
        y_q, z_q = _as_latent_grids(y_q, z_q, img_h, img_w, self.M)
        return self._encode_from(y_q, z_q, self._psi(z_q[None]), img_h, img_w)

    def _encode_from(self, y_q: np.ndarray, z_q: np.ndarray, psi: np.ndarray,
                     img_h: int, img_w: int) -> bytes:
        zmin, zmax, z_bytes = self._encode_z(z_q)
        with ThreadPoolExecutor(2) as pool:
            y1 = pool.submit(_ar_encode_latents, self._nets1,
                             np.ascontiguousarray(y_q[..., :self.M1]), psi)
            y2 = pool.submit(_ar_encode_latents, self._nets2,
                             np.ascontiguousarray(y_q[..., self.M1:]), psi)
            y1_bytes, y2_bytes = y1.result(), y2.result()
        return self._pack_layers(_KIND_SCALABLE, img_h, img_w, zmin, zmax, z_bytes, y1_bytes,
                                 y2_bytes)

    def compress_portable(self, x) -> bytes:
        """A portable layered stream (kind 6) of one image; truncate_base
        applies to it too."""
        img_h, img_w, x_dev, y16, z_dev = self._analyse_device(x)
        y_q, z_q = self._fetch_latents(x_dev, y16, z_dev)
        return self._encode_portable_from(y_q, z_q, img_h, img_w)

    def compress_latents_portable(self, y_q, z_q, img_h: int, img_w: int) -> bytes:
        """Given integer latent grids as a portable layered stream; z_q is
        clipped to the cards' [zmin, zmax]."""
        card1, _ = self.portable_cards()
        y_q, z_q = _as_latent_grids(y_q, z_q, img_h, img_w, self.M)
        return self._encode_portable_from(y_q, np.clip(z_q, card1.zmin, card1.zmax), img_h,
                                          img_w)

    def _encode_portable_from(self, y_q: np.ndarray, z_q: np.ndarray, img_h: int,
                              img_w: int) -> bytes:
        card1, card2 = self.portable_cards()
        _, _, z_bytes = self._encode_z(z_q, (card1.z_cdfs, card1.z_offsets, card1.z_sizes))
        psi_fix = card1.hyper_forward(z_q)  # card2's hyper-decoder is the same
        y1_bytes = portable_ar_encode(card1, np.ascontiguousarray(y_q[..., :self.M1]), psi_fix)
        y2_bytes = portable_ar_encode(card2, np.ascontiguousarray(y_q[..., self.M1:]), psi_fix)
        return self._pack_layers(_KIND_SCALABLE_PORTABLE, img_h, img_w, card1.zmin, card1.zmax,
                                 z_bytes, y1_bytes, y2_bytes, card1.hash + card2.hash)

    def truncate_base(self, data: bytes) -> bytes:
        """The stream without its enhancement layer: decompress_base reads
        it; decompress raises."""
        header, start = self._layered_header(data, check_cards=False)
        return data[:start + header[9] + header[10]]

    # -- decode ----------------------------------------------------------
    def _layered_header(self, data: bytes, check_cards: bool = True):
        """(header, offset of the z stream), checked: the kind, this codec's
        K, M and M1, the image size, z's range, a portable stream's card
        hashes (with check_cards), and a length that holds at least z and
        the base layer."""
        if len(data) < _HEADER_SIZE:
            raise ValueError(f"truncated stream: {len(data)} bytes, header needs {_HEADER_SIZE}")
        header = struct.unpack(_HEADER, data[:_HEADER_SIZE])
        magic, kind, K, M, img_h, img_w, M1, zmin, zmax, len_z, len_y1 = header
        if magic != _MAGIC:
            raise ValueError(f"not a NIC1 stream (magic {magic!r})")
        if kind not in self.KINDS:
            raise ValueError(f"stream kind {kind} is not a scalable stream (kind "
                             f"{self.KINDS[0]}, or {self.KINDS[1]} portable)")
        if (K, M, M1) != (self.K, self.M, self.M1):
            raise ValueError(f"stream is for K={K}, M={M}, M1={M1}; this codec's model has "
                             f"K={self.K}, M={self.M}, M1={self.M1}")
        if img_h == 0 or img_w == 0:
            raise ValueError(f"corrupt header: image size {img_h}x{img_w}")
        if zmin > zmax:
            raise ValueError(f"corrupt header: zmin {zmin} > zmax {zmax}")
        start = _HEADER_SIZE
        if kind == _KIND_SCALABLE_PORTABLE and check_cards:
            card1, card2 = self.portable_cards()
            if data[start:start + 2 * _CARD_HASH_SIZE] != card1.hash + card2.hash:
                raise ValueError("portable stream was encoded with different cards — load the "
                                 "encoder's card file (portable.load_scalable_cards) and pass "
                                 "it via ScalableCodec(portable_cards=...)")
        if kind == _KIND_SCALABLE_PORTABLE:
            start += 2 * _CARD_HASH_SIZE
        if len(data) < start + len_z + len_y1:
            raise ValueError(f"stream is {len(data)} bytes, its header says at least "
                             f"{start + len_z + len_y1} (truncated)")
        return header, start

    def _decode_common(self, data: bytes):
        """(y1 bytes, y2 bytes, psi, z_q, h, w, portable)."""
        header, start = self._layered_header(data)
        kind, img_h, img_w, zmin, zmax, len_z, len_y1 = (header[1], header[4], header[5],
                                                         header[7], header[8], header[9],
                                                         header[10])
        portable = kind == _KIND_SCALABLE_PORTABLE
        ph, pw = _round_up(img_h, _MULTIPLE), _round_up(img_w, _MULTIPLE)
        if portable:
            card = self.portable_cards()[0]
            tables = (card.z_cdfs, card.z_offsets, card.z_sizes)
        else:
            tables = self._z_tables(zmin, zmax)
        hz, wz = ph // 64, pw // 64
        z_index = np.tile(np.arange(self.M, dtype=np.int32), hz * wz)
        z_q = _decode_indexed_checked(data[start:start + len_z], z_index, *tables).reshape(
            hz, wz, self.M).astype(np.float32)
        psi = card.hyper_forward(z_q) if portable else self._psi(z_q[None])
        body = start + len_z
        return (data[body:body + len_y1], data[body + len_y1:], psi, z_q, ph // 16, pw // 16,
                portable)

    def _decode_layer(self, layer: int, payload: bytes, psi, h: int, w: int,
                      portable: bool) -> np.ndarray:
        if portable:
            return portable_ar_decode(self.portable_cards()[layer - 1], payload, psi, h, w)
        return _ar_decode_latents(self._nets1 if layer == 1 else self._nets2, payload, psi, h, w)

    def decode_latents(self, data: bytes) -> Tuple[np.ndarray, np.ndarray]:
        """(y_q (h, w, M), z_q (hz, wz, M)) float32 of a full stream, float or
        portable: both layers decoded on two host threads."""
        y1_bytes, y2_bytes, psi, z_q, h, w, portable = self._decode_common(data)
        if not y2_bytes:
            raise ValueError("enhancement stream missing (truncated bitstream); use "
                             "decompress_base")
        return self._decode_layers(y1_bytes, y2_bytes, psi, h, w, portable), z_q

    def _decode_layers(self, y1_bytes: bytes, y2_bytes: bytes, psi, h: int, w: int,
                       portable: bool) -> np.ndarray:
        """Both layers' wavefronts on two host threads: y (h, w, M) float32."""
        with ThreadPoolExecutor(2) as pool:
            jobs = [pool.submit(self._decode_layer, layer, payload, psi, h, w, portable)
                    for layer, payload in ((1, y1_bytes), (2, y2_bytes))]
            y1, y2 = (job.result() for job in jobs)
        return np.concatenate([y1, y2], axis=-1).astype(np.float32)

    def decompress(self, data: bytes, as_uint8: bool = False) -> np.ndarray:
        """The full stream's image, (1, H, W, 3) at its true size (float32
        in [0, 1], or uint8 with as_uint8). A base-only stream raises."""
        y_hat, _ = self.decode_latents(data)
        img_h, img_w = stream_size(data)
        return self._synthesize(y_hat[None], img_h, img_w, as_uint8)

    def decompress_base(self, data: bytes) -> Tuple[np.ndarray, np.ndarray]:
        """Base-layer decode of a full or truncated stream: (y1 (h, w, M1)
        float32, F_tilde (1, 2h, 2w, 2 M1) float32 for the default LST), both
        over the padded latent grid when the image size is not a multiple of
        64 (``stream_size`` gives the true size)."""
        y1_bytes, _, psi, _, h, w, portable = self._decode_common(data)
        y1 = self._decode_layer(1, y1_bytes, psi, h, w, portable).astype(np.float32)
        return y1, self._lst(y1)

    def _lst(self, y1: np.ndarray) -> np.ndarray:
        """The LatentSpaceTransform of integer base latents (h, w, M1) on the
        device: F_tilde (1, ...) float32 on the host."""
        y_dev = _latents_to_device(y1[None], self.device)
        with torch.inference_mode():
            return _nhwc(self.model.LST(_nchw(y_dev.float()))).float().cpu().numpy()


def _image_batch(xs) -> np.ndarray:
    xs = np.asarray(xs)
    if xs.ndim != 4 or xs.shape[3] != 3:
        raise ValueError(f"xs must be (B, H, W, 3) images, got shape {xs.shape}")
    return xs


# --- the parallel-decode families ---------------------------------------------------

def _coder_rows(params, K: int, index=None) -> Tuple[torch.Tensor, ...]:
    """Entropy parameters (1, h, w, [K,] M) float32 on the device -> the
    coder's rows, float16 on the device, in (mus, sigmas, weights) order
    (weights None at K=1): (n*M,) at K=1, (n*M, K) at K>1 (each symbol's K
    components contiguous). index: the flat positions to keep (a pass's
    half of the grid), in order; every position when None."""
    def rows(p):
        flat = p.reshape((-1,) + tuple(p.shape[3:]))
        if index is not None:
            flat = flat.index_select(0, index)
        if K == 1:
            return flat.reshape(-1).to(_PARAM_FETCH)
        return flat.transpose(1, 2).reshape(-1, K).to(_PARAM_FETCH)

    if K == 1:
        mu, sigma = params
        return rows(mu), rows(sigma), None
    weights, mus, sigmas = params
    return rows(mus), rows(sigmas), rows(weights)


def _rows_to_host(rows) -> Tuple[np.ndarray, ...]:
    """Fetch coder rows (the float16 upcast to float32 is exact)."""
    return tuple(None if r is None else r.cpu().numpy().astype(np.float32) for r in rows)


def _passes_to_host(passes) -> Tuple[np.ndarray, ...]:
    """Several passes' coder rows (each ``_coder_rows``'s triple, in stream
    order) concatenated on the device and fetched once a kind."""
    return _rows_to_host(None if rows[0] is None else torch.cat(rows)
                         for rows in zip(*passes))


def _encode_lanes(sym, mus, sigmas, weights, bounds, n: int, workers=None) -> bytes:
    """N-way lanes over a symbol sequence of blocks (block j: symbols
    bounds[j] to bounds[j + 1]): within each block, symbol s goes to lane
    s % N, so a block's decode needs each lane's slice of that block only.
    Payload: N uint32 lane lengths, then the lanes."""
    def one(i):
        pick = np.concatenate([np.arange(b0 + i, b1, n)
                               for b0, b1 in zip(bounds[:-1], bounds[1:])])
        return backend.encode_gaussian(sym[pick], mus[pick], sigmas[pick],
                                       None if weights is None else weights[pick])

    lanes = _pool_map(one, range(n), workers or min(n, os.cpu_count() or 1))
    return struct.pack(f"<{n}I", *map(len, lanes)) + b"".join(lanes)


def _open_lanes(payload: bytes, layout: int) -> list:
    """One RansDecoder a lane of a y payload (one stream: one lane)."""
    if layout & _LAYOUT_INTERLEAVED:
        return [backend.RansDecoder(s)
                for s in _split_streams(payload, layout & 0xFF, "interleaved")]
    return [backend.RansDecoder(payload)]


def _decode_block_lanes(decs, mus, sigmas, weights, workers=None) -> np.ndarray:
    """One block's symbols across the lanes: lane i holds symbols i, i+N, ...
    of the block; the lanes decode concurrently."""
    n = len(decs)
    out = np.empty(mus.shape[0], np.int32)

    def one(i):
        out[i::n] = decs[i].decode_gaussian(mus[i::n], sigmas[i::n],
                                            None if weights is None else weights[i::n])

    _pool_map(one, range(n), workers or min(n, os.cpu_count() or 1))
    return out


def _finish(decs) -> None:
    for dec in decs:
        dec.finish()  # a truncated or corrupt stream raises, not wrong symbols


class _ParallelCodec(_Codec):
    """The codec of a family whose entropy parameters come from device
    passes (hyperprior: one; checkerboard: two; channel-conditional
    checkerboard: two a group). A family sets ``_enqueue(z_dev)`` (the
    passes that need z alone, enqueued before the latents' fetch),
    ``_coder_args(y_q, pending)`` (the rest of the passes and the fetch:
    the symbols in stream order, their rows, and the bounds of the blocks
    that decode pass by pass) and ``_decode_ys``."""

    PORTABLE_LAYOUT = _LAYOUT_ONE_STREAM

    def __init__(self, model, portable_card=None):
        super().__init__(model, portable_card)
        self._plans = {}

    def _plan(self, h: int, w: int):
        """(anchor mask, anchor and non-anchor flat positions on the device)
        of an h x w grid."""
        if (h, w) not in self._plans:
            am = checkerboard_mask(h, w)
            self._plans[h, w] = (am,) + tuple(
                torch.from_numpy(np.flatnonzero(m.ravel())).to(self.device) for m in (am, ~am))
        return self._plans[h, w]

    def _check_layout_word(self, kind: int, layout: int) -> None:
        super()._check_layout_word(kind, layout)
        if not layout & _LAYOUT_INTERLEAVED and layout != _LAYOUT_ONE_STREAM:
            raise ValueError(f"corrupt header: {self.NAME} stream with layout {layout:#06x}")

    # -- encode ----------------------------------------------------------
    def compress(self, x, n_streams: int = 1) -> bytes:
        """x: (1, H, W, 3) float32 in [0, 1] or uint8, any size (padded to
        multiples of 64 here, cropped back by decompress).

        n_streams=N (1..255): N lanes, a partition of each block of symbols
        with the entropy parameters unchanged, for at most 8 more bytes a
        lane (its length-table entry and rANS flush); decode pulls the lanes
        on N threads."""
        backend._check_streams(n_streams)
        img_h, img_w, x_dev, y16, z_dev = self._analyse_device(x)
        # the passes that need z alone are enqueued before any fetch
        pending = self._enqueue(z_dev)
        y_q, z_q = self._fetch_latents(x_dev, y16, z_dev)
        return self._write(z_q, self._coder_args(y_q, pending), img_h, img_w, n_streams)

    def compress_latents(self, y_q, z_q, img_h: int, img_w: int, n_streams: int = 1) -> bytes:
        """Encode given integer latent grids (numpy arrays or tensors, e.g.
        from ``coding.refine``) for an img_h x img_w image: compress()'s
        stream for the same latents (the entropy parameters derive from z_q
        and the coded latents through the same passes)."""
        backend._check_streams(n_streams)
        y_q, z_q = _as_latent_grids(y_q, z_q, img_h, img_w, self.M)
        pending = self._enqueue(z_q[None])
        return self._write(z_q, self._coder_args(y_q, pending), img_h, img_w, n_streams)

    def _write(self, z_q: np.ndarray, args, img_h: int, img_w: int, n_streams: int,
               lane_workers=None) -> bytes:
        """The host half: the z stream, the y stream or lanes, the header."""
        sym, mus, sigmas, weights, bounds = args
        zmin, zmax, z_bytes = self._encode_z(z_q)
        if n_streams == 1:
            layout = _LAYOUT_ONE_STREAM
            y_payload = backend.encode_gaussian(sym, mus, sigmas, weights)
        else:
            layout = _LAYOUT_INTERLEAVED | n_streams
            y_payload = _encode_lanes(sym, mus, sigmas, weights, bounds, n_streams, lane_workers)
        return self._pack(self.KINDS[0], img_h, img_w, layout, zmin, zmax, z_bytes, y_payload)

    def compress_batch(self, xs, workers=None, n_streams: int = 1) -> list:
        """B streams for xs (B, H, W, 3) (any size, padded here), each
        byte-identical to compress() of that image: every device program
        (analysis, the parameter passes, the z tables) runs batch-1 per image
        on the calling thread, as compress() runs it (a batched program need
        not give batch-1's bits), then the host coders run on ``workers``
        threads (default: one per image, at most one per core), each image's
        lanes on its own thread."""
        backend._check_streams(n_streams)
        xs = _image_batch(xs)
        jobs = []
        for b in range(xs.shape[0]):
            img_h, img_w, x_dev, y16, z_dev = self._analyse_device(xs[b:b + 1])
            pending = self._enqueue(z_dev)
            y_q, z_q = self._fetch_latents(x_dev, y16, z_dev)
            self._z_tables(int(z_q.min()), int(z_q.max()))  # a device program too
            jobs.append((z_q, self._coder_args(y_q, pending), img_h, img_w))

        def one(job):
            z_q, args, img_h, img_w = job
            return self._write(z_q, args, img_h, img_w, n_streams, lane_workers=1)

        return _pool_map(one, jobs, workers)

    # -- decode ----------------------------------------------------------
    def _decode_float(self, payload: bytes, header, z_q: np.ndarray, h: int, w: int):
        return self._decode_ys([(payload, header[6], z_q)], h, w)[0]

    def decompress_batch(self, datas, workers=None, as_uint8: bool = False) -> np.ndarray:
        """(B, H, W, 3) from B streams of one image size: the z streams and
        the parameter passes (batch-1 per image, as decompress runs them) on
        the calling thread, the rANS decodes on ``workers`` threads (one an
        image), then one batched synthesis. Portable streams decode one by
        one with decompress."""
        heads = self._batch_headers(datas)
        img_h, img_w = heads[0][4], heads[0][5]
        if any(hd[1] == self.KINDS[1] for hd in heads):
            return np.concatenate([self.decompress(d, as_uint8) for d in datas])
        h, w = _round_up(img_h, _MULTIPLE) // 16, _round_up(img_w, _MULTIPLE) // 16
        jobs = [(self._payload(d, hd), hd[6], self._decode_z(d, hd)) for d, hd in zip(datas, heads)]
        y_all = np.stack(self._decode_ys(jobs, h, w, workers, lane_workers=1))
        return self._synthesize(y_all, img_h, img_w, as_uint8)


class MeanScaleHyperpriorCodec(_ParallelCodec):
    """Real encode/decode for ``models.MeanScaleHyperprior``: one device
    pass (the hyper-decoder and the entropy-parameter net on z_q) gives
    every entropy parameter, then one rANS call codes the whole grid (or N
    lanes). Devices and the portable card as ``JointARCodec``'s."""

    KINDS = (_KIND_HYPERPRIOR, _KIND_HYPERPRIOR_PORTABLE)
    NAME = "hyperprior"
    _portable_encode = staticmethod(portable_hp_encode)
    _portable_decode = staticmethod(portable_hp_decode)

    def _params_device(self, z_q):
        """The coder's rows (float16, on the device) for z_q (1, hz, wz, M):
        the one pass, batch-1, on a fresh float32 z under fixed numerics."""
        z = _fresh_f32(z_q, self.device)
        with torch.inference_mode(), fixed_numerics():
            return _coder_rows(self.model.entropy_params_from_hyper(z), self.K)

    _enqueue = _params_device

    def _coder_args(self, y_q: np.ndarray, pending):
        sym = y_q.astype(np.int32).reshape(-1)  # row-major, channel fastest
        return (sym,) + _rows_to_host(pending) + ([0, sym.shape[0]],)

    def _decode_ys(self, jobs, h: int, w: int, workers=None, lane_workers=None) -> list:
        """(h, w, M) float32 latents of each (payload, layout, z_q) job: the
        passes on the calling thread, the rANS decodes on ``workers``
        threads."""
        rows = [_rows_to_host(self._params_device(z_q[None])) for _, _, z_q in jobs]

        def one(b):
            payload, layout, _ = jobs[b]
            decs = _open_lanes(payload, layout)
            vals = _decode_block_lanes(decs, *rows[b], lane_workers)
            _finish(decs)
            return vals.reshape(h, w, self.M).astype(np.float32)

        return _pool_map(one, range(len(jobs)), workers)


class CheckerboardCodec(_ParallelCodec):
    """Real encode/decode for ``models.CheckerboardHierarchical``: two device
    passes give every entropy parameter (``anchor_pass`` on z_q, psi kept
    on the device; ``nonanchor_pass`` over the anchor-filled grid), and one
    rANS stream (or N lanes) holds the anchors, then the non-anchors.
    Devices and the portable card as ``JointARCodec``'s."""

    KINDS = (_KIND_CHECKERBOARD, _KIND_CHECKERBOARD_PORTABLE)
    NAME = "checkerboard"
    _portable_encode = staticmethod(portable_cb_encode)
    _portable_decode = staticmethod(portable_cb_decode)

    def _anchor_device(self, z_q):
        """Pass 1 for z_q (1, hz, wz, M): (psi on the device, the anchors'
        coder rows, float16 on the device)."""
        z = _fresh_f32(z_q, self.device)
        with torch.inference_mode(), fixed_numerics():
            psi, *params = self.model.anchor_pass(z)
            return psi, _coder_rows(params, self.K, self._plan(psi.shape[1], psi.shape[2])[1])

    _enqueue = _anchor_device

    def _nonanchor_device(self, psi: torch.Tensor, y_anchor: np.ndarray):
        """Pass 2: the non-anchors' coder rows (float16, on the device) from
        psi and y_anchor (h, w, M), the anchors' values with zeros at the
        non-anchors, uploaded as a fresh float32 grid."""
        y = _fresh_f32(y_anchor[None], self.device)
        with torch.inference_mode(), fixed_numerics():
            params = self.model.nonanchor_pass(psi, y)
            return _coder_rows(params, self.K, self._plan(*y_anchor.shape[:2])[2])

    def _coder_args(self, y_q: np.ndarray, pending):
        psi, rows_a = pending
        am = self._plan(*y_q.shape[:2])[0]
        rows_n = self._nonanchor_device(psi, np.where(am[..., None], y_q, 0.0).astype(np.float32))
        sym = np.concatenate([y_q[am], y_q[~am]]).astype(np.int32).reshape(-1)
        return (sym,) + _passes_to_host([rows_a, rows_n]) + (
            [0, int(am.sum()) * self.M, sym.shape[0]],)

    def _decode_ys(self, jobs, h: int, w: int, workers=None, lane_workers=None) -> list:
        """(h, w, M) float32 latents of each (payload, layout, z_q) job:
        every pass 1, then the anchors' decodes on ``workers`` threads, every
        pass 2, then the non-anchors' decodes."""
        am = self._plan(h, w)[0]
        n = len(jobs)
        firsts = [self._anchor_device(z_q[None]) for _, _, z_q in jobs]
        rows_a = [_rows_to_host(rows) for _, rows in firsts]
        decs = [_open_lanes(payload, layout) for payload, layout, _ in jobs]
        y_hats = [np.zeros((h, w, self.M), np.float32) for _ in range(n)]

        def anchors(b):
            y_hats[b][am] = _decode_block_lanes(decs[b], *rows_a[b], lane_workers).reshape(
                -1, self.M)

        _pool_map(anchors, range(n), workers)
        rows_n = [_rows_to_host(self._nonanchor_device(firsts[b][0], y_hats[b]))
                  for b in range(n)]

        def nonanchors(b):
            vals = _decode_block_lanes(decs[b], *rows_n[b], lane_workers)
            _finish(decs[b])
            y_hats[b][~am] = vals.reshape(-1, self.M)

        _pool_map(nonanchors, range(n), workers)
        return y_hats


def _anchor_grid(am: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(1, h, w, c): y (h, w, c) at the anchors of mask am, zeros elsewhere."""
    return np.where(am[..., None], y, 0.0)[None]


class ChannelCheckerboardCodec(_ParallelCodec):
    """Real encode/decode for ``models.ChannelCheckerboardHierarchical``:
    2·G device passes, two a channel group, give every entropy parameter.
    Group i's anchor pass runs its channel context over the groups before it
    (decoded everywhere) and keeps it on the device for the group's
    non-anchor pass, which adds the spatial context over the group's
    decoded anchors. One rANS stream (or N lanes) holds the 2·G blocks: per
    group, its anchors, then its non-anchors, each row-major, channel
    fastest. Groups chain: group i's passes need groups < i decoded.

    Every pass runs batch-1 on fresh float32 inputs built the same way at
    encode and at decode (z_q; the previous groups' grid; the group's
    anchor-filled grid), under fixed numerics, so the float parameters are
    bit-identical on both sides. Portable streams (kind 12) use a
    ``portable.ChannelCBCards`` set, one checkerboard card a group.
    Devices as ``JointARCodec``'s."""

    KINDS = (_KIND_CHANNEL_CB, _KIND_CHANNEL_CB_PORTABLE)
    NAME = "channel_cb"
    _portable_encode = staticmethod(portable_ccb_encode)
    _portable_decode = staticmethod(portable_ccb_decode)

    def __init__(self, model, portable_card=None):
        super().__init__(model, portable_card)
        self.groups = tuple(model.group_sizes)

    def portable_card(self):
        """The ``portable.ChannelCBCards`` set of this codec's portable
        streams (built from the model at first use; see
        ``JointARCodec.portable_card``)."""
        if self._portable_card is None:
            self._portable_card = build_channel_cb_cards(self.model)
        if tuple(self._portable_card.groups) != self.groups:
            raise ValueError(f"portable card set is for groups "
                             f"{tuple(self._portable_card.groups)}, the codec's model has "
                             f"{self.groups}")
        return self._portable_card

    # -- the 2·G passes ------------------------------------------------------
    def _psi_device(self, z_q) -> torch.Tensor:
        """psi (1, h, w, 2M) on the device for z_q (1, hz, wz, M): the
        hyper-decoder on a fresh float32 z under fixed numerics."""
        z = _fresh_f32(z_q, self.device)
        with torch.inference_mode(), fixed_numerics():
            return self.model.hyper_features(z)

    _enqueue = _psi_device

    def _anchor_device(self, i: int, psi: torch.Tensor, y_prev):
        """Group i's anchor pass: (its channel context on the device, None
        for group 0; the anchors' coder rows, float16 on the device).
        y_prev (1, h, w, sum(groups[:i])): the groups before it."""
        y = None if i == 0 else _fresh_f32(y_prev, self.device)
        with torch.inference_mode(), fixed_numerics():
            ch = self.model.group_channel_ctx(i, y)
            params = self.model.group_params(i, psi, ch, None)
            return ch, _coder_rows(params, self.K, self._plan(psi.shape[1], psi.shape[2])[1])

    def _nonanchor_device(self, i: int, psi: torch.Tensor, ch, y_anchor):
        """Group i's non-anchor pass: the non-anchors' coder rows (float16,
        on the device) from psi, the group's channel context and y_anchor
        (1, h, w, g), its anchors with zeros at the non-anchors."""
        y = _fresh_f32(y_anchor, self.device)
        with torch.inference_mode(), fixed_numerics():
            params = self.model.group_params(i, psi, ch, y)
            return _coder_rows(params, self.K, self._plan(psi.shape[1], psi.shape[2])[2])

    def _coder_args(self, y_q: np.ndarray, psi):
        """Every pass on the exact latents (at encode the decoded groups are
        y_q itself), all enqueued before one fetch: the symbols and rows in
        stream order and the 2·G blocks' bounds."""
        am = self._plan(*y_q.shape[:2])[0]
        passes, syms, bounds = [], [], [0]
        off = 0
        for i, gi in enumerate(self.groups):
            y_g = y_q[..., off:off + gi]
            ch, rows_a = self._anchor_device(i, psi, y_q[None, ..., :off])
            passes += [rows_a, self._nonanchor_device(i, psi, ch, _anchor_grid(am, y_g))]
            for sel in (am, ~am):
                syms.append(y_g[sel].astype(np.int32).reshape(-1))
                bounds.append(bounds[-1] + syms[-1].size)
            off += gi
        return (np.concatenate(syms),) + _passes_to_host(passes) + (bounds,)

    def _decode_ys(self, jobs, h: int, w: int, workers=None, lane_workers=None) -> list:
        """(h, w, M) float32 latents of each (payload, layout, z_q) job,
        group by group: every image's anchor pass, then the anchors' decodes
        on ``workers`` threads, every image's non-anchor pass, then the
        non-anchors' decodes."""
        am = self._plan(h, w)[0]
        n = len(jobs)
        psis = [self._psi_device(z_q[None]) for _, _, z_q in jobs]
        decs = [_open_lanes(payload, layout) for payload, layout, _ in jobs]
        y_hats = [np.zeros((h, w, self.M), np.float32) for _ in range(n)]
        off = 0
        for i, gi in enumerate(self.groups):
            firsts = [self._anchor_device(i, psis[b], y_hats[b][None, ..., :off])
                      for b in range(n)]
            rows = [_rows_to_host(r) for _, r in firsts]

            def anchors(b):
                vals = _decode_block_lanes(decs[b], *rows[b], lane_workers)
                y_hats[b][am, off:off + gi] = vals.reshape(-1, gi)

            _pool_map(anchors, range(n), workers)
            rows = [_rows_to_host(self._nonanchor_device(
                i, psis[b], firsts[b][0], _anchor_grid(am, y_hats[b][..., off:off + gi])))
                for b in range(n)]

            def nonanchors(b):
                vals = _decode_block_lanes(decs[b], *rows[b], lane_workers)
                y_hats[b][~am, off:off + gi] = vals.reshape(-1, gi)

            _pool_map(nonanchors, range(n), workers)
            off += gi
        for d in decs:
            _finish(d)
        return y_hats


class FactorizedPriorCodec(_DeviceCodec):
    """Real encode/decode for ``models.FactorizedPrior``: the analysis and
    synthesis on the model's device, and one indexed rANS stream of y under
    the bottleneck's per-channel tables for the image's [ymin, ymax]
    (``cdf_tables.factorized_tables``, cached by range), on the host. There
    is no z and no device pass between the coders, so one image's stream
    is a few milliseconds of host work. Images pad to multiples of 16.

    Header: kind 2 (5 portable), K 1, layout 0, ymin and ymax in the z
    fields, len_z 0; a portable stream carries its card's 8-byte hash after
    the header. portable_card: the ``portable.FactorizedCard`` (the tables
    frozen over [-256, 256]; built from the model at first use when none is
    given)."""

    KINDS = (_KIND_FACTORIZED, _KIND_FACTORIZED_PORTABLE)
    NAME = "factorized"
    MULTIPLE = 16

    def __init__(self, model, portable_card=None):
        super().__init__(model, portable_card)
        self._y_cache = {}

    def _tables(self, ymin: int, ymax: int):
        key = (ymin, ymax)
        if key not in self._y_cache:
            self._y_cache[key] = factorized_tables(self.model, ymin, ymax)
        return self._y_cache[key]

    def _analyse_image(self, x):
        """(img_h, img_w, y_q (h, w, M)) on the host for one image."""
        img_h, img_w, x_dev, y16, z_dev = self._analyse_device(x)
        return (img_h, img_w) + self._fetch_latents(x_dev, y16, z_dev)[:1]

    def _encode_y(self, y_q: np.ndarray, tables) -> bytes:
        sym = y_q.reshape(-1).astype(np.int32)
        index = np.tile(np.arange(self.M, dtype=np.int32), sym.shape[0] // self.M)
        return backend.encode_indexed(sym, index, *tables)

    def _pack(self, kind: int, img_h: int, img_w: int, ymin: int, ymax: int, y_bytes: bytes,
              card_hash: bytes = b"") -> bytes:
        return struct.pack(_HEADER, _MAGIC, kind, 1, self.M, img_h, img_w, _LAYOUT_ONE_STREAM,
                           ymin, ymax, 0, len(y_bytes)) + card_hash + y_bytes

    # -- encode ----------------------------------------------------------
    def compress(self, x) -> bytes:
        """x: (1, H, W, 3) float32 in [0, 1] or uint8, any size (padded to
        multiples of 16 here, cropped back by decompress)."""
        img_h, img_w, y_q = self._analyse_image(x)
        return self._encode_from(y_q, img_h, img_w)

    def compress_latents(self, y_q, img_h: int, img_w: int, z_q=None) -> bytes:
        """Encode a given integer latent grid (e.g. from ``coding.refine``)
        for an img_h x img_w image: compress()'s stream for the same
        latents. z_q is taken and ignored, so the call shape is the other
        codecs' (the refiner gives an empty z)."""
        y_q, _ = _as_latent_grids(y_q, None, img_h, img_w, self.M, mult=self.MULTIPLE)
        return self._encode_from(y_q, img_h, img_w)

    def _encode_from(self, y_q: np.ndarray, img_h: int, img_w: int) -> bytes:
        ymin, ymax = int(y_q.min()), int(y_q.max())
        return self._pack(_KIND_FACTORIZED, img_h, img_w, ymin, ymax,
                          self._encode_y(y_q, self._tables(ymin, ymax)))

    # -- portable streams ------------------------------------------------------
    def portable_card(self) -> FactorizedCard:
        """The card of this codec's portable streams: the tables frozen over
        the card's range (built from the model at first use; save it and
        load it where the stream decodes)."""
        if self._portable_card is None:
            self._portable_card = FactorizedCard.build(self.model)
        return self._portable_card

    def compress_portable(self, x) -> bytes:
        """Encode one image under the card's frozen tables: the stream
        decodes on any machine and implementation that holds the card."""
        img_h, img_w, y_q = self._analyse_image(x)
        return self._encode_portable_from(y_q, img_h, img_w)

    def compress_latents_portable(self, y_q, img_h: int, img_w: int, z_q=None) -> bytes:
        """compress_latents' portable twin. y_q is clipped to the card's
        [ymin, ymax]: the clipped grid is what decode reconstructs."""
        card = self.portable_card()
        y_q, _ = _as_latent_grids(y_q, None, img_h, img_w, self.M, mult=self.MULTIPLE)
        return self._encode_portable_from(np.clip(y_q, card.ymin, card.ymax), img_h, img_w)

    def _encode_portable_from(self, y_q: np.ndarray, img_h: int, img_w: int) -> bytes:
        card = self.portable_card()
        y_bytes = self._encode_y(y_q, (card.cdfs, card.offsets, card.sizes))
        return self._pack(_KIND_FACTORIZED_PORTABLE, img_h, img_w, card.ymin, card.ymax, y_bytes,
                          card.hash)

    # -- decode ----------------------------------------------------------
    def decode_latents(self, data: bytes) -> Tuple[np.ndarray, np.ndarray]:
        """(y_q (h, w, M) float32, an empty (0, 0, 0) z) from a float or
        portable stream."""
        header = _read_header(data, self.KINDS, self.NAME)
        _, kind, K, M, img_h, img_w, layout, ymin, ymax, len_z, _ = header
        if (K, M) != (1, self.M):
            raise ValueError(f"stream is for K={K}, M={M}; this codec's model has K=1, "
                             f"M={self.M}")
        if layout != _LAYOUT_ONE_STREAM or len_z:
            raise ValueError(f"corrupt header: factorized stream with layout {layout:#06x} "
                             f"and a {len_z}-byte z stream")
        if kind == _KIND_FACTORIZED_PORTABLE:
            card = self.portable_card()
            _check_card_hash(data, card, type(self).__name__)
            tables = (card.cdfs, card.offsets, card.sizes)
        else:
            tables = self._tables(ymin, ymax)
        h = _round_up(img_h, self.MULTIPLE) // 16
        w = _round_up(img_w, self.MULTIPLE) // 16
        index = np.tile(np.arange(self.M, dtype=np.int32), h * w)
        sym = _decode_indexed_checked(data[_body_start(header):], index, *tables)
        return sym.reshape(h, w, self.M).astype(np.float32), np.zeros((0, 0, 0), np.float32)

    def decompress(self, data: bytes, as_uint8: bool = False) -> np.ndarray:
        """(1, H, W, 3) at the stream's true size: float32 clipped to
        [0, 1], or uint8 with as_uint8=True."""
        y_hat, _ = self.decode_latents(data)
        img_h, img_w = stream_size(data)
        return self._synthesize(y_hat[None], img_h, img_w, as_uint8)
