"""Build and ctypes bindings of the native coders (``csrc/rans/``): the
generic rANS stream coder, the autoregressive wavefront codec (one stream
or N interleaved) and the portable integer codec of the three hierarchical
families (wavefront, checkerboard, hyperprior), port of coding/backend.py
(the subset the port's codecs call).

The library is compiled at first use with ``g++ -O3 -march=native`` into
``librans-<hash>.so`` under the package's ``_build/`` (a directory git
ignores). The hash covers the sources, the flags and what ``-march=native``
resolves to on this host, so a library built for another CPU is never
loaded. The build writes a temporary file and renames it, so concurrent
processes never load half a library. A missing ``g++`` or a failed build
raises: there is no other coder behind this one.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

from neural_image_compression_tpu_torch.ops.kernels._build import BUILD_DIR, CSRC

RANS_DIR = CSRC / "rans"
SOURCES = ("rans.cc", "ar_wavefront.cc", "ar_portable.cc")
HEADERS = ("rans_core.h",)
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp", "-std=c++17")

PROB_BITS = 16
PROB_SCALE = 1 << PROB_BITS

_lib = None
_lock = threading.Lock()


def _gxx(*args: str, timeout: float) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(["g++", *args], capture_output=True, text=True,
                              timeout=timeout)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found; the port's rANS coder is compiled "
                           "from csrc/rans/ at first use") from e


def library_path():
    """``_build/librans-<hash>.so``: sources, flags and the host's ISA."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((RANS_DIR / name).read_bytes())
    target = _gxx("-march=native", "-Q", "--help=target", timeout=60)
    if target.returncode != 0:
        raise RuntimeError(f"g++ -march=native -Q --help=target failed:\n{target.stderr}")
    h.update(platform.machine().encode())
    h.update(target.stdout.encode())
    return BUILD_DIR / f"librans-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False):
    """Compile the library unless it is built already; returns its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    res = _gxx(*GXX_FLAGS, *(str(RANS_DIR / s) for s in SOURCES), "-o", str(tmp),
               timeout=600)
    if verbose and (res.stdout or res.stderr):
        print(f"[g++ rans]\n{(res.stdout + res.stderr).rstrip()}", flush=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"rANS coder build failed (g++ exited {res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded coder library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f32p = ctypes.POINTER(ctypes.c_float)
        c_int, c_void_p = ctypes.c_int, ctypes.c_void_p

        lib.rans_encode_gaussian.restype = c_int
        lib.rans_encode_gaussian.argtypes = [i32p, f32p, f32p, f32p, c_int, c_int, u8p, c_int]
        lib.rans_dec_create.restype = c_void_p
        lib.rans_dec_create.argtypes = [u8p, c_int]
        lib.rans_dec_destroy.restype = None
        lib.rans_dec_destroy.argtypes = [c_void_p]
        lib.rans_dec_ok.restype = c_int
        lib.rans_dec_ok.argtypes = [c_void_p]
        lib.rans_dec_gaussian.restype = None
        lib.rans_dec_gaussian.argtypes = [c_void_p, f32p, f32p, f32p, c_int, c_int, i32p]
        lib.rans_encode_indexed.restype = c_int
        lib.rans_encode_indexed.argtypes = [i32p, i32p, c_int, u32p, c_int, i32p, i32p, u8p,
                                            c_int]
        lib.rans_dec_indexed.restype = None
        lib.rans_dec_indexed.argtypes = [c_void_p, i32p, c_int, u32p, c_int, i32p, i32p, i32p]
        lib.arwave_create.restype = c_void_p
        lib.arwave_create.argtypes = [c_int] * 6 + [f32p] * 8
        lib.arwave_destroy.restype = None
        lib.arwave_destroy.argtypes = [c_void_p]
        lib.arwave_encode.restype = c_int
        lib.arwave_encode.argtypes = [c_void_p, f32p, f32p, c_int, c_int, u8p, c_int]
        lib.arwave_decode.restype = c_int
        lib.arwave_decode.argtypes = [c_void_p, u8p, c_int, f32p, c_int, c_int, f32p]
        lib.arwave_encode_n.restype = c_int
        lib.arwave_encode_n.argtypes = [c_void_p, f32p, f32p, c_int, c_int, c_int, u8p, c_int]
        lib.arwave_decode_n.restype = c_int
        lib.arwave_decode_n.argtypes = [c_void_p, u8p, c_int, f32p, c_int, c_int, c_int, f32p]
        lib.arwave_param_sweep.restype = ctypes.c_float
        lib.arwave_param_sweep.argtypes = [c_void_p, f32p, f32p, c_int, c_int]
        i16p = ctypes.POINTER(ctypes.c_int16)
        i64p = ctypes.POINTER(ctypes.c_int64)
        c_int64 = ctypes.c_int64
        lib.arport_create.restype = c_void_p
        lib.arport_create.argtypes = [
            c_int, c_int, c_int, c_int, c_int, c_int,  # M, K, phi_dim, hidden, out_dim, n_bins
            i16p, i64p, c_int,                         # ctx
            i16p, c_int,                               # ep1_phi
            i16p, i64p, c_int,                         # ep2
            i16p, i64p, c_int,                         # ep3
            i64p, i64p, i64p, i64p,                    # sigma_thr, sigma_fix, sigma2_fix, sigma_R
            i32p, c_int64, i64p, i64p,                 # tables, their total, offsets, lengths
            i64p, c_int]                               # exp LUT
        lib.arport_destroy.restype = None
        lib.arport_destroy.argtypes = [c_void_p]
        for family in ("", "_cb", "_hp"):  # wavefront, checkerboard, hyperprior
            encode = getattr(lib, "arport_encode" + family)
            decode = getattr(lib, "arport_decode" + family)
            encode.restype = c_int
            encode.argtypes = [c_void_p, i32p, i64p, c_int, c_int, u8p, c_int]
            decode.restype = c_int
            decode.argtypes = [c_void_p, u8p, c_int, i64p, c_int, c_int, i32p]
        lib.arport_psi.restype = None
        lib.arport_psi.argtypes = [i16p, i64p, c_int, c_int, i64p, c_int, i64p]
        lib.arport_hyper_create.restype = c_void_p
        lib.arport_hyper_create.argtypes = [c_int, i64p, i16p, i64p, i64p, i64p]
        lib.arport_hyper_destroy.restype = None
        lib.arport_hyper_destroy.argtypes = [c_void_p]
        lib.arport_hyper_run.restype = c_int64
        lib.arport_hyper_run.argtypes = [c_void_p, i32p, c_int, c_int, i64p, c_int64]
        _lib = lib
        return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _checked_length(n: int) -> None:
    if n < 0:
        raise RuntimeError("rANS encode overflow")


def encode_gaussian(symbols: np.ndarray, mus: np.ndarray, sigmas: np.ndarray,
                    weights=None) -> bytes:
    """Encode int32 symbols under per-symbol (mixture-)Gaussians.

    symbols: (n,) int32; mus/sigmas/weights: (n,) or (n, K) float32 (K=1:
    weights None).
    """
    lib = get_lib()
    symbols = np.ascontiguousarray(symbols, np.int32)
    mus = np.ascontiguousarray(mus, np.float32)
    sigmas = np.ascontiguousarray(sigmas, np.float32)
    n = symbols.shape[0]
    k = 1 if mus.ndim == 1 else mus.shape[1]
    if mus.shape[0] != n or sigmas.shape != mus.shape:
        raise ValueError(f"symbols {symbols.shape}, mus {mus.shape}, sigmas {sigmas.shape}")
    wp = None
    if weights is not None:
        weights = np.ascontiguousarray(weights, np.float32)
        if weights.shape != mus.shape:
            raise ValueError(f"weights {weights.shape} vs mus {mus.shape}")
        wp = _ptr(weights, ctypes.c_float)
    cap = max(1024, n * 8 + 64)
    out = np.empty(cap, np.uint8)
    ln = lib.rans_encode_gaussian(_ptr(symbols, ctypes.c_int32), wp,
                                  _ptr(mus, ctypes.c_float), _ptr(sigmas, ctypes.c_float),
                                  k, n, _ptr(out, ctypes.c_uint8), cap)
    _checked_length(ln)
    return out[:ln].tobytes()


def _indexed_args(index, cdfs, offsets, sizes):
    index = np.ascontiguousarray(index, np.int32)
    cdfs = np.ascontiguousarray(cdfs, np.uint32)
    offsets = np.ascontiguousarray(offsets, np.int32)
    sizes = np.ascontiguousarray(sizes, np.int32)
    rows = cdfs.shape[0]
    if offsets.shape != (rows,) or sizes.shape != (rows,):
        raise ValueError(f"cdfs {cdfs.shape}, offsets {offsets.shape}, sizes {sizes.shape}")
    if index.size and (index.min() < 0 or index.max() >= rows):
        raise ValueError(f"table index outside [0, {rows})")
    if sizes.size and (sizes.min() < 1 or sizes.max() >= cdfs.shape[1]):
        raise ValueError(f"table sizes outside [1, {cdfs.shape[1]})")
    return index, cdfs, offsets, sizes


def encode_indexed(symbols: np.ndarray, index: np.ndarray, cdfs: np.ndarray,
                   offsets: np.ndarray, sizes: np.ndarray) -> bytes:
    """Encode symbols whose distributions are rows of a shared CDF table:
    symbol i under row index[i] (cdfs (rows, L+1) uint32 cumulative, row r
    covering offsets[r] .. offsets[r] + sizes[r] - 2, its last symbol the
    escape)."""
    lib = get_lib()
    symbols = np.ascontiguousarray(symbols, np.int32)
    index, cdfs, offsets, sizes = _indexed_args(index, cdfs, offsets, sizes)
    n = symbols.shape[0]
    if index.shape != (n,):
        raise ValueError(f"index {index.shape} vs symbols {symbols.shape}")
    cap = max(1024, n * 8 + 64)
    out = np.empty(cap, np.uint8)
    ln = lib.rans_encode_indexed(_ptr(symbols, ctypes.c_int32), _ptr(index, ctypes.c_int32), n,
                                 _ptr(cdfs, ctypes.c_uint32), cdfs.shape[1],
                                 _ptr(offsets, ctypes.c_int32), _ptr(sizes, ctypes.c_int32),
                                 _ptr(out, ctypes.c_uint8), cap)
    _checked_length(ln)
    return out[:ln].tobytes()


class RansDecoder:
    """Stateful decoder: decode in forward order, in chunks, as the
    distributions become known."""

    def __init__(self, data: bytes):
        self._lib = get_lib()
        self._buf = np.frombuffer(data, np.uint8).copy()  # the decoder reads it in place
        self._handle = self._lib.rans_dec_create(_ptr(self._buf, ctypes.c_uint8),
                                                 len(self._buf))

    def decode_gaussian(self, mus: np.ndarray, sigmas: np.ndarray, weights=None) -> np.ndarray:
        mus = np.ascontiguousarray(mus, np.float32)
        sigmas = np.ascontiguousarray(sigmas, np.float32)
        if sigmas.shape != mus.shape:
            raise ValueError(f"mus {mus.shape} vs sigmas {sigmas.shape}")
        n = mus.shape[0]
        k = 1 if mus.ndim == 1 else mus.shape[1]
        wp = None
        if weights is not None:
            weights = np.ascontiguousarray(weights, np.float32)
            if weights.shape != mus.shape:
                raise ValueError(f"weights {weights.shape} vs mus {mus.shape}")
            wp = _ptr(weights, ctypes.c_float)
        out = np.empty(n, np.int32)
        self._lib.rans_dec_gaussian(self._handle, wp, _ptr(mus, ctypes.c_float),
                                    _ptr(sigmas, ctypes.c_float), k, n,
                                    _ptr(out, ctypes.c_int32))
        return out

    def decode_indexed(self, index: np.ndarray, cdfs: np.ndarray, offsets: np.ndarray,
                       sizes: np.ndarray) -> np.ndarray:
        index, cdfs, offsets, sizes = _indexed_args(index, cdfs, offsets, sizes)
        n = index.shape[0]
        out = np.empty(n, np.int32)
        self._lib.rans_dec_indexed(self._handle, _ptr(index, ctypes.c_int32), n,
                                   _ptr(cdfs, ctypes.c_uint32), cdfs.shape[1],
                                   _ptr(offsets, ctypes.c_int32), _ptr(sizes, ctypes.c_int32),
                                   _ptr(out, ctypes.c_int32))
        return out

    def ok(self) -> bool:
        """True iff the stream decoded completely (state back at its start,
        every byte consumed). Check after the last decode call: a truncated
        or corrupt stream otherwise yields wrong symbols silently."""
        return bool(self._lib.rans_dec_ok(self._handle))

    def finish(self) -> None:
        if not self.ok():
            raise ValueError("corrupt or truncated rANS stream")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rans_dec_destroy(self._handle)
            self._handle = None


def _require_integral_latents(y_q: np.ndarray) -> None:
    """The AR coder codes float32 holding integers: encode reads the raw
    floats as context where decode rebuilds the rounded symbols, so a
    non-integral (or NaN) input would desynchronise the two sides."""
    if not np.array_equal(y_q, np.rint(y_q)):  # NaN fails array_equal too
        raise ValueError("AR encode requires integer-valued finite latents "
                         "(quantize with round() first)")


class ArWaveCoder:
    """Native autoregressive wavefront codec over one latent layer: context
    gather, entropy-parameter GEMMs, Gaussian/GMM model build and rANS in
    one native call per image. Encode and decode run the same machine code,
    so the coding parameters are bit-identical on both sides.

    ctx_w: (12M, 2M) mask-A context weights in ``CTX_POSITIONS`` order;
    w1: (2M + psi_dim, hidden); w3's columns in coder layout (kind, m, k)
    for K > 1.
    """

    def __init__(self, ctx_w, ctx_b, w1, b1, w2, b2, w3, b3, M: int, K: int):
        self._lib = get_lib()
        self.M, self.K = M, K
        arrs = [np.ascontiguousarray(a, np.float32) for a in (ctx_w, ctx_b, w1, b1, w2, b2, w3, b3)]
        phi_dim = 2 * M
        psi_dim = arrs[2].shape[0] - phi_dim
        hidden = arrs[2].shape[1]
        out_dim = 2 * M if K == 1 else 3 * K * M
        shapes = [(12 * M, phi_dim), (phi_dim,), (phi_dim + psi_dim, hidden), (hidden,),
                  (hidden, hidden), (hidden,), (hidden, out_dim), (out_dim,)]
        got = [a.shape for a in arrs]
        if got != shapes or psi_dim < 1:
            raise ValueError(f"coder weights {got} do not fit M={M}, K={K}: want {shapes}")
        self.psi_dim = psi_dim
        # arwave_create copies the weights
        self._handle = self._lib.arwave_create(M, K, phi_dim, psi_dim, hidden, out_dim,
                                               *[_ptr(a, ctypes.c_float) for a in arrs])

    def _psi(self, psi: np.ndarray, h: int, w: int) -> np.ndarray:
        psi = np.ascontiguousarray(psi, np.float32)
        if psi.shape != (h, w, self.psi_dim):
            raise ValueError(f"psi {psi.shape} is not ({h}, {w}, {self.psi_dim})")
        return psi

    def encode(self, y_q: np.ndarray, psi: np.ndarray) -> bytes:
        """y_q: (H, W, M) integer-valued floats; psi: (H, W, psi_dim)."""
        y_q = np.ascontiguousarray(y_q, np.float32)
        if y_q.ndim != 3 or y_q.shape[2] != self.M:
            raise ValueError(f"y_q {y_q.shape} is not (H, W, {self.M})")
        _require_integral_latents(y_q)
        h, w = y_q.shape[:2]
        psi = self._psi(psi, h, w)
        cap = max(1024, h * w * self.M * 8 + 64)
        out = np.empty(cap, np.uint8)
        ln = self._lib.arwave_encode(self._handle, _ptr(y_q, ctypes.c_float),
                                     _ptr(psi, ctypes.c_float), h, w,
                                     _ptr(out, ctypes.c_uint8), cap)
        _checked_length(ln)
        return out[:ln].tobytes()

    def decode(self, data: bytes, psi: np.ndarray, h: int, w: int) -> np.ndarray:
        """(h, w, M) float32 latents from one layer's stream."""
        psi = self._psi(psi, h, w)
        buf = np.frombuffer(data, np.uint8)
        y_out = np.empty((h, w, self.M), np.float32)
        rc = self._lib.arwave_decode(self._handle, _ptr(buf, ctypes.c_uint8), len(data),
                                     _ptr(psi, ctypes.c_float), h, w,
                                     _ptr(y_out, ctypes.c_float))
        if rc != 0:
            raise ValueError("corrupt or truncated AR stream")
        return y_out

    def encode_n(self, y_q: np.ndarray, psi: np.ndarray, n_streams: int) -> bytes:
        """N-way interleaved encode (symbol s to stream s % N): encode()'s
        entropy parameters and CDFs, about 4 (N - 1) bytes more, and decode_n
        pulls the N streams concurrently with the exact context."""
        _check_streams(n_streams)
        y_q = np.ascontiguousarray(y_q, np.float32)
        if y_q.ndim != 3 or y_q.shape[2] != self.M:
            raise ValueError(f"y_q {y_q.shape} is not (H, W, {self.M})")
        _require_integral_latents(y_q)
        h, w = y_q.shape[:2]
        psi = self._psi(psi, h, w)
        cap = max(1024, h * w * self.M * 8 + 64 + 8 * n_streams)
        out = np.empty(cap, np.uint8)
        ln = self._lib.arwave_encode_n(self._handle, _ptr(y_q, ctypes.c_float),
                                       _ptr(psi, ctypes.c_float), h, w, n_streams,
                                       _ptr(out, ctypes.c_uint8), cap)
        _checked_length(ln)
        return out[:ln].tobytes()

    def decode_n(self, data: bytes, psi: np.ndarray, h: int, w: int,
                 n_streams: int) -> np.ndarray:
        """(h, w, M) float32 latents from an N-way interleaved stream; the
        streams of each wave are decoded on OpenMP threads."""
        _check_streams(n_streams)
        psi = self._psi(psi, h, w)
        buf = np.frombuffer(data, np.uint8)
        y_out = np.empty((h, w, self.M), np.float32)
        rc = self._lib.arwave_decode_n(self._handle, _ptr(buf, ctypes.c_uint8), len(data),
                                       _ptr(psi, ctypes.c_float), h, w, n_streams,
                                       _ptr(y_out, ctypes.c_float))
        if rc != 0:
            raise ValueError("corrupt interleaved stream")
        return y_out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.arwave_destroy(self._handle)
            self._handle = None


def arwave_param_sweep_time(coder: ArWaveCoder, y_q: np.ndarray, psi: np.ndarray) -> float:
    """Profiling: run the wavefront's parameter sweep alone (context gather
    and entropy-parameter GEMMs, no CDF or rANS) once over y_q (H, W, M) and
    psi (H, W, psi_dim); returns its checksum (the caller times the call).
    Against ``encode``'s time this splits the coder's host time into the
    sweep and the CDF/rANS work."""
    y_q = np.ascontiguousarray(y_q, np.float32)
    if y_q.ndim != 3 or y_q.shape[2] != coder.M:
        raise ValueError(f"y_q {y_q.shape} is not (H, W, {coder.M})")
    h, w = y_q.shape[:2]
    psi = coder._psi(psi, h, w)
    return float(coder._lib.arwave_param_sweep(coder._handle, _ptr(y_q, ctypes.c_float),
                                               _ptr(psi, ctypes.c_float), h, w))


def _check_streams(n_streams: int) -> None:
    if not 1 <= n_streams <= 255:
        raise ValueError(f"n_streams must be in 1..255, got {n_streams}")


class ArPortableCoder:
    """Native integer codec over a ``portable.PortableCard``
    (``csrc/rans/ar_portable.cc``): the hyper-decoder, the layer-1 psi
    accumulators and the coder of the card's family (wavefront,
    checkerboard or hyperprior), bit-identical to the numpy spec in
    ``coding/portable.py`` (exact integer arithmetic on both)."""

    def __init__(self, card):
        self._lib = get_lib()
        self.M, self.K = card.M, card.K
        self.hidden = card.ep2.wq.shape[0]
        self.psi_dim = card.ep1_psi.wq.shape[0]
        # hyper-decoder rows [kind, kh, kw, cin, cout, stride, pad, opad, sw]
        metas, w_parts, b_parts = [], [], []
        self._hyper_geom = []
        for kind, layer, geom in card.hyper:
            kh, kw, cin, cout = layer.wq.shape
            stride, pad = geom[0], geom[1]
            opad = geom[2] if kind == "deconv" else 0
            metas.append([0 if kind == "conv" else 1, kh, kw, cin, cout, stride, pad, opad,
                          layer.sw])
            w_parts.append(np.ascontiguousarray(layer.wq, np.int16).reshape(-1))
            b_parts.append(np.ascontiguousarray(layer.bq, np.int64))
            self._hyper_geom.append((kind, kh, kw, cout, stride, pad, opad))

        def offsets(parts):
            return np.concatenate([[0], np.cumsum([p.size for p in parts[:-1]])]).astype(np.int64)

        table_len = np.array([len(t) for t in card.tables], np.int64)
        # every buffer stays referenced here while the handles live
        self._arrs = a = dict(
            hyper_meta=np.ascontiguousarray(np.array(metas, np.int64)),
            hyper_w=np.concatenate(w_parts), hyper_w_off=offsets(w_parts),
            hyper_b=np.concatenate(b_parts), hyper_b_off=offsets(b_parts),
            ctx_w=np.ascontiguousarray(card.ctx.wq, np.int16),
            ctx_b=np.ascontiguousarray(card.ctx.bq, np.int64),
            ep1_psi_w=np.ascontiguousarray(card.ep1_psi.wq, np.int16),
            ep1_psi_b=np.ascontiguousarray(card.ep1_psi.bq, np.int64),
            ep1_w=np.ascontiguousarray(card.ep1_phi.wq, np.int16),
            ep2_w=np.ascontiguousarray(card.ep2.wq, np.int16),
            ep2_b=np.ascontiguousarray(card.ep2.bq, np.int64),
            ep3_w=np.ascontiguousarray(card.ep3.wq, np.int16),
            ep3_b=np.ascontiguousarray(card.ep3.bq, np.int64),
            sigma_thr=np.ascontiguousarray(card.sigma_thr, np.int64),
            sigma_fix=np.ascontiguousarray(card.sigma_fix, np.int64),
            sigma2_fix=np.ascontiguousarray(card.sigma2_fix, np.int64),
            sigma_R=np.ascontiguousarray(card.sigma_R, np.int64),
            tables_cat=np.ascontiguousarray(np.concatenate(
                [t.astype(np.int32) for t in card.tables])),
            table_off=np.concatenate([[0], np.cumsum(table_len[:-1])]).astype(np.int64),
            table_len=table_len,
            exp_lut=np.ascontiguousarray(card.exp_lut, np.int64))
        i16, i32, i64 = ctypes.c_int16, ctypes.c_int32, ctypes.c_int64
        self._handle = self._lib.arport_create(
            self.M, self.K, card.ctx.wq.shape[1], self.hidden, card.ep3.wq.shape[1],
            len(card.tables),
            _ptr(a["ctx_w"], i16), _ptr(a["ctx_b"], i64), card.ctx.sw,
            _ptr(a["ep1_w"], i16), card.ep1_phi.sw,
            _ptr(a["ep2_w"], i16), _ptr(a["ep2_b"], i64), card.ep2.sw,
            _ptr(a["ep3_w"], i16), _ptr(a["ep3_b"], i64), card.ep3.sw,
            _ptr(a["sigma_thr"], i64), _ptr(a["sigma_fix"], i64),
            _ptr(a["sigma2_fix"], i64), _ptr(a["sigma_R"], i64),
            _ptr(a["tables_cat"], i32), int(a["tables_cat"].shape[0]),
            _ptr(a["table_off"], i64), _ptr(a["table_len"], i64),
            _ptr(a["exp_lut"], i64), len(a["exp_lut"]))
        if not self._handle:
            raise ValueError("the native portable coder rejected the card (K, M or sigma_R "
                             "out of spec)")
        self._hyper_handle = self._lib.arport_hyper_create(
            len(card.hyper), _ptr(a["hyper_meta"], i64), _ptr(a["hyper_w"], i16),
            _ptr(a["hyper_w_off"], i64), _ptr(a["hyper_b"], i64), _ptr(a["hyper_b_off"], i64))

    def hyper_shape(self, h: int, w: int):
        """(oh, ow, cout) of the hyper-decoder's output for an (h, w) z grid."""
        cout = None
        for kind, kh, kw, cout, stride, pad, opad in self._hyper_geom:
            if kind == "conv":
                h = (h + 2 * pad - kh) // stride + 1
                w = (w + 2 * pad - kw) // stride + 1
            else:
                # per-axis pads (kh against kw), as portable._int_deconv2d
                h = (h - 1) * stride + 1 + 2 * (kh - 1 - pad) + opad - kh + 1
                w = (w - 1) * stride + 1 + 2 * (kw - 1 - pad) + opad - kw + 1
        return h, w, cout

    def hyper(self, z_q: np.ndarray) -> np.ndarray:
        """(hz, wz, M) integer z -> (oh, ow, 2M) int64 psi at F_BITS: the
        native twin of ``PortableCard.hyper_forward``'s numpy path."""
        z = np.ascontiguousarray(z_q, np.int32)
        h, w = z.shape[:2]
        out = np.empty(self.hyper_shape(h, w), np.int64)
        n = self._lib.arport_hyper_run(self._hyper_handle, _ptr(z, ctypes.c_int32), h, w,
                                       _ptr(out, ctypes.c_int64), out.size)
        if n != out.size:
            raise RuntimeError("hyper-decoder output size mismatch")
        return out

    def psi(self, psi_flat: np.ndarray) -> np.ndarray:
        """(n, psi_dim) int64 psi -> (n, hidden) int64 layer-1 accumulators,
        bias included: the native twin of ``PortableCard.psi_precompute``."""
        psi_flat = np.ascontiguousarray(psi_flat, np.int64)
        if psi_flat.ndim != 2 or psi_flat.shape[1] != self.psi_dim:
            raise ValueError(f"psi {psi_flat.shape} is not (n, {self.psi_dim})")
        n = psi_flat.shape[0]
        out = np.empty((n, self.hidden), np.int64)
        self._lib.arport_psi(_ptr(self._arrs["ep1_psi_w"], ctypes.c_int16),
                             _ptr(self._arrs["ep1_psi_b"], ctypes.c_int64),
                             self.psi_dim, self.hidden, _ptr(psi_flat, ctypes.c_int64), n,
                             _ptr(out, ctypes.c_int64))
        return out

    def _p_acc(self, p_acc: np.ndarray, h: int, w: int) -> np.ndarray:
        p_acc = np.ascontiguousarray(p_acc, np.int64)
        if p_acc.shape != (h * w, self.hidden):
            raise ValueError(f"p_acc {p_acc.shape} is not ({h * w}, {self.hidden})")
        return p_acc

    def _encode(self, entry, y_q: np.ndarray, p_acc: np.ndarray) -> bytes:
        y = np.ascontiguousarray(y_q, np.int32)
        if y.ndim != 3 or y.shape[2] != self.M:
            raise ValueError(f"y_q {y.shape} is not (H, W, {self.M})")
        h, w = y.shape[:2]
        p_acc = self._p_acc(p_acc, h, w)
        cap = max(1024, h * w * self.M * 8 + 64)
        out = np.empty(cap, np.uint8)
        ln = entry(self._handle, _ptr(y, ctypes.c_int32), _ptr(p_acc, ctypes.c_int64), h, w,
                   _ptr(out, ctypes.c_uint8), cap)
        _checked_length(ln)
        return out[:ln].tobytes()

    def _decode(self, entry, data: bytes, p_acc: np.ndarray, h: int, w: int) -> np.ndarray:
        p_acc = self._p_acc(p_acc, h, w)
        buf = np.frombuffer(data, np.uint8)
        y_out = np.empty((h, w, self.M), np.int32)
        rc = entry(self._handle, _ptr(buf, ctypes.c_uint8), len(data),
                   _ptr(p_acc, ctypes.c_int64), h, w, _ptr(y_out, ctypes.c_int32))
        if rc != 0:
            raise ValueError("corrupt or truncated portable AR stream")
        return y_out.astype(np.float32)

    def encode(self, y_q: np.ndarray, p_acc: np.ndarray) -> bytes:
        """Wavefront encode (family-0 cards). y_q: (H, W, M) integer-valued;
        p_acc: (H*W, hidden) int64."""
        return self._encode(self._lib.arport_encode, y_q, p_acc)

    def decode(self, data: bytes, p_acc: np.ndarray, h: int, w: int) -> np.ndarray:
        """(h, w, M) float32 latents from one wavefront stream."""
        return self._decode(self._lib.arport_decode, data, p_acc, h, w)

    def encode_cb(self, y_q: np.ndarray, p_acc: np.ndarray) -> bytes:
        """Checkerboard two-pass encode (family-1 cards): anchors, then
        non-anchors, each row-major. Arguments as ``encode``'s."""
        return self._encode(self._lib.arport_encode_cb, y_q, p_acc)

    def decode_cb(self, data: bytes, p_acc: np.ndarray, h: int, w: int) -> np.ndarray:
        return self._decode(self._lib.arport_decode_cb, data, p_acc, h, w)

    def encode_hp(self, y_q: np.ndarray, p_acc: np.ndarray) -> bytes:
        """Hyperprior one-pass encode (family-2 cards): every position from
        psi alone, row-major. Arguments as ``encode``'s."""
        return self._encode(self._lib.arport_encode_hp, y_q, p_acc)

    def decode_hp(self, data: bytes, p_acc: np.ndarray, h: int, w: int) -> np.ndarray:
        return self._decode(self._lib.arport_decode_hp, data, p_acc, h, w)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.arport_destroy(self._handle)
            self._handle = None
        if getattr(self, "_hyper_handle", None):
            self._lib.arport_hyper_destroy(self._hyper_handle)
            self._hyper_handle = None
