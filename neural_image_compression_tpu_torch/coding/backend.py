"""Build and ctypes bindings of the native coders (``csrc/rans/``): the
generic rANS stream coder and the autoregressive wavefront codec, port of
coding/backend.py (the subset the single-image joint-AR codec calls).

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
SOURCES = ("rans.cc", "ar_wavefront.cc")
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

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.arwave_destroy(self._handle)
            self._handle = None
