"""ctypes binding for the native GF(2) core (csrc/gf2core.cpp).

Auto-builds the shared library with g++ on first use when missing (no
pybind11 in this image — plain C ABI + ctypes per the environment contract).
All entry points fall back to the NumPy implementations when the toolchain or
library is unavailable; `QLDPC_NATIVE=0` disables the native path entirely.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "_gf2core.so")
_SRC = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "csrc", "gf2core.cpp")


# Must match gf2core_abi_version() in csrc/gf2core.cpp; bump both whenever
# any exported signature changes.
_ABI_VERSION = 2


def _abi_version(lib) -> int:
    """ABI version exported by the loaded library (0 = predates the
    handshake)."""
    if not hasattr(lib, "gf2core_abi_version"):
        return 0
    lib.gf2core_abi_version.restype = ctypes.c_int
    lib.gf2core_abi_version.argtypes = []
    return int(lib.gf2core_abi_version())


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    try:
        # Build to a temp name + rename: the fresh inode guarantees a
        # subsequent CDLL() maps the NEW library (dlopen caches by inode, so
        # overwriting in place could silently return the stale mapping).
        tmp = _SO + ".build"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("QLDPC_NATIVE", "1") == "0":
        return None
    # Rebuild when the source is newer than the library (fast mtime hint);
    # the authoritative staleness check is the ABI version handshake below,
    # which also catches a stale .so whose mtime a checkout has refreshed.
    stale = (os.path.exists(_SO) and os.path.exists(_SRC)
             and os.path.getmtime(_SRC) > os.path.getmtime(_SO))
    if (not os.path.exists(_SO) or stale) and not _build():
        return None  # never call a known-stale library
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    # ABI handshake: the C ABI has grown output parameters over time, and
    # calling a mismatched .so through new signatures would silently
    # misbehave (extra args ignored). One rebuild attempt on mismatch.
    if _abi_version(lib) != _ABI_VERSION:
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        if _abi_version(lib) != _ABI_VERSION:
            return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.gf2_eliminate.restype = ctypes.c_int
    lib.gf2_eliminate.argtypes = [u64p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  u64p, ctypes.c_int, ctypes.c_int, i32p]
    lib.gf2_rank.restype = ctypes.c_int
    lib.gf2_rank.argtypes = [u64p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ms_decode_cpu.restype = ctypes.c_int
    lib.ms_decode_cpu.argtypes = [i8p, ctypes.c_int, ctypes.c_int,
                                  i8p, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_int, ctypes.c_float,
                                  i32p, i32p, ctypes.c_int,
                                  i8p, i32p, i8p, f32p]
    if hasattr(lib, "ms_decode_cpu_mt"):
        lib.ms_decode_cpu_mt.restype = ctypes.c_int
        lib.ms_decode_cpu_mt.argtypes = lib.ms_decode_cpu.argtypes + [ctypes.c_int]
    f64p = ctypes.POINTER(ctypes.c_double)
    if hasattr(lib, "bp_decode_cpu"):
        bp_args = [i8p, ctypes.c_int, ctypes.c_int,
                   i8p, ctypes.c_int,
                   ctypes.c_double, ctypes.c_int,
                   i32p, i32p, ctypes.c_int,
                   i8p, i32p, i8p, f64p]
        lib.bp_decode_cpu.restype = ctypes.c_int
        lib.bp_decode_cpu.argtypes = bp_args
        lib.bp_decode_cpu_mt.restype = ctypes.c_int
        lib.bp_decode_cpu_mt.argtypes = bp_args + [ctypes.c_int]
    if hasattr(lib, "osd_decode_cpu"):
        lib.osd_decode_cpu.restype = ctypes.c_int
        lib.osd_decode_cpu.argtypes = [i8p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int,
                                       i8p, i8p, f64p, ctypes.c_int,
                                       ctypes.c_int, i8p]
    _LIB = lib
    return _LIB


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def rank_native(packed: np.ndarray, n: int) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    P = np.ascontiguousarray(packed, dtype=np.uint64)
    return int(lib.gf2_rank(_u64p(P), P.shape[0], n, P.shape[1]))


def eliminate_native(packed: np.ndarray, n: int, T: Optional[np.ndarray],
                     reduced: bool):
    """In-place elimination on `packed` (and T). Returns pivots or None."""
    lib = get_lib()
    if lib is None:
        return None
    m, words = packed.shape
    pivots = np.full(max(1, min(m, n)), -1, dtype=np.int32)
    tptr = _u64p(T) if T is not None else ctypes.POINTER(ctypes.c_uint64)()
    twords = T.shape[1] if T is not None else 0
    r = lib.gf2_eliminate(_u64p(packed), m, n, words, tptr, twords,
                          1 if reduced else 0, _i32p(pivots))
    return [int(p) for p in pivots[:r]]


def ms_decode_native(H: np.ndarray, syndromes: np.ndarray, p: float,
                     max_iter: int, layers, beta: float = 0.75,
                     threads: int = 0):
    """Batched reference-semantics CPU MS decode (threads=0: all cores;
    1: sequential; results are bit-identical either way). Returns
    (e_hat (B,n) int8, n_iter (B,) int32, converged (B,) bool,
    posterior (B,n) float32) or None."""
    lib = get_lib()
    if lib is None:
        return None
    H = np.ascontiguousarray(H, dtype=np.int8)
    syn = np.ascontiguousarray(syndromes, dtype=np.int8)
    m, n = H.shape
    B = syn.shape[0]
    starts = np.asarray([int(l[0]) if len(l) else 0 for l in layers], np.int32)
    ends = np.asarray([int(l[-1]) + 1 if len(l) else 0 for l in layers], np.int32)
    e_out = np.zeros((B, n), np.int8)
    iters = np.zeros(B, np.int32)
    conv = np.zeros(B, np.int8)
    post = np.zeros((B, n), np.float32)
    postp = post.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    args = (_i8p(H), m, n, _i8p(syn), B,
            ctypes.c_float(p), max_iter, ctypes.c_float(beta),
            _i32p(starts), _i32p(ends), len(layers),
            _i8p(e_out), _i32p(iters), _i8p(conv), postp)
    if hasattr(lib, "ms_decode_cpu_mt"):
        lib.ms_decode_cpu_mt(*args, threads)
    else:
        lib.ms_decode_cpu(*args)
    return e_out, iters, conv.astype(bool), post


def bp_decode_native(H: np.ndarray, syndromes: np.ndarray, p: float,
                     max_iter: int, layers, threads: int = 0):
    """Batched STRICT-reference-numerics CPU BP decode (float64, eps=1e-9,
    clamp-by-subtraction; see csrc/gf2core.cpp bp_decode_cpu). Returns
    (e_hat int8, n_iter int32, converged bool, posterior float64) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "bp_decode_cpu"):
        return None
    H = np.ascontiguousarray(H, dtype=np.int8)
    syn = np.ascontiguousarray(syndromes, dtype=np.int8)
    m, n = H.shape
    B = syn.shape[0]
    starts = np.asarray([int(l[0]) if len(l) else 0 for l in layers], np.int32)
    ends = np.asarray([int(l[-1]) + 1 if len(l) else 0 for l in layers], np.int32)
    e_out = np.zeros((B, n), np.int8)
    iters = np.zeros(B, np.int32)
    conv = np.zeros(B, np.int8)
    post = np.zeros((B, n), np.float64)
    lib.bp_decode_cpu_mt(
        _i8p(H), m, n, _i8p(syn), B,
        ctypes.c_double(p), max_iter,
        _i32p(starts), _i32p(ends), len(layers),
        _i8p(e_out), _i32p(iters), _i8p(conv),
        post.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), threads)
    return e_out, iters, conv.astype(bool), post


def osd_decode_native(H: np.ndarray, e_hat: np.ndarray, syndromes: np.ndarray,
                      posterior: np.ndarray, order: int):
    """Batched CPU OSD post-decode (framework semantics — see
    csrc/gf2core.cpp osd_decode_cpu). Returns (B, n) int8 or None."""
    from qldpcsim_jax import gf2

    lib = get_lib()
    if lib is None or not hasattr(lib, "osd_decode_cpu"):
        return None
    H = np.ascontiguousarray(H, dtype=np.int8)
    m, n = H.shape
    rank = gf2.rank(H)
    e_in = np.ascontiguousarray(e_hat, dtype=np.int8)
    syn = np.ascontiguousarray(syndromes, dtype=np.int8)
    post = np.ascontiguousarray(posterior, dtype=np.float64)
    B = e_in.shape[0]
    e_out = np.zeros((B, n), np.int8)
    lib.osd_decode_cpu(_i8p(H), m, n, rank, _i8p(e_in), _i8p(syn),
                       post.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       B, int(order), _i8p(e_out))
    return e_out
