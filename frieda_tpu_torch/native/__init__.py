"""The verifier's host runtime: ctypes bindings over `frieda_native.cpp`.

Jax-free copy of the bindings of `frieda_tpu/native/__init__.py` that the
verifier uses. The library builds at first use with g++ into
`build/native/<sha of the source and flags>/` at the repository root
(`ops/_build.compile_once`); a failed build raises, there is no numpy
fallback. The plain version of each function is in `core/merkle.py`, chosen
there with `plain=True`, and only the tests choose it.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "frieda_native.cpp"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libfrieda_native.so"

_VP = ctypes.c_void_p
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
_SIGNATURES = {
    "frieda_raw_compress_batch": (None, (_VP, _U64, _VP)),
    "frieda_verify_openings": (ctypes.c_int, (_U32, _U64, _VP, _VP, _VP, _U64, _VP, _VP)),
    "frieda_verify_openings_batch": (ctypes.c_int, (_U32, _U32, _VP, _VP, _VP, _VP, _VP, _VP, _VP)),
}

_lib = None


def library() -> ctypes.CDLL:
    """The loaded runtime, built on first use. Raises if g++ fails."""
    global _lib
    if _lib is None:
        from ..ops._build import compile_once

        lib = ctypes.CDLL(str(compile_once(BUILD_ROOT, LIB_NAME, "g++", GXX_FLAGS, [SOURCE])))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = list(argtypes)
        _lib = lib
    return _lib


def raw_compress_batch(msgs: np.ndarray) -> np.ndarray:
    """msgs (n, 16) uint32 -> (n, 8) uint32 zero-state compressions."""
    msgs = np.ascontiguousarray(msgs, np.uint32)
    if msgs.ndim != 2 or msgs.shape[1] != 16:
        raise ValueError(f"expected (n, 16) messages, got {msgs.shape}")
    out = np.empty((msgs.shape[0], 8), np.uint32)
    library().frieda_raw_compress_batch(msgs.ctypes.data, msgs.shape[0], out.ctypes.data)
    return out


def verify_openings(log_n: int, idxs: np.ndarray, rows: np.ndarray, wit_rows: np.ndarray):
    """The multi-opening walk of one tree. idxs (n,) int64 sorted unique leaf
    indices; rows (n, 8) uint32 their hashes; wit_rows (n_wit, 8) uint32.
    Returns (ok, root32, consumed): ok only means the walk ended at node 0;
    callers compare root32 and consumed themselves."""
    idxs = np.ascontiguousarray(idxs, np.int64)
    rows = np.ascontiguousarray(rows, np.uint32)
    wit_rows = np.ascontiguousarray(wit_rows, np.uint32)
    if rows.shape != (idxs.shape[0], 8) or wit_rows.ndim != 2 or wit_rows.shape[1] != 8:
        raise ValueError(f"rows {rows.shape} / witness {wit_rows.shape} do not fit {idxs.shape[0]} leaves")
    out = np.empty(8, np.uint32)
    consumed = ctypes.c_uint64(0)
    ok = library().frieda_verify_openings(
        log_n, idxs.shape[0], idxs.ctypes.data, rows.ctypes.data, wit_rows.ctypes.data,
        wit_rows.shape[0], out.ctypes.data, ctypes.byref(consumed))
    return bool(ok), out.tobytes(), int(consumed.value)


def verify_openings_batch(log_n: int, seg: np.ndarray, idxs: np.ndarray, rows: np.ndarray,
                          wseg: np.ndarray, wit_rows: np.ndarray):
    """Multi-opening walks over len(seg) - 1 independent trees of one depth in
    one call. seg / wseg: (P + 1,) row offsets into idxs / rows and wit_rows;
    idxs tree-local. Returns (ok (P,) bool: the walk ended at node 0 and
    consumed its witness exactly, roots (P, 8) uint32)."""
    seg = np.ascontiguousarray(seg, np.uint64)
    wseg = np.ascontiguousarray(wseg, np.uint64)
    idxs = np.ascontiguousarray(idxs, np.int64)
    rows = np.ascontiguousarray(rows, np.uint32)
    wit_rows = np.ascontiguousarray(wit_rows, np.uint32)
    p = seg.shape[0] - 1
    if (wseg.shape[0] != p + 1 or rows.shape != (idxs.shape[0], 8) or int(seg[-1]) != idxs.shape[0]
            or wit_rows.ndim != 2 or wit_rows.shape[1] != 8 or int(wseg[-1]) != wit_rows.shape[0]):
        raise ValueError("segments do not fit the rows")
    roots = np.empty((p, 8), np.uint32)
    ok = np.zeros(p, np.uint8)
    library().frieda_verify_openings_batch(
        log_n, p, seg.ctypes.data, idxs.ctypes.data, rows.ctypes.data, wseg.ctypes.data,
        wit_rows.ctypes.data, roots.ctypes.data, ok.ctypes.data)
    return ok.astype(bool), roots
