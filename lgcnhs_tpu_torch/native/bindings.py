"""ctypes bindings for the native graph builder, compiled at first use.

Port of ``lgcnhs_tpu/native/bindings.py`` over the port's own copy of the
C++ source (``graph_builder.cc``). The library is built by ``g++ -O3`` on
the first call into ``_build/libgraph_builder.so`` beside the source (a
directory git ignores; written under a temporary name and renamed, so
processes that build at once do not clash). Every entry point keeps the JAX
package's fallback for a machine without a compiler, in numpy and the port's
CSV reader where JAX reads with pandas; ``available()`` says which ran.
This is host code: no kernel of the card.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "graph_builder.cc")
_BUILD_DIR = os.path.join(_HERE, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libgraph_builder.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp],
        check=True, capture_output=True, timeout=120,
    )
    os.replace(tmp, _LIB_PATH)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_LIB_PATH) or os.path.getmtime(
                _LIB_PATH
            ) < os.path.getmtime(_SRC):
                _compile()
            lib = ctypes.CDLL(_LIB_PATH)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.parse_edges_csv.restype = ctypes.c_int64
            lib.parse_edges_csv.argtypes = [
                ctypes.c_char_p, ctypes.c_char, i32p, i32p, ctypes.c_int64,
            ]
            lib.parse_rating_rows.restype = ctypes.c_int64
            lib.parse_rating_rows.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, i32p, i32p, i32p, i32p,
                ctypes.c_int64,
            ]
            lib.build_csr.restype = ctypes.c_int64
            lib.build_csr.argtypes = [
                i32p, i32p, ctypes.c_int64, ctypes.c_int32, i64p, i32p,
            ]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _as_i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def parse_edges_csv(path: str, sep: str = ",") -> Tuple[np.ndarray, np.ndarray]:
    """(users, items) int32 arrays from an integer-id CSV with a header row.
    Without the native library: the first two columns of the port's
    ``read_table`` (JAX reads them with pandas)."""
    lib = _load()
    if lib is not None:
        capacity = max(1024, os.path.getsize(path) // 4)
        users = np.empty(capacity, dtype=np.int32)
        items = np.empty(capacity, dtype=np.int32)
        n = lib.parse_edges_csv(path.encode(), sep.encode(), _i32p(users), _i32p(items),
                                capacity)
        if n >= 0:
            return users[:n].copy(), items[:n].copy()
    from lgcnhs_tpu_torch.runtime.table import read_table

    cols = list(read_table(path, sep=sep).values())
    return cols[0].astype(np.int32), cols[1].astype(np.int32)


def parse_rating_rows(path: str, sep: str) -> Optional[Tuple[np.ndarray, ...]]:
    """(users, items, ratings, timestamps) int32 arrays from an all-integer
    rating file with a possibly MULTI-character separator — covers ML-100K's
    tab-separated ``u.data`` and ML-1M's ``::``-separated ``ratings.dat``.
    Returns None when the native library is unavailable or the file doesn't
    fit the 4-integer-column shape (callers fall back to ``read_table``)."""
    lib = _load()
    if lib is None:
        return None
    capacity = max(1024, os.path.getsize(path) // 8)
    cols = [np.empty(capacity, dtype=np.int32) for _ in range(4)]
    n = lib.parse_rating_rows(path.encode(), sep.encode(), *[_i32p(c) for c in cols],
                              capacity)
    if n < 0:
        return None
    return tuple(c[:n].copy() for c in cols)


def build_csr(
    rows: np.ndarray, cols: np.ndarray, n_rows: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicated CSR (indptr int64 (n_rows+1), indices int32) from COO."""
    rows = _as_i32(rows)
    cols = _as_i32(cols)
    lib = _load()
    if lib is not None:
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        indices = np.empty(rows.shape[0], dtype=np.int32)
        n = lib.build_csr(_i32p(rows), _i32p(cols), rows.shape[0], n_rows,
                          indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                          _i32p(indices))
        return indptr, indices[:n].copy()
    return build_csr_numpy(rows, cols, n_rows)


def build_csr_numpy(
    rows: np.ndarray, cols: np.ndarray, n_rows: int
) -> Tuple[np.ndarray, np.ndarray]:
    """``build_csr`` without the native library: numpy's lexsort + unique."""
    rows = _as_i32(rows)
    cols = _as_i32(cols)
    order = np.lexsort((cols, rows))
    r, c = rows[order], cols[order]
    keep = np.ones(r.shape[0], dtype=bool)
    keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    r, c = r[keep], c[keep]
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.add.at(indptr, r + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, c.astype(np.int32)
