"""ctypes binding to the native C++ CSV parser (``native/fast_csv.cc``).

The reference's loader is native C++ (``src/load.cc``); ours is too for large
clouds (1M+ points for the sharded configs), with a NumPy fallback so the
framework never hard-depends on a compiled artifact.

The shared library is built lazily with g++ the first time it is needed and
cached under ``native/build/`` (the same source and library as
``icp_tpu/io/native.py``, of which this module is a copy).  All failures
degrade silently to the Python loader (``try_load`` returns None).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _build_and_load() -> Optional[ctypes.CDLL]:
    root = _repo_root()
    src = os.path.join(root, "native", "fast_csv.cc")
    if not os.path.exists(src):
        return None
    build_dir = os.path.join(root, "native", "build")
    so_path = os.path.join(build_dir, "libfastcsv.so")
    if not os.path.exists(so_path) or os.path.getmtime(so_path) < os.path.getmtime(src):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"  # concurrent builds never share it
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
               "-o", tmp, src]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    lib.icp_csv_load.restype = ctypes.c_longlong
    lib.icp_csv_load.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong,
    ]
    lib.icp_csv_count_rows.restype = ctypes.c_longlong
    lib.icp_csv_count_rows.argtypes = [ctypes.c_char_p]
    lib.icp_csv_write.restype = ctypes.c_longlong
    lib.icp_csv_write.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong,
    ]
    lib.icp_csv_count_rows_batch.restype = None
    lib.icp_csv_count_rows_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.icp_csv_load_batch.restype = None
    lib.icp_csv_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is None and not _lib_failed:
            _lib = _build_and_load()
            if _lib is None:
                _lib_failed = True
    return _lib


def try_load(path: str) -> Optional[np.ndarray]:
    """Load (N, 3) float64 cloud via the native parser, or None on failure."""
    lib = get_lib()
    if lib is None or not os.path.exists(path):
        return None
    n = lib.icp_csv_count_rows(path.encode())
    if n < 0:
        return None
    out = np.empty((n, 3), dtype=np.float64)
    got = lib.icp_csv_load(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n
    )
    if got != n:
        return None
    return out


def try_load_batch(paths: list[str]) -> Optional[list[np.ndarray]]:
    """Load several clouds with one threaded native call (the SLAM chain's
    N-scan ingest: IO + parse are embarrassingly parallel across files).
    Returns None on any failure (caller falls back per-file)."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    if not all(os.path.exists(p) for p in paths):
        return None
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    counts = (ctypes.c_longlong * n)()
    lib.icp_csv_count_rows_batch(c_paths, n, counts)
    if any(counts[i] < 0 for i in range(n)):
        return None
    arrays = [np.empty((counts[i], 3), np.float64) for i in range(n)]
    ptrs = (ctypes.POINTER(ctypes.c_double) * n)(
        *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for a in arrays]
    )
    results = (ctypes.c_longlong * n)()
    lib.icp_csv_load_batch(c_paths, n, ptrs, counts, results)
    if any(results[i] != counts[i] for i in range(n)):
        return None
    return arrays


def try_write(points: np.ndarray, path: str) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    pts = np.ascontiguousarray(points, dtype=np.float64)
    ok = lib.icp_csv_write(
        path.encode(),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pts.shape[0],
    )
    return ok == pts.shape[0]
