"""Build, load and count the hand-written CUDA kernels.

All sources under ``icp_tpu_torch/csrc/`` are compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together, and
linked into one shared library with a plain C interface, which ``ctypes``
loads.  The build runs on first use, into
``icp_tpu_torch/_build/<hash>/`` (ignored by git), where the hash covers the
sources and the flags: a changed source builds anew, an unchanged one loads
what is there.  Importing this module builds nothing.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
``check`` raises on a non-zero code.  Each wrapper adds one to its count in
``LAUNCHES`` where it launches its kernel, and nowhere else, so a run can
show which kernels carried it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
# --fmad=false: no multiply-add contraction anywhere, so the float64 solve
# rounds as its plain Python version does and the float32 distance
# arithmetic (written with explicit _rn intrinsics besides) as plain torch.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"nn_dense": 0, "qcp_step": 0, "icp_fused": 0, "nn_grid": 0,
            "qcp_rotation": 0, "knn_dense": 0, "knn_grid": 0, "nn_chunked": 0,
            "nn_bf16": 0, "nn_dense_mxu": 0, "nn_dense_points": 0, "nn_grid_near": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C signatures of the entry points (all return the launch's cudaError_t).
_SIGNATURES = {
    "nn_dense_launch": [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P],
    "nn_dense_chunk_rows": [_I, _I, _I, _I, _P],
    "nn_dense_points_launch": [_P, _I, _P, _I, _P, _P, _P, _P],
    "qcp_step_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _D, _D, _I, _I, _P],
    "icp_fused_launch": [_P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _D, _D, _I, _I,
                         _P],
    "icp_fused_scene_blocks": [_I],
    "icp_fused_chunk_rows": [_I, _I, _I, _P],
    "nn_grid_launch": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P, _P, _P],
    "nn_grid_near_launch": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P],
    "qcp_rotation_launch": [_P, _I, _P, _P],
    "qcp_rotation_from_launch": [_P, _P, _P, _I, _I, _P, _P, _P],
    "knn_dense_launch": [_P, _I, _P, _I, _I, _P, _P, _P],
    "knn_grid_plan": [_P, _I, _I, _I, _I, _I, _P, _P, _P],
    "knn_grid_launch": [_P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P,
                        _P],
    "nn_chunked_launch": [_P, _I, _P, _I, _P, _P, _I, _P, _P],
    "nn_chunked_workspace": [_P, _P],
    "nn_chunked_chunk_rows": [_I, _I, _P],
    "nn_bf16_batched_plan": [_I, _I, _I, _P, _P, _P],
    "nn_bf16_batched_launch": [_P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build() -> str:
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    so_path = os.path.join(out_dir, "libicp_kernels.so")
    if os.path.exists(so_path):
        build_info.update(path=so_path, seconds=0.0, cached=True)
        return so_path
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for cu in (p for p in _sources() if p.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(cu)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", obj, cu]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    objs = [obj for _, obj, _ in jobs]
    if not failed:
        tmp = f"{so_path}.{tag}"
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(link.stderr)
    seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
        f.write("\n".join(logs))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, so_path)
    build_info.update(path=so_path, seconds=seconds, cached=False,
                      ptxas="\n".join(logs))
    return so_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(_build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {code}")


def stream_ptr(t) -> int:
    """The current PyTorch stream of ``t``'s device, as a pointer (read
    without building a ``torch.cuda.Stream``, which costs ~8 us a call on
    the host: the wrappers of the small launches are host-bound)."""
    return raw_stream(t.device.index)


def raw_stream(index: int) -> int:
    """The current PyTorch stream of CUDA device ``index``, as a pointer."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)
