"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

All of ``csrc/*.cu`` is compiled by one ``nvcc`` call for ``sm_90a`` into a
shared library with a plain C interface, cached under ``_build/`` by a hash
of the sources and flags (the same scheme as
``alfred_margaret_tpu/native/build.py``).  No PyTorch header is compiled, so
the build takes seconds.  Every pointer and the CUDA stream go to C as
``ctypes.c_void_p``; each launcher returns its ``cudaError_t``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..utils.device import nvcc_path

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


@dataclass
class Built:
    lib: ctypes.CDLL
    path: str
    seconds: float  # compile time in this process; 0.0 when the cache was hit
    log: str  # nvcc's output (``-Xptxas=-v``: registers, shared memory, spills)


_LOCK = threading.Lock()
_BUILT: Optional[Built] = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _so_path(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libamt_kernels_{h.hexdigest()[:16]}.so")


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.amt_dense_count.restype = i
    lib.amt_dense_count.argtypes = [
        p, i, i,  # streams, T, S
        p, p, i,  # classmap, table, table_words
        p, p,  # warm, vend
        i, i,  # packing, state_bits
        p, p,  # out, stream
    ]
    lib.amt_bitap_count.restype = i
    lib.amt_bitap_count.argtypes = [
        p, i, i,  # streams, T, S
        p, p, p,  # btab, seed, endmask
        p, p, p,  # field_start, field_bit, field_weight
        i, i,  # n_words, n_fields
        p, p, p,  # warm, out, stream
    ]
    lib.amt_error_string.restype = ctypes.c_char_p
    lib.amt_error_string.argtypes = [i]


def load() -> Built:
    """Build (once per source hash) and load the kernels' library."""
    global _BUILT
    with _LOCK:
        if _BUILT is not None:
            return _BUILT
        srcs = sources()
        so = _so_path(srcs)
        seconds, log = 0.0, ""
        if not os.path.exists(so):
            nvcc = nvcc_path()
            if nvcc is None:
                raise KernelBuildError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, *srcs],
                capture_output=True,
                text=True,
                timeout=600,
            )
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise KernelBuildError(f"nvcc exited {proc.returncode}:\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _bind(lib)
        _BUILT = Built(lib=lib, path=so, seconds=seconds, log=log)
        return _BUILT


def check(err: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = load().lib.amt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel launch failed: error {err} ({msg})")


__all__ = ["Built", "KernelBuildError", "check", "load", "sources"]
