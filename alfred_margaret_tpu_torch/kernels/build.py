"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Each of ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and one more ``nvcc`` call links the objects
into a shared library with a plain C interface, cached under ``_build/`` by
a hash of the sources, their headers and the flags (the same scheme as
``alfred_margaret_tpu/native/build.py``).  No PyTorch header is compiled.
Every pointer and the CUDA stream go to C as ``ctypes.c_void_p``; each
launcher returns its ``cudaError_t``.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
LINK_FLAGS = ("-shared",)


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in [*srcs, *sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))]:
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
        i, i,  # overlap, segments
        p, p,  # out, stream
    ]
    lib.amt_dense_states.restype = i
    lib.amt_dense_states.argtypes = [
        p, i, i,  # streams, T, S
        p, p, i,  # classmap, table, table_words
        i, i,  # packing, state_bits
        i, i,  # overlap, segments
        p, p,  # out, stream
    ]
    lib.amt_bitap_count.restype = i
    lib.amt_bitap_count.argtypes = [
        p, i, i,  # streams, T, S
        p, p, p,  # btab, seed, endmask
        p, p, p,  # field_start, field_bit, field_weight
        i, i,  # n_words, n_fields
        p, i, i,  # warm, overlap, segments
        p, p,  # out, stream
    ]
    lib.amt_bitap_count_trap.restype = i
    lib.amt_bitap_count_trap.argtypes = [
        p, i, i,  # streams, T, S
        p, p, p,  # btab, seed, endmask
        p, p, p,  # field_start, field_bit, field_weight
        i, i,  # n_words, n_fields
        p, p, i, i,  # warm, trapmask, overlap, segments
        p, p, p,  # out, trap_out, stream
    ]
    lib.amt_dense_contains.restype = i
    lib.amt_dense_contains.argtypes = [
        p, i, i,  # streams, T, S
        p, p, i, p,  # classmap, table, table_words, vend
        i, i, i,  # packing, state_bits, absorb
        i, i,  # s0, s1
        i, i,  # overlap, segments
        p, p,  # out, stream
    ]
    lib.amt_bitap_contains.restype = i
    lib.amt_bitap_contains.argtypes = [
        p, i, i,  # streams, T, S
        p, p, p, i,  # btab, seed, endmask, n_words
        i, i,  # overlap, segments
        p, p,  # out, stream
    ]
    lib.amt_bitap_contains_trap.restype = i
    lib.amt_bitap_contains_trap.argtypes = [
        p, i, i,  # streams, T, S
        p, p, p, p, i,  # btab, seed, endmask, trapmask, n_words
        i, i,  # overlap, segments
        p, p, p,  # out, trap_out, stream
    ]
    lib.amt_bitap_presence.restype = i
    lib.amt_bitap_presence.argtypes = [
        p, i, i,  # streams, T, S
        p, p, p, i,  # btab, seed, endmask, n_words
        i, i,  # overlap, segments
        p, p,  # out, stream
    ]
    lib.amt_bitap_presence_trap.restype = i
    lib.amt_bitap_presence_trap.argtypes = [
        p, i, i,  # streams, T, S
        p, p, p, p, i,  # btab, seed, endmask, trapmask, n_words
        i, i,  # overlap, segments
        p, p,  # out, stream
    ]
    lib.amt_matchbits_dense.restype = i
    lib.amt_matchbits_dense.argtypes = [
        p, i, i, p, p,  # streams, T, S, warm, vend
        p, p, i, i, i,  # classmap, table, table_words, packing, state_bits
        i, i,  # overlap, segments
        p, p, p,  # counts, bits, stream
    ]
    lib.amt_matchbits_bitap.restype = i
    lib.amt_matchbits_bitap.argtypes = [
        p, i, i, p, p,  # streams, T, S, warm, vend
        p, p, p, p, p, i,  # btab, seed, endmask, field_bit, field_weight, n_fields
        i, i,  # overlap, segments
        p, p, p,  # counts, bits, stream
    ]
    comb16 = [
        p, p, i, p, i,  # classmap, comb, comb_words, aux, aux_words
        p, p,  # root_row, segtable
    ]
    lib.amt_comb16_count.restype = i
    lib.amt_comb16_count.argtypes = [
        p, i, i, p, p,  # streams, T, S, warm, vend
        *comb16, p,  # ..., ranges
        i, i, i, i,  # BB, owner_mask, CB, root_cb
        i, i,  # overlap, segments
        p, p,  # out, stream
    ]
    lib.amt_comb16_contains.restype = i
    lib.amt_comb16_contains.argtypes = [
        p, i, i, p,  # streams, T, S, vend
        *comb16,
        i, i, i, i,  # BB, owner_mask, root_cb, absorb
        i, i,  # overlap, segments
        p, p,  # out, stream
    ]
    lib.amt_comb16_states.restype = i
    lib.amt_comb16_states.argtypes = [
        p, i, i,  # streams, T, S
        *comb16,
        i, i, i, i,  # BB, owner_mask, CB, root_cb
        i, i,  # overlap, segments
        p, p,  # out, stream
    ]
    comb = [
        p, p, i, p, i,  # classmap, comb, comb_words, def_table, def_words
        i, i, i, i,  # k, owner_bits, root_base, root_def
    ]
    lib.amt_comb_count.restype = i
    lib.amt_comb_count.argtypes = [
        p, i, i, p, p, *comb,  # streams, T, S, warm, vend, ...
        i, i,  # overlap, segments
        p, p,  # out, stream
    ]
    lib.amt_comb_contains.restype = i
    lib.amt_comb_contains.argtypes = [
        p, i, i, p, *comb,  # streams, T, S, vend, ...
        i, i, i,  # absorb, overlap, segments
        p, p,  # out, stream
    ]
    lib.amt_comb_states.restype = i
    lib.amt_comb_states.argtypes = [
        p, i, i, *comb,  # streams, T, S, ...
        i, i,  # overlap, segments
        p, p,  # out, stream
    ]
    grouped = [
        i, p, p, i, p, i,  # G, classmap, comb, comb_words, aux, aux_words
        p, p, p,  # root_row, segtable, gscal
    ]
    lib.amt_comb16_count_grouped.restype = i
    lib.amt_comb16_count_grouped.argtypes = [
        p, i, i, p, p,  # streams, T, S, warm, vend
        *grouped, i,  # ..., gscal_width
        i, i, i,  # BB, owner_mask, CB
        i, i, i,  # overlap, segments, chunk
        p, p,  # out, stream
    ]
    lib.amt_comb16_contains_grouped.restype = i
    lib.amt_comb16_contains_grouped.argtypes = [
        p, i, i, p,  # streams, T, S, vend
        *grouped,
        i, i,  # BB, owner_mask
        i, i, i,  # overlap, segments, chunk
        p, p,  # out, stream
    ]
    lib.amt_matchbits_comb16.restype = i
    lib.amt_matchbits_comb16.argtypes = [
        p, i, i, p, p,  # streams, T, S, warm, vend
        *comb16, p,  # ..., ranges
        i, i, i, i,  # BB, owner_mask, CB, root_cb
        i, i,  # overlap, segments
        p, p, p,  # counts, bits, stream
    ]
    lib.amt_filter_contains.restype = i
    lib.amt_filter_contains.argtypes = [
        p, i, i, p,  # streams, T, S, vend
        p, p, p, i,  # btab, seed, endmask, n_words
        p, p, i,  # short_mask, short_const, n_shorts
        i, i,  # restart, segments
        p, p,  # out, stream
    ]
    lib.amt_screen_count.restype = i
    lib.amt_screen_count.argtypes = [
        p, i, i, p, p,  # streams, T, S, warm, vend
        p, i, p, i, p,  # bitmap, bits, slots, slot_bits, recs
        i, i, i,  # key_bytes, overlap, segments
        p, p, p,  # out, passes, stream
    ]
    lib.amt_error_string.restype = ctypes.c_char_p
    lib.amt_error_string.argtypes = [i]


def _compile(nvcc: str, srcs, so: str) -> str:
    """One nvcc process per source, all running at once, then one link;
    returns nvcc's output.  Raises ``KernelBuildError`` if any step fails."""
    tmp = f"{so}.{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(srcs, objs)
    ]
    log, failed = [], []
    try:
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate(timeout=600)
            log.append(f"== {os.path.basename(src)}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} (exit {proc.returncode})")
    finally:
        for proc in procs:  # stop every compiler still running after a timeout
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    try:
        if failed:
            raise KernelBuildError(f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log))
        proc = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", f"{tmp}.so", *objs],
            capture_output=True, text=True, timeout=600,
        )
        log.append(f"== link\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc link exited {proc.returncode}:\n" + "\n".join(log))
        os.replace(f"{tmp}.so", so)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "\n".join(log)


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
            t0 = time.perf_counter()
            log = _compile(nvcc, srcs, so)
            seconds = time.perf_counter() - t0
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
