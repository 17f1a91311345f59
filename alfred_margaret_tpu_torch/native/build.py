"""Lazy ctypes build and load of the port's host C++ engine.

Compiles ``am_native.cpp`` with g++ on first use into
``alfred_margaret_tpu_torch/_build/`` (keyed by a hash of the source), so
importing the package never compiles anything.  A copy of
``alfred_margaret_tpu/native/build.py`` that binds the entry points of the
port's ``am_native.cpp`` only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "am_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    return os.path.join(_BUILD_DIR, f"am_native_{digest}.so")


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.am_expand_hit_bits.restype = i64
    lib.am_expand_hit_bits.argtypes = [
        p, p, p, i64,  # t_words (int64), s_idx (int64), wval (int32), n_words
        p, p, i64, i64,  # warm (int64), vend (int64), S, L
        p, i32,  # out (int64), n_threads
    ]
    lib.am_states_at.restype = None
    lib.am_states_at.argtypes = [
        p, p, i64,  # delta, data, n
        p, i64, i32,  # pos (int64), n_pos, w
        p, i32,  # out_states (int32), n_threads
    ]
    lib.am_scan_count_mt.restype = i64
    lib.am_scan_count_mt.argtypes = [p, p, i32, p, i64, i64, i32]
    lib.am_scan_states_mt.restype = None
    lib.am_scan_states_mt.argtypes = [
        p, i32,  # delta, n_states
        p, i64, i64, i32,  # data, n, overlap, n_threads
        p,  # out_states (int32)
    ]
    lib.am_scan_count_class_mt.restype = i64
    lib.am_scan_count_class_mt.argtypes = [
        p, p, p, i64, i64, i32,  # tab, cls, data, n, overlap, n_threads
    ]
    lib.am_scan_hits_class_mt.restype = i64
    lib.am_scan_hits_class_mt.argtypes = [
        p, p, i32,  # tab, cls, n_classes
        p, i64, i64, i32,  # data, n, overlap, n_threads
        p, p, i64,  # out_pos, out_state, cap
    ]
    lib.am_scan_hits_mt.restype = i64
    lib.am_scan_hits_mt.argtypes = [
        p, p, i32,  # delta, match_count, n_states
        p, i64, i64, i32,  # data, n, overlap, n_threads
        p, p, i64,  # out_pos, out_state, cap
    ]
    lib.am_scan_first_hit_class.restype = i64
    lib.am_scan_first_hit_class.argtypes = [p, p, p, i64, i64, i32]
    lib.am_scan_first_hit.restype = i64
    lib.am_scan_first_hit.argtypes = [p, p, p, i64, i64, i32]
    lib.am_scan_all_values_class.restype = i64
    lib.am_scan_all_values_class.argtypes = [
        p, p, i32,  # tab, cls, n_classes
        p, p, i32,  # out_offset, out_values, n_values
        p, i64, i64, i32,  # data, n, overlap, n_threads
        p,  # out_seen
    ]
    lib.am_lower_transform.restype = i64
    lib.am_lower_transform.argtypes = [
        p, p,  # lower_map (int32 [0x110000]), emap (uint64 [0x10000])
        p, i64,  # data, n
        p, i64,  # out, out_cap
        p, p, p,  # raw_start, raw_len, out_len (int32 per unit)
        p,  # out_nbytes (int64)
    ]
    lib.am_lower_bytes.restype = i32
    lib.am_lower_bytes.argtypes = [p, p, p, i64, p, i64, p]  # ..., out, out_cap, out_nbytes
    lib.am_lower_ascii.restype = None
    lib.am_lower_ascii.argtypes = [p, i64, p]
    lib.am_is_ascii.restype = i32
    lib.am_is_ascii.argtypes = [p, i64]
    lib.am_scan_all_values.restype = i64
    lib.am_scan_all_values.argtypes = [
        p, p,  # delta, match_count
        p, p, i32,  # out_offset, out_values, n_values
        p, i64, i64, i32,  # data, n, overlap, n_threads
        p,  # out_seen
    ]
    lib.am_scan_segments_hits.restype = i64
    lib.am_scan_segments_hits.argtypes = [
        p, p, p,  # delta, match_count, data
        p, p, i64,  # seg_begin, seg_end (int64), n_segs
        p, p, i64,  # out_pos, out_state, cap
    ]
    lib.am_splice.restype = i64
    lib.am_splice.argtypes = [
        p, i64,  # data, n
        p, p, i64,  # starts, ends (int64), n_sites
        p, i64,  # repl, repl_len
        p,  # out
    ]
    lib.am_splice_mt.restype = i64
    lib.am_splice_mt.argtypes = lib.am_splice.argtypes + [i32]  # ..., n_threads
    lib.am_splice_multi.restype = i64
    lib.am_splice_multi.argtypes = [
        p, i64,  # data, n
        p, p, i64,  # starts, ends (int64), n_sites
        p, p, p,  # repl_blob, repl_off (int64), rid (int32 per site)
        p, i32,  # out, n_threads
    ]
    lib.am_remove_overlap.restype = i64
    lib.am_remove_overlap.argtypes = [
        p, p, i64,  # starts, ends (int64), n
        p, p,  # kept_starts, kept_ends
    ]
    u64 = ctypes.c_uint64
    lib.am_bitap_count_mt.restype = i64
    lib.am_bitap_count_mt.argtypes = [
        p, u64, u64,  # btab (uint64 [256]), seed, endmask
        p, i64, i64, i32,  # data, n, overlap, n_threads
    ]
    lib.am_bitap_first.restype = i64
    lib.am_bitap_first.argtypes = [p, u64, u64, p, i64]  # btab, seed, endmask, data, n
    pf = [
        p, i64,  # bloom, bloom_words
        p, p, p, i64,  # keys, grp_off, grp_needles, slots
        p, p,  # nb_off, nb_bytes
        p, i64,  # data, n
    ]
    lib.am_prefilter_count.restype = i64
    lib.am_prefilter_count.argtypes = pf + [i32]  # ..., n_threads
    lib.am_prefilter_first.restype = i64
    lib.am_prefilter_first.argtypes = list(pf)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the native library; raises
    ``NativeUnavailable`` when no toolchain is present."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = _so_path()
        if not os.path.exists(so):
            cmd = ["g++", "-O3", "-std=c++17", "-march=native", "-shared", "-fPIC", "-pthread",
                   _SRC, "-o", f"{so}.{os.getpid()}.tmp"]
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
                detail = getattr(e, "stderr", b"")
                raise NativeUnavailable(f"native build failed: {e} {detail!r}") from e
            os.replace(cmd[-1], so)
        lib = ctypes.CDLL(so)
        _bind(lib)
        _LIB = lib
        return lib


def default_threads() -> int:
    return min(16, os.cpu_count() or 1)


__all__ = ["NativeUnavailable", "default_threads", "load"]
