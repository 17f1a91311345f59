"""Text input helpers of the port: canonicalization to UTF-8 bytes, the
lead-byte length table the automaton builder reads, and the loader of the
port's host C++ library.

The port's copy of the parts of ``alfred_margaret_tpu/utils/utf8.py`` it
uses (``TextLike``, ``to_bytes``, ``to_u8``, ``_LEAD_LEN`` and
``_native_lib``); the lowering tables and transducers come with IgnoreCase
(ROADMAP Queue A item 11).  ``tests/test_torch_host.py`` pins each to its
original.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np

TextLike = Union[str, bytes, bytearray, np.ndarray]


def to_bytes(text: TextLike) -> bytes:
    """Canonicalize any supported text-like input to UTF-8 bytes."""
    if isinstance(text, str):
        return text.encode("utf-8")
    if isinstance(text, np.ndarray):
        return text.astype(np.uint8).tobytes()
    return bytes(text)


def to_u8(text: TextLike) -> np.ndarray:
    """Canonicalize text-like input to an np.uint8 array."""
    if isinstance(text, np.ndarray):
        return np.ascontiguousarray(text, dtype=np.uint8)
    return np.frombuffer(to_bytes(text), dtype=np.uint8)


# Byte length of the code point started by each possible lead byte; trail
# bytes map to 0 so they are easy to mask out.
_LEAD_LEN = np.zeros(256, dtype=np.int8)
_LEAD_LEN[0x00:0x80] = 1
_LEAD_LEN[0xC0:0xE0] = 2
_LEAD_LEN[0xE0:0xF0] = 3
_LEAD_LEN[0xF0:0xF9] = 4

_NATIVE_LIB = None
_NATIVE_TRIED = False


def _native_lib():
    """The port's host C++ library, or None (no toolchain, or
    ``AMT_NO_NATIVE`` set)."""
    global _NATIVE_LIB, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        if os.environ.get("AMT_NO_NATIVE"):
            return None
        try:
            from ..native import build as _native_build

            _NATIVE_LIB = _native_build.load()
        except Exception:
            _NATIVE_LIB = None
    return _NATIVE_LIB


__all__ = ["TextLike", "to_bytes", "to_u8"]
