"""Offline generator for the frozen Unicode simple-lowercase table.

The reference lowercases per code point with GHC's ``Char.toLower`` — the
*simple* (single code point) Unicode lowercase mapping
(``src/Data/Text/Utf8.hs:145-151``). Python's ``str.lower`` implements the
*full* mapping, which differs only for U+0130 (LATIN CAPITAL LETTER I WITH
DOT ABOVE → "i" + COMBINING DOT, per SpecialCasing.txt); the simple mapping
sends it to plain "i". We derive the simple table from ``str.lower`` plus
that one special case, and freeze it into the repo as a compact (cp, lower)
pair array so results never drift with the host Python's Unicode version.

Run ``python -m alfred_margaret_tpu_torch.utils._gen_unicode_tables`` to
regenerate the port's own ``utils/_data/lower_pairs.npy`` (beside this file).
The port's copy of ``alfred_margaret_tpu/utils/_gen_unicode_tables.py``: the
same code, which writes beside its own module.
"""

from __future__ import annotations

import os

import numpy as np

MAX_CP = 0x110000

# The only code point whose full lowercase mapping (used by str.lower) is
# multi-char; its simple mapping is U+0069.
_SPECIAL_SIMPLE_LOWER = {0x130: 0x69}


def compute_lower_pairs() -> np.ndarray:
    """All (cp, simple_lower(cp)) pairs where the mapping is not identity."""
    pairs = []
    for cp in range(MAX_CP):
        if cp in _SPECIAL_SIMPLE_LOWER:
            low = _SPECIAL_SIMPLE_LOWER[cp]
        else:
            l = chr(cp).lower()
            low = ord(l) if len(l) == 1 else cp
        if low != cp:
            pairs.append((cp, low))
    return np.asarray(pairs, dtype=np.int32)


def main() -> None:
    out_dir = os.path.join(os.path.dirname(__file__), "_data")
    os.makedirs(out_dir, exist_ok=True)
    pairs = compute_lower_pairs()
    np.save(os.path.join(out_dir, "lower_pairs.npy"), pairs)
    print(f"wrote {len(pairs)} non-identity lowercase pairs")


if __name__ == "__main__":
    main()
