"""The work an operation needs, counted from its input alone.

A count reads every byte of its text once and writes one number, so the
least time the card could take is the text's length over the card's
bandwidth (``peaks.json``).  The count is of the text, not of the program's
layout (its stream warm-up, ``S`` or ``T``), so a roofline share reads the
same work whatever implements it.  A count does a few integer operations a
byte, far under the card's arithmetic peak, so the bytes bound it.
"""

from __future__ import annotations


def count_bytes(text_bytes: int) -> int:
    """Bytes a count of ``text_bytes`` bytes of text has to move."""
    return int(text_bytes)


__all__ = ["count_bytes"]
