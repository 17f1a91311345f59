"""Byte-class track planning for IgnoreCase bitap engines.

The port's copy of ``alfred_margaret_tpu/models/byteclass.py``, read by
its CUDA bitap engine's planner (``ops.bitap_scan.plan_bitap_ci``):
per-position accepted-byte sets from the *same-length unlowerings* of each
needle code point, an exactness
closure gate, and the trap encodings (length-changing unlowerings — İ→i,
Kelvin K→k, Å→å, ẞ→ß, … — 25 in all of Unicode) that a fixed-width track
cannot hold and a runtime guard must watch for.

Exactness argument (verified by the CI fuzz/soak lanes): strict decoding
(``utf8.decode_strict``) consumes invalid bytes one at a time and UTF-8 is
self-synchronizing, so any raw window that byte-equals a valid minimal
encoding sequence is decoded as exactly those code points; the closure
gate rejects code points whose variant byte mix could decode to a
*different* letter (e.g. Greek ω/Ω mixes to ϩ, Cyrillic pairs crossing the
D0/D1 lead boundary), which would otherwise over-match.
"""

from __future__ import annotations

from itertools import product as _iproduct
from typing import Dict, List, Optional, Tuple

from ..utils import utf8


def needle_cps(nd: bytes) -> Optional[List[int]]:
    """Strict whole-code-point parse of a needle, or None if any byte is
    not part of a valid minimal sequence (such needles are not composed-CI
    eligible in the first place, ``models.case_dfa.eligible``)."""
    cps = []
    i, n = 0, len(nd)
    while i < n:
        consumed, cp, valid = utf8.decode_strict(nd, i)
        if not valid:
            return None
        cps.append(cp)
        i += consumed
    return cps


def ci_track_key(nd: bytes) -> Optional[bytes]:
    """Canonical IgnoreCase track key: the lowered needle, re-encoded.
    None when the needle is not whole-code-point strict UTF-8."""
    cps = needle_cps(bytes(nd))
    if cps is None:
        return None
    return "".join(chr(int(utf8.LOWER_TABLE[cp])) for cp in cps).encode("utf-8")


def ci_cp_sets(cp: int):
    """Per-byte accepted sets + trap encodings for one lowered code point.

    Returns ``(possets, traps)`` or None when the closure gate fails:
    ``possets`` accept exactly the same-length unlowerings of ``cp`` (every
    cartesian-product byte string must be strict-valid UTF-8 decoding to a
    preimage — otherwise a mixed-variant byte string would either decode to
    a different letter or pass through as invalid bytes, both over-matches),
    ``traps`` are the encodings of length-changing unlowerings (İ→i class),
    which the track cannot hold and the runtime trap word must guard.
    """
    pre = [ord(u) for u in utf8.unlower_code_point(chr(cp))]
    if cp not in pre:
        return None  # cp is not its own lowering: no fixed-width language
    enc = chr(cp).encode("utf-8")
    L = len(enc)
    same, traps = [], []
    for u in pre:
        ue = chr(u).encode("utf-8")
        (same if len(ue) == L else traps).append(ue)
    possets = tuple(tuple(sorted({ue[j] for ue in same})) for j in range(L))
    if any(0 in s for s in possets):
        return None  # NUL must stay register-killing (pad bytes)
    preset = set(pre)
    for combo in _iproduct(*possets):
        bs = bytes(combo)
        consumed, val, valid = utf8.decode_strict(bs, 0)
        if not (valid and consumed == L and val in preset):
            return None  # closure gate: product would over-match
    return possets, traps


def ci_tracks(machine) -> Optional[Tuple[list, list]]:
    """Byte-class tracks for a composed case-folding DFA, or None.

    Returns ``(tracks, trap_encodings)`` where ``tracks`` is a list of
    ``(possets, weight, key)`` — one per unique *lowered* needle, with
    original-case duplicates folded into the multiplicity weight — and
    ``trap_encodings`` the distinct length-changing variant encodings the
    caller must guard at runtime.  Mirrors the per-needle eligibility gates
    of ``ops.bitap_scan.plan_bitap`` (no empty needle; NUL via ci_cp_sets).
    """
    if not getattr(machine, "composed_ci", False):
        return None
    if not machine.needles:
        return None
    mult: Dict[bytes, int] = {}
    cps_of: Dict[bytes, List[int]] = {}
    for nd in machine.needles:
        nd = bytes(nd)
        if len(nd) == 0:
            return None
        cps = needle_cps(nd)
        if cps is None:
            return None
        key = "".join(chr(int(utf8.LOWER_TABLE[cp])) for cp in cps).encode("utf-8")
        mult[key] = mult.get(key, 0) + 1
        cps_of[key] = [int(utf8.LOWER_TABLE[cp]) for cp in cps]

    tracks = []
    trap_encs: Dict[bytes, None] = {}
    cache: Dict[int, Optional[Tuple]] = {}
    for key, w in mult.items():
        possets: List[Tuple[int, ...]] = []
        for cp in cps_of[key]:
            if cp not in cache:
                cache[cp] = ci_cp_sets(cp)
            got = cache[cp]
            if got is None:
                return None
            ps, traps = got
            possets.extend(ps)
            for t in traps:
                trap_encs.setdefault(t, None)
        tracks.append((tuple(possets), w, key))
    return tracks, list(trap_encs)


__all__ = ["ci_cp_sets", "ci_track_key", "ci_tracks", "needle_cps"]
