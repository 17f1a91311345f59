"""The port's copies of the IgnoreCase host layers against the originals.

The port keeps its own ``utils/utf8.py`` lowering half (with its own copy of
the frozen table ``_data/lower_pairs.npy``), ``models/byteclass.py``,
``models/case_dfa.py``, the IgnoreCase scalar oracle of ``models/ac.py``,
``plan_bitap_ci`` and the native lowering entry points.  Each must give the
original's output on the same inputs: the reference's case probes (İ, Ⱥ,
Kelvin K, Å, ẞ/ß), invalid UTF-8 and seeded random byte soup.  Tolerance:
exact equality.
"""

import os

import numpy as np
import pytest

from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.models import byteclass as jbyteclass
from alfred_margaret_tpu.models import case_dfa as jcase_dfa
from alfred_margaret_tpu.native.build import NativeUnavailable
from alfred_margaret_tpu.native.build import load as jload
from alfred_margaret_tpu.ops import bitap_scan as jbitap
from alfred_margaret_tpu.utils import utf8 as jutf8
from alfred_margaret_tpu.utils.case import IGNORE_CASE as JIC

from alfred_margaret_tpu_torch.models import ac, byteclass, case_dfa
from alfred_margaret_tpu_torch.native import build as tnative
from alfred_margaret_tpu_torch.ops import bitap_scan
from alfred_margaret_tpu_torch.utils import utf8
from alfred_margaret_tpu_torch.utils.case import IGNORE_CASE

#: The reference's case probes: İ (2 bytes lowering to 1), Ⱥ (2 to 3),
#: Kelvin K (3 to 1), Ångström Å, capital ẞ and ß, digraphs, then invalid
#: UTF-8 (stray continuation, overlong, surrogate, truncated sequences).
PROBES = [
    "KİLO İstanbul fİx",
    "Ⱥⱥ ȺB ⱥb",
    "KILO K kilo",
    "Ångström Å å",
    "STRAẞE straße ẞß",
    "Ǆǅǆ Ǳ DŽ",
    "日本 ΩΣω Σς",
]
INVALID = [
    b"\xff\xfe invalid \x80 utf-8 caf\xc3\xa9 \x00\x00xyz",
    b"\xc0\xaf \xe0\x80\xaf \xed\xa0\x80 \xf4\x90\x80\x80 \xc3",
    b"ab\xe2\x84",
]


def _soup(seed, n=3000):
    """Seeded bytes drawn from ASCII letters, the probes' encodings and junk."""
    rng = np.random.default_rng(seed)
    pool = [c.encode() for c in "aAkKsSiI İKÅẞßȺⱥéÉ"]
    pool += [b"\xff", b"\x80", b"\xc3", b"\xe2\x84"]
    return b"".join(pool[i] for i in rng.integers(0, len(pool), size=n))


HAYS = [p.encode() for p in PROBES] + INVALID + [_soup(1), _soup(2, 500), b""]


def test_lower_table_is_the_originals():
    here = os.path.join(os.path.dirname(utf8.__file__), "_data", "lower_pairs.npy")
    there = os.path.join(os.path.dirname(jutf8.__file__), "_data", "lower_pairs.npy")
    with open(here, "rb") as a, open(there, "rb") as b:
        assert a.read() == b.read()
    assert utf8.LOWER_TABLE.dtype == jutf8.LOWER_TABLE.dtype
    np.testing.assert_array_equal(utf8.LOWER_TABLE, jutf8.LOWER_TABLE)
    np.testing.assert_array_equal(utf8.ASCII_LOWER_BYTES, jutf8.ASCII_LOWER_BYTES)
    assert utf8._unlower_map() == jutf8._unlower_map()
    np.testing.assert_array_equal(utf8._lower_encode_map(), jutf8._lower_encode_map())
    for c in "aAkKiIßåΣςωİK日":
        assert utf8.lower_code_point(c) == jutf8.lower_code_point(c)
        assert utf8.unlower_code_point(c) == jutf8.unlower_code_point(c)
        assert ac.needle_casings(c + "k") == jac.needle_casings(c + "k")
    for cp in (0x41, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10000, 0x10FFFF):
        assert utf8.unicode2utf8(cp) == jutf8.unicode2utf8(cp)
        assert utf8.num_code_units(cp) == jutf8.num_code_units(cp)
    for p in PROBES:
        assert utf8.lower_str(p) == jutf8.lower_str(p)


@pytest.mark.parametrize("i", range(len(HAYS)))
def test_lowering_matches_jax(i):
    hay = HAYS[i]
    for j in range(len(hay)):
        assert utf8.decode_strict(hay, j) == jutf8.decode_strict(hay, j)
    assert utf8.lower_units_scalar(hay) == jutf8.lower_units_scalar(hay)
    arr = np.frombuffer(hay, np.uint8)
    for got, want in zip(utf8.lower_units_np(arr), jutf8.lower_units_np(arr)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(utf8.strict_units_np(arr), jutf8.strict_units_np(arr)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(utf8.decode_utf8_np(arr), jutf8.decode_utf8_np(arr)):
        np.testing.assert_array_equal(got, want)
    cps = np.frombuffer(hay.decode("utf-8", "replace").encode("utf-32-le"), np.int32)
    for got, want in zip(utf8.encode_utf8_np(cps), jutf8.encode_utf8_np(cps)):
        np.testing.assert_array_equal(got, want)
    for need_coords in (True, False):
        got = utf8.lower_transform(hay, need_coords=need_coords)
        want = jutf8.lower_transform(hay, need_coords=need_coords)
        assert got.lowered.tobytes() == want.lowered.tobytes()
        assert got.identity == want.identity
    got, want = utf8.lower_transform(hay), jutf8.lower_transform(hay)
    ends = np.arange(1, len(got.lowered) + 1)
    np.testing.assert_array_equal(got.map_ends_to_raw(ends), want.map_ends_to_raw(ends))
    assert got.n_code_points == want.n_code_points
    for a in ("cp_index", "raw_start", "raw_end"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a), err_msg=a)
    raw_ends = np.unique(got.map_ends_to_raw(ends)) if len(ends) else ends
    np.testing.assert_array_equal(got.cp_of_raw_end(raw_ends), want.cp_of_raw_end(raw_ends))
    if len(hay):
        lenc = np.random.default_rng(i).integers(0, 3, size=len(raw_ends))
        lenc = np.minimum(lenc, want.cp_of_raw_end(raw_ends) + 1)
        np.testing.assert_array_equal(utf8.raw_match_starts(hay, raw_ends, lenc),
                                      jutf8.raw_match_starts(hay, raw_ends, lenc))
        last = len(hay) - 1
        assert utf8.skip_code_points_backwards(hay, last, 0) == \
            jutf8.skip_code_points_backwards(hay, last, 0)


def test_native_lowering_matches_jax():
    try:
        jlib = jload()
    except NativeUnavailable:
        pytest.skip("the JAX package's native library does not build here")
    tlib = tnative.load()
    for hay in HAYS:
        if not hay:
            continue
        arr = np.frombuffer(hay, np.uint8)
        n = len(arr)
        assert tlib.am_is_ascii(arr.ctypes.data, n) == jlib.am_is_ascii(arr.ctypes.data, n)
        outs = []
        for lib in (tlib, jlib):
            asc = np.empty(n, np.uint8)
            lib.am_lower_ascii(arr.ctypes.data, n, asc.ctypes.data)
            cap = 4 * n + 16
            lb, nb = np.zeros(cap, np.uint8), np.zeros(1, np.int64)
            st = lib.am_lower_bytes(utf8.LOWER_TABLE.ctypes.data, utf8._lower_encode_map().ctypes.data,
                                    arr.ctypes.data, n, lb.ctypes.data, cap, nb.ctypes.data)
            lt, nt = np.zeros(cap, np.uint8), np.zeros(1, np.int64)
            rs, rl, ol = (np.zeros(n, np.int32) for _ in range(3))
            units = lib.am_lower_transform(
                utf8.LOWER_TABLE.ctypes.data, utf8._lower_encode_map().ctypes.data,
                arr.ctypes.data, n, lt.ctypes.data, cap, rs.ctypes.data, rl.ctypes.data,
                ol.ctypes.data, nt.ctypes.data)
            outs.append((asc.tobytes(), st, lb[: nb[0]].tobytes(), units,
                         lt[: nt[0]].tobytes(), rs[:units].tolist(), rl[:units].tolist(),
                         ol[:units].tolist()))
        assert outs[0] == outs[1]
        assert outs[0][2] == jutf8.lower_units_np(arr)[0].tobytes()


@pytest.mark.parametrize("hay", HAYS[:4] + HAYS[7:9])
def test_ignore_case_oracle_matches_jax(hay):
    needles = ["kilo", "i", "ⱥb", "straße", "å", "tshirt", "ss", ""]
    pairs = [(n, i) for i, n in enumerate(needles)]
    m, jm = ac.build(pairs), jac.build(pairs)
    assert ac.all_matches(m, hay, IGNORE_CASE) == jac.all_matches(jm, hay, JIC)
    assert ac.count_matches(m, hay, IGNORE_CASE) == jac.count_matches(jm, hay, JIC)
    first = ac.run_lower(None, lambda _a, x: ac.Done(x), m, hay)
    assert first == jac.run_lower(None, lambda _a, x: jac.Done(x), jm, hay)


NEEDLE_SETS = [
    ("bench", ["tshirt", "shirts", "shorts"]),
    ("specials", ["kilo", "i", "straße", "å", "ⱥb", "ǆ"]),
    ("mixed_case_and_latin", ["Foo", "foo", "café", "écl", "ив"]),
    ("random", list(dict.fromkeys(
        "".join(np.random.default_rng(5).choice(list("abcdefghik"), size=int(k)))
        for k in np.random.default_rng(6).integers(2, 7, size=40)))),
]


def _composed(mod, acmod, needles):
    m = acmod.build([(n, i) for i, n in enumerate(needles)])
    return m, mod.compose_build(list(zip(m.needles, m.values)), machine=m)


@pytest.mark.parametrize("name,needles", NEEDLE_SETS, ids=[c[0] for c in NEEDLE_SETS])
def test_compose_build_and_ci_plan_match_jax(name, needles):
    m, cm = _composed(case_dfa, ac, needles)
    jm, jcm = _composed(jcase_dfa, jac, needles)
    assert cm.n_states == jcm.n_states and cm.composed_ci and jcm.composed_ci
    for f in ("delta", "match_count", "out_offset", "out_values", "fail"):
        w, g = getattr(jcm, f), getattr(cm, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (cm.values, cm.needles, cm.max_needle_bytes) == (
        jcm.values, jcm.needles, jcm.max_needle_bytes)
    assert case_dfa.eligible(m.needles) == jcase_dfa.eligible(jm.needles)
    assert case_dfa.max_raw_match_bytes(m.needles) == jcase_dfa.max_raw_match_bytes(jm.needles)
    assert byteclass.ci_tracks(cm) == jbyteclass.ci_tracks(jcm)
    for nd in m.needles:
        assert byteclass.ci_track_key(nd) == jbyteclass.ci_track_key(nd)
        assert bitap_scan.ci_track_key(nd) == jbitap.ci_track_key(nd)
    for max_words in (1, 2, 3):
        got = bitap_scan.plan_bitap_ci(cm, max_words=max_words)
        want = jbitap.plan_bitap_ci(jcm, max_words=max_words)
        assert (got is None) == (want is None)
        if got is None:
            continue
        assert (got.unroll, got.ci, got.n_words, got.has_trap) == (
            want.unroll, want.ci, want.n_words, want.has_trap)
        assert len(got.all_words()) == len(want.all_words())
        for gw, ww in zip(got.all_words(), want.all_words()):
            assert (gw.seed, gw.endmask, gw.fields, gw.keys, gw.trap_endmask, gw.fold) == (
                ww.seed, ww.endmask, ww.fields, ww.keys, ww.trap_endmask, ww.fold)
            np.testing.assert_array_equal(gw.btab, ww.btab)
    assert bitap_scan.plan_bitap(cm) is None and bitap_scan.plan_bitap_ci(m) is None
    hay = _soup(3, 800) + b" " + " ".join(n.upper() for n in needles).encode()
    assert ac.count_matches(cm, hay) == ac.count_matches(m, hay, IGNORE_CASE)


def test_ineligible_needles_match_jax():
    for needles in (["ab", b"\xff"], [b"\xc3"], ["ok", "fine"]):
        assert case_dfa.eligible(needles) == jcase_dfa.eligible(needles)
    with pytest.raises(ValueError, match="whole-code-point"):
        case_dfa.compose_build([(b"\xc3", 0)])
    for cp in (ord("a"), ord("k"), ord("ω"), ord("т"), ord("и"), ord("ß"), ord("å")):
        assert byteclass.ci_cp_sets(cp) == jbyteclass.ci_cp_sets(cp)
