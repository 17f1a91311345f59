"""The port's own copies of the JAX package's host layers, and the port's
independence of that package.

The port imports nothing of ``alfred_margaret_tpu``, not even its modules
that do not import ``jax``: it keeps copies of ``utils/case.py``, the parts
of ``utils/utf8.py``, ``models/ac.py``, ``native/`` and
``bench/dataformat.py`` that it uses, of ``replacer.py``, ``splitter.py``,
``boyer_moore/``, ``boyer_moore_ci/``, ``ops/streaming.py``,
``utils/config.py``, ``native/prefilter.py``, ``models/nfa_oracle.py``,
the host bitap oracle, and the tools' modules (``cli.py``, ``bench/``'s
``dataformat``, ``timing``, ``naive``, ``report``, ``driver``,
``countmatches`` and ``micro``, ``utils/_gen_unicode_tables.py``) and
functions (``debug_build_dot``, ``AcMachine.nbytes`` / ``state_dtype``,
``memscan_baseline``, ``partition_needles``, ``ScanStats``), pinned function
by function, but for the functions that differ on purpose, and defines ``MatchSet``,
``StagedHaystack`` and ``AUTO_PYTHON_THRESHOLD`` itself.  Each copy must give
the original's output on seeded inputs (tolerance: exact equality).  A fresh
interpreter that imports every module of the port must hold no ``jax`` and
no ``alfred_margaret_tpu`` module, and ``chip_smoke.py`` must name none.
The port's entry points run on ``"cuda"`` unless asked for the CPU.
"""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import alfred_margaret_tpu as jamt
from alfred_margaret_tpu import engine as jengine
from alfred_margaret_tpu.bench import dataformat as jdata
from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.native.build import NativeUnavailable
from alfred_margaret_tpu.utils import case as jcase
from alfred_margaret_tpu.utils import utf8 as jutf8

import alfred_margaret_tpu_torch as port
from alfred_margaret_tpu_torch import boyer_moore as bm
from alfred_margaret_tpu_torch import boyer_moore_ci as bmci
from alfred_margaret_tpu_torch import engine as tengine
from alfred_margaret_tpu_torch.bench import dataformat as tdata
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.native import build as tnative
from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine
from alfred_margaret_tpu_torch.ops import bitap_scan, comb16_scan, comb_scan, pallas_scan, xla_scan
from alfred_margaret_tpu_torch.utils import case as tcase
from alfred_margaret_tpu_torch.utils import utf8 as tutf8

from test_torch_comb16 import CONFIG2
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NEEDLE_SETS = [
    ("bench", ["tshirt", "shirts", "shorts"]),
    ("overlap_duplicates", ["ab", "b", "abc", "zz", "b"]),
    ("empty_needle", ["", "a", "ab"]),
    ("nul", [b"a\x00b", b"\x00\x00", b"xyz"]),
    ("non_ascii", ["café", "écl", "ü", "日本"]),
    ("config2", CONFIG2),
]


def _hay(needles, seed=0):
    """Needles among random words, then NULs, invalid UTF-8 and non-ASCII."""
    words = [n if isinstance(n, str) else n.decode("latin-1") for n in needles if n]
    rng = np.random.default_rng(seed)
    noise = bytes(rng.choice(list(b"abcz \x00"), size=2000).astype(np.uint8))
    return (jdata.synth_corpus(words, 1 << 13, hit_fraction=0.1, seed=seed) + noise
            + b"\xff\xfe invalid \x80 utf-8 caf\xc3\xa9 \x00\x00xyz")


def test_case_module_matches_jax():
    for name in ("CASE_SENSITIVE", "IGNORE_CASE"):
        t, j = getattr(tcase, name), getattr(jcase, name)
        assert t.value == j.value and t.to_json() == j.to_json()
        assert tcase.CaseSensitivity.from_json(j.to_json()) is t
    assert [c.value for c in tcase.CaseSensitivity] == [c.value for c in jcase.CaseSensitivity]
    assert port.CASE_SENSITIVE is tcase.CASE_SENSITIVE


@pytest.mark.parametrize("text", [
    "tshirt café 日本", b"\xff\xfe\x00abc", bytearray(b"xyz\x80"),
    np.arange(300, dtype=np.int64) % 256, np.frombuffer(b"read-only", np.uint8), "",
])
def test_utf8_helpers_match_jax(text):
    assert tutf8.to_bytes(text) == jutf8.to_bytes(text)
    got, want = tutf8.to_u8(text), jutf8.to_u8(text)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tutf8._LEAD_LEN, jutf8._LEAD_LEN)


#: Texts for the scalar UTF-8 helpers: every width, case specials, and
#: malformed sequences (stray trail bytes, truncations, 0xF5-0xF8 leads).
UTF8_TEXTS = ["", "tshirt", "café 日本 \U0001f574", "KİLO Ⱥⱥ Ångström ẞß ǅ", "a\x00b"]
UTF8_BYTES = [t.encode() for t in UTF8_TEXTS] + [
    b"\xff\xfe invalid \x80 utf-8 caf\xc3\xa9 \xc3", b"\xe6\x97", b"\xf7\xbf\xbf\xbfx\xf8\x80",
    bytes(np.random.default_rng(8).integers(0, 256, size=300).astype(np.uint8)),
]


def test_utf8_reference_surface_matches_jax():
    """The nine helpers of the reference's UTF-8 surface that the port copied
    for the Replacer, Splitter and Boyer-Moore layers."""
    import io

    for text in UTF8_TEXTS + ["\U000437b8", "\u2c65\u023a"]:
        assert tutf8.length_utf8(text) == jutf8.length_utf8(text)
        assert tutf8.is_case_invariant(text) == jutf8.is_case_invariant(text)
        for c in text:
            assert tutf8.to_lower_ascii(c) == jutf8.to_lower_ascii(c)
    for data in UTF8_BYTES:
        assert tutf8.decode_utf8(data) == jutf8.decode_utf8(data)
        assert tutf8.length_utf8(data) == jutf8.length_utf8(data)
        for i in range(len(data)):
            assert tutf8.decode_code_point(data, i) == jutf8.decode_code_point(data, i)
            assert tutf8.unsafe_index_code_point(data, i) == jutf8.unsafe_index_code_point(data, i)
        for b, n in ((0, 3), (2, 100), (len(data), 1), (1, 0)):
            assert tutf8.unsafe_slice_utf8(b, n, data) == jutf8.unsafe_slice_utf8(b, n, data)
            assert tutf8.unsafe_cut_utf8(b, n, data) == jutf8.unsafe_cut_utf8(b, n, data)
    got, want = io.StringIO(), io.StringIO()
    tutf8.print_unlowerings(got)
    jutf8.print_unlowerings(want)
    assert got.getvalue() == want.getvalue() and "U+006B k <- " in got.getvalue()


MACHINE_FIELDS = ("delta", "out_offset", "out_values", "match_count", "values", "needles",
                  "max_needle_bytes", "edge_src", "edge_byte", "edge_dst", "fail", "cp_complete",
                  "composed_ci")


@pytest.mark.parametrize("name,needles", NEEDLE_SETS, ids=[c[0] for c in NEEDLE_SETS])
def test_ac_matches_jax(name, needles):
    for pairs in ([(n, i) for i, n in enumerate(needles)], [(n, (n, "v")) for n in needles]):
        want, got = jac.build(pairs), ac.build(pairs)
        for f in MACHINE_FIELDS:
            w, g = getattr(want, f), getattr(got, f)
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype, f
                np.testing.assert_array_equal(g, w, err_msg=f)
            else:
                assert g == w, f
        ac.validate_machine(got)
        hay = _hay(needles)
        assert ac.all_matches(got, hay) == jac.all_matches(want, hay)
        assert ac.count_matches(got, hay) == jac.count_matches(want, hay)
        first = ac.run_text(None, lambda _a, m: ac.Done(m), got, hay)
        assert first == jac.run_text(None, lambda _a, m: jac.Done(m), want, hay)
        some = ac.run_text(0, lambda a, _m: ac.Step(a + 1), got, hay[:500])
        assert some == jac.run_text(0, lambda a, _m: jac.Step(a + 1), want, hay[:500])
        states = np.random.default_rng(3).integers(0, got.n_states, size=200)
        np.testing.assert_array_equal(ac.presence_of_states(got, states, len(got.values)),
                                      jac.presence_of_states(want, states, len(want.values)))
        assert [list(got.outputs(s)) for s in range(got.n_states)] == [
            list(want.outputs(s)) for s in range(want.n_states)]
    bad = ac.build([(n, i) for i, n in enumerate(needles)])
    bad.match_count = bad.match_count + 1
    with pytest.raises(AssertionError):
        ac.validate_machine(bad)


@pytest.mark.parametrize("name,needles", NEEDLE_SETS, ids=[c[0] for c in NEEDLE_SETS])
def test_cpp_engine_matches_original(name, needles):
    from alfred_margaret_tpu.native.cpp_engine import CppAcEngine as Original

    try:
        jm = jac.build([(n, i) for i, n in enumerate(needles)])
        want_eng = Original(jm)
    except NativeUnavailable:
        pytest.skip("the JAX package's native library does not build here")
    m = ac.build([(n, i) for i, n in enumerate(needles)])
    hay = _hay(needles, seed=1) * 20
    for classes in (False, True):
        got_eng = CppAcEngine(m)
        if classes:  # the byte-class tables serve scans of 64 KiB and more
            got_eng._class_bytes_seen = want_eng._class_bytes_seen = 1 << 40
        for h in (hay, hay[:1000], b""):
            assert got_eng.count(h) == want_eng.count(h)
            assert (got_eng.first_hit(h) >= 0) == (want_eng.first_hit(h) >= 0)
            np.testing.assert_array_equal(got_eng.value_presence(h, len(m.values)),
                                          want_eng.value_presence(h, len(jm.values)))
            for w, g in zip(want_eng.matches_arrays(h), got_eng.matches_arrays(h)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            for nt in (None, 1):
                got, want = got_eng.final_states(h, nt), want_eng.final_states(h, nt)
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)
        assert got_eng._class_state == want_eng._class_state
    # The Replacer's window rescan: seeded, merged, possibly empty windows.
    rng = np.random.default_rng(len(needles))
    for n_win in (0, 1, 40):
        b = np.sort(rng.integers(0, len(hay), size=n_win))
        e = np.minimum(b + rng.integers(0, 64, size=n_win), len(hay))
        u8 = np.frombuffer(hay, np.uint8)
        for w, g in zip(want_eng.segments_matches_arrays(u8, b, e),
                        got_eng.segments_matches_arrays(u8, b, e)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    # The host bitap oracle's and the prefilter's entry points, on the same
    # tables and corpora, against the JAX package's library.
    from alfred_margaret_tpu.native import prefilter as jprefilter
    from alfred_margaret_tpu.native.build import load as jload
    from alfred_margaret_tpu_torch.native import prefilter
    from alfred_margaret_tpu_torch.native.cpp_engine import plan_host_bitap

    lib, jlib = tnative.load(), jload()
    plan = plan_host_bitap(m)
    for h in (hay, hay[:1000], b"x"):
        u8 = np.frombuffer(h, np.uint8)
        if plan is not None:
            btab, seed, endmask = plan
            for nt in (1, 4):
                args = (btab.ctypes.data, seed, endmask, u8.ctypes.data, len(u8), got_eng.overlap,
                        nt)
                assert lib.am_bitap_count_mt(*args) == jlib.am_bitap_count_mt(*args)
            args = (btab.ctypes.data, seed, endmask, u8.ctypes.data, len(u8))
            assert lib.am_bitap_first(*args) == jlib.am_bitap_first(*args)
        if prefilter.eligible(m.needles):
            pf = prefilter.PrefilterEngine(m.needles)
            args = pf._args(u8)
            assert lib.am_prefilter_first(*args) == jlib.am_prefilter_first(*args)
            for nt in (1, 4):
                assert (lib.am_prefilter_count(*args, nt) == jlib.am_prefilter_count(*args, nt)
                        == jprefilter.PrefilterEngine(jm.needles).count(h, nt))
    assert tnative.load() is tnative.load()
    assert os.path.dirname(tnative._so_path()).endswith(os.path.join("alfred_margaret_tpu_torch",
                                                                      "_build"))


def _sites(rng, n, k):
    """``k`` sorted, disjoint ``[start, end)`` sites in ``[0, n)``, some empty."""
    cuts = np.sort(rng.choice(n + 1, size=2 * k, replace=False))
    s, e = cuts[0::2].astype(np.int64), cuts[1::2].astype(np.int64)
    e[::3] = s[::3]
    return s, e


@pytest.mark.parametrize("n,k,threads", [(0, 0, 4), (50, 5, 1), (1 << 13, 300, 4),
                                         ((1 << 21) + 7, 2000, 2)])
def test_native_replacer_entry_points_match_jax(n, k, threads):
    """``am_splice``, ``am_splice_mt``, ``am_splice_multi`` and
    ``am_remove_overlap`` of the port's library against the JAX package's on
    seeded sites (2 MiB with two threads takes the threaded splices)."""
    from alfred_margaret_tpu.native import build as jbuild

    try:
        jlib = jbuild.load()
    except NativeUnavailable:
        pytest.skip("the JAX package's native library does not build here")
    lib = tnative.load()
    rng = np.random.default_rng(n + k)
    data = rng.integers(0, 256, size=max(n, 1)).astype(np.uint8)[:n]
    s, e = _sites(rng, n, k) if k else (np.zeros(0, np.int64), np.zeros(0, np.int64))
    repl = np.frombuffer(b"<replacement>", np.uint8)
    cap = n + k * len(repl) + 1

    def run(name, lib_, *args):
        out = np.zeros(cap, np.uint8)
        wrote = getattr(lib_, name)(data.ctypes.data, n, s.ctypes.data, e.ctypes.data, k,
                                    *args, out.ctypes.data, *([threads] if name != "am_splice"
                                                              else []))
        return wrote, out

    for name in ("am_splice", "am_splice_mt"):
        args = (repl.ctypes.data, len(repl))
        (wg, og), (ww, ow) = run(name, lib, *args), run(name, jlib, *args)
        assert wg == ww == n + k * len(repl) - int(np.sum(e - s))
        np.testing.assert_array_equal(og, ow)
    blob = np.frombuffer(b"ABCxyz", np.uint8)
    off = np.array([0, 0, 1, 3, 6], np.int64)  # four replacements, the first empty
    rid = rng.integers(0, 4, size=k).astype(np.int32)
    args = (blob.ctypes.data, off.ctypes.data, rid.ctypes.data)
    (wg, og), (ww, ow) = (run("am_splice_multi", lib, *args), run("am_splice_multi", jlib, *args))
    assert wg == ww
    np.testing.assert_array_equal(og, ow)
    # Overlapping, end-sorted matches for the overlap removal.
    ends = np.sort(rng.integers(1, max(n, 2), size=k)).astype(np.int64)
    starts = np.maximum(ends - rng.integers(0, 9, size=k), 0).astype(np.int64)
    kept = []
    for lib_ in (lib, jlib):
        ks, ke = np.zeros(k, np.int64), np.zeros(k, np.int64)
        m = lib_.am_remove_overlap(starts.ctypes.data, ends.ctypes.data, k, ks.ctypes.data,
                                   ke.ctypes.data)
        kept.append((m, ks[:m].tolist(), ke[:m].tolist()))
    assert kept[0] == kept[1]


@pytest.mark.parametrize("native", [True, False])
def test_replacer_host_helpers_match_jax(monkeypatch, native):
    """The Replacer's splices, overlap removal, window merge and Python window
    scan against the JAX package's, with the host C++ helpers and without
    them (both packages read their own ``utf8._native_lib``)."""
    from alfred_margaret_tpu import replacer as jrep

    from alfred_margaret_tpu_torch import replacer as trep

    if not native:
        for mod in (tutf8, jutf8):
            monkeypatch.setattr(mod, "_NATIVE_LIB", None)
            monkeypatch.setattr(mod, "_NATIVE_TRIED", True)
    rng = np.random.default_rng(21)
    n = 5000
    data = rng.integers(97, 100, size=n).astype(np.uint8)
    s, e = _sites(rng, n, 200)
    for f in ("_splice_np", "_splice"):
        got = getattr(trep, f)(data, s, e, b"XY")
        want = getattr(jrep, f)(data, s, e, b"XY")
        assert bytes(got) == bytes(want)
    g_view, g_obj = trep._splice_owned(data, s, e, b"Q")
    w_view, w_obj = jrep._splice_owned(data, s, e, b"Q")
    assert g_obj == w_obj and bytes(g_view) == bytes(w_view)
    ends = np.sort(rng.integers(1, n, size=300)).astype(np.int64)
    starts = np.maximum(ends - rng.integers(0, 9, size=300), 0)
    for g, w in zip(trep._remove_overlap(starts, ends), jrep._remove_overlap(starts, ends)):
        np.testing.assert_array_equal(g, w)
    rids = rng.integers(0, 3, size=len(s)).astype(np.int32)
    tvals = [trep.Payload(0, 1, 1, r) for r in (b"", b"ab", b"long")]
    jvals = [jrep.Payload(0, 1, 1, r) for r in (b"", b"ab", b"long")]
    assert (trep._splice_multi_bytes(data, s, e, rids, tvals)
            == jrep._splice_multi_bytes(data, s, e, rids, jvals))
    wb = np.sort(rng.integers(0, n, size=50))
    we = np.minimum(wb + rng.integers(1, 200, size=50), n)
    for g, w in zip(trep._merge_windows(wb, we), jrep._merge_windows(wb, we)):
        np.testing.assert_array_equal(g, w)
    mb, me = trep._merge_windows(wb, we)
    pairs = [("ab", 0), ("bca", 1), ("c", 2)]
    for g, w in zip(trep._scan_segments_py(ac.build(pairs), bytes(data), mb, me),
                    jrep._scan_segments_py(jac.build(pairs), bytes(data), mb, me)):
        np.testing.assert_array_equal(g, w)


def _function_dumps(path, skip=()):
    """``ast.dump`` of every function and method of a module, by qualified
    name, docstrings dropped."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.ClassDef)):
                name = prefix + child.name
                if isinstance(child, ast.FunctionDef) and name not in skip:
                    body = child.body
                    if body and isinstance(body[0], ast.Expr) and isinstance(
                            getattr(body[0], "value", None), ast.Constant):
                        body = body[1:]
                    out[name] = ast.dump(ast.Module(body=body, type_ignores=[]))
                walk(child, name + ".")

    walk(tree, "")
    return out


#: Copied modules and the functions whose port differs on purpose: the
#: ``device`` keyword, the dropped relay branch and the composed engine read
#: through ``_composed``'s result (replacer), the ``device`` keyword
#: (splitter and the Boyer-Moore searchers, which hand it to their AC route),
#: the knobs the port keeps (config).
BM_SEARCHER_DIFFER = {"Searcher.__init__", "Searcher.build", "Searcher.build_with_values",
                      "Searcher.build_needle_id_searcher", "Searcher._ac_searcher"}
COPIES = [
    ("replacer.py", {"Replacer.build", "Replacer.load_npz", "Replacer.compose",
                     "Replacer.from_json", "Replacer.run_with_limit", "Replacer._run_incremental"}),
    ("splitter.py", {"Splitter.__init__", "Splitter.build", "Splitter.from_json"}),
    ("boyer_moore/__init__.py", set()), ("boyer_moore/automaton.py", set()),
    ("boyer_moore/replacer.py", set()),
    ("boyer_moore/searcher.py", BM_SEARCHER_DIFFER),
    ("boyer_moore_ci/__init__.py", set()), ("boyer_moore_ci/automaton.py", set()),
    ("boyer_moore_ci/replacer.py", set()),
    ("boyer_moore_ci/searcher.py", BM_SEARCHER_DIFFER),
    ("ops/streaming.py", set()),
    # The port keeps four knobs: no stream count, time tile or interpret mode;
    # ``AMT_ENGINE`` takes the JAX name ``pallas`` through ``engine_name``.
    ("utils/config.py", {"EngineConfig.from_env", "engine_name"}),
    ("native/prefilter.py", set()),
    ("models/nfa_oracle.py", set()),
    # The tools: the reference protocol's modules and the table generator,
    # which writes beside its own module (the port's ``utils/_data``).
    ("bench/dataformat.py", set()), ("bench/timing.py", set()), ("bench/naive.py", set()),
    ("bench/report.py", set()), ("bench/driver.py", set()),
    ("utils/_gen_unicode_tables.py", set()), ("cli.py", set()),
    # ``--device`` and the port's engines (``test_torch_cli.py`` and
    # ``test_torch_bench.py`` hold their behaviour against the originals).
    ("bench/countmatches.py", {"count_with_engine", "main"}), ("bench/micro.py", {"main"}),
]


@pytest.mark.parametrize("rel,differ", COPIES, ids=[c[0] for c in COPIES])
def test_copied_modules_match_jax(rel, differ):
    """Every function of a copied module is the original's, statement for
    statement, but for the ones listed, whose behaviour the port's own tests
    hold against the original (``test_torch_replacer.py``,
    ``test_torch_splitter.py``, ``test_torch_boyer_moore.py``,
    ``test_torch_config.py``)."""
    got = _function_dumps(os.path.join(REPO, "alfred_margaret_tpu_torch", rel), differ)
    want = _function_dumps(os.path.join(REPO, "alfred_margaret_tpu", rel), differ)
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name


#: Functions copied into modules that are not copies as a whole.
FUNCTION_COPIES = [
    ("models/ac.py", ("debug_build_dot", "AcMachine.nbytes", "AcMachine.state_dtype")),
    ("native/cpp_engine.py", ("CppAcEngine.memscan_baseline",)),
    ("ops/grouped.py", ("partition_needles",)),
    ("utils/trace.py", ("ScanStats.bytes_per_second", "ScanStats.record", "ScanStats.as_dict")),
]


@pytest.mark.parametrize("rel,names", FUNCTION_COPIES, ids=[c[0] for c in FUNCTION_COPIES])
def test_copied_functions_match_jax(rel, names):
    """Each function is the original's, statement for statement."""
    got = _function_dumps(os.path.join(REPO, "alfred_margaret_tpu_torch", rel))
    want = _function_dumps(os.path.join(REPO, "alfred_margaret_tpu", rel))
    for name in names:
        assert name in want and got.get(name) == want[name], name


def test_partition_needles_matches_jax():
    from alfred_margaret_tpu.ops.grouped import partition_needles as jpartition

    from alfred_margaret_tpu_torch.ops.grouped import partition_needles

    for needles, rows in ((CONFIG2, 2), (CONFIG2 + CONFIG2[:7], 1), (["ab", "ab", "b"], 48)):
        want = jpartition(jac.build([(n, i) for i, n in enumerate(needles)]), max_rows=rows)
        got = partition_needles(ac.build([(n, i) for i, n in enumerate(needles)]), max_rows=rows)
        assert got == want and sum(map(len, got)) == len(needles)
    m = ac.build([("abcdefghijklmnopqrstuvwxyz" * 8, 0)])
    with pytest.raises(pallas_scan.CapacityError):
        partition_needles(m, max_rows=1)


@pytest.mark.parametrize("name,needles", NEEDLE_SETS[:4], ids=[c[0] for c in NEEDLE_SETS[:4]])
def test_native_single_core_entry_points_match_jax(name, needles):
    """``am_scan_count``, ``am_scan_states`` and ``am_memscan_baseline`` (the
    single-core baseline's) of the port's library against the JAX
    package's, on seeded corpora of every length mod 8."""
    from alfred_margaret_tpu.native import build as jbuild
    from alfred_margaret_tpu.native.cpp_engine import CppAcEngine as Original

    try:
        jlib = jbuild.load()
    except NativeUnavailable:
        pytest.skip("the JAX package's native library does not build here")
    lib = tnative.load()
    m = ac.build([(n, i) for i, n in enumerate(needles)])
    delta = np.ascontiguousarray(m.delta, np.int32)
    mc = np.ascontiguousarray(m.match_count, np.int32)
    hay = _hay(needles, seed=4)
    for n in (0, 1, 7, 8, 1000, len(hay)):
        u8 = np.frombuffer(hay[:n], np.uint8)
        want_count = jlib.am_scan_count(delta.ctypes.data, mc.ctypes.data, m.n_states,
                                        u8.ctypes.data, n)
        assert lib.am_scan_count(delta.ctypes.data, mc.ctypes.data, m.n_states, u8.ctypes.data,
                                 n) == want_count == ac.count_matches(m, hay[:n])
        got, want = np.zeros(n, np.int32), np.zeros(n, np.int32)
        fg = lib.am_scan_states(delta.ctypes.data, m.n_states, u8.ctypes.data, n, got.ctypes.data)
        fw = jlib.am_scan_states(delta.ctypes.data, m.n_states, u8.ctypes.data, n,
                                 want.ctypes.data)
        assert fg == fw
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, CppAcEngine(m).final_states(hay[:n]))
        assert (CppAcEngine(m).memscan_baseline(hay[:n])
                == Original(jac.build([(x, i) for i, x in enumerate(needles)])).memscan_baseline(
                    hay[:n]) == lib.am_memscan_baseline(u8.ctypes.data, n))


def test_host_bitap_oracle_copy_matches_jax():
    """``plan_host_bitap``, ``plan_host_bitap_ci`` and ``CppBitapEngine`` of
    the port's ``native/cpp_engine.py`` are the original's, statement for
    statement (``test_torch_config.py`` holds their answers)."""
    got = _function_dumps(os.path.join(REPO, "alfred_margaret_tpu_torch", "native",
                                       "cpp_engine.py"))
    want = _function_dumps(os.path.join(REPO, "alfred_margaret_tpu", "native", "cpp_engine.py"))
    names = [n for n in want if n.startswith(("plan_host_bitap", "CppBitapEngine."))]
    assert len(names) == 9  # with plan_host_bitap_ci's inner pack
    for name in names:
        assert got[name] == want[name], name


@pytest.mark.parametrize("args", [
    (["tshirt", "shirts"], 1 << 12, 0.01, 3), (CONFIG2, 5000, 0.05, 5), ([], 300, 0.5, 0),
    (["abc"], 10, 0.0, 1),
])
def test_synth_corpus_matches_jax(args):
    needles, size, frac, seed = args
    got = tdata.synth_corpus(needles, size, hit_fraction=frac, seed=seed)
    assert got == jdata.synth_corpus(needles, size, hit_fraction=frac, seed=seed)
    assert len(got) == size


def test_engine_types_match_jax():
    assert tengine.AUTO_PYTHON_THRESHOLD == jengine.AUTO_PYTHON_THRESHOLD

    def fields(cls):
        return [f.name for f in dataclasses.fields(cls)]

    # The JAX package's, IgnoreCase fields included.
    assert fields(tengine.StagedHaystack) == fields(jengine.StagedHaystack)
    assert fields(tengine.MatchSet) == fields(jengine.MatchSet)
    assert tengine.MatchEngine.AUTO_COMPOSE_BYTES == jengine.MatchEngine.AUTO_COMPOSE_BYTES
    assert tengine.COMPOSED_CI_MAX_STATES == jamt.utils.config.DEFAULT.composed_ci_max_states
    staged = tengine.StagedHaystack(case=port.CASE_SENSITIVE, data=np.zeros(7, np.uint8))
    assert len(staged) == 7 and not tengine._has_device(staged) and not tengine._has_device(b"x")
    staged.device = object()
    assert tengine._has_device(staged)
    assert len(tengine.MatchSet(np.zeros(3, np.int64), np.zeros(3, np.int32))) == 3


def test_searcher_surface_matches_jax():
    for needles in ([], ["tshirt", "shirts", "shorts"], CONFIG2):
        want = jamt.Searcher.build(jamt.CASE_SENSITIVE, needles, engine="python")
        got = port.Searcher.build(port.CASE_SENSITIVE, needles, engine="python", device="cpu")
        assert got.to_json() == want.to_json()
        assert repr(got) == repr(want) and got.num_needles == want.num_needles
        assert got.needles == want.needles
        np.testing.assert_array_equal(got.automaton.delta, want.automaton.delta)
    pairs = [("ab", 1), ("cd", [2, 3]), ("ef", None)]
    want = jamt.Searcher.build_with_values(jamt.CASE_SENSITIVE, pairs)
    got = port.Searcher.build_with_values(port.CASE_SENSITIVE, pairs, device="cpu")
    assert got.to_json() == want.to_json()
    same = port.Searcher.build_with_values(port.CASE_SENSITIVE, pairs, device="cpu")
    assert got == same and hash(got) == hash(same)
    assert got != port.Searcher.build_with_values(port.CASE_SENSITIVE, pairs[:2], device="cpu")
    assert not isinstance(got, jamt.Searcher)


def test_npz_artifact_matches_jax(tmp_path):
    values = [1, None, b"\x00\xff", ("t", [2, {"k": (3,)}]), "s", 2.5, True]
    needles = ["tshirt", "shirts", "ab", "b", "café", "", "ab"]
    pairs = list(zip(needles, values))
    jm, tm = jac.build(pairs), ac.build(pairs)
    extra = {"caseSensitivity": "CaseSensitive"}
    ac.save_npz(tm, str(tmp_path / "port.npz"), extra=extra)
    jac.save_npz(jm, str(tmp_path / "jax.npz"), extra=extra)
    for path in ("port.npz", "jax.npz"):
        want, want_extra = jac.load_npz(str(tmp_path / path), with_extra=True)
        got, got_extra = ac.load_npz(str(tmp_path / path), with_extra=True)
        assert got_extra == want_extra == extra
        for f in ("delta", "out_offset", "out_values", "match_count", "values", "needles",
                  "max_needle_bytes"):
            w, g = getattr(want, f), getattr(got, f)
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w, err_msg=f)
            else:
                assert g == w == getattr(tm, f), f
    with pytest.raises(TypeError, match="cannot persist"):
        ac.save_npz(ac.build([("a", object())]), str(tmp_path / "bad.npz"))

    s = port.Searcher.build_with_values(port.CASE_SENSITIVE, pairs, device="cpu")
    s.save_npz(str(tmp_path / "s.npz"))
    back = port.Searcher.load_npz(str(tmp_path / "s.npz"), device="cpu")
    assert back == s and back.needles == s.needles
    hay = _hay(needles)
    assert back.count_matches(hay) == jamt.Searcher.load_npz(str(tmp_path / "s.npz"),
                                                              engine="python").count_matches(hay)


# -- the port stands alone ----------------------------------------------------------

_GUARD = """
import importlib, pkgutil, sys
import alfred_margaret_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "alfred_margaret_tpu"
             or m.startswith("alfred_margaret_tpu."))
print(len(names), bad)
"""


def test_port_imports_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    n, bad = proc.stdout.strip().split(" ", 1)
    assert int(n) >= 55 and bad == "[]", proc.stdout


def test_chip_smoke_names_no_jax_module():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "alfred_margaret_tpu_torch" in names
    bad = [n for n in names if n == "alfred_margaret_tpu" or n.startswith("alfred_margaret_tpu.")
           or n.split(".")[0] in ("jax", "jaxlib")]
    assert not bad, bad


# -- devices default to "cuda" ------------------------------------------------------


def test_entry_points_default_to_cuda():
    for fn in (port.Searcher.__init__, port.Searcher.build, port.Searcher.build_with_values,
               port.Searcher.load_npz, port.MatchEngine.__init__, port.make_engine, comb_scan.make_engine,
               pallas_scan.DenseAcEngine.__init__, comb16_scan.Comb16AcEngine.__init__,
               xla_scan.XlaAcEngine.__init__, port.Searcher.build_needle_id_searcher,
               port.Searcher.from_json, port.Replacer.build, port.Replacer.from_json,
               port.Replacer.load_npz, port.Splitter.__init__, port.Splitter.build,
               port.Splitter.from_json, bm.Searcher.__init__, bm.Searcher.build,
               bm.Searcher.build_with_values, bm.Searcher.build_needle_id_searcher,
               bmci.Searcher.__init__, bmci.Searcher.build, bmci.Searcher.build_with_values,
               bmci.Searcher.build_needle_id_searcher):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    if torch.cuda.is_available():
        return
    m = ac.build([("tshirt", 0)])
    for call in (lambda: port.Searcher.build(port.CASE_SENSITIVE, ["tshirt"]),
                 lambda: port.Searcher.build(port.IGNORE_CASE, ["tshirt"]),
                 lambda: port.Searcher(port.CASE_SENSITIVE, [(b"tshirt", 0)]),
                 lambda: port.MatchEngine(m),
                 lambda: port.make_engine(m),
                 lambda: bitap_scan.BitapAcEngine(m),
                 lambda: xla_scan.XlaAcEngine(m),
                 lambda: comb16_scan.Comb16AcEngine(ac.build([(n, 0) for n in CONFIG2])),
                 lambda: port.Replacer.build(port.CASE_SENSITIVE, [("a", "b")]),
                 lambda: port.Replacer.from_json(
                     port.Replacer.build(port.IGNORE_CASE, [("a", "b")], device="cpu").to_json()),
                 lambda: port.Splitter.build(","),
                 lambda: port.Splitter(b"\xff"),
                 lambda: port.Searcher.build_needle_id_searcher(port.CASE_SENSITIVE, ["a"]),
                 lambda: bm.Searcher.build(["a", "b"]),
                 lambda: bmci.Searcher.build_needle_id_searcher(["k"])):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
