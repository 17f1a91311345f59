"""The port's own copies of the JAX package's host layers, and the port's
independence of that package.

The port imports nothing of ``alfred_margaret_tpu``, not even its modules
that do not import ``jax``: it keeps copies of ``utils/case.py``, the parts
of ``utils/utf8.py``, ``models/ac.py``, ``native/`` and
``bench/dataformat.py`` that it uses, and defines ``MatchSet``,
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
    assert tnative.load() is tnative.load()
    assert os.path.dirname(tnative._so_path()).endswith(os.path.join("alfred_margaret_tpu_torch",
                                                                      "_build"))


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
    assert int(n) >= 25 and bad == "[]", proc.stdout


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
               xla_scan.XlaAcEngine.__init__):
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
                 lambda: comb16_scan.Comb16AcEngine(ac.build([(n, 0) for n in CONFIG2]))):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
