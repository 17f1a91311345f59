"""The PyTorch port's Searcher end to end on the CPU.

``Searcher`` (build, stage, count_matches, contains_any, contains_all,
all_matches, all_matches_arrays) on ``device="cpu"`` against the JAX
package's ``Searcher`` with the scalar ``python`` engine, on every backend of
the port's ``MatchEngine``, staged and unstaged; the dispatcher's choice of
bitap, dense, comb32 or ``CapacityError``, on which ``MatchEngine`` builds
the grouped engine (and, for a large set with an empty needle, the
reference scan engine); the
sticky-table overflow answered by
counting; staged haystack checks and unported operations; and that the port
never imports ``jax``.  Tolerance: exact equality of every count, flag and
match list.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import alfred_margaret_tpu as jamt
from alfred_margaret_tpu.bench.dataformat import synth_corpus
from alfred_margaret_tpu.models import ac
from alfred_margaret_tpu.native.build import NativeUnavailable
from alfred_margaret_tpu.ops import bitap_scan as jbitap
from alfred_margaret_tpu.ops.comb_scan import CombPallasAcEngine, make_pallas_engine

import alfred_margaret_tpu_torch as port
from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, MatchEngine, Searcher, make_engine
from alfred_margaret_tpu_torch.kernels import build
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine
from alfred_margaret_tpu_torch.ops.comb_scan import CombAcEngine
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import CapacityError, DenseAcEngine
from alfred_margaret_tpu_torch.ops.xla_scan import XlaAcEngine
from alfred_margaret_tpu_torch.utils import device as device_mod
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEEDLES3 = ["tshirt", "shirts", "shorts"]
TWO_WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf"]
THREE_WORDS = TWO_WORDS + ["hotel", "india", "juliett", "kilo", "lima", "mike"]
PACK30 = [bytes([97 + i % 11, 98 + (i * 3) % 9, 99 + i % 7]).decode() for i in range(30)]
_RNG0 = np.random.default_rng(0)
#: 300 random 8-letter needles, which comb32 holds, and 600, which no
#: single-pass engine holds.
LARGE = ["".join(chr(97 + c) for c in _RNG0.integers(0, 26, size=8)) for _ in range(600)]
BIG = LARGE[:300]


def _machine(needles):
    return ac.build([(n, i) for i, n in enumerate(needles)])


SLICE_CASES = [
    ("bench_bitap", NEEDLES3, synth_corpus(NEEDLES3, 1 << 16, hit_fraction=0.02, seed=3)),
    ("two_words", TWO_WORDS, synth_corpus(TWO_WORDS, 1 << 15, hit_fraction=0.05, seed=4)),
    ("nul_dense", ["a\x00b", "\x00\x00", "xyz"],
     synth_corpus(["a\x00b", "\x00\x00", "xyz"], 1 << 14, hit_fraction=0.05, seed=5)),
    ("thirty_dense", PACK30, synth_corpus(PACK30, 1 << 15, hit_fraction=0.05, seed=6)),
    ("tiny_python", NEEDLES3, b"short tshirts and shorts"),
    ("empty", NEEDLES3, b""),
]


@pytest.mark.parametrize("name,needles,hay", SLICE_CASES, ids=[c[0] for c in SLICE_CASES])
def test_searcher_counts_match_jax_searcher(name, needles, hay):
    ref = jamt.Searcher.build(jamt.CASE_SENSITIVE, needles, engine="python")
    want = ref.count_matches(hay)
    s = Searcher.build(CASE_SENSITIVE, needles, device="cpu")
    assert s.count_matches(hay) == want
    staged = s.stage(hay)
    assert s.count_matches(staged) == want
    if len(hay) >= port.engine.AUTO_PYTHON_THRESHOLD:
        assert staged.device is not None  # device-staged streams
    sv = Searcher.build_with_values(CASE_SENSITIVE, [(n, i) for i, n in enumerate(needles)],
                                    engine="device", device="cpu")
    assert sv.count_matches(hay) == want


_BACKENDS = ["python", "device", "auto"]
try:
    from alfred_margaret_tpu.native import build as _native_build

    _native_build.load()
    _BACKENDS.append("cpp")
except NativeUnavailable:
    pass

OPERATION_CASES = SLICE_CASES + [("miss", NEEDLES3, b"short shirt and sport " * 300)]


@pytest.mark.parametrize("name,needles,hay", OPERATION_CASES, ids=[c[0] for c in OPERATION_CASES])
def test_searcher_operations_match_jax_searcher(name, needles, hay):
    ref = jamt.Searcher.build(jamt.CASE_SENSITIVE, needles, engine="python")
    want_any = ref.contains_any(hay)
    want_all = ref.contains_all(hay)
    want_matches = ref.all_matches(hay)
    want_ends, want_vids = ref.all_matches_arrays(hay)
    for backend in _BACKENDS:
        s = Searcher.build(CASE_SENSITIVE, needles, engine=backend, device="cpu")
        for label, h in (("unstaged", hay), ("staged", s.stage(hay))):
            where = (backend, label)
            assert s.contains_any(h) is want_any, where
            assert s.contains_all(h) is want_all, where
            assert s.all_matches(h) == want_matches, where
            ends, vids = s.all_matches_arrays(h)
            assert ends.dtype == np.int64 and vids.dtype == np.int32, where
            np.testing.assert_array_equal(ends, want_ends)
            np.testing.assert_array_equal(vids, want_vids)
    if name == "miss":
        assert not want_any and not want_all


def test_contains_all_needs_every_needle():
    needles = NEEDLES3 + ["SHORTS"]  # upper case: not in the lower-case corpus
    hay = synth_corpus(NEEDLES3, 1 << 14, hit_fraction=0.05, seed=8)
    for kind in (BitapAcEngine, DenseAcEngine):
        for backend in _BACKENDS:
            s = Searcher.build(CASE_SENSITIVE, needles, engine=backend, device="cpu")
            full = Searcher.build(CASE_SENSITIVE, NEEDLES3, engine=backend, device="cpu")
            if kind is DenseAcEngine:  # the dense engine on bitap-eligible sets
                for x in (s, full):
                    x._engine._device_eng = DenseAcEngine(x.automaton, device="cpu")
            assert s.contains_all(hay) is False and s.contains_any(hay) is True
            assert full.contains_all(full.stage(hay)) is True
        assert type(full._engine.device_engine()) is kind


def test_empty_haystack_and_needles():
    for backend in _BACKENDS:
        s = Searcher.build(CASE_SENSITIVE, NEEDLES3, engine=backend, device="cpu")
        for h in (b"", s.stage(b"")):
            assert s.contains_any(h) is False
            assert s.contains_all(h) is False
            assert s.all_matches(h) == []
            ends, vids = s.all_matches_arrays(h)
            assert len(ends) == len(vids) == 0
            assert ends.dtype == np.int64 and vids.dtype == np.int32
        none = Searcher.build(CASE_SENSITIVE, [], engine=backend, device="cpu")
        assert none.contains_all(b"tshirt") is True and none.contains_all(b"") is True
    for engine in ("python", "cpp", "device"):
        if engine in _BACKENDS:
            me = MatchEngine(_machine(NEEDLES3), engine, device="cpu")
            assert not me.value_presence(b"", CASE_SENSITIVE).any()


def _sticky_overflow_needles():
    """77 random needles whose machine (303 states, 27 byte classes) fits
    the dense table, while its sticky view, one state larger, does not."""
    rng = np.random.default_rng(4)
    return ["".join(chr(97 + c) for c in rng.integers(0, 26, size=int(rng.integers(3, 7))))
            for _ in range(77)]


def test_sticky_capacity_answers_by_count():
    from alfred_margaret_tpu.ops.pallas_scan import CapacityError as JaxCapacityError
    from alfred_margaret_tpu.ops.pallas_scan import PallasAcEngine

    needles = _sticky_overflow_needles()
    m = _machine(needles)
    eng = make_engine(m, "cpu")
    assert type(eng) is DenseAcEngine
    with pytest.raises(CapacityError):
        eng.sticky_tables()
    with pytest.raises(JaxCapacityError):
        PallasAcEngine(m, n_streams=128, interpret=True)._sticky_setup()
    ref = jamt.Searcher.build(jamt.CASE_SENSITIVE, needles, engine="python")
    s = Searcher.build(CASE_SENSITIVE, needles, engine="device", device="cpu")
    hit = b"0123456789 " * 500 + needles[40].encode() + b" 0123" * 100
    miss = b"0123456789 " * 600
    for hay in (hit, miss):
        want = ref.contains_any(hay)
        assert s.contains_any(hay) is want
        assert s.contains_any(s.stage(hay)) is want
    assert s.contains_any(hit) is True


@pytest.mark.parametrize(
    "needles,expect",
    [
        (NEEDLES3, BitapAcEngine),
        (TWO_WORDS, BitapAcEngine),
        (THREE_WORDS, DenseAcEngine),  # 3 registers: over the port's 2-word bitap budget
        (["a\x00b"], DenseAcEngine),  # NUL: pads must clear bitap registers
        (["", "a"], DenseAcEngine),  # empty needle
        (PACK30, DenseAcEngine),  # the JAX package sends this set to comb/comb16
    ],
)
def test_dispatcher_choice(needles, expect):
    eng = make_engine(_machine(needles), "cpu")
    assert type(eng) is expect


@pytest.mark.parametrize("needles", [NEEDLES3, TWO_WORDS, THREE_WORDS, ["x", "x", "yy"], PACK30])
def test_port_bitap_choice_implies_jax_bitap(needles):
    m = _machine(needles)
    if isinstance(make_engine(m, "cpu"), BitapAcEngine):
        jeng = make_pallas_engine(m, interpret=True, n_streams=128, t_tile=32)
        assert isinstance(jeng, jbitap.BitapAcEngine)


def test_dispatcher_amt_bitap_off(monkeypatch):
    # The JAX package's AMT_BITAP=0 changes nothing here: the set decides.
    monkeypatch.setenv("AMT_BITAP", "0")
    assert type(make_engine(_machine(NEEDLES3), "cpu")) is BitapAcEngine


def test_dispatcher_capacity_error():
    # 300 needles overflow comb16 and take comb32, as in the JAX package;
    # for 600, make_engine stays single-pass and raises, and the MatchEngine
    # then builds the grouped engine.
    m = _machine(BIG)
    assert type(make_engine(m, "cpu")) is CombAcEngine
    assert type(make_pallas_engine(m, interpret=True)) is CombPallasAcEngine
    m = _machine(LARGE)
    with pytest.raises(CapacityError, match="the grouped engine"):
        make_engine(m, "cpu")
    assert type(MatchEngine(m, "device", device="cpu").device_engine()) is GroupedAcEngine


def test_dispatcher_empty_needle_in_a_large_set():
    # An empty needle's matches depend on every group's states: no grouped
    # engine, and the device backend falls back to the reference scan engine,
    # as the JAX package falls back to its XLA engine.
    m = _machine([""] + LARGE)
    with pytest.raises(CapacityError, match="empty needle"):
        GroupedAcEngine(m, device="cpu")
    me = MatchEngine(m, "device", device="cpu")
    assert type(me.device_engine()) is XlaAcEngine
    hay = synth_corpus(LARGE, 1 << 13, hit_fraction=0.05, seed=12)
    assert me.count(hay, CASE_SENSITIVE) == ac.count_matches(m, hay)


def test_match_engine_backends_agree():
    m = _machine(NEEDLES3)
    hay = synth_corpus(NEEDLES3, 1 << 14, hit_fraction=0.05, seed=9)
    want = ac.count_matches(m, hay)
    backends = ["python", "device", "auto"]
    try:
        from alfred_margaret_tpu.native import build as native_build

        native_build.load()
        backends.append("cpp")
    except NativeUnavailable:
        pass
    for b in backends:
        assert MatchEngine(m, b, device="cpu").count(hay, CASE_SENSITIVE) == want, b
    auto = MatchEngine(m, device="cpu")
    assert auto._pick(100) == "python" and auto._pick(1 << 14) == "device"
    with pytest.raises(ValueError):
        MatchEngine(m, "pallas", device="cpu")


def test_staged_haystack_checks():
    a = Searcher.build(CASE_SENSITIVE, NEEDLES3, device="cpu")
    b = Searcher.build(CASE_SENSITIVE, NEEDLES3, device="cpu")
    staged = a.stage(b"tshirts " * 1000)
    with pytest.raises(ValueError, match="different searcher"):
        b.count_matches(staged)
    # Another searcher over the same machine shares the staging.
    c = Searcher(CASE_SENSITIVE, a.needles, machine=a.automaton, device="cpu")
    assert c.count_matches(staged) == a.count_matches(staged) == 2000
    staged.case = IGNORE_CASE
    with pytest.raises(ValueError, match="different case mode"):
        a.count_matches(staged)


def test_unported_operations_raise():
    """The operations that raised ``NotImplementedError`` before the rest of
    the reference API was ported (ROADMAP items 8 and 18) now run, with the
    JAX package's results; none raises any more."""
    s = Searcher.build(CASE_SENSITIVE, NEEDLES3, device="cpu")
    j = jamt.Searcher.build(jamt.CASE_SENSITIVE, NEEDLES3)
    hay = b"short tshirts and shorts"
    mapped = s.map_searcher(str)
    assert mapped.needles == j.map_searcher(str).needles
    assert [m.value for m in mapped.all_matches(hay)] == [m.value for m in j.map_searcher(
        str).all_matches(hay)]
    assert (s + s).needles == (j + j).needles and (s + s).count_matches(hay) == 2 * s.count_matches(
        hay)
    assert Searcher.from_json(s.to_json(), device="cpu") == s
    assert Searcher.from_json(j.to_json(), device="cpu").to_json() == j.to_json()
    # Sharding (item 16) is ported: tests/test_torch_parallel.py.
    from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, make_mesh

    assert isinstance(s.distributed(make_mesh(["cpu"] * 2)), DistributedAcEngine)
    assert s.num_needles == 3 and s.device == torch.device("cpu")
    assert s == Searcher.build(CASE_SENSITIVE, NEEDLES3, device="cpu")


def test_devices_are_explicit():
    with pytest.raises(ValueError):
        device_mod.resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            Searcher.build(CASE_SENSITIVE, NEEDLES3, device="cuda")
        # No device given: the card, and never a quiet fall back to the CPU.
        with pytest.raises(RuntimeError, match="is_available"):
            Searcher.build(CASE_SENSITIVE, NEEDLES3)
    assert Searcher.build(CASE_SENSITIVE, NEEDLES3, device="cpu").device == torch.device("cpu")


def test_toolchain_report_keys():
    rep = port.toolchain_report()
    assert set(rep) == {"torch", "torch_cuda", "gpu", "gpu_count", "nvidia_smi", "nvcc"}
    assert rep["torch"] == torch.__version__


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_BUILT", None)
    monkeypatch.setattr(build, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.load()
    assert build.sources() and all(p.endswith(".cu") for p in build.sources())


_SUBPROCESS_SLICE = """
import sys
import numpy as np
import alfred_margaret_tpu_torch as port
from alfred_margaret_tpu.models import ac
needles = ["tshirt", "shirts", "shorts"]
hay = b"short tshirts and shorts galore " * 300
s = port.Searcher.build(port.CASE_SENSITIVE, needles, device="cpu")
got = s.count_matches(s.stage(hay))
assert got == ac.count_matches(s.automaton, hay), got
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine
d = port.Searcher(port.CASE_SENSITIVE, s.needles, machine=s.automaton, device="cpu")
d._engine._device_eng = DenseAcEngine(s.automaton, device="cpu")
assert d.count_matches(hay) == got
want = ac.all_matches(s.automaton, hay)
for eng in ("device", "cpp", "python"):
    for srch in (port.Searcher(port.CASE_SENSITIVE, s.needles, machine=s.automaton, engine=eng,
                               device="cpu"), d):
        staged = srch.stage(hay)
        assert srch.contains_any(staged) and srch.contains_all(staged)
        assert srch.all_matches(staged) == want
        assert len(srch.all_matches_arrays(hay)[0]) == got
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("ok", got)
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["OMP_NUM_THREADS"] = "1"  # as the one_torch_thread fixture, for the plain versions
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS_SLICE],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok ")


def test_chip_smoke_alone_fails(tmp_path):
    # A directory holding chip_smoke.py and nothing else of the repo.
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
