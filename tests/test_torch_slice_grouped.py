"""The port's Searcher on 500 needles of config 5, the grouped tier, end to end
on the CPU.

The first 500 needles of ``BASELINE.json`` config 5
(``alfred_margaret_tpu/bench/configs.py``: random 5-11-letter needles) are
more than the JAX plan lets one comb table hold, so neither package has a
single-pass engine for them and the port's ``MatchEngine`` builds
``GroupedAcEngine`` with the JAX engine's groups, engines and fusion
decisions (three comb32 groups and one comb16 group): ``count_matches``
runs the suffix screen's count once (``kernels/screen_count.py``; B9's
fused tables are built for containsAny and compared with the JAX engine's),
``contains_any`` the 12-word stride-2
screen (B14) and then B11, ``contains_all`` and ``all_matches`` each group's
extraction (B15 and B17 for a comb32 group, the hit bitmap with the comb16
step, B13, for the other), here through the plain torch versions.  Every
answer must equal the JAX ``Searcher`` on its ``cpp`` backend over the same
seeded 64 KiB corpus (tolerance: exact equality), with the fused kernels on
and with the groups' own passes (the fused table sets and the suffix screen
taken away).
"""

import numpy as np
import pytest

import alfred_margaret_tpu as jamt
from alfred_margaret_tpu.native.build import NativeUnavailable
from alfred_margaret_tpu.ops.grouped import GroupedPallasAcEngine

from alfred_margaret_tpu_torch import CASE_SENSITIVE, Searcher, make_engine
from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.kernels import (
    comb16_contains_grouped_plain,
    comb16_count_grouped_plain,
    comb_contains_plain,
    comb_count_plain,
    comb_states_plain,
    filter_contains_plain,
    screen_count_plain,
)
from alfred_margaret_tpu_torch.ops import comb_scan as tcomb
from alfred_margaret_tpu_torch.ops import filter_scan
from alfred_margaret_tpu_torch.ops import grouped as tgrouped
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import CapacityError

from test_torch_filter import DIGITS, fire_free
from test_torch_grouped import config5_needles
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

try:
    from alfred_margaret_tpu.native import build as _native_build

    _native_build.load()
except NativeUnavailable:  # pragma: no cover - the reference needs its C++ engine
    pytestmark = pytest.mark.skip(reason="the JAX package's C++ engine does not build here")

N500 = config5_needles(500)
CORPUS = synth_corpus(N500[:250], 64 << 10, hit_fraction=0.01, seed=11)


@pytest.fixture(scope="module")
def slice_():
    """The port's Searcher and the JAX reference, built once."""
    s = Searcher.build(CASE_SENSITIVE, N500, device="cpu")
    return s, jamt.Searcher.build(jamt.CASE_SENSITIVE, N500, engine="cpp")


def _kernel_calls(monkeypatch):
    """Count the calls of B9, B11, the screen, the suffix screen's count
    (``count_screen``), B15, B16 and B17 (their plain versions run)."""
    calls = {"B9": 0, "B11": 0, "screen": 0, "count_screen": 0, "B15": 0, "B16": 0, "B17": 0}

    def wrap(key, fn):
        def call(*a):
            calls[key] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(tgrouped, "comb16_count_grouped", wrap("B9", comb16_count_grouped_plain))
    monkeypatch.setattr(tgrouped, "comb16_contains_grouped",
                        wrap("B11", comb16_contains_grouped_plain))
    monkeypatch.setattr(filter_scan, "filter_kernel", wrap("screen", filter_contains_plain))
    monkeypatch.setattr(tgrouped, "screen_count",
                        wrap("count_screen", lambda *a: screen_count_plain(*a[:4])))
    monkeypatch.setattr(tcomb, "comb_count", wrap("B15", comb_count_plain))
    monkeypatch.setattr(tcomb, "comb_contains", wrap("B16", comb_contains_plain))
    monkeypatch.setattr(tcomb, "comb_states", wrap("B17", comb_states_plain))
    return calls


#: The JAX engines and the port's that take their place.
PORT_KIND = {"CombPallasAcEngine": "CombAcEngine", "Comb16PallasAcEngine": "Comb16AcEngine",
             "PallasAcEngine": "DenseAcEngine", "BitapAcEngine": "BitapAcEngine"}


def test_config5_500_takes_the_grouped_engine(slice_):
    s, _ = slice_
    with pytest.raises(CapacityError, match="grouped engine"):
        make_engine(s.automaton, "cpu")
    eng = s._engine.device_engine()
    assert type(eng) is GroupedAcEngine and eng.n_groups > 1
    assert eng._fused_setup() is not None and eng._fused_sticky_setup() is not None
    assert len(eng._fused.groups) > 1 and len(eng._fused_sticky.groups) > 1
    assert eng._filter_lay is not None and eng._filter_lay.n_words > 3
    # The JAX engine's groups, engines, summed rows (the input of its fusion
    # guards) and fused partitions.
    jeng = GroupedPallasAcEngine(jamt.models.ac.build(
        [(n, i) for i, n in enumerate(N500)]), interpret=True)
    assert eng.groups == jeng.groups
    kinds = [type(e).__name__ for e in eng.engines]
    assert kinds == [PORT_KIND[type(e).__name__] for e in jeng.engines]
    assert kinds.count("CombAcEngine") == 3 and kinds.count("Comb16AcEngine") == 1
    assert eng.total_rows == jeng.total_rows
    jf, jfs = jeng._fused_setup(), jeng._fused_sticky_setup()
    assert jf is not None and jfs is not None
    assert (len(eng._fused.groups), len(eng._fused_sticky.groups)) == (jf["G"], jfs["G"])


def test_config5_operations_match_jax_searcher(slice_, monkeypatch):
    s, ref = slice_
    calls = _kernel_calls(monkeypatch)
    staged = s.stage(CORPUS)
    assert staged.device is not None
    assert s.count_matches(staged) == ref.count_matches(CORPUS) > 0
    assert calls["count_screen"] == 1 and calls["B9"] == calls["B15"] == calls["B17"] == 0
    assert s.contains_all(staged) is ref.contains_all(CORPUS) is False
    # Each comb32 group counted once (B15), and those with matches wrote their
    # packed states (B17).
    assert calls["B15"] == 3 and 1 <= calls["B17"] <= 3
    ends, vids = s.all_matches_arrays(staged)
    want_ends, want_vids = ref.all_matches_arrays(CORPUS)
    np.testing.assert_array_equal(ends, want_ends)
    np.testing.assert_array_equal(vids, want_vids)
    assert s.all_matches(staged) == ref.all_matches(CORPUS)
    # Unstaged, the Searcher stages the corpus itself.
    assert s.count_matches(CORPUS) == len(want_ends)
    # Every needle present: containsAll is true.
    every = b" ".join(n.encode() for n in N500)
    assert s.contains_all(s.stage(every)) is ref.contains_all(every) is True
    assert s._engine.value_presence(every, CASE_SENSITIVE).all()


def test_config5_contains_any_through_the_screen(slice_, monkeypatch):
    s, ref = slice_
    eng = s._engine.device_engine()
    eng._filter_strikes = 0
    calls = _kernel_calls(monkeypatch)
    # No chain fires: the screen answers False alone.
    clean = fire_free(32 << 10, seed=3)
    assert s.contains_any(s.stage(clean)) is ref.contains_any(clean) is False
    assert calls == {"B9": 0, "B11": 0, "screen": 1, "count_screen": 0, "B15": 0, "B16": 0,
                     "B17": 0}
    # Candidates on the digits corpus of config 2b: B11 decides, False, then
    # True with one needle of the last sticky group in it.
    digits = DIGITS * ((32 << 10) // len(DIGITS))
    last = N500[eng._fused_sticky.groups[-1][-1]].encode()
    hit = digits[: len(digits) // 2] + last + digits[len(digits) // 2:]
    assert s.contains_any(s.stage(digits)) is ref.contains_any(digits) is False
    assert calls == {"B9": 0, "B11": 1, "screen": 2, "count_screen": 0, "B15": 0, "B16": 0,
                     "B17": 0} and eng._filter_strikes == 1
    assert s.contains_any(s.stage(hit)) is ref.contains_any(hit) is True
    assert calls == {"B9": 0, "B11": 2, "screen": 3, "count_screen": 0, "B15": 0, "B16": 0,
                     "B17": 0} and eng._filter_strikes == 2
    assert s.contains_any(s.stage(CORPUS)) is ref.contains_any(CORPUS) is True
    assert calls["B11"] == 3


def test_config5_fused_off_is_the_control(slice_, monkeypatch):
    s, ref = slice_
    calls = _kernel_calls(monkeypatch)
    # The groups' own passes, unscreened: no fused table set, no screen.
    eng = s._engine.device_engine()
    for name in ("_fused", "_fused_sticky", "_filter_tables", "_screen"):
        monkeypatch.setattr(eng, name, None)
    monkeypatch.setattr(eng, "_fused_tried", True)
    monkeypatch.setattr(eng, "_fused_sticky_tried", True)
    staged = s.stage(CORPUS)
    digits = DIGITS * ((16 << 10) // len(DIGITS))
    assert s.count_matches(staged) == ref.count_matches(CORPUS)
    assert s.contains_any(staged) is True
    assert s.contains_any(s.stage(digits)) is ref.contains_any(digits) is False
    # The per-group passes: B15 for each comb32 group's count, B16 for its
    # containsAny (the first group hits the config-5 corpus; on the digits
    # corpus every group scans).
    assert calls == {"B9": 0, "B11": 0, "screen": 0, "count_screen": 0, "B15": 3, "B16": 4,
                     "B17": 0}
