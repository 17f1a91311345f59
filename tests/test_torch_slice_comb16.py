"""The port's Searcher on config 2's 100 needles, the comb16 tier, end to end
on the CPU.

``BASELINE.json`` config 2 (``alfred_margaret_tpu/bench/configs.py``: 100
random 4-8-letter needles, four of them nested) overflows the dense table, so
the port's dispatcher sends it to ``Comb16AcEngine``: ``count_matches`` runs
B8, ``contains_any`` the stride-2 screen B14 and then B10, ``contains_all``
and ``all_matches`` B6 with the comb16 step (B13), here through the plain
torch versions.  Every answer must equal the JAX ``Searcher`` on its ``cpp``
backend over the same seeded corpus (tolerance: exact equality).
``contains_any`` is held on each way the screen can go: an exact
short-needle hit, a corpus on which no chain fires (the screen alone says
False), candidate fires that B10 decides, and a call after three strikes,
when the screen is no longer asked.
"""

import numpy as np
import pytest
import torch

import alfred_margaret_tpu as jamt
from alfred_margaret_tpu.native.build import NativeUnavailable

from alfred_margaret_tpu_torch import CASE_SENSITIVE, Searcher
from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.kernels import comb16_contains_plain, filter_contains_plain
from alfred_margaret_tpu_torch.ops import filter_scan
from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine


from test_torch_comb16 import CONFIG2
from test_torch_filter import DIGITS, N97, fire_free
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

try:
    from alfred_margaret_tpu.native import build as _native_build

    _native_build.load()
except NativeUnavailable:  # pragma: no cover - the reference needs its C++ engine
    pytestmark = pytest.mark.skip(reason="the JAX package's C++ engine does not build here")

CORPUS = synth_corpus(CONFIG2, 256 << 10, hit_fraction=0.05, seed=5)


def _reference(needles):
    return jamt.Searcher.build(jamt.CASE_SENSITIVE, needles, engine="cpp")


def _kernel_calls(monkeypatch):
    """Count the calls of the screen's and the sticky scan's kernels."""
    calls = {"screen": 0, "sticky": 0}

    def screen(*a):
        calls["screen"] += 1
        return filter_contains_plain(*a)

    def sticky(*a):
        calls["sticky"] += 1
        return comb16_contains_plain(*a)

    monkeypatch.setattr(filter_scan, "filter_kernel", screen)
    monkeypatch.setattr("alfred_margaret_tpu_torch.ops.comb16_scan.comb16_contains", sticky)
    return calls


def test_config2_operations_match_jax_searcher():
    ref = _reference(CONFIG2)
    s = Searcher.build(CASE_SENSITIVE, CONFIG2, device="cpu")
    staged = s.stage(CORPUS)
    eng = s._engine.device_engine()
    assert type(eng) is Comb16AcEngine and staged.device is not None
    assert s.count_matches(staged) == ref.count_matches(CORPUS) > 0
    assert s.contains_all(staged) is ref.contains_all(CORPUS) is True
    absent = CONFIG2 + ["ABSENT"]
    sa = Searcher.build(CASE_SENSITIVE, absent, device="cpu")
    assert sa.contains_all(sa.stage(CORPUS)) is _reference(absent).contains_all(CORPUS) is False
    assert s.all_matches(staged) == ref.all_matches(CORPUS)
    ends, vids = s.all_matches_arrays(staged)
    want_ends, want_vids = ref.all_matches_arrays(CORPUS)
    np.testing.assert_array_equal(ends, want_ends)
    np.testing.assert_array_equal(vids, want_vids)
    # Unstaged, the Searcher stages the corpus itself.
    assert s.count_matches(CORPUS) == len(want_ends)


def test_config2_contains_any_through_the_screen(monkeypatch):
    calls = _kernel_calls(monkeypatch)
    s = Searcher.build(CASE_SENSITIVE, CONFIG2, device="cpu")
    ref = _reference(CONFIG2)
    eng = s._engine.device_engine()
    lay = eng._filter_lay
    assert (lay.n_words, len(lay.shorts)) == (3, 3)

    # An exact short-needle hit: the screen answers True alone.
    assert s.contains_any(s.stage(CORPUS)) is ref.contains_any(CORPUS) is True
    assert calls == {"screen": 1, "sticky": 0}
    # No chain fires: the screen answers False alone.
    clean = fire_free(200 << 10, seed=3)
    assert s.contains_any(s.stage(clean)) is ref.contains_any(clean) is False
    assert calls == {"screen": 2, "sticky": 0} and eng._filter_strikes == 0
    # The digits-and-punctuation corpus of configs.py config 2b: its byte
    # pairs share hash buckets with the needles' letters, so chains fire and
    # the sticky scan says False (a strike); with one needle in it, True.
    digits = (DIGITS * ((200 << 10) // len(DIGITS)))
    hit = digits[: len(digits) // 2] + CONFIG2[7].encode() + digits[len(digits) // 2:]
    assert s.contains_any(s.stage(digits)) is ref.contains_any(digits) is False
    assert calls == {"screen": 3, "sticky": 1} and eng._filter_strikes == 1
    assert s.contains_any(s.stage(hit)) is ref.contains_any(hit) is True
    assert calls == {"screen": 4, "sticky": 2} and eng._filter_strikes == 2


def test_candidate_only_set_and_strikes(monkeypatch):
    """The 97 needles of 4 bytes or more have no short needle, so the screen
    never answers True: candidates go to B10, and after three strikes the
    screen is no longer asked."""
    calls = _kernel_calls(monkeypatch)
    ref = _reference(N97)
    s = Searcher.build(CASE_SENSITIVE, N97, device="cpu")
    eng = s._engine.device_engine()
    assert type(eng) is Comb16AcEngine and not eng._filter_lay.shorts
    # Candidates without a match: B10 says False.
    digits = DIGITS * ((128 << 10) // len(DIGITS))
    assert s.contains_any(s.stage(digits)) is ref.contains_any(digits) is False
    assert calls == {"screen": 1, "sticky": 1} and eng._filter_strikes == 1
    corpus = synth_corpus(N97, 256 << 10, hit_fraction=0.01, seed=6)
    staged = s.stage(corpus)
    for k in (2, 3):
        assert s.contains_any(staged) is ref.contains_any(corpus) is True
        assert calls == {"screen": k, "sticky": k} and eng._filter_strikes == k
    assert k == filter_scan.FILTER_STRIKES
    # The fourth call: the screen is not run, B10 alone decides, also where
    # the screen would have said False.
    assert s.contains_any(staged) is True
    clean = fire_free(64 << 10)
    assert s.contains_any(s.stage(clean)) is ref.contains_any(clean) is False
    assert calls == {"screen": 3, "sticky": 5}


def test_filter_off_is_the_control(monkeypatch):
    calls = _kernel_calls(monkeypatch)
    s = Searcher.build(CASE_SENSITIVE, CONFIG2, device="cpu")
    eng = s._engine.device_engine()
    assert eng._filter_tables is not None
    eng._filter_tables = None  # the unscreened containsAny
    clean = fire_free(64 << 10, seed=4)
    assert s.contains_any(s.stage(CORPUS)) is True
    assert s.contains_any(s.stage(clean)) is False
    assert calls == {"screen": 0, "sticky": 2}
    assert s._engine.device_engine()._filter_tables is None
    assert s.device == torch.device("cpu")
