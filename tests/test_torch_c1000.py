"""Config 5's first 1,000 needles, the benchmark's configuration ``c1000``,
through the port's normal path on the CPU, and the keyed reference that
checks it.

``Searcher.build`` of the 1,000 needles, ``stage`` of about 256 KiB drawn
by ``perfbench/corpus.py``, then ``count_matches``: ``make_engine`` holds
no single pass for the set, so ``MatchEngine`` builds ``GroupedAcEngine``,
whose build plans the suffix screen (``kernels/screen_count.py``: every
needle of 5 to 11 bytes), and each count runs ``screen_count`` (its plain
version here) once, in one pass.  The count must equal
``perfbench/reference_keyed.py``, ``perfbench/reference.py`` and
``bytes.find`` (exact), and B9 over every group (the fused tables built
directly) and the per-group route (the groups' own counts, summed) the
same.  The build runs once, under the profiler, so that the
grouped engine's spans are read on the normal path too.  The keyed reference is
held to ``bytes.find`` across block seams and its control to the count of
independent blocks; ``configs/c1000.json`` to config 5's draw; the reader
``group_passes_per_query`` to synthetic traces.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from alfred_margaret_tpu_torch import CASE_SENSITIVE, Searcher
from alfred_margaret_tpu_torch.kernels import comb16_count_grouped_plain, screen_count_plain
from alfred_margaret_tpu_torch.ops import grouped as tgrouped
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine
from perfbench import harness, reference, reference_keyed
from perfbench.corpus import generate, to_host_bytes
from perfbench.harness import Op, TracedRun, Window
from perfbench.tracing import Trace

from test_torch_spans import _check_nesting, _parent, _spans
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

with open(os.path.join(REPO, "perfbench", "configs", "c1000.json")) as _f:
    C1000 = json.load(_f)
NEEDLES = [n.encode() for n in C1000["needles"]]


@pytest.fixture(scope="module")
def c1000(tmp_path_factory):
    """The searcher, the corpus, its staging, and the spans of the staging
    (which builds the grouped engine) and of the first count (which builds
    the fused tables), each recorded under the profiler."""
    tmp = tmp_path_factory.mktemp("c1000")
    s = Searcher.build(CASE_SENSITIVE, C1000["needles"], device="cpu")
    data = to_host_bytes(generate((256 << 10) + 4321, NEEDLES, 2**31 + 7, hit_fraction=0.01,
                                  word_min=3, word_max=9, device="cpu"))
    st, stage_spans = _spans(tmp, lambda: s.stage(data))
    first, count_spans = _spans(tmp, lambda: s.count_matches(st))
    return dict(s=s, data=data, st=st, first=first, stage_spans=stage_spans,
                count_spans=count_spans)


def _b9_calls(monkeypatch):
    calls = []

    def b9(*a):
        calls.append(1)
        return comb16_count_grouped_plain(*a)

    monkeypatch.setattr(tgrouped, "comb16_count_grouped", b9)
    return calls


def _screen_calls(monkeypatch):
    calls = []

    def screen(*a):
        calls.append(1)
        return screen_count_plain(*a[:4])

    monkeypatch.setattr(tgrouped, "screen_count", screen)
    return calls


def test_c1000_count_equals_every_reference(c1000, monkeypatch):
    s, data, st = c1000["s"], c1000["data"], c1000["st"]
    eng = s._engine.device_engine()
    assert isinstance(eng, GroupedAcEngine) and eng.n_groups >= 2
    assert eng._screen is not None and eng._fused is None  # no B9 tables for the count
    want = reference.naive_count(data, NEEDLES)
    assert want > 0
    assert reference_keyed.count(data, NEEDLES, "cpu", block=40_000) == want
    assert reference.count(data, NEEDLES, "cpu") == want
    assert c1000["first"] == want
    calls, screens = _b9_calls(monkeypatch), _screen_calls(monkeypatch)
    assert s.count_matches(st) == want
    assert (calls, screens) == ([], [1])  # one screen pass, no B9
    # B9 over every group, its tables built directly: the same count.
    dst = eng.adopt_staged(st.device)
    f = eng._fused_setup()
    assert f is not None and len(f.groups) >= 2
    assert int(eng.stream_counts(dst)[torch.from_numpy(dst.live_np)].long().sum()) == want
    assert calls == [1]


def test_c1000_per_group_route_is_the_same_count(c1000, monkeypatch):
    s, st = c1000["s"], c1000["st"]
    eng = s._engine.device_engine()
    dst = eng.adopt_staged(st.device)
    calls = _b9_calls(monkeypatch)
    assert sum(e.count_staged(dst) for e in eng.engines) == c1000["first"]
    assert calls == []


def test_c1000_spans_on_the_normal_path(c1000):
    """The grouped engine (the screen's tables with it) is built inside the
    first staging's dispatch; the first count holds one pass and, inside
    it, one screen span, and builds no fused table set."""
    stage = c1000["stage_spans"]
    counts = _check_nesting(stage)
    assert counts["amt.group.build"] == 1 and counts["amt.api.stage"] == 1
    i = [name for name, _, _ in stage].index("amt.group.build")
    assert _parent(stage, i) == "amt.prep"
    first = c1000["count_spans"]
    assert _check_nesting(first) == {"amt.api.count_matches": 1, "amt.prep": 1,
                                     "amt.group.pass": 1, "amt.group.screen": 1,
                                     "amt.readback": 1, "amt.reduce": 1}
    names = [name for name, _, _ in first]
    assert _parent(first, names.index("amt.group.pass")) == "amt.api.count_matches"
    assert _parent(first, names.index("amt.group.screen")) == "amt.group.pass"
    assert _parent(first, names.index("amt.readback")) == "amt.group.pass"


# -- the keyed reference -------------------------------------------------------------


@pytest.mark.parametrize("trial", range(16))
@pytest.mark.parametrize("alphabet", [b"abc ", b"\x00\x7f\x80\xff"])
def test_keyed_reference_equals_find_across_block_seams(trial, alphabet):
    """Needles of 1-16 bytes (one or two packed words, sign bits included),
    duplicates, needles nested in others and needles that share their
    first 8 bytes."""
    rng = random.Random(1000 + trial)
    data = bytes(rng.choice(alphabet) for _ in range(rng.randint(0, 3000)))
    needles = [bytes(rng.choice(alphabet[:3]) for _ in range(rng.randint(1, 16)))
               for _ in range(rng.randint(1, 10))]
    needles += [needles[0], needles[-1][: rng.randint(1, len(needles[-1]))]]
    head = bytes(rng.choice(alphabet[:3]) for _ in range(8))
    needles += [head + bytes(rng.choice(alphabet[:3]) for _ in range(rng.randint(1, 8)))
                for _ in range(3)]
    rng.shuffle(needles)
    want = reference.naive_count(data, needles)
    for block in (1, 2, 7, 9, 64, 1000, 1 << 20):
        assert reference_keyed.count(data, needles, "cpu", block=block) == want


def test_keyed_reference_on_c1000_text():
    data = to_host_bytes(generate((1 << 18) + 12345, NEEDLES, 11, hit_fraction=0.01,
                                  word_min=3, word_max=9, device="cpu"))
    want = reference.naive_count(data, NEEDLES)
    assert want > 0
    assert reference_keyed.count(data, NEEDLES, "cpu", block=4099) == want


@pytest.mark.parametrize("trial", range(6))
def test_keyed_control_is_the_count_of_independent_blocks(trial):
    rng = random.Random(200 + trial)
    data = bytes(rng.choice(b"ab") for _ in range(2000))
    needles = [b"ab", b"bab", b"a", b"abababababab", b"ab"]
    cut = rng.randint(1, 40)
    want = sum(reference.naive_count(data[i : i + cut], needles)
               for i in range(0, len(data), cut))
    assert reference_keyed.count(data, needles, "cpu", block=333, cut=cut) == want
    assert reference.count(data, needles, "cpu", block=333, cut=cut) == want


def test_c1000_is_config_5s_draw():
    """``configs/c1000.json``'s needles are the first 1,000 of
    ``alfred_margaret_tpu_torch/bench/configs.py:config5_needles``, the
    draw repeated here from its definition: config 2's 110 draws from
    ``default_rng(7)``, then 11,000 words of 5 to 11 letters, the first
    distinct ones kept."""
    rng = np.random.default_rng(7)

    def draw(lo, hi, n):
        return ("".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(lo, hi)))
                for _ in range(n))

    list(draw(4, 9, 110))
    want = list(dict.fromkeys(draw(5, 12, 11000)))[:1000]
    assert C1000["needles"] == want and len(set(want)) == 1000
    assert C1000["reduced"] == ["needles", "corpus_bytes"]
    assert C1000["case"] == "CaseSensitive"


# -- the reader of the grouped engine's passes --------------------------------------


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _passes(events, n_ops):
    ops = [Op(0.0, 1.0, 1 << 20, 0, 1) for _ in range(n_ops)]
    run = TracedRun(trace=Trace(events), window=Window(setup_s=1.0, start=0.0, end=1.0, ops=ops),
                    kind="Card", peaks={})
    return harness.reader("metrics", "group_passes_per_query")(run)


WINDOW = _x("window", 100, 1000)


def test_group_passes_fused_is_one_a_query():
    events = [WINDOW, _x("amt.group.pass", 50, 20)]  # before the window
    for q in range(4):
        events += [_x("query", 120 + 200 * q, 150), _x("amt.group.pass", 130 + 200 * q, 100),
                   _x("comb16_count_grouped", 140 + 200 * q, 90, cat="kernel")]
    assert _passes(events, 4) == pytest.approx(1.0)


@pytest.mark.parametrize("groups", [2, 8])
def test_group_passes_per_group_route_is_the_group_count(groups):
    events = [WINDOW]
    for q in range(3):
        events.append(_x("query", 110 + 300 * q, 280))
        events += [_x("amt.group.pass", 120 + 300 * q + 30 * g, 25) for g in range(groups)]
    events.append(_x("amt.group.pass", 1150, 10))  # after the window
    assert _passes(events, 3) == pytest.approx(groups)


def test_group_passes_without_the_span_is_none():
    parent = [WINDOW, _x("query", 120, 300), _x("amt.launch", 130, 5),
              _x("comb16_count_grouped", 140, 90, cat="kernel")]
    assert _passes(parent, 1) is None
    assert _passes(parent + [_x("amt.group.pass", 1200, 10)], 1) is None  # outside
    assert _passes([_x("amt.group.pass", 10, 5)], 1) is None  # no window
    assert _passes([WINDOW, _x("amt.group.pass", 200, 5)], 0) is None  # no operation
