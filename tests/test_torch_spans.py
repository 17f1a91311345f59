"""The port's spans at its layer boundaries (``utils/trace.py:span``).

With no profiler running a span is a shared no-op and never enters
``record_function``; under ``torch.profiler.profile`` every span the table
of ``PERF.md`` §3 names appears, nested under its layer's parent, with an
exact count per operation: one ``amt.api.*`` a public call, one
``amt.prep`` a dispatch, one ``amt.stream.chunk`` a chunk, one
``amt.readback`` and one ``amt.reduce`` a staging counted, two
``amt.stage.host`` a streamed chunk (its slice and the writable copy), one
``amt.stage.host.split`` inside a ring slice's ``amt.stage.host`` where the
slice is copied on the intra-op threads and none where it is shorter than
``PARALLEL_COPY_BYTES``, one ``amt.stream.cold_prefix`` a chunk after the first, one
``amt.host_recount`` a trapped stream, one ``amt.group.build`` a grouped
engine, one ``amt.group.fuse`` a fused table set built, one
``amt.group.pass`` a fused count and one a group's own count, one
``amt.group.screen`` inside the pass of a count by the suffix screen.
Every name the port emits is in ``trace.SPANS``, and every name of
``trace.SPANS`` is in ``PERF.md``.  The
kernels' plain versions run here, so ``amt.launch`` is checked on the card
(``tests/test_torch_gpu.py``).
"""

import collections
import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, Searcher
from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops import xla_scan
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap_ci
from alfred_margaret_tpu_torch.utils import config, trace
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "alfred_margaret_tpu_torch")
CPU = "cpu"
NEEDLES3 = ["tshirt", "shirts", "shorts"]
MIB = 1 << 20

#: Each span's parent among the port's spans (None: no port span is open).
PARENTS = {
    "amt.api": {None},
    "amt.prep": {"amt.api.stage", "amt.api.adopt_staged", "amt.api.count_matches",
                 "amt.api.contains_any", "amt.api.contains_all", "amt.api.all_matches",
                 "amt.api.all_matches_arrays"},
    "amt.stream.chunk": {"amt.api.count_matches", "amt.api.contains_any",
                         "amt.api.all_matches", "amt.api.all_matches_arrays"},
    "amt.stream.cold_prefix": {"amt.stream.chunk"},
    "amt.stage": {"amt.api.stage", "amt.api.adopt_staged", "amt.api.count_matches",
                  "amt.api.contains_any", "amt.api.contains_all", "amt.api.all_matches",
                  "amt.api.all_matches_arrays", "amt.stream.chunk"},
    "amt.stage.host": {"amt.stage", "amt.stream.chunk"},
    "amt.stage.host.split": {"amt.stage.host"},
    "amt.stage.htod": {"amt.stage"},
    "amt.stage.layout": {"amt.stage"},
    "amt.readback": {"amt.api.count_matches", "amt.stream.chunk", "amt.host_recount",
                     "amt.group.pass", None},
    "amt.reduce": {"amt.api.count_matches", "amt.stream.chunk", "amt.host_recount",
                   "amt.group.pass", None},
    "amt.host_recount": {"amt.api.count_matches", "amt.stream.chunk", None},
    # The grouped engine: built where the device engine is first asked for,
    # its fused tables and passes inside the call that first needs them.
    "amt.group.build": {"amt.prep", "amt.api.adopt_staged", "amt.api.count_matches",
                        "amt.api.contains_any", "amt.api.contains_all",
                        "amt.api.all_matches", "amt.api.all_matches_arrays", None},
    "amt.group.fuse": {"amt.api.count_matches", "amt.api.contains_any", "amt.stream.chunk",
                       None},
    "amt.group.pass": {"amt.api.count_matches", "amt.api.contains_any", "amt.stream.chunk",
                       None},
    "amt.group.screen": {"amt.group.pass"},
}


@pytest.fixture
def budget_1mb(monkeypatch):
    """A streaming budget of 2 MiB: chunks of 1 MiB (``EngineConfig`` is
    frozen, so the whole default is replaced)."""
    monkeypatch.setattr(config, "DEFAULT", dataclasses.replace(config.DEFAULT, stream_chunk_mb=1))


def _corpus(n, seed=5):
    return synth_corpus(NEEDLES3, n, hit_fraction=0.01, seed=seed)


def _spans(tmp_path, fn):
    """``fn()``'s result and its port spans ``(name, start, end)`` in start
    order, from the Chrome trace of a CPU profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), -float(e["dur"]), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("amt."))
    return got, [(name, a, a - d) for a, d, name in spans]


def _parent(spans, i):
    """The name of the innermost port span that holds span ``i``, or None
    (``spans`` in start order, the longer first at a tie)."""
    b = spans[i][2]
    for j in range(i - 1, -1, -1):
        if spans[j][2] >= b:
            return spans[j][0]
    return None


def _check_nesting(spans):
    counts = collections.Counter(name for name, _, _ in spans)
    for i, (name, _, _) in enumerate(spans):
        key = "amt.api" if name.startswith("amt.api.") else name
        assert name in trace.SPANS, name
        assert _parent(spans, i) in PARENTS[key], (name, _parent(spans, i))
    return counts


# -- no profiler: no record_function -----------------------------------------------


@pytest.fixture
def no_record_function(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)


def test_no_profiler_no_record_function(no_record_function, budget_1mb):
    s = Searcher.build(CASE_SENSITIVE, NEEDLES3, device=CPU)
    small = _corpus(256 << 10)
    want = ac.count_matches(s.automaton, small)
    assert s.count_matches(s.stage(small)) == want
    big = _corpus(2 * MIB + 12345, seed=6)
    assert s.count_matches(big) == s.count_matches(s.stage(big)) > 0
    assert trace.span("amt.prep") is trace.span("amt.launch")


def test_profiler_flag_follows_the_profiler():
    """``span`` reads ``torch.autograd.profiler._is_profiler_enabled``: a
    torch that renamed it would drop every span without a word."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        with trace.span("amt.prep") as sp:
            assert sp is not None
        assert trace.span("amt.prep") is not trace.span("amt.prep")
    assert torch.autograd.profiler._is_profiler_enabled is False


# -- under the profiler: nesting and exact counts -----------------------------------


def test_staged_count_spans(tmp_path):
    s = Searcher.build(CASE_SENSITIVE, NEEDLES3, device=CPU)
    hay = _corpus(256 << 10)

    def run():
        st = s.stage(hay)
        return s.count_matches(st)

    got, spans = _spans(tmp_path, run)
    assert got == ac.count_matches(s.automaton, hay)
    assert len(hay) >= xla_scan.PARALLEL_COPY_BYTES  # one slice, copied on the threads
    assert _check_nesting(spans) == {
        "amt.api.stage": 1, "amt.api.count_matches": 1, "amt.prep": 2, "amt.stage": 1,
        "amt.stage.host": 1, "amt.stage.host.split": 1, "amt.stage.htod": 1,
        "amt.stage.layout": 1, "amt.readback": 1, "amt.reduce": 1}
    order = [name for name, _, _ in spans]
    assert order.index("amt.stage.host") < order.index("amt.stage.htod") < order.index(
        "amt.stage.layout")


@pytest.mark.parametrize("extra", [12345, MIB])
def test_streamed_count_spans(tmp_path, budget_1mb, extra):
    """A one-shot count past the budget: ``ceil(n / chunk)`` chunks, each
    with its slice, staging, readback and reduce, and a cold prefix for
    every chunk after the first; a chunk's one ring slice is copied on the
    intra-op threads unless it is the short tail of 12,345 bytes and the
    prefix."""
    s = Searcher.build(CASE_SENSITIVE, NEEDLES3, device=CPU)
    big = _corpus(2 * MIB + extra, seed=6)
    chunks = -(-len(big) // MIB)
    W = max(len(n) for n in NEEDLES3) - 1
    staged = [MIB] + [min(MIB, len(big) - c * MIB) + W for c in range(1, chunks)]
    split = sum(m >= xla_scan.PARALLEL_COPY_BYTES for m in staged)
    assert split == (chunks if extra == MIB else chunks - 1)
    got, spans = _spans(tmp_path, lambda: s.count_matches(big))
    assert got == s.count_matches(big) > 0
    assert _check_nesting(spans) == {
        "amt.api.count_matches": 1, "amt.prep": 1, "amt.stream.chunk": chunks,
        "amt.stage": chunks, "amt.stage.host": 2 * chunks, "amt.stage.host.split": split,
        "amt.stage.htod": chunks, "amt.stage.layout": chunks, "amt.readback": chunks,
        "amt.reduce": chunks, "amt.stream.cold_prefix": chunks - 1}
    # Each chunk holds its own slice, staging, readback and reduce.
    for name, a, b in spans:
        if name == "amt.stream.chunk":
            inside = collections.Counter(n for n, x, y in spans if a <= x and y <= b and n != name)
            assert inside["amt.stage.host"] == 2 and inside["amt.stage"] == 1
            assert inside["amt.readback"] == inside["amt.reduce"] == 1


RING = 64 << 10
SPLIT = 16 << 10


@pytest.mark.parametrize("n,slices,split", [
    (SPLIT - 1, 1, 0), (SPLIT, 1, 1), (RING, 1, 1), (3 * RING + SPLIT - 1, 4, 3),
    (3 * RING + SPLIT, 4, 4), (2 * RING + 1, 3, 2)])
def test_split_span_once_a_parallel_slice(tmp_path, monkeypatch, n, slices, split):
    """Slices of 64 KiB, the parallel copy from 16 KiB: one
    ``amt.stage.host`` a slice, and one ``amt.stage.host.split`` inside it
    where the slice is at least the threshold, never below it."""
    monkeypatch.setattr(xla_scan, "RING_SLICE_BYTES", RING)
    monkeypatch.setattr(xla_scan, "PARALLEL_COPY_BYTES", SPLIT)
    monkeypatch.setattr(xla_scan, "_RINGS", {})
    s = Searcher.build(CASE_SENSITIVE, NEEDLES3, device=CPU)
    hay = _corpus(n, seed=n)
    assert len(hay) == n
    st, spans = _spans(tmp_path, lambda: s.stage(hay))
    assert s.count_matches(st) == ac.count_matches(s.automaton, hay)
    counts = _check_nesting(spans)
    assert counts["amt.stage.host"] == slices
    assert counts["amt.stage.host.split"] == split
    for name, a, b in spans:
        if name == "amt.stage.host":
            inside = [x for x, c, d in spans if x == "amt.stage.host.split" and a <= c <= d <= b]
            assert len(inside) <= 1


def test_one_api_span_a_public_call(tmp_path):
    s = Searcher.build(CASE_SENSITIVE, NEEDLES3, device=CPU)
    other = Searcher.build(CASE_SENSITIVE, ["shirt", "short"], device=CPU)
    hay = _corpus(256 << 10)
    st = s.stage(hay)
    calls = {
        "contains_any": lambda: s.contains_any(st),
        "contains_all": lambda: s.contains_all(st),
        "all_matches": lambda: s.all_matches(st),
        "all_matches_arrays": lambda: s.all_matches_arrays(st),
        "adopt_staged": lambda: other.adopt_staged(st),
        "count_matches": lambda: s.count_matches(hay),
    }
    for method, fn in calls.items():
        _, spans = _spans(tmp_path, fn)
        counts = _check_nesting(spans)
        api = {k: v for k, v in counts.items() if k.startswith("amt.api.")}
        assert api == {f"amt.api.{method}": 1}, method
        assert counts["amt.prep"] <= 1, method


def test_composed_ignore_case_delegation_opens_no_second_api_span(tmp_path):
    s = Searcher.build(IGNORE_CASE, NEEDLES3, device=CPU)
    hay = _corpus(256 << 10).upper()
    st = s.stage(hay)
    assert st.composed
    got, spans = _spans(tmp_path, lambda: s.count_matches(st))
    assert got == ac.count_matches(s.automaton, hay, IGNORE_CASE) > 0
    assert _check_nesting(spans) == {"amt.api.count_matches": 1, "amt.prep": 1,
                                     "amt.readback": 1, "amt.reduce": 1}


def _trap_engine():
    needles = ["kilo", "fix", "tshirt"]
    m = ac.build([(n, i) for i, n in enumerate(needles)])
    cm = case_dfa.compose_build(list(zip(m.needles, m.values)), machine=m)
    lay = plan_bitap_ci(cm, max_words=2)
    assert lay.has_trap
    return m, BitapAcEngine(cm, layout=lay, device=torch.device(CPU), n_streams=256, t_tile=32)


def test_host_recount_spans_count_trapped_streams(tmp_path):
    m, eng = _trap_engine()
    words = ["kilo", "fix", "tshirt", "xyz", "shirt"]
    rng = np.random.default_rng(7)
    text = " ".join(words[i] for i in rng.integers(0, len(words), size=3000)).encode()
    for pos, t in [(500, "KİLO"), (9000, "fİx"), (15000, "KKILO")]:
        text = text[:pos] + t.encode() + text[pos:]
    st = eng.stage(text)
    trapped = eng._trapped_streams(eng.stream_counts(st)[1].numpy(), st)
    assert 0 < len(trapped) <= 32
    got, spans = _spans(tmp_path, lambda: eng.count_staged(st))
    assert got == ac.count_matches(m, text, IGNORE_CASE)
    assert _check_nesting(spans) == {"amt.readback": 1, "amt.host_recount": len(trapped),
                                     "amt.reduce": 1}

    # Traps in too many streams: B1's rescan of the staging, one recount.
    dense = eng.stage(("tshirt KİLO xx fix " * 800).encode())
    got, spans = _spans(tmp_path, lambda: eng.count_staged(dense))
    assert got == ac.count_matches(m, ("tshirt KİLO xx fix " * 800).encode(), IGNORE_CASE)
    assert _check_nesting(spans) == {"amt.readback": 2, "amt.host_recount": 1, "amt.reduce": 1}
    inner = [i for i, (n, _, _) in enumerate(spans) if n == "amt.reduce"]
    assert [_parent(spans, i) for i in inner] == ["amt.host_recount"]


# -- the grouped engine ---------------------------------------------------------------


def _grouped(n_needles=80):
    """A grouped engine of three groups whose count and containsAny fuse,
    built in a second; the screen is taken off so that containsAny reaches
    the fused scan."""
    from alfred_margaret_tpu_torch.bench.configs import config5_needles
    from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine

    needles = config5_needles(n_needles)
    m = ac.build([(n.encode(), i) for i, n in enumerate(needles)])
    eng = GroupedAcEngine(m, device=CPU, max_rows=5, n_streams=256, t_tile=64)
    eng._filter_tables = None
    return m, eng, (" ".join(needles) + " zz ").encode() * 4


def test_grouped_no_profiler_no_record_function(no_record_function, monkeypatch):
    m, eng, hay = _grouped()
    st = eng._stage(hay)
    want = ac.count_matches(m, hay)
    assert eng.count_staged(st) == eng.count_staged(st) == want  # the suffix screen
    assert eng.contains_staged(st) is True
    assert eng._fused is not None and eng._fused_sticky is not None
    monkeypatch.setattr(eng, "_screen", None)  # B9
    assert eng.count_staged(st) == want
    monkeypatch.setattr(eng, "_fused", None)  # the groups' own passes
    assert eng.count_staged(st) == want


def test_grouped_spans(tmp_path, monkeypatch):
    """One build (the suffix screen's tables in it); one pass a count by the
    screen, holding one screen span and its readback, and no fused table
    set; the fused table sets for containsAny, each built once; with the
    screen taken away, one fused table set for the count, built once, and
    one pass a fused count; with the fused table set taken away too, one
    pass a group, each holding the group's own readback."""
    (m, eng, hay), spans = _spans(tmp_path, _grouped)
    assert _check_nesting(spans) == {"amt.group.build": 1}
    assert eng.n_groups == 3 and eng._screen is not None
    st = eng._stage(hay)
    want = ac.count_matches(m, hay)
    for _ in range(2):
        got, spans = _spans(tmp_path, lambda: eng.count_staged(st))
        assert got == want
        assert _check_nesting(spans) == {"amt.group.pass": 1, "amt.group.screen": 1,
                                         "amt.readback": 1, "amt.reduce": 1}
        assert [_parent(spans, i) for i, (n, _, _) in enumerate(spans)
                if n in ("amt.readback", "amt.group.screen")] == ["amt.group.pass"] * 2
    got, spans = _spans(tmp_path, lambda: eng.contains_staged(st))
    assert got is True
    assert _check_nesting(spans) == {"amt.group.fuse": 2}  # the count view's, then the sticky
    fresh = _grouped()[1]
    fresh._screen = None
    got, spans = _spans(tmp_path, lambda: fresh.count_staged(st))
    assert got == want
    assert _check_nesting(spans) == {"amt.group.fuse": 1, "amt.group.pass": 1,
                                     "amt.readback": 1, "amt.reduce": 1}
    got, spans = _spans(tmp_path, lambda: fresh.count_staged(st))
    assert got == want
    assert _check_nesting(spans) == {"amt.group.pass": 1, "amt.readback": 1, "amt.reduce": 1}
    assert [_parent(spans, i) for i, (n, _, _) in enumerate(spans)
            if n == "amt.readback"] == ["amt.group.pass"]
    monkeypatch.setattr(eng, "_screen", None)
    monkeypatch.setattr(eng, "_fused", None)
    got, spans = _spans(tmp_path, lambda: eng.count_staged(st))
    assert got == want
    counts = _check_nesting(spans)
    assert counts["amt.group.pass"] == eng.n_groups
    assert "amt.group.fuse" not in counts
    assert [_parent(spans, i) for i, (n, _, _) in enumerate(spans)
            if n == "amt.readback"] == ["amt.group.pass"] * eng.n_groups


# -- the names -----------------------------------------------------------------------

SPAN_CALL = re.compile(r"trace\.span\(")
SPAN_NAME = re.compile(r"trace\.span\(\"([a-z_.]+)\"\)")


def _emitted_names():
    names, calls = set(), 0
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    src = fh.read()
                calls += len(SPAN_CALL.findall(src))
                names.update(SPAN_NAME.findall(src))
                calls -= len(SPAN_NAME.findall(src))
    return names, calls


def test_every_emitted_name_is_in_spans():
    names, unnamed = _emitted_names()
    assert unnamed == 0  # every site names its span literally
    assert len(set(trace.SPANS)) == len(trace.SPANS)
    assert names == set(trace.SPANS)
    assert all(re.fullmatch(r"amt\.[a-z_.]+", n) for n in trace.SPANS)


def test_every_span_is_named_in_perf_md():
    with open(os.path.join(REPO, "PERF.md")) as f:
        perf = f.read()
    for name in trace.SPANS:
        assert f"`{name}`" in perf, name
