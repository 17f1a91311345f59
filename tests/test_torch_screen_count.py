"""``screen_count``, the grouped engine's count by a suffix screen, on the
CPU: its plain version and the routed ``GroupedAcEngine.count_staged``
against the automaton's own count, B9's plain version and the host C++
engine, and ``bytes.find``.

The cases: config 5's first 1,000 needles on 64 KiB drawn as the benchmark
draws its text; needles given more than once; a needle that is a suffix of
others; needles of 8, 9 and 16 bytes sharing their last bytes; needles
holding NUL over a NUL-padded text; texts shorter than a needle; and dense
matches across every stream seam and segment cut (``run_segments``: each
segment from its scan start, as the kernel cuts a stream).  The plain
version's screen passes are each counted step whose key's bit is set.
Exact equality throughout.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from alfred_margaret_tpu_torch.kernels.screen_count import plan_screen, screen_count_plain
from alfred_margaret_tpu_torch.kernels.segments import run_segments
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine
from perfbench.corpus import generate, to_host_bytes

from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SC = importlib.import_module("alfred_margaret_tpu_torch.kernels.screen_count")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

with open(os.path.join(REPO, "perfbench", "configs", "c1000.json")) as _f:
    C1000 = [n.encode() for n in json.load(_f)["needles"]]


def _find(data: bytes, needles) -> int:
    """Every (needle, end) pair by ``bytes.find``, a needle given twice
    counted twice."""
    total = 0
    for n in needles:
        i = data.find(n)
        while i >= 0:
            total += 1
            i = data.find(n, i + 1)
    return total


def _text(parts, n, seed):
    rng = np.random.default_rng(seed)
    return b"".join(parts[i] for i in rng.integers(0, len(parts), n))


_L8 = [b"abcdefgh", b"xabcdefgh", b"0123456789abcdef", b"9abcdefgh", b"456789abcdefgh"]
_NUL = [b"\x00\x00ab", b"a\x00\x00\x00", b"\x00\x00\x00\x00", b"\x00abc\x00", b"xy\x00z"]

#: name -> (needles, text).
CASES = {
    "duplicates": ([b"abcd", b"abcd", b"bcde", b"xabcd", b"abcd", b"zzzzz"],
                   _text([b"abcde ", b"xabcd", b"zzzzzz", b"q"], 400, 1)),
    "suffix": ([b"tshirts", b"hirts", b"irts", b"shirts", b"shorts"],
               _text([b"tshirts ", b"shorts", b"irts", b"hirt", b" "], 500, 2)),
    "lengths_8_9_16": (_L8, _text(_L8 + [b" ", b"abcdefg"], 400, 3)),
    "nul": (_NUL, b"\x00" * 7 + _text([b"\x00", b"ab", b"a", b"xy", b"z", b"c"], 900, 4)
            + b"\x00" * 9),
    "short_text": ([b"abcd", b"0123456789abcdef"], b"xabcdy"),
    "text_under_a_needle": ([b"abcd", b"0123456789abcdef"], b"abc"),
    "seams": ([b"abcab", b"bcabc", b"cabca", b"abcabcabca"], b"abc" * 3001),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n_streams", [1, 8, 37])
def test_screen_count_equals_the_automaton(name, n_streams):
    needles, data = CASES[name]
    m = ac.build([(n, i) for i, n in enumerate(needles)])
    eng = GroupedAcEngine(m, device=CPU, n_streams=n_streams, t_tile=64)
    tables = eng._screen
    assert tables is not None and tables.key_bytes == min(8, min(map(len, needles)))
    want = _find(data, needles)
    assert CppAcEngine(m).count(data) == ac.count_matches(m, data) == want
    st = eng._stage(data)
    live = torch.from_numpy(st.live_np)
    tables.passes.zero_()
    counts = screen_count_plain(st.streams, st.warm, st.vend, tables)
    assert int(counts[live].long().sum()) == want
    assert int(tables.passes) >= min(1, want)
    # The kernel's segments: each stream cut into pieces restarted the
    # plan's overlap early, each piece's history zero before its start.
    for k in (2, 5):
        seg = run_segments(screen_count_plain, st.streams, st.warm, st.vend, tables,
                           overlap=st.plan.overlap, segments=k)
        assert torch.equal(seg[live], counts[live]), k
    assert eng.count_staged(st) == want  # the route


@pytest.fixture(scope="module")
def c1000():
    m = ac.build([(n, i) for i, n in enumerate(C1000)])
    eng = GroupedAcEngine(m, device=CPU, n_streams=256, t_tile=64)
    data = to_host_bytes(generate((64 << 10) + 123, C1000, 2**32 + 5, hit_fraction=0.01,
                                  word_min=3, word_max=9, device="cpu"))
    return m, eng, data, eng._stage(data)


def test_c1000_screen_equals_b9_and_the_host_engine(c1000):
    m, eng, data, st = c1000
    tables = eng._screen
    assert tables is not None and tables.key_bytes == 5 and tables.bits == SC.BITMAP_BITS
    want = _find(data, C1000)
    assert want > 0 and CppAcEngine(m).count(data) == want
    live = torch.from_numpy(st.live_np)
    tables.passes.zero_()
    counts = screen_count_plain(st.streams, st.warm, st.vend, tables)
    passes = int(tables.passes)
    assert torch.equal(counts[live], eng.stream_counts_plain(st)[live])  # B9, per stream
    assert int(counts[live].long().sum()) == want
    # Every match is a pass; the bitmap's false positives are few.
    assert want <= passes < want + len(data) // 100
    seg = run_segments(screen_count_plain, st.streams, st.warm, st.vend, tables,
                       overlap=st.plan.overlap, segments=3)
    assert torch.equal(seg[live], counts[live])
    assert eng.count_staged(st) == want


def test_plan_screen_tables():
    """Keys, slots and records as the kernel reads them: each distinct
    needle once with its multiplicity, under its key's slot; the bitmap's
    words the keys' hashes; ``KEY_LOAD`` bits a key or more."""
    needles = [b"abcdx", b"abcdx", b"zabcdx", b"qqqqqqqqqq", b"abcdx"]
    t = plan_screen(ac.build([(n, i) for i, n in enumerate(needles)]), CPU)
    assert (t.key_bytes, t.max_bytes, t.slot_bits) == (5, 10, 2)
    assert t.bits == SC.MIN_BITMAP_BITS and int(t.bitmap.ne(0).sum()) == 2  # a word a key
    assert sorted(r[4:6] for r in t.recs.tolist()) == [[5, 3], [6, 1], [10, 1]]
    slots = [r for r in t.slots.tolist() if r[3]]
    assert sorted(r[3] for r in slots) == [1, 2]  # abcdx and zabcdx share their key
    assert len(t.recs) == 3 and int(t.passes) == 0


@pytest.mark.parametrize("needles", [
    [b"abc", b"abcd"],  # a needle under four bytes
    [b"abcd", b"a" * 17],  # one over sixteen
    [b"abcd"] + [b"%dqxqx" % i for i in range(9)],  # nine distinct needles share a key
    [],
], ids=["three_bytes", "seventeen_bytes", "nine_share_a_key", "empty"])
def test_plan_screen_declines(needles):
    m = ac.build([(n, i) for i, n in enumerate(needles)])
    assert plan_screen(m, CPU) is None


def test_plan_screen_takes_eight_sharing_a_key_and_the_limits():
    eight = [b"abcd"] + [b"%dqxqx" % i for i in range(8)]
    assert plan_screen(ac.build([(n, i) for i, n in enumerate(eight)]), CPU) is not None
    assert plan_screen(ac.build([(b"abcd", 0), (b"b" * 16, 1)]), CPU) is not None
    m = ac.build([(b"abcd", 0)])
    m.composed_ci = True  # a composed case-folding machine matches other bytes
    assert plan_screen(m, CPU) is None


def test_overlap_under_the_longest_needle_raises():
    needles = [b"abcd", b"0123456789abcdef"]
    eng = GroupedAcEngine(ac.build([(n, i) for i, n in enumerate(needles)]), device=CPU,
                          n_streams=4, t_tile=64)
    st = eng._stage(b"0123456789abcdef" * 10)
    with pytest.raises(ValueError, match="longest needle"):
        SC.screen_count(st.streams, st.warm, st.vend, eng._screen, 14)
    with pytest.raises(ValueError, match="overlap"):
        SC.screen_count(st.streams, st.warm, st.vend, eng._screen, -1)
    assert int(SC.screen_count(st.streams, st.warm, st.vend, eng._screen, 15)[
        torch.from_numpy(st.live_np)].sum()) == 20
