"""The segmented schedule of B14, the stride-2 screen ``filter_contains``,
which ``csrc/filter_contains.cu`` runs on the card on the staged pipeline
(``csrc/stage.cuh``).

* The restart: ``restart_bytes`` of a layout is ``max(2 (longest chain - 1),
  2)``, ``2 * floor(L / 2)`` for its longest needle of ``L >= 4`` bytes and 2
  for short needles only; the wrapper refuses a restart that is odd, below
  2 or above the plan's ``overlap + 1`` rounded up to even, and the screen
  passes the layout's restart and the plan's overlap.
* Exactness: the plain version run over every segment of the pair-aligned
  schedule (cuts at even steps) from ``restart`` bytes before its own range
  up to ``min(p_{i+1}, vend)``, the two planes OR-ed
  (``planes_over_segments`` of ``alfred_margaret_tpu_torch/kernels/
  segments.py``), equals the unsplit plain version at k = 1, 2, 3 and 5,
  and on config 2's screen that equals the JAX kernel
  (``make_filter_contains_kernel``) in interpret mode, plane for plane on
  every stream (each stream frozen at its vend in every tile): config 2's
  staged corpus; config 5's 1,000 needles in twelve words; short needles
  only (restart 2); crafted streams with a 3-byte short straddling each cut,
  a chain of the longest length ending at the first pair after a cut, odd
  vends (the last pair reads a byte past vend), vend 0 and padded streams.
* The restart guard: two bytes less than the layout's restart loses a
  plane bit on a crafted stream, for a chain and for a short needle.

Tolerance: exact equality of every plane word.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfred_margaret_tpu.ops import comb16_scan as j16
from alfred_margaret_tpu.ops import filter_scan as jfilter

from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.kernels import segments as seg
from alfred_margaret_tpu_torch.kernels.filter_contains import (
    check_restart,
    filter_contains,
    filter_contains_plain,
)
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.ops import comb16_scan as t16
from alfred_margaret_tpu_torch.ops import filter_scan as tfilter
from alfred_margaret_tpu_torch.ops.filter_scan import FilterTables, plan_filter, restart_bytes

from test_torch_comb16 import CONFIG2, _machines
from test_torch_filter import SHORTS_ONLY, fire_free
from test_torch_grouped import config5_needles
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
KS = [1, 2, 3, 5]
_JAX = {}


def _tables(needles, max_words=3):
    m = ac.build([(n, i) for i, n in enumerate(needles)])
    return m, FilterTables.from_layout(plan_filter(m, max_words=max_words), CPU)


def _config2():
    """(the JAX engine with its screen compiled for T, the port's staging of
    the same corpus, the port's tables, T), built once."""
    if not _JAX:
        jm, tm = _machines(CONFIG2)
        jeng = j16.Comb16PallasAcEngine(jm, n_streams=128, t_tile=32, interpret=True)
        eng = t16.Comb16AcEngine(tm, device=CPU, n_streams=128, t_tile=32)
        hay = np.frombuffer(synth_corpus(CONFIG2, 6 << 10, hit_fraction=0.02, seed=1), np.uint8)
        st, pst = jeng.stage(hay), eng.stage(hay)
        jfilter.filter_contains(jeng, st)  # compiles the JAX kernel for T
        _JAX.update(jeng=jeng, pst=pst, tabs=eng._filter_tables, T=st.plan.time_len)
    return _JAX["jeng"], _JAX["pst"], _JAX["tabs"], _JAX["T"]


def _jax_planes(streams, vend):
    """The JAX kernel's planes on ``[T, 128]`` streams, every tile a boundary
    tile (each stream frozen at its vend, as the port freezes it)."""
    jeng, _, _, T = _config2()
    assert streams.shape == (T, 128)
    out = jeng._filter_fns[T](jnp.zeros(2, jnp.int32), jeng._filter_btab,
                              jnp.asarray(vend.numpy().reshape(1, 128)),
                              jnp.asarray(streams.numpy()))
    return torch.from_numpy(np.array(out).reshape(2, 128))


def _over(streams, vend, tabs, k, restart=None):
    run = lambda x, v, *t: filter_contains_plain(x, v, *t)  # noqa: E731
    return seg.planes_over_segments(run, streams, vend, tabs.args()[:5],
                                    restart=tabs.restart if restart is None else restart,
                                    segments=k)


def _short_bytes(tabs):
    """The short needles' bytes, from their (mask, const) compares."""
    out = []
    for m, c in zip(tabs.short_mask.tolist(), tabs.short_const.tolist()):
        n = (m & 0xFFFFFFFF).bit_length() // 8
        out.append(bytes((c >> (8 * (n - 1 - i))) & 0xFF for i in range(n)))
    return out


def _longest(needles):
    """The longest needle of 4 bytes or more (None: short needles only)."""
    longs = [n.encode() for n in needles if len(n.encode()) >= 4]
    return max(longs, key=lambda n: (len(n), n)) if longs else None


def _crafted(tabs, needles, T, cuts, seed):
    """``[T, 128]`` streams of fire-free filler, and their vends, with at
    every cut p in ``cuts``: a 3-byte short ending at p or p + 1 (straddling
    the cut), the longest needle placed so that its longest chain's last
    pair is the pair at p (the first pair after the cut); odd vends after a
    short whose last byte is vend - 1 or vend; vend 0 over a needle; and
    padded streams."""
    rng = np.random.default_rng(seed)
    a = np.frombuffer(fire_free(T * 128, seed), np.uint8).reshape(T, 128).copy()
    vend = np.full(128, T, np.int64)
    shorts = [x for x in _short_bytes(tabs) if len(x) == 3]
    long_ = _longest(needles) or shorts[0]
    L = len(long_)
    s = 0

    def put(col, at, word):
        a[at:at + len(word), col] = np.frombuffer(word, np.uint8)

    for p in cuts:
        for sh in shorts:
            for end in (p, p + 1):
                if end - 2 >= 0 and end < T:
                    put(s, end - 2, sh)
                    s += 1
        if p - L + 1 >= 1 and p + 1 < T:
            put(s, p - L + 1, long_)  # its last chain pair (b, None) is the pair at p
            s += 1
    for sh in shorts[:1]:
        for v in range(3, T, 16):  # odd vends: the short ends at vend - 1, then at vend
            for end in (v - 1, v):
                put(s, end - 2, sh)
                vend[s] = v
                s += 1
    put(s, 4, long_)
    vend[s] = 0
    s += 1
    assert s < 120, s
    a[:, s:s + 3] = 0
    vend[s:s + 3] = 0
    vend[s + 3:] = rng.integers(0, T + 1, 128 - s - 3)
    return torch.from_numpy(a), torch.from_numpy(vend.astype(np.int32))


# -- the restart -------------------------------------------------------------------------


def test_restart_follows_the_layout():
    for needles, words in ((CONFIG2, 3), (SHORTS_ONLY, 3), (config5_needles(1000), 12),
                           (["ab", "xyz", "qrstuvw"], 3)):
        m, tabs = _tables(needles, words)
        longs = [len(n.encode()) for n in needles if len(n.encode()) >= 4]
        want = 2 * (max(longs) // 2) if longs else 2
        assert tabs.restart == restart_bytes(plan_filter(m, max_words=words)) == want
        check_restart(tabs.restart, m.max_needle_bytes - 1)  # the plan's overlap holds it
    assert _tables(CONFIG2)[1].restart == 8 and _tables(SHORTS_ONLY)[1].restart == 2
    for restart, overlap in ((3, 10), (0, 10), (-2, 10), (10, 7), (12, 9), (2, -1)):
        with pytest.raises(ValueError):
            check_restart(restart, overlap)
    for restart, overlap in ((10, 9), (10, 8), (2, 0), (8, None), (None, 5)):
        check_restart(restart, overlap)


def test_screen_passes_the_layouts_restart_and_the_plans_overlap(monkeypatch):
    seen = []

    def spy(*a):
        seen.append(a[-2:])
        return filter_contains_plain(*a)

    monkeypatch.setattr(tfilter, "filter_kernel", spy)
    m = ac.build([(n, i) for i, n in enumerate(CONFIG2)])
    eng = t16.Comb16AcEngine(m, device=CPU, n_streams=16, t_tile=32)
    st = eng.stage(np.frombuffer(fire_free(3000), np.uint8))
    assert tfilter.filter_contains(eng, st) is False
    assert seen == [(eng._filter_tables.restart, st.plan.overlap)] == [(8, 7)]
    args = (st.streams, st.vend, *eng._filter_tables.args())
    for bad in ((*args[:-1], 9, 7), (*args[:-1], 10, 7), (*args, -1)):
        with pytest.raises(ValueError):
            filter_contains(*bad)


# -- exactness ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", KS)
def test_b14_segments_equal_unsplit_and_jax(k):
    _, pst, tabs, T = _config2()
    streams, vend = pst.streams, pst.vend
    whole = filter_contains_plain(streams, vend, *tabs.args())
    assert whole[0].any() and whole[1].any()
    assert torch.equal(whole, _jax_planes(streams, vend))
    got = _over(streams, vend, tabs, k)
    assert got.dtype == torch.int32 and torch.equal(got, whole)
    # The wrapper on the CPU runs the plain version, whatever the restart.
    assert torch.equal(filter_contains(streams, vend, *tabs.args(), pst.plan.overlap), whole)


@pytest.mark.parametrize("k", KS)
def test_b14_segments_at_twelve_words(k):
    needles = config5_needles(1000)
    m, tabs = _tables(needles, 12)
    assert tabs.btab.shape[0] == 12 and tabs.restart == 10
    rng = np.random.default_rng(k)
    data = np.frombuffer(synth_corpus(needles[:500], 1 << 14, hit_fraction=0.05, seed=11),
                         np.uint8)
    T = 64
    off = rng.integers(0, len(data) - T, 128)
    streams = torch.from_numpy(np.ascontiguousarray(data[off[None, :] + np.arange(T)[:, None]]))
    vend = torch.from_numpy(rng.integers(0, T + 1, 128).astype(np.int32))
    whole = filter_contains_plain(streams, vend, *tabs.args())
    assert whole[1].any() and not whole[0].any()
    assert torch.equal(_over(streams, vend, tabs, k), whole)


@pytest.mark.parametrize("k", KS)
def test_b14_shorts_only_segments(k):
    _, tabs = _tables(SHORTS_ONLY)
    assert tabs.btab.shape[0] == 0 and tabs.restart == 2
    T = 64
    cuts = [lo for _, lo, _ in seg.pair_segment_schedule(T, 5, 2)[1:]]
    streams, vend = _crafted(tabs, SHORTS_ONLY, T, cuts, 3)
    whole = filter_contains_plain(streams, vend, *tabs.args())
    assert whole[0].any() and not whole[1].any()
    assert torch.equal(_over(streams, vend, tabs, k), whole)


@pytest.mark.parametrize("k", KS)
def test_b14_crafted_streams_at_the_cuts(k):
    _, _, tabs, T = _config2()
    sched = seg.pair_segment_schedule(T, k, tabs.restart)
    assert all(lo % 2 == 0 and start % 2 == 0 for start, lo, _ in sched)
    cuts = [lo for _, lo, _ in sched[1:]] or [T // 2]
    streams, vend = _crafted(tabs, CONFIG2, T, cuts, k)
    whole = filter_contains_plain(streams, vend, *tabs.args())
    assert whole[0].any() and whole[1].any()
    assert bool((vend % 2 == 1).any()) and bool((vend == 0).any())
    assert not whole[:, vend == 0].any()
    assert torch.equal(whole, _jax_planes(streams, vend))
    assert torch.equal(_over(streams, vend, tabs, k), whole)


def test_restart_guard():
    """Two bytes less than the layout's restart loses a plane bit on a
    crafted stream: the chain of a 7-byte needle ending at the first pair
    after the cut (both its alignment chains start at the bucket's one seed,
    so its end bit needs all four pairs), and, short needles only, the short
    ending at the cut's first byte (restart 0 clears the rolling window)."""
    for needles, plane in ((["ab", "xyz", "qrstuvw"], 1), (SHORTS_ONLY, 0)):
        _, tabs = _tables(needles)
        assert tabs.restart == (6 if plane else 2)
        T = 64
        p = seg.pair_segment_schedule(T, 2, tabs.restart)[1][1]
        streams, vend = _crafted(tabs, needles, T, [p], 9)
        whole = filter_contains_plain(streams, vend, *tabs.args())
        assert torch.equal(_over(streams, vend, tabs, 2), whole)
        short = _over(streams, vend, tabs, 2, restart=tabs.restart - 2)
        lost = (whole[plane] != short[plane]).nonzero().flatten().tolist()
        assert lost and torch.equal(short[plane] | whole[plane], whole[plane]), needles


def _prefix_planes(streams, vend, tabs, start, hi):
    """A segment's planes after each of its 32-step tiles, scanned from
    ``start`` to ``hi``."""
    out = []
    for t1 in range(start + 32, hi + 32, 32):
        t1 = min(t1, hi)
        v = (vend.long().clamp(max=t1) - start).clamp(min=0).to(torch.int32)
        out.append(filter_contains_plain(streams[start:t1].contiguous(), v,
                                         *tabs.args()[:5]).numpy().astype(np.int64))
    return out


@pytest.mark.parametrize("case", ["config2", "split"])
def test_b14_store_protocol_is_order_free(case):
    """The kernel's writes, tile by tile, in every order of three segments'
    blocks and in interleaved schedules: before a tile a segment reads the
    planes stored so far; after it, it stores its exact plane where it
    became set and takes a stored one as its own, stops without storing
    where the stored planes are final, stores its cand plane at once and
    stops where its own OR-ed with them are final, and stores it at its end
    otherwise (a block whose streams are all final leaves before its first
    tile).  Each
    schedule gives the OR over segments: config 2's staged corpus, and
    crafted streams of the 1-word layout with a short needle in one segment
    and the chain in another, whose planes are final only together."""
    if case == "config2":
        _, pst, tabs, T = _config2()
        streams, vend = pst.streams, pst.vend
    else:
        needles = ["ab", "xyz", "qrstuvw"]
        _, tabs = _tables(needles)
        T = 96
        a = np.frombuffer(fire_free(T * 128, 8), np.uint8).reshape(T, 128).copy()
        a[10:12, :64] = np.frombuffer(b"ab", np.uint8)[:, None]  # segment 0
        a[70:77, :32] = np.frombuffer(b"qrstuvw", np.uint8)[:, None]  # segment 2
        a[40:47, 32:64] = np.frombuffer(b"qrstuvw", np.uint8)[:, None]  # segment 1
        streams, vend = torch.from_numpy(a), torch.full((128,), T, dtype=torch.int32)
    full = 0
    for w in tabs.endmask.tolist():
        full |= w & 0xFFFFFFFF
    sched = seg.pair_segment_schedule(T, 3, tabs.restart)
    tiles = [_prefix_planes(streams, vend, tabs, start, hi) for start, _, hi in sched]
    want = filter_contains_plain(streams, vend, *tabs.args()).numpy()

    def final(e, c):
        return (e != 0) & ((c & 0xFFFFFFFF) == full)

    def run(events):
        out = np.zeros((2, 128), np.int64)
        done = np.zeros((3, 128), bool)
        taken = np.zeros((3, 128), np.int64)  # the exact plane, once stored or read
        for i, j in events:
            pe, pc = out.copy()
            e, c = tiles[i][j]
            e = e | taken[i]
            live = ~done[i]
            out[0] |= np.where(live & (taken[i] == 0), e, 0)  # stored where set
            taken[i] |= np.where(live, e | pe, 0)
            covered, joint = final(pe, pc), final(e | pe, c | pc)
            store = live & ~covered & (joint | (j == len(tiles[i]) - 1))
            out[1] |= np.where(store, c, 0)
            done[i] |= covered | joint | store
        return out

    schedules = [[(i, j) for i in order for j in range(len(tiles[i]))]
                 for order in itertools.permutations(range(3))]
    rng = np.random.default_rng(1)
    for _ in range(20):  # interleaved: each segment's tiles in order
        left = {i: list(range(len(tiles[i]))) for i in range(3)}
        events = []
        while any(left.values()):
            i = int(rng.choice([i for i in left if left[i]]))
            events.append((i, left[i].pop(0)))
        schedules.append(events)
    for events in schedules:
        np.testing.assert_array_equal(run(events).astype(np.int32), want)
    if case == "split":  # final only from two segments' planes together
        assert final(*want.astype(np.int64)).sum() == 64
        assert not any(final(*p[-1]).any() for p in tiles)
