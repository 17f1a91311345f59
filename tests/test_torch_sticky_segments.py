"""The segmented schedules of the sticky scans B11 (both modes) and the
states scan B17 (``alfred_margaret_tpu_torch/kernels/segments.py``), which
``csrc/comb16_grouped.cu`` and ``csrc/comb_scan.cu`` run on the card.

* B17: the plain ``comb_states`` run over every segment of a schedule, each
  segment keeping the rows of its own range (``stitch_segments``), equals the
  unsplit plain version and the JAX kernel ``_make_comb_states_kernel`` in
  interpret mode in every ``[T, S]`` entry, at k = 1, 2, 3 and 5, on the
  cases of ``test_torch_segments.py``'s B15 tests: a NUL-bearing set with
  overlap 19, single bytes (overlap 0) and a composed IgnoreCase machine.
  Every step is held, not only the counted ones: before ``warm``, past
  ``vend``, on padding.
* B11 with ``n_groups > 1``: the OR over segments (``any_over_segments``)
  equals the unsplit plain version and the JAX fused contains kernel
  (``_make_c16_contains_kernel_dyn``) on a hit corpus, a fire-free corpus
  and crafted streams: a match only in the second segment's warm-up, a
  ``vend`` just before and just after its last byte (inside that warm-up), a
  ``vend`` inside the warm-up with a match after it, padded streams.
* B11's one-group mode: the absorb-or-owner-base combine (``combine_bases``
  over the plain version's per-segment bases) equals the unsplit plain
  version and the JAX kernel with ``n_groups == 1`` on the crafted streams;
  the kernel's write protocol (fill with the root, ``atomicExch`` of the
  absorbing base, ``atomicCAS`` from the root by the owner segment) gives
  that combine under any order of the segments.

Tolerance: exact equality of every entry.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.ops import grouped as jgrouped
from alfred_margaret_tpu.ops.pallas_scan import _boundary_scalars

from alfred_margaret_tpu_torch import convert
from alfred_margaret_tpu_torch.kernels import segments as seg
from alfred_margaret_tpu_torch.kernels.comb import comb_states, comb_states_plain
from alfred_margaret_tpu_torch.kernels.comb16_grouped import (
    comb16_contains_base,
    comb16_contains_base_plain,
    comb16_contains_grouped,
    comb16_contains_grouped_plain,
)
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine

from test_torch_grouped import mid
from test_torch_parallel import _jax_c16_base
from test_torch_segments import B15_CASES, KW, _layout_cases, b15_case
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
KS = [1, 2, 3, 5]


# -- B17 over the schedule -------------------------------------------------------------

_STATES = {}


def _states(name):
    """(JAX states [T, S], the port's staging, B17's args) of a B15 case."""
    if name not in _STATES:
        jeng, st, eng, pst = b15_case(name)
        want = np.asarray(jeng._states_call(st)).reshape(st.plan.time_len, -1)
        args = eng.states_args(pst)
        assert args[-1] == pst.plan.overlap
        _STATES[name] = (want, pst, args[:-1])
    return _STATES[name]


@pytest.mark.parametrize("name", list(B15_CASES))
@pytest.mark.parametrize("k", KS)
def test_b17_segments_equal_unsplit_and_jax(name, k):
    want, pst, args = _states(name)
    K, T = pst.plan.overlap, pst.plan.time_len
    assert _layout_cases(pst)["padded"]
    whole = comb_states_plain(*args)
    assert whole.shape == want.shape
    np.testing.assert_array_equal(whole.numpy(), want)
    assert torch.equal(comb_states(*args, K), whole)  # the wrapper's CPU path
    got = seg.stitch_segments(comb_states_plain, pst.streams, *args[1:], overlap=K, segments=k)
    assert got.dtype == torch.int32 and torch.equal(got, whole)
    assert int((whole >> 27).sum()) > 0
    if name == "long_nul":
        assert K == 19 and T % 3 and T % 5


# -- B11 over the schedule ------------------------------------------------------------

T_CRAFT = 96  # three 32-step tiles; not a multiple of 5
DIGITS = np.frombuffer(b"0123456789 ,;:!", np.uint8)


@pytest.fixture(scope="module")
def sticky():
    """A 650-needle set whose sticky partition (``max_rows=5``) has several
    groups, in both packages (the JAX engine in interpret mode, its fused
    sticky tables converted, and the port's engine, whose own tables equal
    them), the hit and fire-free corpora staged by both, and crafted
    ``[T_CRAFT, 128]`` streams (``_crafted``)."""
    needles, hay = mid(650, 17)
    pairs = [(x, i) for i, x in enumerate(needles)]
    jm, tm = jac.build(pairs), ac.build(pairs)
    kw = dict(max_rows=5, **KW)
    jeng = jgrouped.GroupedPallasAcEngine(jm, interpret=True, unroll=4, **kw)
    eng = GroupedAcEngine(tm, device=CPU, **kw)
    fs = jeng._fused_sticky_setup()
    assert fs is not None and fs["G"] > 1
    tabs = convert.comb16_group_tables_from_jax(fs["stacked"], CPU, sticky=True)
    own = eng._fused_sticky_setup().tables
    for key, v in own.__dict__.items():
        assert torch.equal(v, getattr(tabs, key)) if torch.is_tensor(v) else v == getattr(tabs, key)
    staged = {}
    for label, text in (("hit", hay[:600]), ("fire-free", (DIGITS.tobytes() * 40)[:600])):
        st, pst = jeng._stage(text), eng._stage(text)
        np.testing.assert_array_equal(pst.vend.numpy(), np.asarray(st.vend_t).reshape(-1))
        args = eng.sticky_args(pst)
        assert args[-1] == pst.plan.overlap == 7 and args[2].n_groups == fs["G"]
        staged[label] = (st, pst)
    return jeng, fs, tabs, staged, needles, _crafted(needles, pst.plan.overlap)


def _crafted(needles, K):
    """Digits (no needle) with at most one needle per stream, by kind
    (stream s has kind s % 8; k = 2 cuts T_CRAFT at 48, its second segment
    warming up over [48 - K, 48)):

    0. no needle, random vend;
    1. a needle ending inside the second segment's warm-up, vend T;
    2. the same, vend at its last byte (excluded): no match;
    3. the same, vend just past its last byte (inside the warm-up);
    4. vend inside the warm-up, a needle after it in the second segment;
    5. fully padded (vend 0, zero bytes);
    6, 7. a needle at a random place, random vend (the other cuts)."""
    T, S = T_CRAFT, 128
    # Needles with no other needle inside: nothing matches before their end.
    alone = [x for x in needles if not any(y != x and y in x for y in needles)]
    rng = np.random.default_rng(23)
    streams = rng.choice(DIGITS, size=(T, S)).astype(np.uint8)
    vend = rng.integers(0, T + 1, S).astype(np.int32)
    lo1 = T // 2
    kinds = np.arange(S) % 8
    for s in range(S):
        nd = np.frombuffer(alone[rng.integers(0, len(alone))].encode(), np.uint8)
        kind = kinds[s]
        if kind in (1, 2, 3):
            end = int(rng.integers(lo1 - K + 1, lo1 - 1))  # last byte inside the warm-up
            streams[end - len(nd) + 1:end + 1, s] = nd
            vend[s] = {1: T, 2: end, 3: end + 1}[kind]
        elif kind == 4:
            vend[s] = int(rng.integers(lo1 - K + 1, lo1 + 1))
            end = int(rng.integers(lo1 + len(nd), T))
            streams[end - len(nd) + 1:end + 1, s] = nd
        elif kind == 5:
            vend[s] = 0
            streams[:, s] = 0
        elif kind in (6, 7):
            end = int(rng.integers(len(nd) - 1, T))
            streams[end - len(nd) + 1:end + 1, s] = nd
    return torch.from_numpy(streams), torch.from_numpy(vend)


def _jax_any(jeng, fs, streams, vend):
    """The JAX fused contains kernel on ``[T, 128]`` streams."""
    T, S = streams.shape
    d = fs["dev"]
    v = vend.numpy()
    bscal = jnp.asarray(_boundary_scalars(np.zeros(S, np.int32), v, False))
    return np.asarray(jeng._get_fused_contains_fn(T)(
        bscal, d["gscal"], d["classmap"], d["comb"], d["aux"], d["rootseg"],
        jnp.asarray(v.reshape(-1, 128)), jnp.asarray(streams.numpy()),
    )).reshape(-1)


@pytest.mark.parametrize("corpus", ["hit", "fire-free"])
def test_b11_segments_equal_unsplit_and_jax(sticky, corpus):
    jeng, fs, tabs, staged, _, _ = sticky
    st, pst = staged[corpus]
    want = np.asarray(jeng._get_fused_contains_fn(st.plan.time_len)(
        jeng._fused_bscal(st), fs["dev"]["gscal"], fs["dev"]["classmap"], fs["dev"]["comb"],
        fs["dev"]["aux"], fs["dev"]["rootseg"], st.vend_t, st.streams_dev,
    )).reshape(-1)
    K = pst.plan.overlap
    whole = comb16_contains_grouped_plain(pst.streams, pst.vend, tabs)
    np.testing.assert_array_equal(whole.numpy(), want)
    assert bool(want.any()) is (corpus == "hit")
    assert torch.equal(comb16_contains_grouped(pst.streams, pst.vend, tabs, K), whole)
    for k in KS:
        got = seg.any_over_segments(comb16_contains_grouped_plain, pst.streams, pst.vend, tabs,
                                    overlap=K, segments=k)
        assert got.dtype == torch.int32 and torch.equal(got, whole), k


def test_b11_crafted_segments_equal_unsplit_and_jax(sticky):
    jeng, fs, tabs, staged, _, (streams, vend) = sticky
    K = staged["hit"][1].plan.overlap
    whole = comb16_contains_grouped_plain(streams, vend, tabs)
    np.testing.assert_array_equal(whole.numpy(), _jax_any(jeng, fs, streams, vend))
    kinds = np.arange(streams.shape[1]) % 8
    hit = whole.numpy().astype(bool)
    assert hit[kinds == 1].all() and hit[kinds == 3].all()
    assert not hit[np.isin(kinds, (0, 2, 4, 5))].any()
    for k in KS:
        got = seg.any_over_segments(comb16_contains_grouped_plain, streams, vend, tabs,
                                    overlap=K, segments=k)
        assert torch.equal(got, whole), k
    # k = 2: kind 2's and 3's vends and kind 4's lie in the second
    # segment's warm-up.
    start, lo, _ = seg.segment_schedule(T_CRAFT, 2, K)[1]
    v = vend.numpy()
    assert ((v[np.isin(kinds, (2, 3, 4))] > start) & (v[np.isin(kinds, (2, 3, 4))] <= lo)).all()


def _bases_case(sticky):
    """The crafted streams, the groups to hold one at a time (group 0 and the
    group with the most hits), and the overlap."""
    _, fs, tabs, staged, _, (streams, vend) = sticky
    hits = [int((comb16_contains_base_plain(streams, vend, tabs.group(g))
                 == int(tabs.gscal[g, 1])).sum()) for g in range(tabs.n_groups)]
    return streams, vend, sorted({0, int(np.argmax(hits))}), staged["hit"][1].plan.overlap


def test_b11_one_group_segments_equal_unsplit_and_jax(sticky):
    _, fs, tabs, _, _, _ = sticky
    streams, vend, groups, K = _bases_case(sticky)
    for g in groups:
        one = tabs.group(g)
        whole = comb16_contains_base_plain(streams, vend, one)
        want = _jax_c16_base(fs["stacked"], g, streams.numpy(), vend.numpy(),
                             np.zeros(streams.shape[1], np.int32))
        np.testing.assert_array_equal(whole.numpy(), want)
        root, absorb = int(one.gscal[0, 0]), int(one.gscal[0, 1])
        assert (whole.numpy()[vend.numpy() == 0] == root).all()
        assert torch.equal(comb16_contains_base(streams, vend, one, K), whole)
        for k in KS:
            got = seg.base_over_segments(comb16_contains_base_plain, streams, vend, one,
                                         overlap=K, segments=k)
            assert got.dtype == torch.int32 and torch.equal(got, whole), (g, k)
    assert (whole.numpy() == absorb).any() and (whole.numpy() != absorb).sum() > 8


def test_b11_one_group_write_protocol_is_order_free(sticky):
    """The kernel's writes, in every order of three segments' blocks: the
    launcher fills out with the root base, an absorbing segment exchanges in
    the absorbing base, the owner of step vend - 1 swaps its base in only
    where out still holds the root.  Each order gives ``combine_bases``."""
    _, _, tabs, _, _, _ = sticky
    streams, vend, groups, K = _bases_case(sticky)
    one = tabs.group(groups[-1])
    root, absorb = int(one.gscal[0, 0]), int(one.gscal[0, 1])
    sched = seg.segment_schedule(T_CRAFT, 3, K)
    bases = []
    for start, _, hi in sched:
        v = (vend.long().clamp(max=hi) - start).clamp(min=0).to(torch.int32)
        bases.append(comb16_contains_base_plain(streams[start:hi].contiguous(), v, one).numpy())
    want = seg.combine_bases([torch.from_numpy(b) for b in bases], vend, sched, root, absorb)
    assert torch.equal(want, comb16_contains_base_plain(streams, vend, one))
    v = vend.numpy()
    for order in itertools.permutations(range(3)):
        out = np.full(len(v), root)
        for i in order:
            _, lo, hi = sched[i]
            b = bases[i]
            owner = (v > lo) & (v <= hi)
            out = np.where(b == absorb, absorb, out)  # atomicExch
            out = np.where(owner & (b != absorb) & (out == root), b, out)  # atomicCAS
        np.testing.assert_array_equal(out, want.numpy())
