"""The segmented schedule of B16, the comb32 sticky scan ``comb_contains``,
which ``csrc/comb_scan.cu`` runs on the card as the sticky mode of B15's
scan (``csrc/stage.cuh``).

* The rule: B16 takes B15's design (the same shared memory): k = 16 at
  config 5's 300 needles on the main path's 32768 streams, one segment
  without an overlap.
* Exactness: B16's plain version run over every segment of a schedule, from
  its scan start up to ``min(p_{i+1}, vend)``, the final bases combined
  (``base_over_segments``' combine, ``entry_over_segments`` and
  ``combine_bases`` of ``alfred_margaret_tpu_torch/kernels/segments.py``:
  ``absorb`` where a segment absorbed, else the base of the segment whose
  own range holds step ``vend - 1``, else the root base), equals the
  unsplit plain version at k = 1, 2, 3 and 5 with T = 40, and on config 5's
  first 300 needles that equals the JAX kernel
  (``_make_comb_contains_kernel``) in interpret mode, base for base on every
  stream (the base held from ``vend`` on in every tile); also on a
  NUL-bearing set and a composed IgnoreCase machine that the dispatcher
  sends to comb32 (overlap ``max_raw_match_bytes + 3``), on stagings with
  stream 0 and fully padded streams, on B11's crafted streams and on
  streams whose only match straddles a cut.
* The write protocol (fill with the root base, ``atomicExch`` of
  ``absorb``, ``atomicCAS`` from the root base by the owner of step
  ``vend - 1``, a segment that read ``absorb`` in ``out[s]`` stopping with
  any base) gives the combine under any order of the segments.
* The guard and the plumbing: ``CombStickyTables.check_overlap`` refuses a
  staging whose overlap is below the machine's ``max_needle_bytes - 1``
  without a launch, the wrapper a negative overlap and a root base that is
  the absorbing one; ``CombAcEngine.sticky_args`` ends with the plan's
  overlap, which ``contains_staged`` passes on, also for the grouped
  engine's comb32 groups where the fused scans are not built.

Tolerance: exact equality of every base.
"""

import dataclasses
import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfred_margaret_tpu.ops import comb_scan as jcomb

from alfred_margaret_tpu_torch.kernels import segments as seg
from alfred_margaret_tpu_torch.kernels.comb import comb_contains, comb_contains_plain
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops import comb_scan as tcomb
from alfred_margaret_tpu_torch.ops.comb_scan import CombAcEngine, make_engine
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine

from test_torch_comb import C5_300, NUL, _machines
from test_torch_comb16 import random_needles
from test_torch_count_segments import KW, _composed, _spy
from test_torch_dense_sticky_segments import _hay
from test_torch_grouped import MID, MID_HAY
from test_torch_segments import _layout_cases
from test_torch_sticky_segments import DIGITS, T_CRAFT, _crafted
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

comb_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.comb")
CPU = torch.device("cpu")
KS = [1, 2, 3, 5]
#: Whole-code-point needles whose composed IgnoreCase machine the dispatcher
#: sends to comb32.
CI32 = random_needles(47, 120) + ["straße", "kelvin"]

#: name: (needles, composed, held against the JAX kernel)
B16_CASES = {
    "config5_300": (C5_300, False, True),
    "nul": (NUL, False, False),
    "ignorecase": (CI32, True, False),
}
_B16 = {}


def _b16_case(name):
    """(JAX final bases or None, the port's staging, the engine, B16's args
    without the overlap) of a case, built once."""
    if name not in _B16:
        needles, composed, jax = B16_CASES[name]
        jm, tm = _machines(needles)
        if composed:
            tm = _composed(ac, case_dfa, needles)
        eng = CombAcEngine(tm, device=CPU, **KW)
        pst = eng.stage(np.frombuffer(_hay(needles, composed, len(name)), np.uint8))
        want = None
        if jax:
            jeng = jcomb.CombPallasAcEngine(jm, interpret=True, **KW)
            c = jeng._sticky_setup()
            assert c["absorb_base"] == eng.sticky_tables().absorb
            fn = jeng._get_contains_fn(pst.plan.time_len)
            want = np.asarray(fn(jnp.zeros(2, jnp.int32), c["cm"], c["comb_dev"], c["def_dev"],
                                 jnp.asarray(pst.vend.numpy().reshape(-1, 128)),
                                 jnp.asarray(pst.streams.numpy()))).reshape(-1)
        args = eng.sticky_args(pst)
        assert args[-1] == pst.plan.overlap
        _B16[name] = (want, pst, eng, args[:-1])
    return _B16[name]


def _run(args):
    """B16's plain version on one slice of steps: ``run(streams, vend)``."""
    tables = args[2:]
    return lambda x, v: comb_contains_plain(x, v, *tables)


def _bases(args, vend, sched):
    """Each segment's final base of ``sched``, as its block leaves it."""
    streams, run = args[0], _run(args)
    return [run(streams[s:h].contiguous(), ((vend.long().clamp(max=h) - s).clamp(min=0)).int())
            for s, _, h in sched]


# -- the rule ----------------------------------------------------------------------------


def test_b16_design_follows_the_rule(monkeypatch):
    monkeypatch.setattr(comb_mod, "sm_count", lambda _dev: 132)
    t = CombAcEngine(_machines(C5_300)[1], device=CPU, n_streams=8, t_tile=8).sticky_tables()
    wide = torch.zeros(4224, 32768, dtype=torch.uint8)
    d = comb_mod.comb_count_design(wide, t.comb, t.def_table, 9)
    assert d.as_dict() == {"k": 16, "t_tile": seg.T_TILE, "Gc": 1}
    assert d == seg.comb_design(32768, 4224, 9, t.comb.numel(), t.def_table.numel(), 132)
    assert comb_mod.comb_count_design(wide, t.comb, t.def_table).segments == 1


# -- B16 over the schedule -----------------------------------------------------------------


@pytest.mark.parametrize("name", list(B16_CASES))
@pytest.mark.parametrize("k", KS)
def test_b16_segments_equal_unsplit_and_jax(name, k):
    want, pst, eng, args = _b16_case(name)
    streams, vend = args[:2]
    t = eng.sticky_tables()
    K, T = pst.plan.overlap, pst.plan.time_len
    assert T == 40 and _layout_cases(pst)["padded"] and _layout_cases(pst)["stream 0"]
    assert t.min_overlap == K == eng.machine.max_needle_bytes - 1
    if name == "ignorecase":
        assert eng.machine.composed_ci and type(make_engine(eng.machine, CPU)) is CombAcEngine
    whole = comb_contains_plain(*args)
    if want is not None:
        np.testing.assert_array_equal(whole.numpy(), want)
    hit = whole == t.absorb
    assert hit.any() and (~hit & (vend > 0)).any()
    assert (whole[vend == 0] == t.root_base).all()  # padded streams keep the root base
    assert torch.equal(comb_contains(*args, K), whole)  # the wrapper's CPU path
    got = seg.entry_over_segments(_run(args), streams, vend, t.root_base, t.absorb, overlap=K,
                                  segments=k)
    assert got.dtype == torch.int32 and torch.equal(got, whole)
    if k == 3:  # the combine's own pieces, as the kernel's blocks leave them
        sched = seg.segment_schedule(T, k, K)
        assert torch.equal(seg.combine_bases(_bases(args, vend, sched), vend, sched,
                                             t.root_base, t.absorb), whole)


def test_b16_crafted_segments_equal_unsplit():
    """B11's crafted streams on config 5's sticky tables: kinds 1 and 3
    match only inside the second segment's warm-up (k = 2), kind 2 ends its
    vend at that match's last byte, kind 4 inside the warm-up with a match
    after it, kind 5 is padded."""
    _, tm = _machines(C5_300)
    eng = CombAcEngine(tm, device=CPU, n_streams=128, t_tile=32)
    t = eng.sticky_tables()
    K = t.min_overlap
    streams, vend = _crafted(C5_300, K)
    args = (streams, vend, *t.sticky_args())
    whole = comb_contains_plain(*args)
    kinds = np.arange(128) % 8
    hit = (whole == t.absorb).numpy()
    assert hit[kinds == 1].all() and hit[kinds == 3].all()
    assert not hit[np.isin(kinds, (0, 2, 4, 5))].any()
    assert (whole.numpy()[kinds == 5] == t.root_base).all()
    for k in KS:
        got = seg.entry_over_segments(_run(args), streams, vend, t.root_base, t.absorb, overlap=K,
                                      segments=k)
        assert torch.equal(got, whole), k


@pytest.mark.parametrize("k", [2, 3, 5])
def test_b16_match_across_a_cut(k):
    """Streams of digits whose only match straddles the cut p_1 = T // k: the
    first segment stops before its last byte, the second reads it whole from
    its warm-up, so the combine absorbs; with a vend at that last byte (not
    included) nothing does."""
    _, tm = _machines(C5_300)
    t = CombAcEngine(tm, device=CPU, n_streams=128, t_tile=32).sticky_tables()
    K = t.min_overlap
    rng = np.random.default_rng(k)
    a = rng.choice(DIGITS, size=(T_CRAFT, 128)).astype(np.uint8)
    vend = np.full(128, T_CRAFT, np.int32)
    cut = T_CRAFT // k
    for s in range(128):
        nd = np.frombuffer(C5_300[s].encode(), np.uint8)
        first = cut - int(rng.integers(1, len(nd)))  # bytes on both sides of the cut
        a[first:first + len(nd), s] = nd
        if s % 4 == 3:
            vend[s] = first + len(nd) - 1
    streams, vend = torch.from_numpy(a), torch.from_numpy(vend)
    args = (streams, vend, *t.sticky_args())
    whole = comb_contains_plain(*args)
    hit = (whole == t.absorb).numpy()
    assert hit[np.arange(128) % 4 != 3].all() and not hit[np.arange(128) % 4 == 3].any()
    sched = seg.segment_schedule(T_CRAFT, k, K)
    bases = _bases(args, vend, sched)
    assert not (bases[0] == t.absorb).any()  # the first segment never sees a whole needle
    assert torch.equal(seg.combine_bases(bases, vend, sched, t.root_base, t.absorb), whole)
    assert torch.equal(seg.entry_over_segments(_run(args), streams, vend, t.root_base, t.absorb,
                                               overlap=K, segments=k), whole)


def test_b16_write_protocol_is_order_free():
    """The kernel's writes, in every order of three segments' blocks: the
    wrapper fills out with the root base, a segment that absorbed exchanges
    in ``absorb``, the owner of step vend - 1 swaps its base in only where
    out still holds the root base, and a segment that read ``absorb`` in
    out[s] (the poll) stops with any base.  Each order gives the combine."""
    _, tm = _machines(C5_300)
    t = CombAcEngine(tm, device=CPU, n_streams=128, t_tile=32).sticky_tables()
    K = t.min_overlap
    streams, vend = _crafted(C5_300, K)
    args = (streams, vend, *t.sticky_args())
    sched = seg.segment_schedule(T_CRAFT, 3, K)
    bases = [b.numpy() for b in _bases(args, vend, sched)]
    want = seg.combine_bases([torch.from_numpy(b) for b in bases], vend, sched, t.root_base,
                             t.absorb)
    assert torch.equal(want, comb_contains_plain(*args))
    assert (want == t.absorb).any() and (want != t.absorb).any()
    assert t.root_base != t.absorb
    v = vend.numpy()
    rng = np.random.default_rng(5)
    for order in itertools.permutations(range(3)):
        out = np.full(len(v), t.root_base, np.int64)
        for i in order:
            _, lo, hi = sched[i]
            # A stream already holding absorb may stop this segment early.
            b = np.where(out == t.absorb, rng.integers(0, 1 << 13, len(v)), bases[i])
            owner = (v > lo) & (v <= hi)
            out = np.where(b == t.absorb, t.absorb, out)  # atomicExch
            out = np.where(owner & (b != t.absorb) & (out == t.root_base), b, out)  # atomicCAS
        np.testing.assert_array_equal(out, want.numpy())


# -- the guard and the plumbing ------------------------------------------------------------


def test_b16_overlap_below_the_machines_need_raises(monkeypatch):
    seen = []
    _spy(monkeypatch, tcomb, "comb_contains", 10, seen)
    eng = CombAcEngine(_machines(C5_300)[1], device=CPU, n_streams=8, t_tile=8)
    hay = (" ".join(C5_300[:20])).encode()
    st = eng.stage(hay)
    t = eng.sticky_tables()
    assert t.min_overlap == st.plan.overlap == max(len(x) for x in C5_300) - 1
    short = dataclasses.replace(st, plan=dataclasses.replace(st.plan, overlap=t.min_overlap - 1))
    with pytest.raises(ValueError, match="max_needle_bytes"):
        eng.sticky_args(short)
    with pytest.raises(ValueError, match="max_needle_bytes"):
        eng.contains_staged(short)
    assert seen == []
    assert eng.contains_staged(st) and seen == [st.plan.overlap]
    args = eng.sticky_args(st)
    with pytest.raises(ValueError):
        comb_contains(*args[:-1], -1)
    with pytest.raises(ValueError, match="root"):
        comb_contains(*args[:9], t.root_base, st.plan.overlap)
    # A composed IgnoreCase machine needs max_raw_match_bytes + 3.
    ci = CombAcEngine(_composed(ac, case_dfa, CI32), device=CPU, n_streams=8, t_tile=8)
    assert ci.sticky_tables().min_overlap == case_dfa.max_raw_match_bytes(
        [x.encode() for x in CI32]) + 3 == ci.overlap


def test_b16_callers_pass_the_plans_overlap(monkeypatch):
    seen = []
    _spy(monkeypatch, tcomb, "comb_contains", 10, seen)
    _, tm = _machines(C5_300)
    eng = CombAcEngine(tm, device=CPU, n_streams=16, t_tile=32)
    st = eng.stage(b"0123456789 ,;:!" * 30 + C5_300[7].encode())
    assert eng.contains_staged(st) is True
    assert eng.contains_staged_early(st, n_segments=4) is True
    assert seen == [st.plan.overlap] * 2 == [tm.max_needle_bytes - 1] * 2
    # The grouped engine's comb32 groups, one sticky scan each where the
    # fused scans are not built, warm up over the full set's overlap.
    seen.clear()
    g = GroupedAcEngine(_machines(MID)[1], device=CPU, max_rows=4, n_streams=256, t_tile=64)
    g._fused_tried = True
    gst = g.stage(np.frombuffer(MID_HAY, np.uint8))
    n32 = sum(type(e) is CombAcEngine for e in g.engines)
    assert n32 > 0
    g.contains_staged(gst)
    assert len(seen) >= 1 and set(seen) == {gst.plan.overlap}
