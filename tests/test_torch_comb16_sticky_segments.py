"""The segmented schedule of B10, the comb16 sticky scan ``comb16_contains``,
which ``csrc/comb16_grouped.cu`` runs on the card as the sticky-base mode of
B8's scan (``csrc/stage.cuh``), the mode it shares with B11's one-group mode.

* Exactness: B10's plain version run over every segment of a schedule, from
  its scan start up to ``min(p_{i+1}, vend)``, the final bases combined
  (``entry_over_segments`` and ``combine_bases`` of
  ``alfred_margaret_tpu_torch/kernels/segments.py``: ``absorb`` where a
  segment absorbed, else the base of the segment whose own range holds step
  ``vend - 1``, else the root base), equals the unsplit plain version at
  k = 1, 2, 3 and 5 with T = 40, and on config 2's sticky tables that
  equals the JAX kernel (``_make_c16_contains_kernel``) in interpret mode,
  base for base on every stream (the base held from ``vend`` on in every
  tile); also on a NUL-bearing set and a composed IgnoreCase machine
  (overlap ``max_raw_match_bytes + 4``), on stagings with stream 0 and
  fully padded streams, and on B11's crafted streams (a match only in a
  later segment's warm-up, ``vend`` at and just past its last byte,
  ``vend`` inside the warm-up, padded streams).
* The write protocol (fill with the root base, ``atomicExch`` of
  ``absorb``, ``atomicCAS`` from the root by the owner of step
  ``vend - 1``, a segment that read ``absorb`` in ``out[s]`` stopping with
  any base) gives the combine under any order of the segments.
* The plumbing: ``Comb16AcEngine.sticky_args`` ends with the plan's
  overlap, ``contains_staged`` passes it to the wrapper, and the wrapper
  refuses a negative overlap.

Tolerance: exact equality of every base.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfred_margaret_tpu.ops import comb16_scan as j16

from alfred_margaret_tpu_torch.kernels import segments as seg
from alfred_margaret_tpu_torch.kernels.comb16 import comb16_contains, comb16_contains_plain
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops import comb16_scan as t16
from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine

from test_torch_comb16 import CONFIG2, NUL, _machines
from test_torch_comb16_segments import CI, KW
from test_torch_count_segments import _spy
from test_torch_dense_sticky_segments import _hay
from test_torch_segments import _layout_cases
from test_torch_sticky_segments import T_CRAFT, _crafted
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
KS = [1, 2, 3, 5]

#: name: (needles, composed, held against the JAX kernel)
B10_CASES = {
    "config2": (CONFIG2, False, True),
    "nul": (NUL, False, False),
    "ignorecase": (CI, True, False),
}
_B10 = {}


def _b10_case(name):
    """(JAX final bases or None, the port's staging, the engine, B10's args
    without the overlap) of a case, built once."""
    if name not in _B10:
        needles, composed, jax = B10_CASES[name]
        jm, tm = _machines(needles)
        if composed:
            tm = case_dfa.compose_build(list(zip(tm.needles, tm.values)), machine=tm)
        eng = Comb16AcEngine(tm, device=CPU, **KW)
        pst = eng.stage(np.frombuffer(_hay(needles, composed, len(name)), np.uint8))
        want = None
        if jax:
            jeng = j16.Comb16PallasAcEngine(jm, interpret=True, **KW)
            c = jeng._sticky_setup()
            assert c["absorb_cb"] == eng.sticky_tables().absorb
            fn = jeng._get_contains_fn(pst.plan.time_len)
            want = np.asarray(fn(jnp.zeros(2, jnp.int32), c["cm"], c["comb_dev"], c["aux_dev"],
                                 c["rootseg_dev"], jnp.asarray(pst.vend.numpy().reshape(-1, 128)),
                                 jnp.asarray(pst.streams.numpy()))).reshape(-1)
        args = eng.sticky_args(pst)
        assert args[-1] == pst.plan.overlap
        _B10[name] = (want, pst, eng, args[:-1])
    return _B10[name]


def _run(args):
    """B10's plain version on one slice of steps: ``run(streams, vend)``."""
    tables = args[2:]
    return lambda x, v: comb16_contains_plain(x, v, *tables)


@pytest.mark.parametrize("name", list(B10_CASES))
@pytest.mark.parametrize("k", KS)
def test_b10_segments_equal_unsplit_and_jax(name, k):
    want, pst, eng, args = _b10_case(name)
    streams, vend = args[:2]
    t = eng.sticky_tables()
    K, T = pst.plan.overlap, pst.plan.time_len
    assert T == 40 and _layout_cases(pst)["padded"]
    if name == "ignorecase":
        assert eng.machine.composed_ci and K == eng.machine.max_needle_bytes - 1
    whole = comb16_contains_plain(*args)
    if want is not None:
        np.testing.assert_array_equal(whole.numpy(), want)
    hit = whole == t.absorb
    assert hit.any() and (~hit & (vend > 0)).any()
    assert (whole[vend == 0] == t.root_cb).all()  # padded streams keep the root base
    assert torch.equal(comb16_contains(*args, K), whole)  # the wrapper's CPU path
    got = seg.entry_over_segments(_run(args), streams, vend, t.root_cb, t.absorb, overlap=K,
                                  segments=k)
    assert got.dtype == torch.int32 and torch.equal(got, whole)
    if k == 3:  # the combine's own pieces, as the kernel's blocks leave them
        sched = seg.segment_schedule(T, k, K)
        bases = [comb16_contains_plain(streams[s:h].contiguous(),
                                       ((vend.long().clamp(max=h) - s).clamp(min=0)).int(),
                                       *args[2:]) for s, _, h in sched]
        assert torch.equal(seg.combine_bases(bases, vend, sched, t.root_cb, t.absorb), whole)


def test_b10_crafted_segments_equal_unsplit():
    """B11's crafted streams on config 2's sticky tables: kinds 1 and 3
    match only inside the second segment's warm-up (k = 2), kind 2 ends its
    vend at that match's last byte, kind 4 inside the warm-up with a match
    after it, kind 5 is padded."""
    _, tm = _machines(CONFIG2)
    eng = Comb16AcEngine(tm, device=CPU, n_streams=128, t_tile=32)
    t = eng.sticky_tables()
    K = tm.max_needle_bytes - 1
    streams, vend = _crafted(CONFIG2, K)
    args = (streams, vend, *t.sticky_args())
    whole = comb16_contains_plain(*args)
    kinds = np.arange(128) % 8
    hit = (whole == t.absorb).numpy()
    assert hit[kinds == 1].all() and hit[kinds == 3].all()
    assert not hit[np.isin(kinds, (0, 2, 4, 5))].any()
    assert (whole.numpy()[kinds == 5] == t.root_cb).all()
    for k in KS:
        got = seg.entry_over_segments(_run(args), streams, vend, t.root_cb, t.absorb, overlap=K,
                                      segments=k)
        assert torch.equal(got, whole), k
    start, lo, _ = seg.segment_schedule(T_CRAFT, 2, K)[1]
    v = vend.numpy()
    assert ((v[np.isin(kinds, (2, 3, 4))] > start) & (v[np.isin(kinds, (2, 3, 4))] <= lo)).all()


def test_b10_write_protocol_is_order_free():
    """The kernel's writes, in every order of three segments' blocks: the
    launcher fills out with the root base, a segment that absorbed
    exchanges in ``absorb``, the owner of step vend - 1 swaps its base in
    only where out still holds the root, and a segment that read ``absorb``
    in out[s] (the poll) stops with any base.  Each order gives the
    combine."""
    _, tm = _machines(CONFIG2)
    t = Comb16AcEngine(tm, device=CPU, n_streams=128, t_tile=32).sticky_tables()
    K = tm.max_needle_bytes - 1
    streams, vend = _crafted(CONFIG2, K)
    args = (streams, vend, *t.sticky_args())
    sched = seg.segment_schedule(T_CRAFT, 3, K)
    run = _run(args)
    bases = []
    for start, _, hi in sched:
        v = (vend.long().clamp(max=hi) - start).clamp(min=0).to(torch.int32)
        bases.append(run(streams[start:hi].contiguous(), v).numpy())
    want = seg.combine_bases([torch.from_numpy(b) for b in bases], vend, sched, t.root_cb,
                             t.absorb)
    assert torch.equal(want, comb16_contains_plain(*args))
    assert (want == t.absorb).any() and (want != t.absorb).any()
    v = vend.numpy()
    rng = np.random.default_rng(5)
    for order in itertools.permutations(range(3)):
        out = np.full(len(v), t.root_cb, np.int64)
        for i in order:
            _, lo, hi = sched[i]
            # A stream already holding absorb may stop this segment early.
            b = np.where(out == t.absorb, rng.integers(0, 1 << t.BB, len(v)), bases[i])
            owner = (v > lo) & (v <= hi)
            out = np.where(b == t.absorb, t.absorb, out)  # atomicExch
            out = np.where(owner & (b != t.absorb) & (out == t.root_cb), b, out)  # atomicCAS
        np.testing.assert_array_equal(out, want.numpy())


def test_b10_callers_pass_the_plans_overlap(monkeypatch):
    seen = []
    _spy(monkeypatch, t16, "comb16_contains", 11, seen)
    m = ac.build([(x, i) for i, x in enumerate(CONFIG2)])
    for screened in (True, False):  # through the screen's fall-through, and without it
        eng = Comb16AcEngine(m, device=CPU, n_streams=16, t_tile=32)
        assert eng._filter_tables is not None
        if not screened:
            eng._filter_tables = None
        hay = b"0123456789 ,;:!" * 30 + CONFIG2[40].encode()  # digits fire the chains
        st = eng.stage(hay)
        assert eng.contains_staged(st) is True
        assert eng.sticky_args(st)[11] == st.plan.overlap == m.max_needle_bytes - 1
    assert seen == [st.plan.overlap] * 2
    args = eng.sticky_args(st)
    with pytest.raises(ValueError):
        comb16_contains(*args[:-1], -1)
