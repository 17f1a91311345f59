"""The schedules of the segmented count kernels B9 and B15
(``alfred_margaret_tpu_torch/kernels/segments.py``), which the CUDA sources
run on the card (``csrc/stage.cuh``).

* The split: every step of a stream lies in exactly one segment's counted
  range, each segment scans from ``overlap`` bytes before it, and the
  choice of the segment count and of B9's group chunks follows its rules.
* Exactness: the plain versions of B15 (comb32 count) and B9 (fused grouped
  comb16 count) run over every segment of a schedule and summed per stream
  equal the unsplit plain versions and the JAX kernels
  (``_make_comb_count_kernel``, ``_make_c16_count_kernel_dyn``) in interpret
  mode on the same staged corpus, for several segment counts (T not a
  multiple of k), on stagings with stream 0 (warm 0), head streams whose
  warm-up is shorter than the overlap, fully padded streams and streams
  whose vend falls inside a later segment's warm-up; on a NUL-bearing set,
  a set of single bytes (overlap 0) and a composed IgnoreCase machine for
  B15; with eleven groups, each group alone (G = 1) and chunks of groups for
  B9.  Segments no longer than the overlap are exact too; the rule only
  keeps them out of the launches.

Tolerance: exact equality of every count.
"""

import dataclasses

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.models import case_dfa as jcase
from alfred_margaret_tpu.ops import comb_scan as jcomb
from alfred_margaret_tpu.ops import grouped as jgrouped

from alfred_margaret_tpu_torch import convert
from alfred_margaret_tpu_torch.kernels import segments as seg
from alfred_margaret_tpu_torch.kernels.comb import comb_count_plain
from alfred_margaret_tpu_torch.kernels.comb16_grouped import comb16_count_grouped_plain
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops import comb_scan as tcomb
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine

from test_torch_comb16 import random_needles
from test_torch_grouped import mid
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
KW = dict(n_streams=128, t_tile=32)


# -- the split and its rules -------------------------------------------------------


@pytest.mark.parametrize("T,k,K", [(32, 1, 7), (32, 3, 19), (4224, 5, 10), (100, 7, 0),
                                   (5, 5, 3)])
def test_segment_schedule_covers_every_step_once(T, k, K):
    sched = seg.segment_schedule(T, k, K)
    assert len(sched) == k
    covered = np.zeros(T, np.int64)
    for start, lo, hi in sched:
        assert start == max(0, lo - K) and lo <= hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert sched[0][1] == 0 and sched[-1][2] == T


def test_pick_segments_rules():
    # No overlap: one segment, whatever the shapes.
    assert seg.pick_segments(32768, 4224, None, 40_000, 132) == 1
    # Enough blocks for SEGMENT_WAVES rounds of every SM's resident slots,
    # at most MAX_AUTO_SEGMENTS.
    per_sm = seg.SMEM_PER_SM // 41_024
    k = seg.pick_segments(32768, 4224, 10, 40_000, 132)
    assert k == min(seg.MAX_AUTO_SEGMENTS, -(-seg.SEGMENT_WAVES * 132 * per_sm // 256)) > 1
    assert seg.pick_segments(16384, 4224, 10, 40_000, 132) >= k
    assert seg.pick_segments(128, 4224, 10, 40_000, 132) == seg.MAX_AUTO_SEGMENTS
    # Never a segment no longer than the overlap: k falls, to 1 at worst.
    assert seg.pick_segments(128, 40, 10, 40_000, 132) == 3  # 40 // 3 = 13 > 10
    assert seg.pick_segments(128, 20, 10, 40_000, 132) == 1
    assert seg.pick_segments(128, 32, 0, 40_000, 132) <= seg.MAX_SEGMENTS


def test_pick_chunk_rules():
    # Config 5's eleven groups (comb 512 and aux 128 words each): three
    # chunks of four, three and four groups, seven blocks an SM.
    assert seg.pick_chunk(11, 512, 128) == 4
    assert seg.chunk_smem_bytes(4, 512, 128) <= seg.B9_CHUNK_BUDGET < seg.chunk_smem_bytes(
        5, 512, 128)
    assert seg.group_chunks(11, 4) == [(0, 4), (4, 8), (8, 11)]
    # Small tables: every group in one block.
    assert seg.pick_chunk(11, 8, 8) == 11
    # Tables near MAX_ROWS: one group a block, so several chunks.
    c = seg.pick_chunk(3, 47 * 128, 128)
    assert c == 1 and seg.group_chunks(3, c) == [(0, 1), (1, 2), (2, 3)]
    # Chunks are balanced and never pass MAX_CHUNK.
    c = seg.pick_chunk(40, 8, 8)
    assert c == 14 <= seg.MAX_CHUNK and seg.group_chunks(40, c)[-1][1] == 40
    assert max(b - a for a, b in seg.group_chunks(40, c)) - min(
        b - a for a, b in seg.group_chunks(40, c)) <= c - 1
    with pytest.raises(ValueError):
        seg.pick_chunk(1, 60_000, 128)
    d = seg.grouped_design(32768, 4224, 10, 11, 512, 128, 132)
    assert d.chunk == 4 and d.segments > 1
    assert d.as_dict() == {"k": d.segments, "t_tile": seg.T_TILE, "Gc": 4}


# -- B15 over the schedule ------------------------------------------------------------

#: Long needles (overlap 19 against 8-byte emissions) and NUL bytes.
LONG_NUL = random_needles(41, 40) + ["abcdefghijklmnopqrst", "a\x00b", "\x00\x00x"]
#: Single bytes: overlap 0.
SINGLES = ["a", "e", " ", "z"]
#: Whole-code-point lowercase needles for the composed IgnoreCase machine.
CI = random_needles(43, 30) + ["straße", "ǆx", "kelvin"]


def _stage_pair(jeng, eng, hay):
    data = np.frombuffer(hay, dtype=np.uint8)
    st, pst = jeng.stage(data), eng.stage(data)
    np.testing.assert_array_equal(pst.live_np, np.asarray(st.live_np).reshape(-1))
    np.testing.assert_array_equal(pst.warm_np, np.asarray(st.warm_np).reshape(-1))
    return st, pst


def _layout_cases(pst):
    """The stream cases a staging holds: stream 0 from step 0, head streams
    warmed less than the overlap, fully padded streams."""
    K = pst.plan.overlap
    warm, vend = pst.warm_np, pst.vend.numpy()
    return {"stream 0": warm[0] == 0, "short warm-up": bool(((warm > 0) & (warm < K)).any()),
            "padded": bool((vend == 0).any())}


B15_CASES = {
    "long_nul": (LONG_NUL, 1000, False),
    "singles": (SINGLES, 1500, False),
    "ignorecase": (CI, 1300, True),
}
_B15 = {}
_B15_STAGED = {}


def b15_case(name):
    """(JAX engine, its staging, the port's engine, its staging) of a case,
    built once: the JAX comb32 engine in interpret mode and the port's on
    the CPU, over the same corpus."""
    if name not in _B15_STAGED:
        needles, n, composed = B15_CASES[name]
        pairs = [(x, i) for i, x in enumerate(needles)]
        jm, tm = jac.build(pairs), ac.build(pairs)
        if composed:
            jm = jcase.compose_build(list(zip(jm.needles, jm.values)), machine=jm)
            tm = case_dfa.compose_build(list(zip(tm.needles, tm.values)), machine=tm)
        jeng = jcomb.CombPallasAcEngine(jm, interpret=True, **KW)
        eng = tcomb.CombAcEngine(tm, device=CPU, **KW)
        rng = np.random.default_rng(len(name))
        words = [x.encode() for x in needles if "\x00" not in x]
        text = b" ".join(words[i] for i in rng.integers(0, len(words), n // 4))
        if composed:  # raw bytes in mixed case
            a = np.frombuffer(text, np.uint8).copy()
            up = (a >= 97) & (a <= 122) & (rng.random(len(a)) < 0.5)
            a[up] -= 32
            text = a.tobytes()
        hay = (text + b"a\x00b" * 3)[:n]
        st, pst = _stage_pair(jeng, eng, hay)
        _B15_STAGED[name] = (jeng, st, eng, pst)
    return _B15_STAGED[name]


def _b15(name):
    """(JAX counts, the port's staging, B15's args without the overlap) of a
    case, built once."""
    if name not in _B15:
        jeng, st, eng, pst = b15_case(name)
        T = st.plan.time_len
        want = np.asarray(jeng._get_count_fn(T)(
            jeng._bscal_for(st), jeng._classmap_dev, jeng._comb_dev, jeng._def_dev,
            st.warm_t, st.vend_t, st.streams_dev,
        )).reshape(-1)
        args = eng._kernel_args(pst)
        assert args[-1] == pst.plan.overlap
        _B15[name] = (want, pst, args[:-1])
    return _B15[name]


@pytest.mark.parametrize("name", list(B15_CASES))
@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_b15_segments_equal_unsplit_and_jax(name, k):
    want, pst, args = _b15(name)
    K, T, live = pst.plan.overlap, pst.plan.time_len, pst.live_np
    cases = _layout_cases(pst)
    assert cases["stream 0"] and cases["padded"]
    if name == "long_nul":
        assert K == 19 and cases["short warm-up"] and T % 3
    if name == "singles":
        assert K == 0
    whole = comb_count_plain(*args)
    np.testing.assert_array_equal(whole.numpy()[live], want[live])
    got = seg.run_segments(comb_count_plain, *args, overlap=K, segments=k)
    assert got.dtype == torch.int32 and torch.equal(got, whole)
    assert int(got.sum()) > 0
    # Streams whose vend lies inside the second segment's warm-up count
    # nothing there, and still all their matches.
    if name == "long_nul" and k == 2:
        start, lo, _ = seg.segment_schedule(T, k, K)[1]
        vend = pst.vend.numpy()
        assert ((vend > start) & (vend <= lo)).any()


# -- B9 over the schedule ----------------------------------------------------------------


@pytest.fixture(scope="module")
def eleven():
    """A 650-needle set in eleven uniform groups (``max_rows=5``; one count
    range a group, as config 5's 1,000), the JAX fused count on a 600-byte
    corpus (5-byte emissions against an overlap of 7), and the port's
    staging and tables."""
    needles, hay = mid(650, 17)
    pairs = [(x, i) for i, x in enumerate(needles)]
    jm, tm = jac.build(pairs), ac.build(pairs)
    kw = dict(max_rows=5, **KW)
    jeng = jgrouped.GroupedPallasAcEngine(jm, interpret=True, unroll=4, **kw)
    eng = GroupedAcEngine(tm, device=CPU, **kw)
    hay = hay[:600]
    st, pst = jeng._stage(hay), eng._stage(hay)
    np.testing.assert_array_equal(pst.warm_np, np.asarray(st.warm_np).reshape(-1))
    f = jeng._fused_setup()
    d = f["dev"]
    want = np.asarray(jeng._get_fused_count_fn(st.plan.time_len, 1)(
        jeng._fused_bscal(st), d["gscal"], d["classmap"], d["comb"], d["aux"], d["rootseg"],
        st.warm_t, st.vend_t, st.streams_dev,
    )).reshape(-1)
    tabs = convert.comb16_group_tables_from_jax(f["stacked"], CPU)
    args = eng._count_args(pst)
    assert args[-1] == pst.plan.overlap == 7 and args[3].n_groups == tabs.n_groups == 11
    for key, v in args[3].__dict__.items():
        assert torch.equal(v, getattr(tabs, key)) if torch.is_tensor(v) else v == getattr(tabs, key)
    return want, pst, args[:-1]


def _groups(tables, g0, g1):
    return dataclasses.replace(tables, gscal_host=tables.gscal_host[g0:g1], **{
        f: getattr(tables, f)[g0:g1].contiguous()
        for f in ("classmap", "comb", "aux", "root_row", "segtable", "gscal")})


@pytest.mark.parametrize("k", [1, 2, 5])
def test_b9_segments_equal_unsplit_and_jax(eleven, k):
    want, pst, args = eleven
    K, T = pst.plan.overlap, pst.plan.time_len
    cases = _layout_cases(pst)
    assert all(cases.values()) and T % 5
    whole = comb16_count_grouped_plain(*args)
    np.testing.assert_array_equal(whole.numpy(), want)
    assert int(whole.sum()) > 0
    got = seg.run_segments(comb16_count_grouped_plain, *args, overlap=K, segments=k)
    assert torch.equal(got, whole)


@pytest.mark.parametrize("chunk", [1, 4, 11])
def test_b9_group_chunks_sum_to_jax(eleven, chunk):
    """Each chunk of groups (one group alone at chunk 1, G = 1 as on a mesh
    shard) over two segments, summed: the JAX fused count."""
    want, pst, (streams, warm, vend, tables) = eleven
    total = torch.zeros_like(vend)
    for g0, g1 in seg.group_chunks(tables.n_groups, chunk):
        total += seg.run_segments(comb16_count_grouped_plain, streams, warm, vend,
                                  _groups(tables, g0, g1), overlap=pst.plan.overlap, segments=2)
    np.testing.assert_array_equal(total.numpy(), want)
