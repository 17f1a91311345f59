"""The needle-grouped engine of the PyTorch port against the JAX package.

* Pins: ``partition_adaptive`` (with its rows), ``partition_uniform16``
  (count and sticky views), ``build_comb16_uniform``,
  ``build_sticky16_uniform``, ``plan_pallas`` and ``comb_structure_cost``
  are numpy copies; each gives the original's groups, machines, stacked
  arrays and consts on seeded sets (duplicates, a NUL needle, ``max_rows``
  1, 2, 4 and 5), and both refuse an empty needle.
* Kernels: B9 (the fused grouped count) and B11 (the fused grouped sticky
  scan), run here by their plain torch versions, equal the JAX fused kernels
  in interpret mode per stream, on the JAX engine's own stacked tables
  carried across by ``convert.comb16_group_tables_from_jax`` (one machine,
  since each compile in interpret mode takes some 20 s to 30 s): B9 on a hit
  corpus, B11 on a hit corpus, a miss corpus and one with a needle of the
  last group only.  B14 at 12 words equals the JAX screen kernel on the
  layout of 1,000 config-5 needles.
* ``GroupedAcEngine`` on the CPU against the JAX ``GroupedPallasAcEngine``
  (count and containsAny) and the scalar oracles (count, containsAny,
  matches and value presence), with the JAX engine's groups and its fusion
  decisions: fused and per group (the fused tables left unbuilt), a
  NUL-needle group beside zero-inert groups on one staging, the split-and-retry, the 12-word screen
  in front of the groups, and a fused kernel that fails, which raises.

Tolerance: exact equality of every group, array, count, flag and match.
"""

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.models import minimize as jmin
from alfred_margaret_tpu.ops import comb16_scan as j16
from alfred_margaret_tpu.ops import comb_scan as jcomb
from alfred_margaret_tpu.ops import filter_scan as jfilter
from alfred_margaret_tpu.ops import grouped as jgrouped
from alfred_margaret_tpu.ops.pallas_scan import CapacityError as JaxCapacityError
from alfred_margaret_tpu.ops.pallas_scan import PallasAcEngine

from alfred_margaret_tpu_torch import CASE_SENSITIVE, MatchEngine, convert
from alfred_margaret_tpu_torch.kernels import (
    comb16_contains_grouped,
    comb16_count_grouped,
    filter_contains,
)
from alfred_margaret_tpu_torch.kernels.comb16_grouped import (
    comb16_contains_grouped_plain,
    comb16_count_grouped_plain,
)
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.models import minimize as tmin
from alfred_margaret_tpu_torch.ops import comb16_scan as t16
from alfred_margaret_tpu_torch.ops import comb_scan as tcomb
from alfred_margaret_tpu_torch.ops import filter_scan as tfilter
from alfred_margaret_tpu_torch.ops import grouped as tgrouped
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import CapacityError, DenseAcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import _zero_inert

from test_torch_comb16 import random_needles
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")


def config5_needles(n: int):
    """The first ``n`` needles of ``BASELINE.json`` config 5, drawn as
    ``alfred_margaret_tpu/bench/configs.py`` draws them: config 2's 110
    draws from ``default_rng(7)``, then 11,000 needles of 5 to 11 letters,
    the first 10,000 distinct ones kept."""
    rng = np.random.default_rng(7)
    list("".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(4, 9)))
         for _ in range(110))
    return list(dict.fromkeys(
        "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(5, 12)))
        for _ in range(11000)
    ))[:n]


def mid(n: int = 150, seed: int = 17):
    """The JAX package's fused-engine set (``tests/test_pallas_engine.py``
    ``TestFusedGroupedCount._mid``): ``n`` random needles and a corpus of
    600 fragments, 20 needles and a miss."""
    rng = np.random.default_rng(seed)
    needles = list(dict.fromkeys(
        "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(4, 9)))
        for _ in range(n + 10)
    ))[:n]
    frags = [x.encode() for x in needles[:20]] + [b"zqzq"]
    hay = b"".join(frags[i] for i in rng.integers(0, len(frags), 600))
    return needles, hay


MID, MID_HAY = mid()
_base = random_needles(5, 80)
#: Duplicates far from their first occurrence: they must join its group.
DUPS = _base[:40] + _base[10:20] + _base[40:] + _base[:3]
#: NUL bytes: groups that are not zero-inert.
NUL = random_needles(9, 60)[:30] + ["a\x00b", "\x00\x00x"] + random_needles(9, 60)[30:]
_rng = np.random.default_rng(6)
#: Short needles over six letters (``test_grouped_adaptive_parity``).
SMALL = [x.decode() for x in dict.fromkeys(
    bytes(_rng.integers(97, 103, size=_rng.integers(2, 5), dtype=np.uint8)) for _ in range(200)
)][:90]
SETS = {"mid": MID, "dups": DUPS, "nul": NUL, "small": SMALL}


def _machines(needles):
    pairs = [(n, i) for i, n in enumerate(needles)]
    return jac.build(pairs), ac.build(pairs)


def _raises_alike(fn_jax, fn_port):
    """Both raise their package's CapacityError with the same message, or
    both return; returns the two results."""
    try:
        want = fn_jax()
    except JaxCapacityError as e:
        with pytest.raises(CapacityError) as got:
            fn_port()
        assert str(got.value) == str(e)
        return None, None
    return want, fn_port()


# -- pins: partitions, plan_pallas, comb_structure_cost, uniform builds ----------------


@pytest.mark.parametrize("max_rows", [1, 2, 4, 5])
@pytest.mark.parametrize("name", sorted(SETS))
def test_partition_adaptive_matches_jax(name, max_rows):
    jm, tm = _machines(SETS[name])
    want, got = _raises_alike(
        lambda: jgrouped.partition_adaptive(jm, max_rows, with_rows=True),
        lambda: tgrouped.partition_adaptive(tm, max_rows, with_rows=True))
    assert got == want
    if want is not None:
        groups = want[0]
        assert sorted(v for g in groups for v in g) == list(range(len(SETS[name])))
        if name == "dups":  # each duplicate sits in its first occurrence's group
            where = {v: i for i, g in enumerate(groups) for v in g}
            first = {}
            for v, nd in enumerate(DUPS):
                assert where[v] == where[first.setdefault(nd, v)]


@pytest.mark.parametrize("max_rows", [2, 5, 48])
@pytest.mark.parametrize("name", sorted(SETS))
def test_plan_pallas_and_structure_cost_match_jax(name, max_rows):
    jm, tm = _machines(SETS[name])
    want, got = _raises_alike(lambda: jcomb.plan_pallas(jm, max_rows),
                              lambda: tcomb.plan_pallas(tm, max_rows))
    assert got == want
    jmm, tmm = jmin.count_minimized(jm), tmin.count_minimized(tm)
    want, got = _raises_alike(lambda: jcomb.comb_structure_cost(jmm, max_rows=max_rows),
                              lambda: tcomb.comb_structure_cost(tmm, max_rows=max_rows))
    assert got == want
    assert tcomb.comb_structure_cost(tmm) == jcomb.comb_structure_cost(jmm)


def test_empty_needle_refused_alike():
    jm, tm = _machines(["", "abcd"] + MID[:60])
    with pytest.raises(JaxCapacityError, match="empty needle"):
        jgrouped.partition_adaptive(jm, 5)
    with pytest.raises(CapacityError, match="empty needle"):
        tgrouped.partition_adaptive(tm, 5)
    with pytest.raises(JaxCapacityError, match="empty needle"):
        jgrouped.GroupedPallasAcEngine(jm, max_rows=5, n_streams=128, t_tile=64, interpret=True)
    with pytest.raises(CapacityError, match="empty needle"):
        GroupedAcEngine(tm, device=CPU, max_rows=5)


_MACHINE_FIELDS = ("delta", "match_count", "out_offset", "out_values")


def _assert_fields(got, want, fields):
    for f in fields:
        if hasattr(want, f):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("view", ["count", "sticky"])
@pytest.mark.parametrize("name,max_rows", [("mid", 5), ("dups", 4), ("nul", 4)])
def test_partition_uniform16_matches_jax(name, max_rows, view):
    jm, tm = _machines(SETS[name])
    jg, jsubs, jmins, jsplit = jgrouped.partition_uniform16(jm, max_rows, view=view)
    tg, tsubs, tmins, tsplit = tgrouped.partition_uniform16(tm, max_rows, view=view)
    assert (tg, tsplit) == (jg, jsplit) and len(tg) > 1
    assert tsplit[0] == (0 if view == "sticky" else 1)
    for g, w in zip(tsubs, jsubs):
        _assert_fields(g, w, _MACHINE_FIELDS)
        assert g.needles == w.needles and g.values == w.values
    for g, w in zip(tmins, jmins):
        _assert_fields(g, w, ("delta", "match_count"))
        assert getattr(g, "absorb", None) == getattr(w, "absorb", None)


C16_FIELDS = ("classmap", "comb", "aux", "root_row", "segtable", "base", "cbase", "rows_c",
              "rows_a", "CB", "OB", "BB", "count_ranges")


def _uniform_builds(needles, max_rows, sticky):
    """The JAX and the port's uniform builds on the same partition."""
    jm, tm = _machines(needles)
    view = "sticky" if sticky else "count"
    _, _, jmins, split = jgrouped.partition_uniform16(jm, max_rows, view=view)
    _, _, tmins, _ = tgrouped.partition_uniform16(tm, max_rows, view=view)
    if sticky:
        want = j16.build_sticky16_uniform([], max_rows, split=split, views=jmins)
        got = t16.build_sticky16_uniform([], max_rows, split=split, views=tmins)
    else:
        want = j16.build_comb16_uniform(jmins, max_rows, split=split)
        got = t16.build_comb16_uniform(tmins, max_rows, split=split)
    return want, got


def _assert_stacked_equal(got, want):
    assert set(got) == set(want)
    assert got["consts"] == want["consts"]
    for k in ("classmap", "comb", "aux", "rootseg", "gscal"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("sticky", [False, True], ids=["count", "sticky"])
@pytest.mark.parametrize("name,max_rows", [("mid", 5), ("nul", 4)])
def test_uniform_builds_match_jax(name, max_rows, sticky):
    (jc16s, jst), (tc16s, tst) = _uniform_builds(SETS[name], max_rows, sticky)
    _assert_stacked_equal(tst, jst)
    assert len(tc16s) == len(jc16s) > 1
    for g, w in zip(tc16s, jc16s):
        _assert_fields(g, w, C16_FIELDS)
    # The split ladder (no pinned split) on the first groups' machines, and
    # the sticky views built from the machines themselves.
    jm, tm = _machines(SETS[name])
    _, jsubs, _, _ = jgrouped.partition_uniform16(jm, max_rows)
    _, tsubs, _, _ = tgrouped.partition_uniform16(tm, max_rows)
    if sticky:
        want, got = _raises_alike(lambda: j16.build_sticky16_uniform(jsubs[:2]),
                                  lambda: t16.build_sticky16_uniform(tsubs[:2]))
    else:
        want, got = _raises_alike(
            lambda: j16.build_comb16_uniform([jmin.count_minimized(m) for m in jsubs[:2]]),
            lambda: t16.build_comb16_uniform([tmin.count_minimized(m) for m in tsubs[:2]]))
    assert want is not None
    _assert_stacked_equal(got[1], want[1])


def test_group_tables_check_their_inputs():
    (_, _), (c16s, stacked) = _uniform_builds(MID, 5, False)
    tabs = t16.Comb16GroupTables.from_stacked(stacked, CPU, c16s=c16s)
    assert tabs.n_groups == len(c16s) and not tabs.sticky
    assert tabs.gscal_host == tuple(map(tuple, tabs.gscal.tolist()))
    assert tabs.group(1).gscal_host == tabs.gscal_host[1:2]
    assert tuple(tabs.comb.shape) == (len(c16s), stacked["consts"]["rows_c"] * 128)
    # A group's probe window past its padded table.
    cut = dict(stacked, comb=stacked["comb"][:, :1])
    with pytest.raises(CapacityError, match="group 0: comb16 comb probe window"):
        t16.Comb16GroupTables.from_stacked(cut, CPU, c16s=c16s)
    bad = dict(stacked, gscal=np.full_like(stacked["gscal"], 1 << 20))
    with pytest.raises(CapacityError, match="base is outside"):
        t16.Comb16GroupTables.from_stacked(bad, CPU)
    wide = dict(stacked, gscal=np.zeros((len(c16s), 3), np.int32))
    with pytest.raises(ValueError, match="sticky gscal"):
        t16.Comb16GroupTables.from_stacked(wide, CPU, sticky=True)
    # The wrappers refuse count tables for B11, sticky ones for B9, and
    # tables on another device or of another shape.
    eng = DenseAcEngine(ac.build([("abcd", 0)]), device=CPU, n_streams=128, t_tile=64)
    st = eng.stage(np.frombuffer(b"abcd" * 100, np.uint8))
    with pytest.raises(ValueError, match="B9 takes count tables"):
        comb16_contains_grouped(st.streams, st.vend, tabs)
    half = t16.Comb16GroupTables(**{**tabs.__dict__, "gscal": tabs.gscal[:1].contiguous()})
    with pytest.raises(ValueError):
        comb16_count_grouped(st.streams, st.warm, st.vend, half)
    # The host copy of gscal must hold its rows (B11's one-group launch reads
    # its bases there).
    short = t16.Comb16GroupTables(**{**tabs.__dict__, "gscal_host": tabs.gscal_host[:1]})
    with pytest.raises(ValueError, match="gscal_host"):
        comb16_count_grouped(st.streams, st.warm, st.vend, short)
    with pytest.raises(ValueError):
        comb16_count_grouped(st.streams, st.warm[:3], st.vend, tabs)


# -- B9, B11 and B14 against the JAX kernels (interpret mode) --------------------------


@pytest.fixture(scope="module")
def fused():
    """One machine, ``mid(150, 17)`` at ``max_rows=5``, in both packages:
    the JAX engine (interpret mode), the port's engine, and three corpora
    staged by each (a hit corpus, a miss corpus, and one whose only match is
    the last needle, which lies in the last group of every partition)."""
    jm, tm = _machines(MID)
    kw = dict(max_rows=5, n_streams=256, t_tile=64)
    jeng = jgrouped.GroupedPallasAcEngine(jm, interpret=True, unroll=4, **kw)
    eng = GroupedAcEngine(tm, device=CPU, **kw)
    corpora = {"hit": MID_HAY, "miss": b"ZQ" * 3000,
               "last": b"ZQ" * 100 + MID[-1].encode() + b"QZ" * 100}
    staged = {}
    for k, hay in corpora.items():
        st, pst = jeng._stage(hay), eng._stage(hay)
        assert pst.plan.time_len == st.plan.time_len == 64
        np.testing.assert_array_equal(pst.live_np, np.asarray(st.live_np).reshape(-1))
        np.testing.assert_array_equal(pst.warm_np, np.asarray(st.warm_np).reshape(-1))
        staged[k] = (st, pst)
    return jeng, eng, corpora, staged


def test_b9_matches_jax_fused_count(fused):
    jeng, eng, corpora, staged = fused
    st, pst = staged["hit"]
    f = jeng._fused_setup()
    assert f is not None and f["G"] > 1
    d = f["dev"]
    want = np.asarray(jeng._get_fused_count_fn(st.plan.time_len, 1)(
        jeng._fused_bscal(st), d["gscal"], d["classmap"], d["comb"], d["aux"], d["rootseg"],
        st.warm_t, st.vend_t, st.streams_dev,
    )).reshape(-1)
    tabs = convert.comb16_group_tables_from_jax(f["stacked"], CPU)
    got = comb16_count_grouped(pst.streams, pst.warm, pst.vend, tabs)
    assert got.dtype == torch.int32 and got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), want)
    total = jac.count_matches(jeng.machine, corpora["hit"])
    assert int(want.sum()) == total > 0
    # The port's own tables are the JAX engine's.
    own = eng._fused_setup()
    assert own is not None and own.groups == [list(g) for g in jgrouped.partition_uniform16(
        jeng.machine, 5)[0]]
    for k, v in own.tables.__dict__.items():
        assert (torch.equal(v, getattr(tabs, k)) if torch.is_tensor(v)
                else v == getattr(tabs, k)), k
    assert torch.equal(eng.stream_counts(pst), got)
    assert torch.equal(eng.stream_counts_plain(pst), got)


@pytest.mark.parametrize("corpus", ["hit", "miss", "last"])
def test_b11_matches_jax_fused_contains(fused, corpus):
    jeng, eng, corpora, staged = fused
    st, pst = staged[corpus]
    fs = jeng._fused_sticky_setup()
    assert fs is not None and fs["G"] > 1
    d = fs["dev"]
    want = np.asarray(jeng._get_fused_contains_fn(st.plan.time_len)(
        jeng._fused_bscal(st), d["gscal"], d["classmap"], d["comb"], d["aux"], d["rootseg"],
        st.vend_t, st.streams_dev,
    )).reshape(-1)
    tabs = convert.comb16_group_tables_from_jax(fs["stacked"], CPU, sticky=True)
    got = comb16_contains_grouped(pst.streams, pst.vend, tabs)
    assert got.dtype == torch.int32 and got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(want.any()) is (corpus != "miss")
    own = eng._fused_sticky_setup()
    for k, v in own.tables.__dict__.items():
        assert (torch.equal(v, getattr(tabs, k)) if torch.is_tensor(v)
                else v == getattr(tabs, k)), k
    if corpus == "last":  # the hit lies in the last group only
        one = t16.Comb16GroupTables(**{**tabs.__dict__, **{
            k: getattr(tabs, k)[-1:].contiguous()
            for k in ("classmap", "comb", "aux", "root_row", "segtable", "gscal")},
            "gscal_host": tabs.gscal_host[-1:]})
        rest = t16.Comb16GroupTables(**{**tabs.__dict__, **{
            k: getattr(tabs, k)[:-1].contiguous()
            for k in ("classmap", "comb", "aux", "root_row", "segtable", "gscal")},
            "gscal_host": tabs.gscal_host[:-1]})
        assert torch.equal(comb16_contains_grouped(pst.streams, pst.vend, one), got)
        assert not comb16_contains_grouped(pst.streams, pst.vend, rest).any()


def test_b14_twelve_words_matches_jax_kernel():
    needles = config5_needles(1000)
    jm, tm = _machines(needles)
    data = np.frombuffer(
        (b"0123456789 ,;:!" * 400)[:3000] + needles[500].encode() + b"ab cd " * 200, np.uint8)
    # A JAX engine only for the staging, with the full machine's overlap.
    overlap = max(0, jm.max_needle_bytes - 1)
    jeng = PallasAcEngine(jac.build([("zz", 0)]), n_streams=128, t_tile=64, interpret=True,
                          overlap=overlap)
    assert jfilter.attach_filter(jeng, jm, max_words=12)
    assert jeng._filter_lay.n_words == 12
    port = DenseAcEngine(ac.build([("zz", 0)]), device=CPU, n_streams=128, t_tile=64,
                         overlap=overlap)
    assert tfilter.attach_filter(port, tm, max_words=12)
    st, pst = jeng.stage(data), port.stage(data)
    T = st.plan.time_len
    verdict = jfilter.filter_contains(jeng, st)  # compiles the JAX kernel
    want = np.asarray(jeng._filter_fns[T](
        jfilter._strict_bscal(st), jeng._filter_btab, st.vend_t, st.streams_dev
    )).reshape(2, -1)
    got = filter_contains(pst.streams, pst.vend, *port._filter_tables.args())
    live = pst.live_np
    np.testing.assert_array_equal(got.numpy()[:, live], want[:, live])
    assert bool(want[1, live].any()) and verdict is None
    assert tfilter.filter_contains(port, pst) is verdict


# -- the engine ------------------------------------------------------------------------


def _oracle(m, hay):
    return (jac.count_matches(m, hay), jac.count_matches(m, hay) > 0,
            [(x.pos, x.value) for x in jac.all_matches(m, hay)])


def _presence(m, hay):
    present = np.zeros(len(m.values), dtype=bool)
    for x in jac.all_matches(m, hay):
        present[x.value] = True
    return present


def test_grouped_engine_matches_jax_engine_and_oracles(fused):
    jeng, eng, corpora, staged = fused
    assert eng.n_groups > 1 and eng.overlap == jeng.machine.max_needle_bytes - 1
    # The JAX engine's groups (no group split apart), and its fusion decisions.
    assert eng.groups == jeng.groups
    assert (eng._fused_setup() is None) is (jeng._fused_setup() is None) is False
    assert (eng._fused_sticky_setup() is None) is (jeng._fused_sticky_setup() is None) is False
    assert all(e.overlap == eng.overlap for e in eng.engines)
    assert sorted(v for g in eng.groups for v in g) == list(range(len(MID)))
    for k, hay in corpora.items():
        st, pst = staged[k]
        count, any_, matches = _oracle(jeng.machine, hay)
        assert eng.count_staged(pst) == jeng.count_staged(st) == count
        assert eng.contains_staged(pst) is jeng.contains_staged(st) is any_
        ends, vids = eng.matches_arrays_staged(pst)
        assert ends.dtype == np.int64 and vids.dtype == np.int32
        assert [(int(e), int(v)) for e, v in zip(ends, vids)] == matches
        np.testing.assert_array_equal(eng.value_presence_staged(pst, len(MID)),
                                      _presence(jeng.machine, hay))
    assert eng._fused is not None and eng._fused_sticky is not None
    assert eng.count(b"") == 0 and eng.contains(b"") is False
    assert len(eng.matches_arrays(b"")[0]) == 0 and not eng.value_presence(b"", 3).any()


def _counting(monkeypatch):
    """Count the fused kernels' calls (their plain versions run)."""
    calls = {"B9": 0, "B11": 0}

    def b9(*a):
        calls["B9"] += 1
        return comb16_count_grouped_plain(*a)

    def b11(*a):
        calls["B11"] += 1
        return comb16_contains_grouped_plain(*a)

    monkeypatch.setattr(tgrouped, "comb16_count_grouped", b9)
    monkeypatch.setattr(tgrouped, "comb16_contains_grouped", b11)
    return calls


def test_fused_off_is_the_control(monkeypatch):
    calls = _counting(monkeypatch)
    _, tm = _machines(MID)
    eng = GroupedAcEngine(tm, device=CPU, max_rows=5, n_streams=256, t_tile=64)
    eng._filter_tables = None  # the fused scan decides every containsAny
    eng._screen = None  # and B9 every count (the set suits the suffix screen)
    hays = [MID_HAY, b"ZQ" * 3000, b"ZQ" * 100 + MID[-1].encode()]
    st = [eng._stage(h) for h in hays]
    fused = [(eng.count_staged(s), eng.contains_staged(s)) for s in st]
    assert calls == {"B9": 3, "B11": 3}
    # The groups' own passes, run directly: the same answers, no fused launch.
    per_group = [(sum(e.count_staged(s) for e in eng.engines),
                  any(e.contains_staged(s) for e in eng.engines)) for s in st]
    assert per_group == fused
    assert calls == {"B9": 3, "B11": 3}
    assert [c for c, _ in fused] == [ac.count_matches(tm, h) for h in hays]
    # Marked tried before its first use, an engine keeps the fused tables
    # unbuilt and runs the groups' own passes.
    fresh = GroupedAcEngine(tm, device=CPU, max_rows=5, n_streams=256, t_tile=64)
    fresh._filter_tables = fresh._screen = None
    fresh._fused_tried = True
    assert [(fresh.count_staged(s), fresh.contains_staged(s)) for s in st] == fused
    assert fresh._fused is None and fresh._fused_sticky_setup() is None
    assert calls == {"B9": 3, "B11": 3}


def test_fused_kernel_error_raises(monkeypatch, recwarn):
    _, tm = _machines(MID)
    eng = GroupedAcEngine(tm, device=CPU, max_rows=5, n_streams=256, t_tile=64)
    eng._filter_tables = None
    st = eng._stage(MID_HAY)

    def broken(*a):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(tgrouped, "comb16_count_grouped", broken)
    monkeypatch.setattr(tgrouped, "comb16_contains_grouped", broken)
    monkeypatch.setattr(tgrouped, "screen_count", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.count_staged(st)  # the suffix screen's
    assert eng._screen is not None and eng._fused is None  # no fallback to B9
    eng._screen = None
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.count_staged(st)  # B9's
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.contains_staged(st)
    assert eng._fused is not None and eng._fused_sticky is not None  # still engaged
    assert len(recwarn) == 0


#: Sets the suffix screen declines, each beside config-5-like needles whose
#: count and containsAny fuse: a needle of 3 bytes, one of 17, and nine
#: distinct needles sharing the key (their last 4 bytes, MID's shortest).
DECLINED = {
    "three_bytes": MID + ["qzx"],
    "seventeen_bytes": MID + ["qzxqzxqzxqzxqzxqz"],
    "nine_share_a_key": MID + [p + "qxqx" for p in ("a", "b", "c", "d", "e", "f", "g", "h",
                                                     "i")],
}


@pytest.mark.parametrize("name", sorted(DECLINED))
def test_screen_declines_and_b9_counts(name, monkeypatch, tmp_path):
    from test_torch_spans import _check_nesting, _spans

    calls = _counting(monkeypatch)
    needles = DECLINED[name]
    _, tm = _machines(needles)
    eng = GroupedAcEngine(tm, device=CPU, max_rows=5, n_streams=256, t_tile=64)
    assert eng._screen is None
    hay = MID_HAY + " ".join(needles[150:]).encode()
    st = eng._stage(hay)
    got, spans = _spans(tmp_path, lambda: eng.count_staged(st))
    assert got == ac.count_matches(tm, hay) > 0
    assert calls["B9"] == 1 and eng._fused is not None
    counts = _check_nesting(spans)
    assert counts["amt.group.pass"] == 1 and "amt.group.screen" not in counts


def test_screen_takes_eight_sharing_a_key(monkeypatch, tmp_path):
    """Eight distinct needles sharing a key are within the screen's bound:
    one screen span inside one pass a count, and B9 is not launched."""
    from test_torch_spans import _check_nesting, _parent, _spans

    calls = _counting(monkeypatch)
    needles = MID + [p + "qxqx" for p in "abcdefgh"]
    _, tm = _machines(needles)
    eng = GroupedAcEngine(tm, device=CPU, max_rows=5, n_streams=256, t_tile=64)
    assert eng._screen is not None and eng._screen.key_bytes == 4
    hay = MID_HAY + " ".join(needles[150:]).encode()
    st = eng._stage(hay)
    got, spans = _spans(tmp_path, lambda: eng.count_staged(st))
    assert got == ac.count_matches(tm, hay) > 0
    assert calls["B9"] == 0 and eng._fused is None
    assert _check_nesting(spans) == {"amt.group.pass": 1, "amt.group.screen": 1,
                                     "amt.readback": 1, "amt.reduce": 1}
    names = [n for n, _, _ in spans]
    assert _parent(spans, names.index("amt.group.screen")) == "amt.group.pass"


def test_shared_staging_nul_group():
    # A NUL-needle group beside zero-inert groups on one staging: the NUL
    # group's kernels must not read the right padding (cf. the JAX test of
    # the same name), fused and per group.
    needles = ["\x00y", "a\x00b"] + MID[:60]
    tm = ac.build([(n, i) for i, n in enumerate(needles)])
    eng = GroupedAcEngine(tm, device=CPU, max_rows=4, n_streams=256, t_tile=64)
    inert = [_zero_inert(e.machine) for e in eng.engines]
    assert not inert[0] and all(inert[1:]) and eng.n_groups > 1
    hay = (b"q\x00y abcd a\x00b " + MID_HAY[:300] + b"\x00" * 5) * 3
    st = eng._stage(hay)
    count, any_, matches = _oracle(jac.build([(n, i) for i, n in enumerate(needles)]), hay)
    assert eng._fused_setup() is not None and eng._fused_sticky_setup() is not None
    assert not all(_zero_inert(m) for m in tgrouped.partition_uniform16(tm, 4)[2])
    assert eng.count_staged(st) == count
    assert eng.contains_staged(st) is any_
    ends, vids = eng.matches_arrays_staged(st)
    assert [(int(e), int(v)) for e, v in zip(ends, vids)] == matches
    assert sum(e.count_staged(st) for e in eng.engines) == count
    assert eng.count(b"qr" * 10) == 0 and eng.contains(b"qr" * 10) is False


def test_split_and_retry(monkeypatch):
    # One group of everything overflows every single-pass engine: the engine
    # splits it in halves on needle boundaries until each half fits, and
    # duplicates stay together.
    _, tm = _machines(DUPS)
    monkeypatch.setattr(tgrouped, "partition_adaptive",
                        lambda m, max_rows: [list(range(len(m.needles)))])
    eng = GroupedAcEngine(tm, device=CPU, max_rows=2, n_streams=128, t_tile=64)
    assert eng.n_groups > 2
    assert sorted(v for g in eng.groups for v in g) == list(range(len(DUPS)))
    where = {v: i for i, g in enumerate(eng.groups) for v in g}
    for v, nd in enumerate(DUPS):
        assert where[v] == where[DUPS.index(nd)]
    hay = " ".join(DUPS).encode()
    assert eng.count(hay) == ac.count_matches(tm, hay)
    ends, vids = eng.matches_arrays(hay)
    assert [(int(e), int(v)) for e, v in zip(ends, vids)] == [
        (x.pos, x.value) for x in ac.all_matches(tm, hay)]


def test_top_level_screen_replaces_the_groups():
    _, tm = _machines(MID)
    eng = GroupedAcEngine(tm, device=CPU, max_rows=5, n_streams=256, t_tile=64)
    lay = eng._filter_lay
    assert lay is not None and lay.n_words > 3
    assert all(getattr(e, "_filter_tables", None) is None for e in eng.engines)
    # The same plan as the JAX package's 12-word screen.
    want = jfilter.plan_filter(jac.build([(n, i) for i, n in enumerate(MID)]), max_words=12)
    assert (lay.n_words, lay.shorts) == (want.n_words, want.shorts)
    assert eng.contains(b"0 " * 2000) is False  # no chain fires: the screen says False
    # Detached, the screen leaves every containsAny to the groups' scans.
    eng._filter_tables = None
    assert eng.contains(MID_HAY) is True and eng.contains(b"0 " * 2000) is False


def test_adopt_staged_needs_the_full_overlap():
    _, tm = _machines(MID)
    eng = GroupedAcEngine(tm, device=CPU, max_rows=5, n_streams=256, t_tile=64)
    st = eng._stage(MID_HAY)
    assert eng.adopt_staged(st) is st and eng.adopt_staged(None) is None
    short = DenseAcEngine(ac.build([("ab", 0)]), device=CPU, n_streams=256, t_tile=64)
    assert eng.adopt_staged(short.stage(np.frombuffer(MID_HAY, np.uint8))) is None
    with pytest.raises(ValueError, match="overlap override below"):
        DenseAcEngine(tm, device=CPU, overlap=2)
    with pytest.raises(ValueError, match="max_rows must be in"):
        DenseAcEngine(ac.build([("ab", 0)]), device=CPU, max_rows=49)


def test_match_engine_takes_the_grouped_engine():
    needles = config5_needles(500)
    tm = ac.build([(n, i) for i, n in enumerate(needles)])
    with pytest.raises(CapacityError, match="grouped engine"):
        tcomb.make_engine(tm, "cpu")
    me = MatchEngine(tm, "device", device="cpu")
    eng = me.device_engine()
    assert type(eng) is GroupedAcEngine and eng.n_groups > 1
    hay = b"..".join(n.encode() for n in needles[::7])
    np.testing.assert_array_equal(me.value_presence(hay, CASE_SENSITIVE),
                                  _presence(jac.build([(n, i) for i, n in enumerate(needles)]), hay))

