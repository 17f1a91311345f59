"""The comb32 tier of the PyTorch port against the JAX package.

* Builder pins: ``CombMachine`` and ``build_comb`` of ``ops/comb_scan.py``
  are numpy copies; each gives the original's arrays, field by field, on the
  three builds an engine makes (the full machine, the count-minimized one
  and the minimized sticky view) of seeded sets, and the same
  ``CapacityError`` where a build does not fit.
* Kernels: B15 (comb32 count), B16 (comb32 sticky scan) and B17 (comb32
  packed states), run here by their plain torch versions, equal the JAX
  kernels in interpret mode on the same corpus and on the JAX engine's own
  tables through ``convert.comb_tables_from_jax``, once each, on 200 random
  needles (which overflow comb16, so both packages' dispatchers take
  comb32); the extraction built on B15 and B17 equals the JAX engine's.
* Wider checks against the host oracles: ``CombMachine.resolve_classes``
  (which emulates the kernels' step), the scalar fold and the port's C++
  engine, on those sets, a NUL-bearing set and counts of up to 5 per state.
* The dispatcher takes comb32 where comb16 overflows, as the JAX package's.

Tolerance: exact equality of every array, count, base and entry.
"""

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.bench.dataformat import synth_corpus
from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.models import minimize as jmin
from alfred_margaret_tpu.ops import comb_scan as jcomb
from alfred_margaret_tpu.ops.pallas_scan import CapacityError as JaxCapacityError
from alfred_margaret_tpu.ops.pallas_scan import _StickyView as JaxStickyView
from alfred_margaret_tpu.ops.pallas_scan import _boundary_scalars

from alfred_margaret_tpu_torch import MatchEngine, convert
from alfred_margaret_tpu_torch.kernels import comb_contains, comb_count, comb_states
from alfred_margaret_tpu_torch.kernels.comb import comb_contains_plain, comb_states_plain
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.models import minimize as tmin
from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine
from alfred_margaret_tpu_torch.ops import comb_scan as tcomb
from alfred_margaret_tpu_torch.ops.comb16_scan import build_comb16
from alfred_margaret_tpu_torch.ops.pallas_scan import CapacityError, _StickyView, _zero_inert

from test_torch_comb16 import N200, random_needles
from test_torch_grouped import config5_needles
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")

#: Counts of up to 5 per state (the 4-bit count field holds 15).
NESTED = ["a", "aa", "aaa", "aaaa", "aaaaa"] + random_needles(31, 120)
#: NUL bytes: not zero-inert.
NUL = N200[:150] + ["a\x00b", "\x00\x00x"]
C5_300 = config5_needles(300)
SETS = {"n200": N200, "nested": NESTED, "nul": NUL, "config5_300": C5_300}

FIELDS = ("classmap", "comb", "def_table", "base", "def_idx", "inv_base", "n_states", "k", "D",
          "rows_c", "rows_d", "owner_bits", "def_bits", "n_exceptions", "owner_shift",
          "owner_mask", "def_mask", "rows_total")


def _machines(needles):
    pairs = [(n, i) for i, n in enumerate(needles)]
    return jac.build(pairs), ac.build(pairs)


def _views(needles):
    """(label, JAX machine, port machine) of the three builds an engine
    makes: the full machine, the count-minimized one and the minimized
    sticky view."""
    jm, tm = _machines(needles)
    jmm, tmm = jmin.count_minimized(jm), tmin.count_minimized(tm)
    return [
        ("full", jm, tm),
        ("minimized", jmm, tmm),
        ("sticky", jmin.minimize_sticky(JaxStickyView(jmm)), tmin.minimize_sticky(_StickyView(tmm))),
    ]


def _assert_equal(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f


# -- pins: the comb32 builder -------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SETS))
def test_build_comb_matches_jax(name):
    for label, jm, tm in _views(SETS[name]):
        want, got = jcomb.build_comb(jm), tcomb.build_comb(tm)
        _assert_equal(got, want)
        rng = np.random.default_rng(5)
        states = rng.integers(0, got.n_states, size=2000)
        classes = rng.integers(0, got.k, size=2000)
        for w, g in zip(want.resolve_classes(states, classes), got.resolve_classes(states, classes)):
            np.testing.assert_array_equal(g, w, err_msg=label)
        assert got.rows_total <= 48


@pytest.mark.parametrize("max_rows", [4, 8, 16])
def test_build_comb_capacity_matches_jax(max_rows):
    jm, tm = _machines(N200)
    try:
        want = jcomb.build_comb(jm, max_rows)
    except JaxCapacityError as e:
        with pytest.raises(CapacityError) as got:
            tcomb.build_comb(tm, max_rows)
        assert str(got.value) == str(e)
    else:
        _assert_equal(tcomb.build_comb(tm, max_rows), want)


def test_build_comb_refuses_what_jax_refuses():
    # A state with 16 matches overflows the 4-bit count field; 200 needles
    # overflow two rows.
    for needles, max_rows in ((["a" * i for i in range(1, 17)], 48), (N200, 2)):
        jm, tm = _machines(needles)
        with pytest.raises(JaxCapacityError) as want:
            jcomb.build_comb(jm, max_rows)
        with pytest.raises(CapacityError) as got:
            tcomb.build_comb(tm, max_rows)
        assert str(got.value) == str(want.value)


# -- kernels B15, B16 and B17 against the JAX kernels (interpret mode) ------------------


def _corpus(needles, n, seed):
    return synth_corpus([x for x in needles if "\x00" not in x] or needles, n,
                        hit_fraction=0.05, seed=seed) + "".join(needles[-2:]).encode() * 3


@pytest.fixture(scope="module")
def n200():
    """N200 in both packages: the JAX comb32 engine (interpret mode), the
    port's, and one corpus staged by each."""
    jm, tm = _machines(N200)
    kw = {"n_streams": 128, "t_tile": 32}
    jeng = jcomb.CombPallasAcEngine(jm, interpret=True, **kw)
    eng = tcomb.CombAcEngine(tm, device=CPU, **kw)
    hay = _corpus(N200, 4 << 10, seed=1)
    data = np.frombuffer(hay, dtype=np.uint8)
    st, pst = jeng.stage(data), eng.stage(data)
    np.testing.assert_array_equal(pst.live_np, st.live_np.reshape(-1))
    np.testing.assert_array_equal(pst.warm_np, np.asarray(st.warm_np).reshape(-1))
    return jeng, st, eng, pst, hay


def _assert_tables_equal(got, want):
    for f, v in want.__dict__.items():
        assert (torch.equal(getattr(got, f), v) if torch.is_tensor(v)
                else getattr(got, f) == v), f


def test_b15_matches_jax_kernel(n200):
    jeng, st, eng, pst, hay = n200
    T, live = st.plan.time_len, pst.live_np
    want = np.asarray(jeng._get_count_fn(T)(
        jeng._bscal_for(st), jeng._classmap_dev, jeng._comb_dev, jeng._def_dev,
        st.warm_t, st.vend_t, st.streams_dev,
    )).reshape(-1)
    got = eng.stream_counts(pst)
    assert got.dtype == torch.int32 and got.shape == (128,)
    np.testing.assert_array_equal(got.numpy()[live], want[live])
    total = jac.count_matches(jeng.machine, hay)
    assert eng.count_staged(pst) == jeng.count_staged(st) == total > 0
    count_t, _, _ = convert.comb_tables_from_jax(jeng, CPU)
    _assert_tables_equal(eng.tables, count_t)
    assert torch.equal(comb_count(pst.streams, pst.warm, pst.vend, *count_t.args()), got)
    assert eng.comb is not eng.comb_full  # B15 scans the count-minimized machine


def test_b16_matches_jax_kernel(n200):
    jeng, st, eng, pst, hay = n200
    T, live = st.plan.time_len, pst.live_np
    c = jeng._sticky_setup()
    fn = jeng._get_contains_fn(T)
    jt = (c["cm"], c["comb_dev"], c["def_dev"])
    strict = _boundary_scalars(st.warm_np, np.asarray(st.vend_t).reshape(-1), False)
    want = np.asarray(fn(strict, *jt, st.vend_t, st.streams_dev)).reshape(-1)
    own = np.asarray(fn(jeng._bscal_for(st), *jt, st.vend_t, st.streams_dev)).reshape(-1)
    got = comb_contains(*eng.sticky_args(pst))
    tabs = eng.sticky_tables()
    assert tabs.absorb == c["absorb_base"]
    np.testing.assert_array_equal(got.numpy()[live], want[live])
    np.testing.assert_array_equal(got.numpy()[live] == tabs.absorb, own[live] == c["absorb_base"])
    assert eng.contains_staged(pst) is jeng.contains_staged(st) is True
    _, sticky_t, _ = convert.comb_tables_from_jax(jeng, CPU)
    _assert_tables_equal(tabs, sticky_t)
    assert torch.equal(comb_contains(pst.streams, pst.vend, *sticky_t.sticky_args()), got)


def test_b17_matches_jax_kernel(n200):
    jeng, st, eng, pst, hay = n200
    T = st.plan.time_len
    want = np.asarray(jeng._states_call(st)).reshape(T, -1)
    got = comb_states(*eng.states_args(pst))
    assert got.dtype == torch.int32 and got.shape == (T, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    _, _, full_t = convert.comb_tables_from_jax(jeng, CPU)
    _assert_tables_equal(eng.full_tables, full_t)
    assert torch.equal(comb_states(pst.streams, *full_t.args()), got)
    # The extraction on B15 and B17 equals the JAX engine's states path.
    want_pos, want_states = jeng.match_positions_staged(st)
    pos, states = eng.match_positions_staged(pst)
    np.testing.assert_array_equal(pos, want_pos)
    np.testing.assert_array_equal(states, want_states)
    ends, vids = eng.matches_arrays_staged(pst)
    assert [(int(e), int(v)) for e, v in zip(ends, vids)] == [
        (x.pos, x.value) for x in jac.all_matches(jeng.machine, hay)]


# -- wider checks against the host oracles -----------------------------------------


def _resolve_scan(cm, data):
    """Per-position counts of the host oracle ``CombMachine.resolve_classes``
    over ``data`` from the root."""
    s, counts = 0, np.zeros(len(data), dtype=np.int64)
    for i, cls in enumerate(cm.classmap[data]):
        nxt, cnt = cm.resolve_classes(np.array([s]), np.array([cls]))
        s, counts[i] = int(nxt[0]), int(cnt[0])
    return counts


@pytest.mark.parametrize("name", sorted(SETS))
def test_engine_answers_match_host_oracles(name):
    needles = SETS[name]
    _, tm = _machines(needles)
    data = np.frombuffer(_corpus(needles, 24 << 10, seed=3), dtype=np.uint8)
    eng = tcomb.CombAcEngine(tm, device=CPU, n_streams=512, t_tile=64)
    st = eng.stage(data)
    host = CppAcEngine(tm)
    total = host.count(data)
    assert eng.count_staged(st) == total == ac.count_matches(tm, data) > 0
    assert int(_resolve_scan(eng.comb, data[: 2 << 10]).sum()) == ac.count_matches(tm, data[: 2 << 10])
    assert eng.contains_staged(st) is (host.first_hit(data) >= 0)
    ends, vids = eng.matches_arrays_staged(st)
    hends, hvids = host.matches_arrays(data)
    np.testing.assert_array_equal(ends, hends)
    np.testing.assert_array_equal(vids, hvids)
    _, hit = eng.match_positions_staged(st)
    np.testing.assert_array_equal(ac.presence_of_states(tm, hit, len(tm.values)),
                                  host.value_presence(data, len(tm.values)))
    assert _zero_inert(tm) is (name != "nul")
    if name == "nested":
        assert int(tm.match_count.max()) == 5


def test_extraction_without_matches_skips_b17(monkeypatch):
    _, tm = _machines(N200)
    eng = tcomb.CombAcEngine(tm, device=CPU, n_streams=128, t_tile=32)
    calls = []
    monkeypatch.setattr(tcomb, "comb_states", lambda *a: calls.append(1) or comb_states_plain(*a))
    st = eng.stage(np.frombuffer(b"0123456789 " * 300, np.uint8))
    pos, states = eng.match_positions_staged(st)
    assert len(pos) == len(states) == 0 and calls == []
    assert eng.contains_staged(st) is False
    with pytest.raises(NotImplementedError, match="no hit-bitmap step"):
        eng.bits_args(st)
    st = eng.stage(np.frombuffer(b"0123 " * 100 + N200[3].encode() + b" 99" * 50, np.uint8))
    pos, _ = eng.match_positions_staged(st)
    assert len(pos) >= 1 and calls == [1]


def test_comb_wrappers_check_inputs():
    _, tm = _machines(N200)
    eng = tcomb.CombAcEngine(tm, device=CPU, n_streams=8, t_tile=32)
    st = eng.stage(np.frombuffer(b"xxabcd" * 8, np.uint8))
    args = list(eng._kernel_args(st))
    bad = [
        (0, st.streams.int()),  # dtype
        (1, st.warm[:4]),  # warm shape
        (3, args[3][:128]),  # classmap shape
        (4, torch.zeros(48 * 128, dtype=torch.int32)),  # comb + default rows over shared memory
        (6, 0),  # k
        (7, 15),  # owner bits: no default-row bits left
        (8, 1 << 13),  # root base outside the base field
        (9, 1 << (14 - args[7])),  # root default row outside its field
    ]
    for i, v in bad:
        a = list(args)
        a[i] = v
        with pytest.raises(ValueError):
            comb_count(*a)
    sargs = list(eng.sticky_args(st))
    assert torch.equal(comb_contains(*sargs), comb_contains_plain(*sargs))
    for i, v in ((1, st.vend[:3]), (len(sargs) - 2, 1 << 13)):  # vend, absorb
        a = list(sargs)
        a[i] = v
        with pytest.raises(ValueError):
            comb_contains(*a)
    with pytest.raises(ValueError):
        comb_states(st.streams[:, :4], *eng.full_tables.args())  # streams not contiguous
    with pytest.raises(ValueError, match="classmap is on cpu"):
        comb_states(st.streams.to("meta"), *eng.full_tables.args())


# -- the dispatcher ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["n200", "config5_300"])
def test_dispatcher_takes_comb32_where_comb16_overflows(name):
    jm, tm = _machines(SETS[name])
    with pytest.raises(CapacityError):
        build_comb16(tm)
    eng = tcomb.make_engine(tm, "cpu")
    assert type(eng) is tcomb.CombAcEngine
    assert type(jcomb.make_pallas_engine(jm, interpret=True)) is jcomb.CombPallasAcEngine
    assert type(MatchEngine(tm, "device", device="cpu").device_engine()) is tcomb.CombAcEngine


def test_dispatcher_groups_what_the_jax_plan_refuses():
    # Config 5's first 500 needles: the JAX plan estimates that no comb table
    # holds them and its dispatcher groups them without a build, although
    # comb32's placement would fit; the port's dispatcher decides alike.
    jm, tm = _machines(config5_needles(500))
    with pytest.raises(JaxCapacityError) as want:
        jcomb.make_pallas_engine(jm, interpret=True)
    with pytest.raises(CapacityError, match="the grouped engine") as got:
        tcomb.make_engine(tm, "cpu")
    assert str(got.value).startswith(str(want.value))
    assert tcomb.build_comb(tm).rows_total <= 48
