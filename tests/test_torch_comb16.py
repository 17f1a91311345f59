"""The comb16 tier of the PyTorch port against the JAX package.

* Builder pins: ``models/minimize.py``, the comb helpers of
  ``ops/comb_scan.py`` and the comb16 builder of ``ops/comb16_scan.py`` are
  numpy copies; each gives the original's arrays, field by field, on seeded
  machines.
* Kernels: B8 (comb16 count), B10 (comb16 sticky scan) and B13 (the hit
  bitmap's comb16 step), run here by their plain torch versions, equal the
  JAX kernels in interpret mode on the same corpus, and on the JAX engine's
  own tables through ``convert.comb16_tables_from_jax``: B8 and B13 on the
  nested set, B10 on config 2's needles, once each, since each compile in
  interpret mode takes some 10 s to 50 s.  Per-stream outputs
  are compared on live streams (both packages drop the others).
* Wider checks against the host oracles: ``Comb16Machine.resolve_classes``
  (which emulates the kernel exactly), the scalar fold and the port's C++
  engine, on those sets, a NUL-bearing set and 150 needles; and the probe
  windows' fit on seeded sets of 30 to 150 needles.
* The dispatcher: bitap, then dense, then comb16, then ``CapacityError``.

Tolerance: exact equality of every array, count, base and bit.
"""

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.bench.dataformat import synth_corpus
from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.models import minimize as jmin
from alfred_margaret_tpu.ops import comb16_scan as j16
from alfred_margaret_tpu.ops import comb_scan as jcomb
from alfred_margaret_tpu.ops.pallas_scan import CapacityError as JaxCapacityError
from alfred_margaret_tpu.ops.pallas_scan import _StickyView as JaxStickyView
from alfred_margaret_tpu.ops.pallas_scan import _boundary_scalars

from alfred_margaret_tpu_torch import convert
from alfred_margaret_tpu_torch.kernels import comb16_contains, comb16_count, matchbits
from alfred_margaret_tpu_torch.kernels.comb16 import comb16_contains_plain
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.models import minimize as tmin
from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine
from alfred_margaret_tpu_torch.ops import comb16_scan as t16
from alfred_margaret_tpu_torch.ops import comb_scan as tcomb
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap
from alfred_margaret_tpu_torch.ops.pallas_scan import CapacityError, DenseAcEngine, _StickyView
from alfred_margaret_tpu_torch.ops.pallas_scan import _zero_inert

from test_torch_matches import jax_bits
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")


def random_needles(seed: int, n: int):
    """``n`` distinct random lower-case needles of 4 to 8 letters, drawn as
    ``alfred_margaret_tpu/bench/configs.py`` draws config 2's."""
    rng = np.random.default_rng(seed)
    return list(dict.fromkeys(
        "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(4, 9)))
        for _ in range(int(n * 1.1))
    ))[:n]


#: BASELINE.json config 2: 100 needles, four of them nested.
CONFIG2 = random_needles(7, 100)
CONFIG2[:4] = ["abc", "abcd", "bcd", "c"]
#: Counts of up to 5 per state: the minimized build has 4 count ranges.
NESTED = ["a", "aa", "aaa", "aaaa", "aaaaa"] + random_needles(13, 80)
#: NUL bytes: not zero-inert, and no stride-2 screen.
NUL = CONFIG2[:60] + ["a\x00b", "\x00\x00x"]
N150 = random_needles(21, 150)
N200 = random_needles(22, 200)

SETS = {"config2": CONFIG2, "nested": NESTED, "nul": NUL}


def _machines(needles):
    pairs = [(n, i) for i, n in enumerate(needles)]
    return jac.build(pairs), ac.build(pairs)


# -- pins: minimize, comb helpers, comb16 builder ----------------------------------


def _assert_machine_equal(got, want, fields):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f


@pytest.mark.parametrize("name", sorted(SETS))
def test_minimize_matches_jax(name):
    jm, tm = _machines(SETS[name])
    want, got = jmin.count_minimized(jm), tmin.count_minimized(tm)
    assert (want is jm) == (got is tm)
    _assert_machine_equal(got, want, ("delta", "out_offset", "out_values", "match_count", "fail",
                                      "max_needle_bytes"))
    assert got.n_states < tm.n_states
    for newid_w, newid_g in zip(jmin.quotient(jm.delta, jm.match_count),
                                tmin.quotient(tm.delta, tm.match_count)):
        np.testing.assert_array_equal(newid_g, newid_w)
    sw = jmin.minimize_sticky(JaxStickyView(want))
    sg = tmin.minimize_sticky(_StickyView(got))
    assert type(sg).__name__ == type(sw).__name__ == "_MinStickyView"
    _assert_machine_equal(sg, sw, ("delta", "match_count", "fail", "absorb"))
    protect = np.arange(tm.n_states) % 3
    _assert_machine_equal(tmin.minimize_for_counts(tm, protect),
                          jmin.minimize_for_counts(jm, protect), ("delta", "match_count", "fail"))


def test_minimize_kill_switch(monkeypatch):
    monkeypatch.setenv("AMT_MINIMIZE", "0")
    _, tm = _machines(CONFIG2)
    assert tmin.count_minimized(tm) is tm
    view = _StickyView(tm)
    assert tmin.minimize_sticky(view) is view


@pytest.mark.parametrize("name", sorted(SETS))
def test_comb_helpers_match_jax(name):
    jm, tm = _machines(SETS[name])
    for w, g in zip(jcomb._choose_classes(jm.delta), tcomb._choose_classes(tm.delta)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    comp, _ = tcomb._choose_classes(tm.delta)
    for d in (1, 16, 64):
        cw = jcomb._center_candidates(jm, comp.shape[0], d)
        cg = tcomb._center_candidates(tm, comp.shape[0], d)
        np.testing.assert_array_equal(cg, cw)
        mw, mg = jcomb._mism_matrix(comp, cw), tcomb._mism_matrix(comp, cg)
        assert mg.dtype == mw.dtype
        np.testing.assert_array_equal(mg, mw)


C16_FIELDS = ("classmap", "comb", "aux", "root_row", "segtable", "base", "cbase", "def_idx",
              "inv_base", "n_states", "k", "D", "rows_c", "rows_a", "CB", "OB", "BB",
              "n_exceptions", "count_ranges", "base_mask", "owner_mask", "count_shift",
              "rows_total")


def _views(needles):
    """(label, JAX machine, port machine) of the three builds an engine makes:
    the full machine, the count-minimized one and the minimized sticky view."""
    jm, tm = _machines(needles)
    jmm, tmm = jmin.count_minimized(jm), tmin.count_minimized(tm)
    return [
        ("full", jm, tm),
        ("minimized", jmm, tmm),
        ("sticky", jmin.minimize_sticky(JaxStickyView(jmm)), tmin.minimize_sticky(_StickyView(tmm))),
    ]


@pytest.mark.parametrize("name", sorted(SETS) + ["n150"])
def test_build_comb16_matches_jax(name):
    needles = N150 if name == "n150" else SETS[name]
    for label, jm, tm in _views(needles):
        want, got = j16.build_comb16(jm), t16.build_comb16(tm)
        _assert_machine_equal(got, want, C16_FIELDS)
        # The host oracle on random (state, class) pairs.
        rng = np.random.default_rng(5)
        states = rng.integers(0, got.n_states, size=2000)
        classes = rng.integers(0, got.k, size=2000)
        for w, g in zip(want.resolve_classes(states, classes), got.resolve_classes(states, classes)):
            np.testing.assert_array_equal(g, w)
        assert got.count_of_base(got.base).tolist() == want.count_of_base(want.base).tolist()
        assert t16.comb16_structure_cost(tm) == j16.comb16_structure_cost(jm), label
    if name == "nested":
        assert len(t16.build_comb16(_views(needles)[1][2]).count_ranges) == 4


def test_comb16_helpers_match_jax():
    assert t16.MAX_COUNT16 == j16.MAX_COUNT16 == 7
    for mc, S in ((0, 10), (1, 400), (5, 1500), (0, 3000)):
        assert t16._field_split(mc, S) == j16._field_split(mc, S)
    for mc, S in ((8, 10), (1, 40000)):
        with pytest.raises(JaxCapacityError) as want:
            j16._field_split(mc, S)
        with pytest.raises(CapacityError, match=str(want.value)):
            t16._field_split(mc, S)
    rng = np.random.default_rng(2)
    entries = rng.integers(0, 1 << 16, size=301)
    packed = t16._pack16(entries, 160)
    np.testing.assert_array_equal(packed, j16._pack16(entries, 160))
    w = rng.integers(0, 301, size=500)
    np.testing.assert_array_equal(t16._unpack16(packed, w), j16._unpack16(packed, w))
    np.testing.assert_array_equal(t16._unpack16(packed, w), entries[w])
    bases = np.array([0, 3, 40, 41, 77], dtype=np.int64)
    np.testing.assert_array_equal(t16._empty_residues(128, 27, 4, bases),
                                  j16._empty_residues(128, 27, 4, bases))


def test_build_comb16_capacity_matches_jax():
    jm, tm = _machines(N200)
    with pytest.raises(JaxCapacityError) as want:
        j16.build_comb16(jm)
    with pytest.raises(CapacityError) as got:
        t16.build_comb16(tm)
    assert str(got.value) == str(want.value)
    jm, tm = _machines(CONFIG2)
    for split in ((1, 5, 10), (1, 4, 11)):
        _assert_machine_equal(t16.build_comb16(tm, split=split), j16.build_comb16(jm, split=split),
                              C16_FIELDS)
    with pytest.raises(CapacityError):
        t16.build_comb16(tm, split=(1, 5, 9))


def test_tables_check_probe_windows():
    _, tm = _machines(CONFIG2)
    c16 = t16.build_comb16(tm)
    t16.Comb16Tables.from_machine(c16, CPU)
    with pytest.raises(CapacityError, match="comb16 comb probe window"):
        t16.Comb16Tables.from_arrays(
            c16.classmap, c16.comb[:128], c16.aux, c16.root_row, c16.segtable, c16.count_ranges,
            c16.BB, c16.OB, c16.CB, int(c16.base[0]), CPU, bases=c16.base, cbases=c16.cbase,
            k=c16.k,
        )
    with pytest.raises(CapacityError, match="comb16 aux probe window"):
        t16.Comb16Tables.from_arrays(
            c16.classmap, c16.comb, c16.aux[:4], c16.root_row, c16.segtable, c16.count_ranges,
            c16.BB, c16.OB, c16.CB, int(c16.base[0]), CPU, bases=c16.base, cbases=c16.cbase,
            k=c16.k,
        )


# -- kernels B8, B10 and B13 against the JAX kernels (interpret mode) -------------


def _engines(needles, hay, **kw):
    kw = {"n_streams": 128, "t_tile": 32, **kw}
    jm, tm = _machines(needles)
    jeng = j16.Comb16PallasAcEngine(jm, interpret=True, **kw)
    eng = t16.Comb16AcEngine(tm, device=CPU, **kw)
    data = np.frombuffer(hay, dtype=np.uint8)
    st, pst = jeng.stage(data), eng.stage(data)
    np.testing.assert_array_equal(pst.live_np, st.live_np.reshape(-1))
    return jeng, st, eng, pst


def _corpus(needles, n, seed):
    return synth_corpus([x for x in needles if "\x00" not in x] or needles, n,
                        hit_fraction=0.05, seed=seed) + "".join(needles[-2:]).encode() * 3


@pytest.mark.parametrize("name,kernel", [("nested", "B8"), ("config2", "B10")])
def test_count_and_sticky_match_jax_kernels(name, kernel):
    # One JAX kernel per machine, since each compile in interpret mode takes
    # some 10 s: B8 on the nested set (4 count ranges), B10 on config 2's
    # sticky view.  Both machines' tables are held to the JAX engine's, and
    # the NUL-bearing set to the host oracles below.
    needles = SETS[name]
    hay = _corpus(needles, 6 << 10, seed=1)
    jeng, st, eng, pst = _engines(needles, hay)
    live = pst.live_np
    T = st.plan.time_len
    total = jac.count_matches(jeng.machine, hay)
    got = eng.stream_counts(pst)
    assert got.dtype == torch.int32 and got.shape == (128,)
    assert eng.count_staged(pst) == total
    tabs = eng.sticky_tables()
    got_b = comb16_contains(*eng.sticky_args(pst))
    assert eng.contains_staged(pst) == (total > 0)

    if kernel == "B8":  # per-stream counts
        want = np.asarray(jeng._get_count_fn(T)(
            jeng._bscal_for(st), jeng._classmap_dev, jeng._comb_dev, jeng._aux_dev,
            jeng._rootseg_dev, st.warm_t, st.vend_t, st.streams_dev,
        )).reshape(-1)
        np.testing.assert_array_equal(got.numpy()[live], want[live])
        assert jeng.count_staged(st) == total
    else:  # final bases, with the base held from vend on (the strict scalars)
        c = jeng._sticky_setup()
        fn = jeng._get_contains_fn(T)
        strict = _boundary_scalars(st.warm_np, np.asarray(st.vend_t).reshape(-1), False)
        jt = (c["cm"], c["comb_dev"], c["aux_dev"], c["rootseg_dev"])
        want_b = np.asarray(fn(strict, *jt, st.vend_t, st.streams_dev)).reshape(-1)
        own_b = np.asarray(fn(jeng._bscal_for(st), *jt, st.vend_t, st.streams_dev)).reshape(-1)
        assert tabs.absorb == c["absorb_cb"]
        np.testing.assert_array_equal(got_b.numpy()[live], want_b[live])
        np.testing.assert_array_equal(got_b.numpy()[live] == tabs.absorb,
                                      own_b[live] == c["absorb_cb"])

    # The JAX engine's own tables, fed to the port's kernels.
    count_t, sticky_t = convert.comb16_tables_from_jax(jeng, CPU)
    for f, v in eng.tables.__dict__.items():
        assert (torch.equal(v, getattr(count_t, f)) if torch.is_tensor(v)
                else v == getattr(count_t, f)), f
    for f, v in tabs.__dict__.items():
        assert (torch.equal(v, getattr(sticky_t, f)) if torch.is_tensor(v)
                else v == getattr(sticky_t, f)), f
    assert torch.equal(comb16_count(pst.streams, pst.warm, pst.vend, *count_t.args()), got)
    assert torch.equal(comb16_contains(pst.streams, pst.vend, *sticky_t.sticky_args()), got_b)


def test_match_bits_match_jax_kernel():
    # One machine: the JAX bitmap kernel takes some 40 s in interpret mode.
    # The nested set has 4 count ranges; the other sets' bitmaps are held to
    # the host oracles below.
    needles = NESTED
    hay = _corpus(needles, 3 << 10, seed=2)
    jeng, st, eng, pst = _engines(needles, hay)
    jeng._bits_cap_hint, jeng._bits_bcap_hint = 1 << 14, 1 << 12
    want_pos, want_states = jeng.match_positions_staged_bits(st)
    want_counts, want_bits = jax_bits(jeng, st)
    args = eng.bits_args(pst)
    assert args[3] == "comb16"
    counts, bits = matchbits(*args)
    live = pst.live_np
    np.testing.assert_array_equal(counts.numpy()[live], want_counts[live])
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    pos, states = eng.match_positions_staged(pst)
    np.testing.assert_array_equal(pos, want_pos)
    np.testing.assert_array_equal(states, want_states)
    ends, vids = eng.matches_arrays_staged(pst)
    oracle = jac.all_matches(jeng.machine, hay)
    assert len(ends) == len(oracle) > 0
    assert [(int(e), int(v)) for e, v in zip(ends, vids)] == [(x.pos, x.value) for x in oracle]


# -- wider checks against the host oracles -----------------------------------------


def _resolve_scan(c16, data):
    """Per-position (next state, count) of the host oracle
    ``Comb16Machine.resolve_classes`` over ``data`` from the root."""
    s, counts = 0, np.zeros(len(data), dtype=np.int64)
    for i, cls in enumerate(c16.classmap[data]):
        nxt, cnt = c16.resolve_classes(np.array([s]), np.array([cls]))
        s, counts[i] = int(nxt[0]), int(cnt[0])
    return counts


@pytest.mark.parametrize("name", sorted(SETS) + ["n150"])
def test_engine_answers_match_host_oracles(name):
    needles = N150 if name == "n150" else SETS[name]
    _, tm = _machines(needles)
    hay = _corpus(needles, 40 << 10, seed=3)
    data = np.frombuffer(hay, dtype=np.uint8)
    eng = t16.Comb16AcEngine(tm, device=CPU, n_streams=1024, t_tile=64)
    st = eng.stage(data)
    host = CppAcEngine(tm)
    total = host.count(data)
    assert eng.count_staged(st) == total == ac.count_matches(tm, data)
    # The minimized table set, scanned by the oracle, counts the same.
    assert int(_resolve_scan(eng.c16, data[: 4 << 10]).sum()) == ac.count_matches(tm, data[: 4 << 10])
    counts, _ = matchbits(*eng.bits_args(st))
    assert int(counts.numpy()[st.live_np].astype(np.int64).sum()) == total
    assert eng.contains_staged(st) == (host.first_hit(data) >= 0)
    ends, vids = eng.matches_arrays_staged(st)
    hends, hvids = host.matches_arrays(data)
    np.testing.assert_array_equal(ends, hends)
    np.testing.assert_array_equal(vids, hvids)
    m = eng.machine
    _, hit = eng.match_positions_staged(st)
    np.testing.assert_array_equal(ac.presence_of_states(m, hit, len(m.values)),
                                  host.value_presence(data, len(m.values)))
    if name == "nul":
        assert not _zero_inert(m) and eng._filter_tables is None


def test_probe_windows_fit_every_build():
    """The kernels index the flat tables unclamped, so ``from_machine``
    refuses a build whose probe window passes its table.  On 16 seeded sets
    of 30 to 150 random needles it accepts every minimized and sticky build
    that ``build_comb16`` accepts."""
    built = 0
    for seed in range(16):
        mm = tmin.count_minimized(ac.build([(x, i) for i, x in enumerate(
            random_needles(1000 + seed, 30 + seed * 8))]))
        for view in (mm, tmin.minimize_sticky(_StickyView(mm))):
            try:
                c16 = t16.build_comb16(view)
            except CapacityError:
                continue
            t16.Comb16Tables.from_machine(c16, CPU)
            built += 1
    assert built == 32


def test_extraction_needs_b12():
    _, tm = _machines(CONFIG2)
    hay = np.frombuffer(_corpus(CONFIG2, 4 << 10, seed=4), np.uint8)
    odd = t16.Comb16AcEngine(tm, device=CPU, n_streams=128, t_tile=48)
    with pytest.raises(NotImplementedError, match=r"item 10 \(B12\)"):
        odd.match_positions_staged(odd.stage(hay))
    eng = t16.Comb16AcEngine(tm, device=CPU, n_streams=128, t_tile=32)
    st = eng.stage(hay)
    st.data_np = None
    with pytest.raises(NotImplementedError, match=r"item 10 \(B12\)"):
        eng.matches_arrays_staged(st)


def test_comb16_wrappers_check_inputs():
    _, tm = _machines(CONFIG2)
    eng = t16.Comb16AcEngine(tm, device=CPU, n_streams=8, t_tile=32)
    st = eng.stage(b"xxabcd" * 8)
    args = list(eng._kernel_args(st))
    bad = [
        (0, st.streams.int()),  # dtype
        (1, st.warm[:4]),  # warm shape
        (3, args[3][:128]),  # classmap shape
        (4, torch.zeros(48 * 128, dtype=torch.int32)),  # comb + aux over the shared memory
        (8, args[8][:5]),  # ranges shape
        (9, 7),  # BB: the fields no longer add up to 16 bits
        (10, 7),  # owner mask
        (12, 1 << 11),  # root base outside the base space
    ]
    for i, v in bad:
        a = list(args)
        a[i] = v
        with pytest.raises(ValueError):
            comb16_count(*a)
    sargs = list(eng.sticky_args(st))
    assert torch.equal(comb16_contains(*sargs), comb16_contains_plain(*sargs))
    for i, v in ((1, st.vend[:3]), (len(sargs) - 1, -1)):
        a = list(sargs)
        a[i] = v
        with pytest.raises(ValueError):
            comb16_contains(*a)


# -- the dispatcher ------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 10, 20, 30])
def test_dispatcher_keeps_small_sets_on_their_engine(n):
    _, tm = _machines(random_needles(30 + n, n))
    want = BitapAcEngine if plan_bitap(tm, max_words=2) is not None else DenseAcEngine
    assert type(tcomb.make_engine(tm, "cpu")) is want


@pytest.mark.parametrize("name", ["config2", "n150"])
def test_dispatcher_sends_large_sets_to_comb16(name):
    _, tm = _machines(N150 if name == "n150" else CONFIG2)
    with pytest.raises(CapacityError):
        DenseAcEngine(tm, device=CPU)
    assert type(tcomb.make_engine(tm, "cpu")) is t16.Comb16AcEngine


def test_dispatcher_names_the_grouped_engine():
    _, tm = _machines(N200)
    with pytest.raises(CapacityError, match="ROADMAP Queue A item 12"):
        tcomb.make_engine(tm, "cpu")
