"""The PyTorch port's copied helpers against the JAX package's originals.

The port copies the numpy stream planners (the kernel engines' and the
reference scan engine's ``plan_streams``), the dense-table compressor, the
bitap track planner, the sticky view and the extraction helpers (their JAX
modules import ``jax``, which the port must not).  Each copy must give
exactly the original's output, on the native and the numpy paths where there
are both; the torch staging must give ``build_streams``'s bytes; and the JAX
engines' tables passed through ``convert.py`` must equal the port's own.
"""

import dataclasses

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.bench.dataformat import synth_corpus
from alfred_margaret_tpu.models import ac
from alfred_margaret_tpu.native.build import NativeUnavailable
from alfred_margaret_tpu.ops import bitap_scan as jbitap
from alfred_margaret_tpu.ops import pallas_scan as jdense
from alfred_margaret_tpu.ops import xla_scan as jxla
from alfred_margaret_tpu.utils import utf8

from alfred_margaret_tpu_torch import convert
from alfred_margaret_tpu_torch import engine as tengine
from alfred_margaret_tpu_torch.ops import bitap_scan as tbitap
from alfred_margaret_tpu_torch.ops import pallas_scan as tdense
from alfred_margaret_tpu_torch.ops import xla_scan as txla
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")


def _machine(needles):
    return ac.build([(n, i) for i, n in enumerate(needles)])


# -- stream layout ------------------------------------------------------------

# (n, S, L, K, T): plain, L < K head fix-up, corpus shorter than S,
# K = 0 with tail zeroing, an empty corpus, a single stream.
PLANS = [
    (1000, 8, 125, 5, 130),
    (100, 64, 2, 5, 32),
    (10, 32, 1, 3, 8),
    (5000, 128, 40, 0, 64),
    (0, 4, 1, 2, 4),
    (777, 1, 777, 9, 800),
]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    # Plenty of NULs and repeats, so any misplaced byte shows.
    return rng.integers(0, 8, size=n).astype(np.uint8)


@pytest.mark.parametrize("plan", PLANS, ids=[f"n{p[0]}_S{p[1]}_L{p[2]}_K{p[3]}" for p in PLANS])
def test_build_streams_matches_jax(plan):
    n, S, L, K, T = plan
    data = _data(n)
    want = jxla.build_streams(data, jxla.StreamPlan(n, S, L, K, T))
    got = txla.build_streams(data, txla.StreamPlan(n, S, L, K, T))
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("plan", PLANS, ids=[f"n{p[0]}_S{p[1]}_L{p[2]}_K{p[3]}" for p in PLANS])
def test_torch_staging_equals_build_streams(plan):
    n, S, L, K, T = plan
    data = _data(n, seed=1)
    want, wwarm, wvend = jxla.build_streams(data, jxla.StreamPlan(n, S, L, K, T))
    streams, warm, vend = txla.stage_streams_device(data, txla.StreamPlan(n, S, L, K, T), CPU)
    assert streams.dtype == torch.uint8 and streams.is_contiguous()
    np.testing.assert_array_equal(streams.numpy(), want)
    np.testing.assert_array_equal(warm, wwarm)
    np.testing.assert_array_equal(vend, wvend)


def test_torch_staging_read_only_input():
    # np.frombuffer of bytes is read-only; staging must accept it.
    data = np.frombuffer(b"tshirts and shorts " * 30, dtype=np.uint8)
    plan = txla.StreamPlan(len(data), 16, 36, 5, 48)
    streams, _, _ = txla.stage_streams_device(data, plan, CPU)
    want, _, _ = jxla.build_streams(data, jxla.StreamPlan(len(data), 16, 36, 5, 48))
    np.testing.assert_array_equal(streams.numpy(), want)


@pytest.mark.parametrize("n,S,L,K", [(0, 4, 1, 3), (10, 8, 2, 5), (1 << 12, 256, 16, 7), (9, 9, 1, 0)])
def test_stream_validity_matches_jax(n, S, L, K):
    for w, g in zip(jxla._stream_validity(n, S, L, K), txla._stream_validity(n, S, L, K)):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,overlap,kw", [
    (0, 3, {}), (1, 0, {}), (100, 5, {}), (5000, 0, {}), (5000, 7, {}), (1 << 20, 9, {}),
    (1 << 20, 200, {}), (4000, 5, {"n_streams": 13}), (30, 2, {"n_streams": 64}),
    (1 << 16, 3, {"max_streams": 64, "min_emit": 100}),
])
def test_plan_streams_matches_jax(n, overlap, kw):
    got, want = txla.plan_streams(n, overlap, **kw), jxla.plan_streams(n, overlap, **kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    for x, m in ((0, 512), (1, 512), (512, 512), (513, 512), (7, 3)):
        assert txla._round_up(x, m) == jxla._round_up(x, m)


def test_engine_plan_matches_jax_layout():
    m = _machine(["tshirt", "shirts", "shorts"])
    data = _data(3001, seed=2)
    jeng = jdense.PallasAcEngine(m, n_streams=256, t_tile=32, interpret=True)
    teng = tdense.DenseAcEngine(m, device=CPU, n_streams=256, t_tile=32)
    jplan, jstreams, jwarm, jvend = jeng._layout(data)
    st = teng.stage(data)
    assert st.plan == txla.StreamPlan(**jplan.__dict__)
    np.testing.assert_array_equal(st.streams.numpy(), jstreams)
    np.testing.assert_array_equal(st.live_np, jvend > 0)


# -- dense tables ---------------------------------------------------------------

PACK_NEEDLES = [bytes([97 + i % 11, 98 + (i * 3) % 9, 99 + i % 7]) for i in range(24)]
RNG300 = np.random.default_rng(0)
BIG_NEEDLES = [
    "".join(chr(97 + c) for c in RNG300.integers(0, 26, size=8)) for _ in range(300)
]

COMPRESS_CASES = [
    ("bench", ["tshirt", "shirts", "shorts"], {}),
    ("packing2", PACK_NEEDLES, {}),
    ("packing2_forced_1", PACK_NEEDLES, {"force_packing": 1}),
    ("nul", [b"a\x00b", b"\x00\x00", b"xyz"], {}),
    ("non_ascii", ["café", "écl"], {}),
    ("capacity", BIG_NEEDLES, {"max_rows": 4}),
    ("capacity_default_rows", BIG_NEEDLES, {}),
]


@pytest.mark.parametrize("name,needles,kw", COMPRESS_CASES, ids=[c[0] for c in COMPRESS_CASES])
def test_compressed_machine_matches_jax(name, needles, kw):
    m = _machine(needles)
    try:
        want = jdense.CompressedMachine.from_machine(m, **kw)
    except jdense.CapacityError as e:
        with pytest.raises(tdense.CapacityError) as got:
            tdense.CompressedMachine.from_machine(m, **kw)
        assert str(got.value) == str(e)
        return
    got = tdense.CompressedMachine.from_machine(m, **kw)
    for f in ("n_states", "k", "rows", "packing", "state_bits", "state_mask"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("classmap", "packed"):
        assert getattr(got, f).dtype == getattr(want, f).dtype
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize(
    "needles", [["ab"], [b"\x00y"], [b"a\x00b", b"x"], [""], ["tshirt", "shirts"]]
)
def test_zero_inert_matches_jax(needles):
    m = _machine(needles)
    assert tdense._zero_inert(m) == jdense._zero_inert(m)


# -- bitap layouts ----------------------------------------------------------------

_RNG11 = np.random.default_rng(11)
MULTIWORD = list(dict.fromkeys(
    "".join(_RNG11.choice(list("abcdef"), size=int(_RNG11.integers(3, 9)))) for _ in range(12)
))
NEEDLE_SETS = [
    ("bench", ["tshirt", "shirts", "shorts"]),
    ("suffix_overlap", ["ab", "b", "abc", "zz"]),
    ("duplicates", ["x", "x", "yy", "x"]),
    ("non_ascii", ["café", "écl"]),
    ("single_byte", ["a"]),
    ("max_track", ["abcdefghijklmnopqrstuvwxyz1234"]),
    ("multiword", MULTIWORD),
    ("two_words", ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf"]),
    ("empty_needle", ["", "a"]),
    ("nul", ["a\x00b"]),
    ("too_long", ["x" * 31]),
    ("five_dupes", ["abcdefgh"] * 5),
]


def _assert_layout_equal(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None
    assert (got.unroll, got.ci, got.n_words, got.has_trap) == (
        want.unroll, want.ci, want.n_words, want.has_trap
    )
    assert got.trap is None and want.trap is None
    for gw, ww in zip(got.words, want.words):
        assert (gw.seed, gw.endmask, gw.fields, gw.keys, gw.trap_endmask) == (
            ww.seed, ww.endmask, ww.fields, ww.keys, ww.trap_endmask
        )
        assert gw.btab.dtype == ww.btab.dtype
        np.testing.assert_array_equal(gw.btab, ww.btab)


@pytest.mark.parametrize("max_words", [1, 2, 3])
@pytest.mark.parametrize("name,needles", NEEDLE_SETS, ids=[c[0] for c in NEEDLE_SETS])
def test_plan_bitap_matches_jax(name, needles, max_words):
    m = _machine(needles)
    _assert_layout_equal(
        tbitap.plan_bitap(m, max_words=max_words), jbitap.plan_bitap(m, max_words=max_words)
    )


def test_plan_bitap_max_unroll_matches_jax():
    m = _machine(MULTIWORD)
    for unroll in (1, 2, 4, 16):
        _assert_layout_equal(
            tbitap.plan_bitap(m, max_unroll=unroll), jbitap.plan_bitap(m, max_unroll=unroll)
        )


# -- tables from the JAX engines ----------------------------------------------------


@pytest.mark.parametrize("needles", [["tshirt", "shirts", "shorts"], PACK_NEEDLES, [b"\x00\x00", b"x"]])
def test_dense_tables_from_jax(needles):
    m = _machine(needles)
    jeng = jdense.PallasAcEngine(m, n_streams=128, interpret=True)
    comp = jeng.comp
    got = convert.dense_tables_from_jax(
        np.asarray(jeng._classmap_dev), np.asarray(jeng._table_dev),
        comp.n_states, comp.k, comp.packing, CPU,
    )
    own = tdense.DenseAcEngine(m, device=CPU).tables
    assert (got.packing, got.state_bits) == (own.packing, own.state_bits)
    assert torch.equal(got.classmap, own.classmap)
    assert torch.equal(got.table, own.table)


@pytest.mark.parametrize("needles", [["tshirt", "shirts", "shorts"], ["x", "x", "yy", "x"], MULTIWORD])
def test_bitap_tables_from_jax(needles):
    m = _machine(needles)
    jeng = jbitap.BitapAcEngine(m, n_streams=128, interpret=True)
    own = tbitap.BitapAcEngine(m, device=CPU)
    got = convert.bitap_tables_from_jax(np.asarray(jeng._btab_dev), own.bitap, CPU)
    for f in ("btab", "seed", "endmask", "field_start", "field_bit", "field_weight"):
        assert torch.equal(getattr(got, f), getattr(own.bitap_tables, f)), f


def test_convert_rejects_bad_shapes():
    m = _machine(["tshirt"])
    lay = tbitap.plan_bitap(m)
    with pytest.raises(ValueError):
        convert.bitap_tables_from_jax(np.zeros((4, 128), np.int32), lay, CPU)
    with pytest.raises(ValueError):
        convert.dense_tables_from_jax(np.zeros((2, 64), np.int32), np.zeros((1, 128)), 7, 7, 1, CPU)
    with pytest.raises(ValueError):
        convert.dense_tables_from_jax(np.zeros((2, 128), np.int32), np.zeros((1, 128)), 70, 7, 1, CPU)


# -- containsAny and extraction helpers ----------------------------------------------

EXTRACT_NEEDLES = [
    ["tshirt", "shirts", "shorts"],
    ["ab", "b", "abc", "zz", "b"],  # suffixes and a duplicate: several outputs per state
    [b"a\x00b", b"\x00\x00", b"xyz"],
    ["", "a"],  # the empty needle rides the root
    PACK_NEEDLES,
]


@pytest.mark.parametrize("needles", EXTRACT_NEEDLES)
def test_sticky_view_matches_jax(needles):
    m = _machine(needles)
    want, got = jdense._StickyView(m), tdense._StickyView(m)
    assert got.absorb == want.absorb
    for f in ("delta", "match_count", "fail"):
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("needles", EXTRACT_NEEDLES)
def test_expanders_match_jax(needles):
    m = _machine(needles)
    rng = np.random.default_rng(3)
    states = rng.integers(0, m.delta.shape[0], size=700).astype(np.int32)
    for w, g in zip(jxla.extract_matches(m, states), txla.extract_matches(m, states)):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)
    hs = states[m.match_count[states] > 0].astype(np.int64)
    ends = np.sort(rng.choice(10**6, size=len(hs), replace=False)).astype(np.int64)
    got = txla.expand_hits(m, ends, hs)
    for want in (jxla.expand_hits(m, ends, hs), jdense._expand_outputs(m, ends, hs)):
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)
    for g in txla.expand_hits(m, ends[:0], hs[:0]):
        assert len(g) == 0


def _bit_words(seed, S=64, n=400):
    rng = np.random.default_rng(seed)
    gi = np.sort(rng.choice(40 * S, size=n, replace=False)).astype(np.int64)
    wvals = rng.integers(-(1 << 31), 1 << 31, size=n, dtype=np.int64).astype(np.int32)
    warm = rng.integers(0, 9, size=S).astype(np.int64)
    vend = np.minimum(warm + rng.integers(0, 1300, size=S), 40 * 32).astype(np.int64)
    vend[-3:] = warm[-3:] = 0  # fully padded streams
    return gi // S, gi % S, wvals, warm, vend, 1290


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_expand_hit_bits_matches_jax(native, monkeypatch):
    if not native:
        monkeypatch.setattr(utf8, "_native_lib", lambda: None)
    assert (utf8._native_lib() is not None) == native
    for seed in range(3):
        args = _bit_words(seed)
        want = jdense.expand_hit_bits(*args)
        got = tdense.expand_hit_bits(*args)
        assert got.dtype == want.dtype == np.int64 and len(got) > 0
        np.testing.assert_array_equal(got, want)
    t_words, s_idx, wvals, warm, vend, L = _bit_words(0)
    assert len(tdense.expand_hit_bits(t_words[:0], s_idx[:0], wvals[:0], warm, vend, L)) == 0


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("needles", EXTRACT_NEEDLES[:3])
def test_states_at_positions_matches_jax(needles, native, monkeypatch):
    if not native:
        monkeypatch.setattr(utf8, "_native_lib", lambda: None)
    assert (utf8._native_lib() is not None) == native
    m = _machine(needles)
    data = np.frombuffer(synth_corpus([n if isinstance(n, str) else n.decode("latin-1")
                                       for n in needles], 1 << 12, hit_fraction=0.1, seed=2),
                         np.uint8)
    pos = np.random.default_rng(1).integers(1, len(data) + 1, size=300).astype(np.int64)
    want = jdense.states_at_positions(m, data, pos)
    got = tdense.states_at_positions(m, data, pos)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    scalar = np.empty(len(data), dtype=np.int64)
    s = 0
    for i, b in enumerate(data):
        s = m.delta[s, b]
        scalar[i] = s
    np.testing.assert_array_equal(got, scalar[pos - 1])


def test_port_cpp_matches_arrays_equals_original():
    try:
        from alfred_margaret_tpu.native.cpp_engine import CppAcEngine as Original

        for needles in EXTRACT_NEEDLES:
            m = _machine(needles)
            hay = (b"ab abc zzb tshirts a\x00b \x00\x00xyz " * 400)
            want = Original(m).matches_arrays(hay)
            got = tengine.CppAcEngine(m).matches_arrays(hay)
            for w, g in zip(want, got):
                assert w.dtype == g.dtype
                np.testing.assert_array_equal(g, w)
    except NativeUnavailable:
        pass
