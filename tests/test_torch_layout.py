"""The PyTorch port's copied planners against the JAX package's originals.

The port copies the numpy stream planner, the dense-table compressor and the
bitap track planner (their JAX modules import ``jax``, which the port must
not).  Each copy must give exactly the original's output; the torch staging
must give ``build_streams``'s bytes; and the JAX engines' tables passed
through ``convert.py`` must equal the port's own.
"""

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.models import ac
from alfred_margaret_tpu.ops import bitap_scan as jbitap
from alfred_margaret_tpu.ops import pallas_scan as jdense
from alfred_margaret_tpu.ops import xla_scan as jxla

from alfred_margaret_tpu_torch import convert
from alfred_margaret_tpu_torch.ops import bitap_scan as tbitap
from alfred_margaret_tpu_torch.ops import pallas_scan as tdense
from alfred_margaret_tpu_torch.ops import xla_scan as txla

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
