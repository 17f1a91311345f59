"""The port's sharded engine (``alfred_margaret_tpu_torch.parallel``) on meshes
of CPU devices, against the JAX package's ``DistributedAcEngine``.

Mirrors ``tests/test_parallel.py`` on ``["cpu"] * n`` meshes with
``inner="pallas"``, where every shard runs the kernels' plain torch
versions: mesh shapes (8,1,1), (4,2,1), (2,4,1) and (1,8,1), the needle
axis, empty and small inputs, staged reuse, containsAny and containsAll,
``matches_arrays`` for every mesh shape, the empty needle on a needle axis,
the ``CapacityError`` text, the dense steps of a bitap set and of a comb16
set, IgnoreCase with a needle axis, and the composed byte-class bitap
without and with trap tracks and its recovery.  Answers are held against
``ac.count_matches`` / ``ac.all_matches``, the port's single-device engine
and the JAX engine with ``inner="xla"``.  Three tests hold the per-stream
outputs of every step against the JAX engine with ``inner="pallas",
interpret=True``, one per inner: bitap on (2,2,1), uniform comb16 on
(2,1,2) (count and sticky; its states and bitmap steps in interpret mode
take minutes, and the other two tests cover them), dense on (2,2,2) without
the comb16 tables (the JAX engine under ``AMT_DIST_COMB16=0``).  One more
holds B11's one-group mode's plain version against the JAX kernel
``_make_c16_contains_kernel_dyn`` with ``n_groups=1`` in interpret mode:
padded streams, early absorption and no absorption.  Tolerance: exact
equality (every output is an integer).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.ops import comb16_scan as j16
from alfred_margaret_tpu.ops.pallas_scan import CapacityError as JaxCapacityError
from alfred_margaret_tpu.parallel import DistributedAcEngine as JaxEngine
from alfred_margaret_tpu.parallel import make_mesh as jax_mesh

from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, MatchEngine, Searcher, convert
from alfred_margaret_tpu_torch.kernels import comb16_contains_base, comb16_contains_base_plain
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops.pallas_scan import CapacityError
from alfred_margaret_tpu_torch.parallel import (
    DistributedAcEngine,
    init_distributed,
    make_mesh,
)
from test_parallel import _comb16_set as jax_comb16_set
from test_parallel import _mkset as jax_mkset
from test_torch_comb16 import CONFIG2
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

CPU = torch.device("cpu")
NEEDLES3 = ["tshirt", "shirts", "shorts"]
CORPUS = b"short tshirts and shorts for all, tshirtshirts galore " * 137


def _machines(needles):
    pairs = [(n, i) for i, n in enumerate(needles)]
    return jac.build(pairs), ac.build(pairs)


def _mesh(data, seq=1, needle=1):
    return make_mesh(["cpu"] * (data * seq * needle), data=data, seq=seq, needle=needle)


def _jmesh(data, seq=1, needle=1):
    return jax_mesh(jax.devices()[: data * seq * needle], data=data, seq=seq, needle=needle)


def _oracle(m, hay):
    return [(x.pos, x.value) for x in ac.all_matches(m, hay)]


def _pairs(ends, vids):
    return [(int(e), int(v)) for e, v in zip(ends, vids)]


def _mkset():
    """``tests/test_parallel.py``'s set: 24 random needles, duplicates and
    nested ones, over a 30 kB haystack."""
    _, needles, hay = jax_mkset()
    return needles, hay


def _comb16_set(n_needles: int, n_frags: int):
    """``tests/test_parallel.py:252``'s mid-tier set and haystack."""
    jm, hay = jax_comb16_set(n_needles, n_frags)
    return list(jm.needles), hay


# -- mesh shapes, against the oracle and the JAX engine (inner="xla") ----------


@pytest.mark.parametrize("data,seq", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_mesh_shapes_agree(data, seq):
    jm, m = _machines(NEEDLES3)
    eng = DistributedAcEngine(m, _mesh(data, seq), inner="pallas")
    assert eng.inner == "pallas" and eng.count_route() == "bitap"
    expected = ac.count_matches(m, CORPUS)
    assert eng.count(CORPUS) == expected
    assert JaxEngine(jm, _jmesh(data, seq), inner="xla").count(CORPUS) == expected
    assert _pairs(*eng.matches_arrays(CORPUS)) == _oracle(m, CORPUS)


def test_subset_devices_and_auto_inner():
    _, m = _machines(NEEDLES3)
    eng = DistributedAcEngine(m, _mesh(4))
    assert eng.inner == "xla"  # "auto" on a CPU mesh
    assert eng.count(CORPUS) == ac.count_matches(m, CORPUS)
    assert eng.contains_any(CORPUS) and not eng.contains_any(b"zz" * 300)


@pytest.mark.parametrize("inner", ["pallas", "xla"])
def test_empty_and_small(inner):
    _, m = _machines(NEEDLES3)
    eng = DistributedAcEngine(m, _mesh(4, 2), inner=inner)
    assert eng.count(b"") == 0 and eng.stage(b"") is None
    assert eng.count(b"tshirt") == 1
    assert eng.contains_any(b"") is False and eng.contains_any(b"tshirt") is True
    assert _pairs(*eng.matches_arrays(b"")) == []
    assert _pairs(*eng.matches_arrays(b"tshirts")) == _oracle(m, b"tshirts")


@pytest.mark.parametrize("data,seq,needle", [(4, 1, 2), (2, 2, 2), (1, 2, 4), (2, 1, 4)])
def test_needle_axis_agrees(data, seq, needle):
    rng = np.random.default_rng(9)
    needles = [
        rng.integers(97, 105, size=int(rng.integers(2, 6))).astype(np.uint8).tobytes()
        for _ in range(30)
    ] + [b"dup", b"dup"]  # duplicates stay in one group
    jm, m = _machines(needles)
    hay = rng.integers(97, 105, size=20000).astype(np.uint8).tobytes() + b"dup dup"
    eng = DistributedAcEngine(m, _mesh(data, seq, needle), inner="pallas")
    jeng = JaxEngine(jm, _jmesh(data, seq, needle), inner="xla")
    assert eng.n_needle_groups == needle and eng.vid_groups == jeng.vid_groups
    assert eng.count(hay) == jeng.count(hay) == ac.count_matches(m, hay)


@pytest.mark.parametrize("data,seq,needle", [(8, 1, 1), (4, 2, 1), (2, 4, 1), (1, 8, 1),
                                             (2, 2, 2), (1, 2, 4)])
def test_matches_arrays_all_mesh_shapes(data, seq, needle):
    needles, hay = _mkset()
    _, m = _machines(needles)
    eng = DistributedAcEngine(m, _mesh(data, seq, needle), inner="pallas")
    assert _pairs(*eng.matches_arrays(hay)) == _oracle(m, hay)


def test_staged_reuse_across_ops():
    needles, hay = _mkset()
    _, m = _machines(needles)
    eng = DistributedAcEngine(m, _mesh(2, 2, 2), inner="pallas")
    st = eng.stage(hay)
    expected = ac.count_matches(m, hay)
    assert eng.count(st) == eng.count_staged(st) == expected
    assert eng.contains_any(st) is True and eng.contains_staged(st) is True
    ends, _ = eng.matches_arrays_staged(st)
    assert len(ends) == expected
    oracle = np.zeros(len(m.values), dtype=bool)
    oracle[[v for _, v in _oracle(m, hay)]] = True
    assert (eng.value_presence(st) == oracle).all()
    assert eng.count_staged(eng.stage(b"")) == 0


def test_contains_any_and_all_distributed():
    needles, hay = _mkset()
    _, m = _machines(needles)
    eng = DistributedAcEngine(m, _mesh(4, 1, 2), inner="pallas")
    assert eng.contains_any(hay) is True
    assert eng.contains_any(b"zzzzzz") is False
    everything = hay + b" " + b" ".join(needles)
    assert eng.contains_all(everything) is True
    assert eng.contains_all(b"zzzz") is False


def test_matches_through_the_states_route():
    """Without the host corpus, extraction takes the per-shard states step
    (B5's plain version) and gives the bitmap route's answer."""
    needles, hay = _mkset()
    _, m = _machines(needles)
    eng = DistributedAcEngine(m, _mesh(2, 2, 2), inner="pallas")
    st = eng.stage(hay[:6000])
    bare = dataclasses.replace(st, data_np=None)
    assert eng.bits_per_group(bare) is None
    assert _pairs(*eng.matches_arrays(bare)) == _pairs(*eng.matches_arrays(st))
    assert (eng.value_presence(bare) == eng.value_presence(st)).all()


def test_empty_needle_not_needle_shardable():
    rng = np.random.default_rng(1032)
    needles = list(dict.fromkeys(
        bytes(rng.integers(97, 105, size=rng.integers(1, 9), dtype=np.uint8)) for _ in range(60)
    ))[:50] + [b""]
    _, m = _machines(needles)
    hay = b"".join(needles[i] for i in rng.integers(0, len(needles) - 1, 400))
    for inner in ("pallas", "xla"):
        with pytest.raises(ValueError, match="empty needle"):
            DistributedAcEngine(m, _mesh(2, 1, 2), inner=inner)
        # Data-only mesh: every shard runs the full machine.
        assert DistributedAcEngine(m, _mesh(4), inner=inner).count(hay) == ac.count_matches(m, hay)


def test_capacity_error_text():
    """Each needle group must fit the dense table: config 2's 100 needles
    fit in 4 groups and not in 2, with the JAX engine's message."""
    jm, m = _machines(CONFIG2)
    with pytest.raises(JaxCapacityError) as jerr:
        JaxEngine(jm, _jmesh(1, 1, 2), inner="pallas", interpret=True)
    with pytest.raises(CapacityError) as err:
        DistributedAcEngine(m, _mesh(1, 1, 2), inner="pallas")
    assert str(err.value) == str(jerr.value)
    assert "shard the automaton over more 'needle' mesh devices" in str(err.value)
    eng = DistributedAcEngine(m, _mesh(1, 1, 4), inner="pallas")
    assert eng.count_route() == "comb16" and eng.sticky_route() == "comb16"


def test_bitap_inner_dense_steps():
    """A bitap set's dense steps, reached with ``use_bitap=False``."""
    _, m = _machines([b"abc", b"bcd", b"gg"])
    hay = b"xabcdgg" * 500
    eng = DistributedAcEngine(m, _mesh(2, 2), inner="pallas")
    assert eng._bitap_lay is not None and eng.count_route() == "bitap"
    assert eng.count_route(use_bitap=False) == eng.sticky_route(use_bitap=False) == "dense"
    st = eng.stage(hay)
    assert int(eng.stream_counts(st, use_bitap=False).sum()) == ac.count_matches(m, hay)
    assert eng.sticky_hits(st, use_bitap=False) > 0
    assert eng.sticky_hits(eng.stage(b"zz" * 300), use_bitap=False) == 0


def test_comb16_inner_dense_steps():
    """A comb16 set's dense steps, reached by dropping its comb16 tables."""
    needles, hay = _comb16_set(70, 100)
    _, m = _machines(needles)
    eng = DistributedAcEngine(m, _mesh(2, 1, 2), inner="pallas")
    assert eng.count_route() == "comb16"
    eng._c16g = None
    assert eng.count_route() == "dense" and eng.sticky_route() == "dense"
    assert eng.count(hay) == ac.count_matches(m, hay)
    assert eng.contains_any(hay) and not eng.contains_any(b"zq" * 300)


def test_bitmap_extraction_nul_needle_padded_streams():
    """A machine that is not zero-inert (a NUL needle) with fully padded
    streams: pad scans must not inflate the counts, and the positions equal
    the oracle's."""
    _, m = _machines([b"\x00\x00a", b"ab"])
    hay = (b"bc\x00\x00add ab " * 1200) + b"ab"
    eng = DistributedAcEngine(m, _mesh(2, 2), inner="pallas")
    st = eng.stage(hay)
    assert (st.vend_np == 0).any()
    assert eng.count(st) == len(_oracle(m, hay))
    assert _pairs(*eng.matches_arrays(st)) == _oracle(m, hay)


# -- Searcher.distributed ---------------------------------------------------------


def test_searcher_distributed_case_sensitive():
    s = Searcher.build(CASE_SENSITIVE, NEEDLES3, device="cpu")
    eng = s.distributed(_mesh(4, 2), inner="pallas")
    assert eng.count(CORPUS) == s.count_matches(CORPUS)
    assert eng.contains_any(CORPUS) == s.contains_any(CORPUS)
    assert _pairs(*eng.matches_arrays(CORPUS)) == _pairs(*s.all_matches_arrays(CORPUS))


@pytest.mark.parametrize("data,seq,needle", [(8, 1, 1), (2, 4, 1), (2, 2, 2)])
def test_searcher_distributed_ignore_case(monkeypatch, data, seq, needle):
    """The composed case DFA on raw bytes, its needle groups composed too
    (a case-sensitive rebuild would drop every uppercase match)."""
    monkeypatch.setattr(MatchEngine, "AUTO_COMPOSE_BYTES", 0)
    s = Searcher.build(IGNORE_CASE, ["tshirt", "k", "straße"], device="cpu")
    hay = "TShirts KELVIN K strAẞE straße İstanbul filler ".encode() * 53
    expected = s.count_matches(hay)
    assert expected == ac.count_matches(s.automaton, hay, IGNORE_CASE)
    eng = s.distributed(_mesh(data, seq, needle), inner="pallas")
    assert eng.machine.composed_ci and all(sm.composed_ci for sm in eng.sub_machines)
    assert eng.count(hay) == expected
    assert eng.contains_any(hay) is True
    assert _pairs(*eng.matches_arrays(hay)) == _pairs(*s.all_matches_arrays(hay))


def test_searcher_distributed_ignore_case_needs_whole_code_points():
    s = Searcher.build(IGNORE_CASE, [b"caf\xc3"], device="cpu")
    with pytest.raises(ValueError, match="composed case DFA"):
        s.distributed(_mesh(2), inner="pallas")


# -- the composed byte-class bitap and its trap recovery ----------------------------


def test_ci_bitap_inner_trapless():
    _, m = _machines(["dress", "shoe", "glove"])
    cm = case_dfa.compose_build(list(zip(m.needles, m.values)), machine=m)
    hay = b"DRESS and shoe and GlOvE and dReSs plus filler " * 120
    eng = DistributedAcEngine(cm, _mesh(2, 2), inner="pallas")
    assert eng._bitap_lay is not None and eng._bitap_lay.ci and not eng._bitap_lay.has_trap
    st = eng.stage(hay)
    exp = ac.count_matches(m, hay, IGNORE_CASE)
    assert eng.count_staged(st) == exp
    assert eng.contains_any(st) == (exp > 0)


def test_ci_bitap_inner_trap_recovery(monkeypatch):
    """Trap-bearing layouts ('k' pulls the Kelvin-sign trap): a clean corpus
    answers from the bitap steps; a Kelvin corpus re-counts its few trapped
    streams on the host, and with the local budget at 0 takes the dense
    steps; every answer equals the IgnoreCase oracle's."""
    _, m = _machines(["kilo", "tshirt"])
    cm = case_dfa.compose_build(list(zip(m.needles, m.values)), machine=m)
    eng = DistributedAcEngine(cm, _mesh(2, 2), inner="pallas")
    assert eng._bitap_lay is not None and eng._bitap_lay.has_trap
    routes = []
    real = eng.stream_counts
    monkeypatch.setattr(eng, "stream_counts", lambda st, use_bitap=True: (
        routes.append(use_bitap), real(st, use_bitap))[1])

    clean = b"KILO tshirt kIlO filler " * 150
    assert eng.count(clean) == ac.count_matches(m, clean, IGNORE_CASE)
    assert routes == [True]
    kelvin = ("xyz \u212aILO abc " + "filler " * 40).encode() * 6  # the Kelvin sign
    exp = ac.count_matches(m, kelvin, IGNORE_CASE)
    assert exp == 6
    st = eng.stage(kelvin)
    trap = eng.stream_counts(st)[1]
    assert 0 < int((trap != 0).sum()) <= 32  # the host recount takes them
    routes.clear()
    assert eng.count(st) == exp and routes == [True]
    assert eng.contains_any(st) is True and eng.contains_any(b"zz" * 400) is False
    assert eng.contains_any("\u212a ".encode() * 50) is False  # trapped, no match
    monkeypatch.setattr(eng, "_trapped_stream_idx", lambda st, trap: None)
    routes.clear()
    assert eng.count(st) == exp and routes == [True, False]  # the dense fallback
    assert eng.contains_any(st) is True
    assert eng.contains_any("\u212a ".encode() * 50) is False


# -- per-stream step outputs against the JAX engine in interpret mode ----------------


def _jax_steps(jeng, jst):
    """The JAX engine's count step, sticky step, states and bitmap outputs."""
    T, S = jst.plan.time_len, jst.plan.n_streams
    step, args = jeng._get_step(T, S)
    count = np.asarray(step(*args, jst.streams_d, jst.warm_d, jst.vend_d))
    fn, args = jeng._build_contains_step(T, S)
    sticky = np.asarray(fn(*args, jst.streams_d, jst.warm_d, jst.vend_d))
    return count, sticky


def _check_steps(needles, hay, shape, route, full=True):
    jm, m = _machines(needles)
    jeng = JaxEngine(jm, _jmesh(*shape), inner="pallas", interpret=True)
    eng = DistributedAcEngine(m, _mesh(*shape), inner="pallas")
    if route == "dense":
        eng._c16g = None  # the mesh's dense steps
    assert eng.count_route() == route and eng.sticky_route() == route
    jst, st = jeng.stage(hay), eng.stage(hay)
    assert dataclasses.astuple(jst.plan) == dataclasses.astuple(st.plan)
    jcount, jsticky = _jax_steps(jeng, jst)
    counts = eng.stream_counts(st)
    if counts.ndim == 2:  # a trap plane: placed per stream
        assert np.array_equal(jcount, counts)
    else:  # the JAX step psums shard i's stream j into element j
        assert np.array_equal(jcount.reshape(-1), counts.reshape(eng.n_stream_shards, -1).sum(0))
    assert np.array_equal(jsticky, eng.sticky_hits(st))
    if full:
        assert np.array_equal(jeng._states_per_group(jst), eng.states_per_group(st))
        jc, jb = jeng._bits_per_group(jst)
        pc, pb = eng.bits_per_group(st)
        assert np.array_equal(jc, pc) and np.array_equal(jb, pb)
    assert eng.count(st) == ac.count_matches(m, hay)
    assert _pairs(*eng.matches_arrays(st)) == _oracle(m, hay)


def test_steps_match_jax_bitap():
    _check_steps(NEEDLES3, CORPUS, (2, 2, 1), "bitap")


def test_steps_match_jax_comb16():
    needles, hay = _comb16_set(70, 250)
    _check_steps(needles, hay, (2, 1, 2), "comb16", full=False)


def test_steps_match_jax_dense(monkeypatch):
    monkeypatch.setenv("AMT_DIST_COMB16", "0")  # the JAX engine's dense steps
    needles, hay = _mkset()
    _check_steps(needles, hay[:8000], (2, 2, 2), "dense")


def test_xla_inner_matches_jax_xla():
    """The ``xla`` inner: per-stream counts and per-position states equal the
    JAX engine's ``lax.scan`` steps on the same stream plan."""
    needles, hay = _mkset()
    jm, m = _machines(needles)
    jeng = JaxEngine(jm, _jmesh(2, 2, 2), inner="xla")
    eng = DistributedAcEngine(m, _mesh(2, 2, 2), inner="xla")
    jst, st = jeng.stage(hay[:5000]), eng.stage(hay[:5000])
    assert dataclasses.astuple(jst.plan) == dataclasses.astuple(st.plan)
    step, args = jeng._get_step(jst.plan.time_len, jst.plan.n_streams)
    jcount = np.asarray(step(*args, jst.streams_d, jst.warm_d, jst.vend_d))
    assert np.array_equal(jcount.reshape(-1),
                          eng.stream_counts(st).reshape(eng.n_stream_shards, -1).sum(0))
    assert np.array_equal(jeng._states_per_group(jst), eng.states_per_group(st))


# -- B11's one-group mode against the JAX kernel ------------------------------------


def _jax_c16_base(stacked, g, streams, vend, warm):
    """The JAX kernel ``_make_c16_contains_kernel_dyn`` with ``n_groups=1``
    in interpret mode, launched as the sharded engine's sticky step launches
    it (``parallel/shard.py:605-647``): the final base of every stream."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from alfred_margaret_tpu.ops.pallas_scan import _fit_unroll

    T, S = streams.shape
    R = S // 128
    t_tile = 128 if T % 128 == 0 else T
    n_tiles = T // t_tile
    cst = stacked["consts"]
    rows_c, rows_a = cst["rows_c"], cst["rows_a"]
    rt = rows_c + rows_a + 2
    unroll = _fit_unroll(8 if rt <= 8 else (4 if rt <= 16 else 2), t_tile)
    kernel = j16._make_c16_contains_kernel_dyn(t_tile, R, dict(cst, interpret=True), n_tiles,
                                               unroll)
    live = vend[vend > 0]
    bscal = np.array([warm.max(), live.min() if len(live) else 0], dtype=np.int32)
    gscal = np.asarray(stacked["gscal"])[g].reshape(1, -1)
    vm = pltpu.VMEM

    def block(shape):
        return pl.BlockSpec(shape, lambda i: (0,) * len(shape), memory_space=vm)

    out = pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.SMEM),
            block((2, 128)), block((rows_c, 128)), block((rows_a, 128)), block((2, 128)),
            block((R, 128)),
            pl.BlockSpec((t_tile, R, 128), lambda i: (i, 0, 0), memory_space=vm),
        ],
        out_specs=block((R, 128)),
        out_shape=jax.ShapeDtypeStruct((R, 128), jnp.int32),
        scratch_shapes=[pltpu.VMEM((R, 128), jnp.int32)],
        interpret=True,
    )(bscal, gscal, *(np.asarray(stacked[k])[g] for k in ("classmap", "comb", "aux", "rootseg")),
      vend.reshape(R, 128), streams.reshape(T, R, 128))
    return np.asarray(out).reshape(-1)


def test_b11_one_group_matches_jax():
    """Per stream (column s of 256, T = 256, two tiles): s % 4 == 0 digits
    to vend (no absorption), 1 a needle of each group, then random letters
    (absorbs early), 2 digits with
    a needle just before vend (absorbs late), 3 fully padded (vend 0, zero
    bytes: keeps the root base); vends vary, bytes past vend are letters."""
    groups = [CONFIG2[:50], CONFIG2[50:]]
    _, stacked = j16.build_sticky16_uniform(
        [jac.build([(n, i) for i, n in enumerate(g)]) for g in groups])
    tables = convert.comb16_group_tables_from_jax(stacked, CPU, sticky=True)
    T, S = 256, 256
    rng = np.random.default_rng(5)
    streams = rng.integers(97, 123, size=(T, S)).astype(np.uint8)
    digits = np.frombuffer(b"0123456789 ,;:!", np.uint8)
    vend = np.where(np.arange(S) % 4 == 3, 0, T - rng.integers(0, 120, size=S)).astype(np.int32)
    warm = np.minimum(vend, 7).astype(np.int32)
    for s in range(S):
        if s % 4 in (0, 2):
            streams[: vend[s], s] = rng.choice(digits, vend[s])
        if s % 4 == 1:
            nd = np.frombuffer((groups[0][5] + groups[1][0]).encode(), np.uint8)
            streams[: len(nd), s] = nd
        if s % 4 == 2:
            nd = np.frombuffer(groups[s % 8 // 4][s % 50].encode(), np.uint8)
            streams[vend[s] - len(nd): vend[s], s] = nd
        if s % 4 == 3:
            streams[:, s] = 0
    for g in range(2):
        want = _jax_c16_base(stacked, g, streams, vend, warm)
        one = tables.group(g)
        got = comb16_contains_base_plain(torch.from_numpy(streams), torch.from_numpy(vend), one)
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(comb16_contains_base(torch.from_numpy(streams),
                                                torch.from_numpy(vend), one), got)
        absorb = int(one.gscal[0, 1])
        hit = want == absorb
        kinds = np.arange(S) % 4
        assert not hit[kinds == 0].any() and hit[kinds == 1].all()
        assert hit[(kinds == 2) & (np.arange(S) % 8 // 4 == g)].all()
        assert (want[kinds == 3] == int(one.gscal[0, 0])).all()
    with pytest.raises(ValueError, match="one group"):
        comb16_contains_base(torch.from_numpy(streams), torch.from_numpy(vend), tables)


# -- the mesh itself ------------------------------------------------------------------


def test_make_mesh_and_init_distributed():
    mesh = make_mesh(["cpu"] * 8, data=4, seq=2)
    assert mesh.shape == (4, 2, 1) and mesh.world_size == 1 and (mesh.ranks == 0).all()
    assert all(d == CPU for d in mesh.devices.flat)
    assert make_mesh(["cpu"] * 6, seq=3).shape == (2, 3, 1)
    with pytest.raises(ValueError, match="mesh"):
        make_mesh(["cpu"] * 8, data=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_mesh()
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_mesh(["cuda:0"] * 2)
    assert init_distributed() == 1  # no group, no environment: a no-op
    _, m = _machines(NEEDLES3)
    with pytest.raises(ValueError, match="inner"):
        DistributedAcEngine(m, mesh, inner="tpu")


def test_staging_of_another_layout_is_refused():
    """A staging serves any engine of the same mesh layout whose needles its
    warm-up covers (another machine's too); else ``ValueError``."""
    _, m3 = _machines(NEEDLES3)
    _, m4 = _machines(["tshirts", "short"])  # one byte more of warm-up
    _, m2 = _machines(["short"])
    e3 = DistributedAcEngine(m3, _mesh(4, 2), inner="pallas")
    st = e3.stage(CORPUS)
    assert DistributedAcEngine(m2, _mesh(8), inner="pallas").count(st) == ac.count_matches(
        m2, CORPUS)
    for eng in (DistributedAcEngine(m4, _mesh(4, 2), inner="pallas"),
                DistributedAcEngine(m3, _mesh(4), inner="pallas")):
        with pytest.raises(ValueError, match="staged for another"):
            eng.count(st)


@pytest.mark.parametrize("needles,ci", [
    (NEEDLES3, False), (["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf"], False),
    (["ab", "b", "abc", "zz", b"x\x00"], False), (CONFIG2[:40], False), (NEEDLES3, True),
    (["tshirt", "shirts", "shorts", "kilo", "café"], True),
])
def test_plan_bitap_auto_matches_jax(monkeypatch, needles, ci):
    """The sharded engine's bitap law is the JAX package's ``plan_bitap_auto``
    (``bitap_word_budget``): the same layout, or none, for each set."""
    from alfred_margaret_tpu.models import case_dfa as jcase
    from alfred_margaret_tpu.ops.comb_scan import plan_bitap_auto as jax_plan

    from alfred_margaret_tpu_torch.ops.comb_scan import plan_bitap_auto

    jm, m = _machines(needles)
    if ci:
        jm = jcase.compose_build(list(zip(jm.needles, jm.values)), machine=jm)
        m = case_dfa.compose_build(list(zip(m.needles, m.values)), machine=m)

    def words(lay):
        if lay is None:
            return None
        return [(w.seed, w.endmask, w.fields, w.trap_endmask, w.btab.tolist())
                for w in lay.all_words()], lay.ci, lay.trap is not None

    want = words(plan_bitap_auto(m))
    assert want == words(jax_plan(jm))
    monkeypatch.setenv("AMT_BITAP", "0")  # the JAX package's switch changes nothing here
    assert words(plan_bitap_auto(m)) == want
