"""The segmented schedule of B5, the dense states scan ``dense_states``, which
``csrc/dense_count.cu`` runs on the card as the states mode of B1's scan
(``csrc/stage.cuh``), and of the mesh's S7, its per-shard launch.

* The rule: B5 takes B1's design (the same shared memory) with no segment
  under 128 steps: k = 16 on the main paths' 32768 streams, 5 on a (2,1,4)
  mesh shard of S7 (640 steps), one segment without an overlap.
* Exactness: the plain version run over every segment from its scan start,
  each keeping the rows of its own range (``stitch_segments`` of
  ``alfred_margaret_tpu_torch/kernels/segments.py``), equals the unsplit
  plain version in every ``[T, S]`` entry, before ``warm``, past ``vend``
  and on padding, at k = 1, 2, 3 and 5 with T = 40; on the bench needles
  (packing 1) and a packing-2 set with a NUL needle, both against the JAX
  kernel (``_make_states_kernel``) in interpret mode, and on a NUL-bearing
  set whose overlap is 19 and a composed IgnoreCase machine (overlap
  ``max_raw_match_bytes + 3``).
* The guard and the plumbing: ``DenseTables.check_overlap`` refuses a
  staging whose overlap is below the machine's ``max_needle_bytes - 1`` (the
  dense and bitap engines' ``states_args`` and the mesh's S7), without a
  launch; ``packed_states`` (``final_states`` and the extraction without
  the host corpus) and S7 pass the plan's overlap to the wrapper.

Tolerance: exact equality of every entry.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.models import case_dfa as jcase
from alfred_margaret_tpu.ops.pallas_scan import PallasAcEngine

from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.kernels import segments as seg
from alfred_margaret_tpu_torch.kernels.dense_count import dense_states, dense_states_plain
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops import pallas_scan
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine, _zero_inert
from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, make_mesh
from alfred_margaret_tpu_torch.parallel.shard import PLAIN

from test_torch_count_segments import KW, NEEDLES3, _composed, _machine
from test_torch_dense_sticky_segments import CI_SMALL, _hay
from test_torch_segments import LONG_NUL, _layout_cases
from _torch_count_fixtures import PACK2
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

dense_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.dense_count")
CPU = torch.device("cpu")
KS = [1, 2, 3, 5]

#: name: (needles, composed, held against the JAX kernel)
B5_CASES = {
    "bench": (NEEDLES3, False, True),
    "packing2_nul": (PACK2 + ["a\x00b"], False, True),
    "long_nul": (LONG_NUL, False, False),
    "ignorecase": (CI_SMALL, True, False),
}
_B5 = {}


def _b5_case(name):
    """(JAX states [T, S] or None, the port's staging, the engine, B5's args
    without the overlap) of a case, built once."""
    if name not in _B5:
        needles, composed, jax = B5_CASES[name]
        tm = _composed(ac, case_dfa, needles) if composed else _machine(ac, needles)
        eng = DenseAcEngine(tm, device=CPU, **KW)
        data = np.frombuffer(_hay(needles, composed, len(name)), np.uint8)
        pst = eng.stage(data)
        want = None
        if jax:
            jm = _composed(jac, jcase, needles) if composed else _machine(jac, needles)
            jeng = PallasAcEngine(jm, interpret=True, **KW)
            st = jeng.stage(data)
            assert st.plan.time_len == pst.plan.time_len
            want = np.asarray(jeng._states_call(st)).reshape(st.plan.time_len, -1)
        args = eng.states_args(pst)
        assert args[-1] == pst.plan.overlap
        _B5[name] = (want, pst, eng, args[:-1])
    return _B5[name]


# -- the rule ----------------------------------------------------------------------------


def test_b5_design_follows_the_rule(monkeypatch):
    monkeypatch.setattr(dense_mod, "sm_count", lambda _dev: 132)
    table = torch.zeros(200, dtype=torch.int32)
    smem = seg.dense_bits_smem_bytes(200)
    wide = torch.zeros(4224, 32768, dtype=torch.uint8)
    d = dense_mod.dense_states_design(wide, table, 5)
    assert d.as_dict() == {"k": 16, "t_tile": seg.T_TILE, "Gc": 1}
    assert d == dense_mod.dense_count_design(wide, table, 5)
    assert dense_mod.dense_states_design(wide, table).segments == 1
    # S7: a (2,1,4) shard of 16 MiB, 16384 streams of 640 steps, where B1's
    # rule would take 16 segments of 40 steps: no segment under 128 steps.
    shard = torch.zeros(640, 16384, dtype=torch.uint8)
    assert seg.pick_segments(16384, 640, 9, smem, 132) == 16
    assert dense_mod.MIN_STATES_SEGMENT_STEPS == 128
    assert dense_mod.dense_states_design(shard, table, 9).segments == 5
    # Short stagings take one segment, whatever the overlap.
    short = torch.zeros(200, 32768, dtype=torch.uint8)
    assert dense_mod.dense_count_design(short, table, 19).segments == 10
    assert dense_mod.dense_states_design(short, table, 19).segments == 1


# -- B5 over the schedule -----------------------------------------------------------------


@pytest.mark.parametrize("name", list(B5_CASES))
@pytest.mark.parametrize("k", KS)
def test_b5_segments_equal_unsplit_and_jax(name, k):
    want, pst, eng, args = _b5_case(name)
    K, T = pst.plan.overlap, pst.plan.time_len
    cases = _layout_cases(pst)
    assert T == 40 and cases["padded"] and cases["stream 0"]
    assert eng.tables.min_overlap == K == eng.machine.max_needle_bytes - 1
    if name == "long_nul":
        assert K == 19 and not _zero_inert(eng.machine)
    if name == "packing2_nul":
        assert args[3] == 2
    if name == "ignorecase":
        assert eng.machine.composed_ci
    whole = dense_states_plain(*args)
    assert whole.shape == (T, 128) and whole.dtype == torch.int32
    if want is not None:
        np.testing.assert_array_equal(whole.numpy(), want)
    assert int((whole >> args[4]).sum()) > 0  # count fields survive in the entries
    # Every row is written: before warm, and past vend and on padded streams
    # (zero bytes, which leave the root where a needle starts with NUL).
    rows = torch.arange(T).unsqueeze(1)
    assert (whole[rows < torch.from_numpy(pst.warm_np).unsqueeze(0)] != 0).any()
    if name == "long_nul":
        assert (whole[rows >= pst.vend.unsqueeze(0)] != 0).any()
    assert torch.equal(dense_states(*args, K), whole)  # the wrapper's CPU path
    got = seg.stitch_segments(dense_states_plain, args[0], *args[1:], overlap=K, segments=k)
    assert got.dtype == torch.int32 and torch.equal(got, whole)
    if k == 5:  # each segment's own rows, from a scan restarted K bytes early
        for start, lo, hi in seg.segment_schedule(T, k, K):
            part = dense_states_plain(args[0][start:hi].contiguous(), *args[1:])
            assert torch.equal(part[lo - start:], whole[lo:hi]), (start, lo, hi)


# -- the guard and the plumbing ------------------------------------------------------------


def test_b5_overlap_below_the_machines_need_raises(monkeypatch):
    launched = []
    monkeypatch.setattr(pallas_scan, "dense_states",
                        lambda *a, **kw: launched.append(1) or dense_states(*a, **kw))
    eng = DenseAcEngine(_machine(ac, NEEDLES3), device=CPU, n_streams=8, t_tile=8)
    hay = b"tshirts and shorts " * 8
    st = eng.stage(hay)
    assert eng.tables.min_overlap == st.plan.overlap == 5
    short = dataclasses.replace(st, plan=dataclasses.replace(st.plan, overlap=4))
    with pytest.raises(ValueError, match="max_needle_bytes"):
        eng.states_args(short)
    with pytest.raises(ValueError, match="max_needle_bytes"):
        eng.final_states_staged(short)
    assert launched == []
    assert len(eng.final_states_staged(st)) == len(hay) and launched == [1]
    # The bitap engine's dense tables, and a composed IgnoreCase machine,
    # which needs max_raw_match_bytes + 3.
    beng = BitapAcEngine(_machine(ac, NEEDLES3), device=CPU, n_streams=8, t_tile=8)
    with pytest.raises(ValueError, match="max_needle_bytes"):
        beng.states_args(dataclasses.replace(st, plan=short.plan))
    ci = DenseAcEngine(_composed(ac, case_dfa, CI_SMALL), device=CPU, n_streams=8, t_tile=8)
    assert ci.tables.min_overlap == case_dfa.max_raw_match_bytes(
        [x.encode() for x in CI_SMALL]) + 3 == ci.overlap
    # The mesh's S7 builds its own tables and holds them to the same guard.
    mesh = DistributedAcEngine(_machine(ac, NEEDLES3), make_mesh(["cpu"] * 8, data=4, seq=2),
                               inner="pallas")
    staged = mesh.stage(hay * 25)
    short = dataclasses.replace(staged, plan=dataclasses.replace(staged.plan, overlap=4))
    i, g, dev = next(iter(mesh.shards()))
    with pytest.raises(ValueError, match="max_needle_bytes"):
        mesh.shard_call("states", short, i, g, dev)
    # A negative overlap never reaches a kernel.
    with pytest.raises(ValueError):
        dense_states(*eng.states_args(st)[:-1], -1)


def test_b5_callers_pass_the_plans_overlap(monkeypatch):
    seen = []
    real = pallas_scan.dense_states

    def spy(*a, **kw):
        seen.append(a[5] if len(a) > 5 else kw.get("overlap"))
        return real(*a, **kw)

    monkeypatch.setattr(pallas_scan, "dense_states", spy)
    hay = synth_corpus(NEEDLES3, 6000, hit_fraction=0.05, seed=4)
    for engine in (DenseAcEngine, BitapAcEngine):
        eng = engine(_machine(ac, NEEDLES3), device=CPU, n_streams=64, t_tile=32)
        st = eng.stage(hay)
        K = st.plan.overlap
        assert K == 5
        seen.clear()
        assert len(eng.final_states_staged(st)) == len(hay)
        bare = dataclasses.replace(st, data_np=None)
        pos, _ = eng.match_positions_staged(bare)
        assert len(pos) > 0 and seen == [K, K], engine.__name__


def test_mesh_states_site_passes_the_plans_overlap():
    """S7 on a (2,1,4) mesh of the CPU: each shard's call carries the plan's
    overlap, and its plain version equals the stitch of its segments."""
    needles = NEEDLES3 + ["hirts", "orts", "sho"]
    eng = DistributedAcEngine(_machine(ac, needles),
                              make_mesh(["cpu"] * 8, data=2, seq=1, needle=4), inner="pallas")
    staged = eng.stage(synth_corpus(needles, 1 << 13, hit_fraction=0.02, seed=3))
    K = staged.plan.overlap
    for i, g, dev in eng.shards():
        fn, args, kw = eng.shard_call("states", staged, i, g, dev)
        assert fn is dense_states and kw == {"overlap": K}
        whole = PLAIN[fn](*args, **kw)
        assert torch.equal(fn(*args, **kw), whole)
        got = seg.stitch_segments(dense_states_plain, args[0], *args[1:], overlap=K, segments=3)
        assert torch.equal(got, whole)
