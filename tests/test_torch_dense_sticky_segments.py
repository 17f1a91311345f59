"""The segmented schedule of B3, the dense sticky scan ``dense_contains``,
which ``csrc/dense_count.cu`` runs on the card as the sticky mode of B1's
scan (``csrc/stage.cuh``).

* The rule: k = 16 at the main paths' shapes (the whole corpus, a quarter
  range of ``contains_staged_early`` and a (4,2,1) mesh shard), one segment
  without an overlap, never a segment no longer than the overlap; the
  segments of a range come from its own stream count.
* Exactness: the plain version run over every segment of a schedule, from
  its scan start up to ``min(p_{i+1}, vend)``, the final entries combined
  (``entry_over_segments`` of ``alfred_margaret_tpu_torch/kernels/
  segments.py``: ``absorb`` where a segment absorbed, else the entry of the
  segment whose own range holds step ``vend - 1``, else the root's), equals
  the unsplit plain version, and that equals the JAX kernel
  (``_make_contains_kernel``) in interpret mode, entry for entry on every
  stream (the state held from ``vend`` on in every tile), at k = 1, 2, 3
  and 5 with T = 40; on the bench needles, a NUL-bearing set (overlap 19),
  packing 2 and a composed IgnoreCase machine.
* Crafted streams: a match only in the second segment's warm-up, ``vend``
  just before and just after its last byte, ``vend`` inside the warm-up
  with a match after it, ``vend`` = 0, padded streams; and stream ranges
  ``[s0, s1)`` whose ``s0`` is not a multiple of 16.
* The write protocol (fill with the root entry, ``atomicExch`` of
  ``absorb``, ``atomicCAS`` from the root by the owner of step ``vend - 1``,
  a segment that read ``absorb`` in ``out[s]`` stopping anywhere) gives the
  combine under any order of the segments.
* The guard and the plumbing: ``StickyTables.check_overlap`` refuses a
  staging whose overlap is below the machine's ``max_needle_bytes - 1``
  (the dense engine and the mesh's S6); ``contains_staged``,
  ``contains_staged_early``, the bitap engine's trap fallback and S6 pass
  the plan's overlap to the wrapper.

Tolerance: exact equality of every entry.
"""

import dataclasses
import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.models import case_dfa as jcase
from alfred_margaret_tpu.ops.pallas_scan import PallasAcEngine

from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.kernels import segments as seg
from alfred_margaret_tpu_torch.kernels.dense_contains import dense_contains, dense_contains_plain
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops import bitap_scan, pallas_scan
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap_ci
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine, _zero_inert
from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, make_mesh
from alfred_margaret_tpu_torch.parallel.shard import PLAIN

from test_torch_count_segments import KW, NEEDLES3, _composed, _machine
from test_torch_segments import LONG_NUL, _layout_cases
from test_torch_sticky_segments import T_CRAFT, _crafted
from _torch_count_fixtures import PACK2
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

dense_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.dense_contains")
CPU = torch.device("cpu")
KS = [1, 2, 3, 5]
#: Whole-code-point needles whose composed IgnoreCase machine fits the
#: dense table.
CI_SMALL = ["straße", "ǆx", "kelvin", "tshirt", "ab"]
#: Bytes around the needles: most streams of 40 steps hold no needle.
FILLER = b"0123456789 ,;:!"

#: name: (needles, composed)
B3_CASES = {
    "bench": (NEEDLES3, False),
    "long_nul": (LONG_NUL, False),
    "packing2_nul": (PACK2 + ["a\x00b"], False),
    "ignorecase": (CI_SMALL, True),
}
_B3 = {}


def _jax_entries(jeng, streams: np.ndarray, vend: np.ndarray) -> np.ndarray:
    """The JAX kernel's final entries on ``[T, S]`` streams, every tile a
    boundary tile (the state held from ``vend`` on, as the port holds it)."""
    c = jeng._sticky_setup()
    T = streams.shape[0]
    strict = jnp.zeros(2, jnp.int32)
    out = jeng._get_contains_fn(T)(strict, c["cm"], c["tab"], jnp.asarray(vend.reshape(-1, 128)),
                                   jnp.asarray(streams))
    return np.asarray(out).reshape(-1)


def _hay(needles, composed, seed):
    """1300 bytes of digits and punctuation with the needles planted about
    every 60 bytes (mixed case for the composed machine), and 3 NULs."""
    rng = np.random.default_rng(seed)
    words = [x for x in needles if "\x00" not in x]
    parts = []
    while sum(len(p) for p in parts) < 1300:
        parts.append(bytes(rng.choice(np.frombuffer(FILLER, np.uint8), int(rng.integers(20, 100)))))
        w = words[rng.integers(0, len(words))].encode()
        parts.append(w.upper() if composed and rng.random() < 0.5 else w)
    return b"".join(parts)[:1297] + b"\x00a\x00"


def _b3_case(name):
    """(the JAX engine, the port's staging, the engine, B3's args) of a case,
    built once."""
    if name not in _B3:
        needles, composed = B3_CASES[name]
        tm = _composed(ac, case_dfa, needles) if composed else _machine(ac, needles)
        jm = _composed(jac, jcase, needles) if composed else _machine(jac, needles)
        eng = DenseAcEngine(tm, device=CPU, **KW)
        jeng = PallasAcEngine(jm, interpret=True, **KW)
        pst = eng.stage(np.frombuffer(_hay(needles, composed, len(name)), np.uint8))
        args = eng.sticky_args(pst)
        assert args[-1] == pst.plan.overlap and args[7:9] == (0, 128)
        assert jeng._sticky_setup()["absorb_pk"] == eng.sticky_tables().absorb
        _B3[name] = (jeng, pst, eng, args)
    return _B3[name]


def _b3_run(args):
    """B3's plain version on one slice of steps: ``run(streams, vend)``."""
    _, classmap, table, _, packing, state_bits, absorb = args[:7]
    return lambda x, v: dense_contains_plain(x, classmap, table, v, packing, state_bits, absorb)


# -- the rule ----------------------------------------------------------------------------


def test_b3_design_follows_the_rule(monkeypatch):
    monkeypatch.setattr(dense_mod, "sm_count", lambda _dev: 132)
    table = torch.zeros(200, dtype=torch.int32)
    wide = torch.zeros(4224, 32768, dtype=torch.uint8)
    smem = seg.dense_bits_smem_bytes(200)
    for s0, s1 in ((0, None), (0, 8192), (3 * 8192, 32768)):  # whole, quarters
        d = dense_mod.dense_contains_design(wide, table, 5, s0, s1)
        assert d.as_dict() == {"k": 16, "t_tile": seg.T_TILE, "Gc": 1}
    shard = torch.zeros(4224, 4096, dtype=torch.uint8)
    assert dense_mod.dense_contains_design(shard, table, 6).segments == seg.pick_segments(
        4096, 4224, 6, smem, 132) == 16
    assert dense_mod.dense_contains_design(wide, table).segments == 1
    # A range of one stream asks for the most segments, each longer than the
    # overlap: 40 steps at overlap 19 take two, at overlap 5 six.
    short = torch.zeros(40, 300, dtype=torch.uint8)
    assert dense_mod.dense_contains_design(short, table, 19, 5, 6).segments == 2
    assert dense_mod.dense_contains_design(short, table, 5, 5, 6).segments == 6


# -- B3 over the schedule -----------------------------------------------------------------


@pytest.mark.parametrize("name", list(B3_CASES))
@pytest.mark.parametrize("k", KS)
def test_b3_segments_equal_unsplit_and_jax(name, k):
    jeng, pst, eng, args = _b3_case(name)
    streams, vend, absorb = args[0], args[3], args[6]
    K, T = pst.plan.overlap, pst.plan.time_len
    assert T == 40 and _layout_cases(pst)["padded"]
    t = eng.sticky_tables()
    assert t.min_overlap == K == eng.machine.max_needle_bytes - 1
    if name == "long_nul":
        assert K == 19 and not _zero_inert(eng.machine)
    if name == "packing2_nul":
        assert t.packing == 2
    if name == "ignorecase":
        assert eng.machine.composed_ci
    whole = dense_contains_plain(*args)
    np.testing.assert_array_equal(whole.numpy(), _jax_entries(jeng, streams.numpy(),
                                                              vend.numpy()))
    hit = whole == absorb
    assert hit.any() and (~hit & (vend > 0)).any()
    assert (whole[vend == 0] == 0).all()  # padded streams keep the root entry
    assert torch.equal(dense_contains(*args), whole)  # the wrapper's CPU path
    got = seg.entry_over_segments(_b3_run(args), streams, vend, 0, absorb, overlap=K,
                                  segments=k)
    assert got.dtype == torch.int32 and torch.equal(got, whole)


def test_b3_crafted_segments_equal_unsplit_and_jax():
    """The crafted streams of B11's tests on the bench needles' sticky
    tables, over the whole range and ranges whose start is not a multiple of
    16: kinds 1 and 3 match only inside the second segment's warm-up (k = 2),
    kind 2 ends its vend at that match's last byte, kind 4 inside the
    warm-up with a match after it, kind 5 is padded."""
    m = _machine(ac, NEEDLES3)
    eng = DenseAcEngine(m, device=CPU, n_streams=128, t_tile=32)
    jeng = PallasAcEngine(_machine(jac, NEEDLES3), interpret=True, n_streams=128, t_tile=32)
    t = eng.sticky_tables()
    K = t.min_overlap
    streams, vend = _crafted(NEEDLES3, K)
    args = (streams, t.classmap, t.table, vend, t.packing, t.state_bits, t.absorb)
    whole = dense_contains_plain(*args)
    np.testing.assert_array_equal(whole.numpy(), _jax_entries(jeng, streams.numpy(),
                                                              vend.numpy()))
    kinds = np.arange(128) % 8
    hit = (whole == t.absorb).numpy()
    assert hit[kinds == 1].all() and hit[kinds == 3].all()
    assert not hit[np.isin(kinds, (0, 2, 4, 5))].any()
    assert (whole.numpy()[kinds == 5] == 0).all()
    run = _b3_run(args)
    for k in KS:
        got = seg.entry_over_segments(run, streams, vend, 0, t.absorb, overlap=K, segments=k)
        assert torch.equal(got, whole), k
    start, lo, _ = seg.segment_schedule(T_CRAFT, 2, K)[1]
    v = vend.numpy()
    assert ((v[np.isin(kinds, (2, 3, 4))] > start) & (v[np.isin(kinds, (2, 3, 4))] <= lo)).all()
    # Ranges: the kernel's block x covers s0 + 128 x; out[s - s0].
    for s0, s1 in ((3, 128), (17, 45), (0, 1), (127, 128)):
        part = dense_contains(*args, s0, s1, K)
        assert torch.equal(part, whole[s0:s1]), (s0, s1)
        for k in KS:
            got = seg.entry_over_segments(run, streams[:, s0:s1].contiguous(), vend[s0:s1], 0,
                                          t.absorb, overlap=K, segments=k)
            assert torch.equal(got, whole[s0:s1]), (s0, s1, k)


def test_b3_write_protocol_is_order_free():
    """The kernel's writes, in every order of three segments' blocks: the
    wrapper fills out with the root entry 0, a segment that absorbed
    exchanges in ``absorb``, the owner of step vend - 1 swaps its entry in
    only where out still holds the root, and a segment that read ``absorb``
    in out[s] stops with any entry.  Each order gives the combine."""
    m = _machine(ac, NEEDLES3)
    t = DenseAcEngine(m, device=CPU, n_streams=128, t_tile=32).sticky_tables()
    K = t.min_overlap
    streams, vend = _crafted(NEEDLES3, K)
    args = (streams, t.classmap, t.table, vend, t.packing, t.state_bits, t.absorb)
    sched = seg.segment_schedule(T_CRAFT, 3, K)
    run = _b3_run(args)
    entries = []
    for start, _, hi in sched:
        v = (vend.long().clamp(max=hi) - start).clamp(min=0).to(torch.int32)
        entries.append(run(streams[start:hi].contiguous(), v).numpy())
    want = seg.combine_bases([torch.from_numpy(e) for e in entries], vend, sched, 0, t.absorb)
    assert torch.equal(want, dense_contains_plain(*args))
    v = vend.numpy()
    rng = np.random.default_rng(5)
    for order in itertools.permutations(range(3)):
        out = np.zeros(len(v), np.int64)
        for i in order:
            _, lo, hi = sched[i]
            # A stream already holding absorb may stop this segment early.
            e = np.where(out == t.absorb, rng.integers(0, t.absorb, len(v)), entries[i])
            owner = (v > lo) & (v <= hi)
            out = np.where(e == t.absorb, t.absorb, out)  # atomicExch
            out = np.where(owner & (e != t.absorb) & (out == 0), e, out)  # atomicCAS
        np.testing.assert_array_equal(out, want.numpy())


# -- the guard and the plumbing ------------------------------------------------------------


def test_b3_overlap_below_the_machines_need_raises():
    eng = DenseAcEngine(_machine(ac, NEEDLES3), device=CPU, n_streams=8, t_tile=8)
    hay = b"tshirts and shorts " * 8
    st = eng.stage(hay)
    assert eng.sticky_tables().min_overlap == st.plan.overlap == 5
    short = dataclasses.replace(st, plan=dataclasses.replace(st.plan, overlap=4))
    with pytest.raises(ValueError, match="max_needle_bytes"):
        eng.sticky_args(short)
    with pytest.raises(ValueError, match="max_needle_bytes"):
        eng.contains_staged(short)
    assert eng.contains_staged(st)
    # A composed IgnoreCase machine needs max_raw_match_bytes + 3.
    ci = DenseAcEngine(_composed(ac, case_dfa, CI_SMALL), device=CPU, n_streams=8, t_tile=8)
    assert ci.sticky_tables().min_overlap == case_dfa.max_raw_match_bytes(
        [x.encode() for x in CI_SMALL]) + 3 == ci.overlap
    # The mesh's S6 builds its own tables and holds them to the same guard.
    mesh = DistributedAcEngine(_machine(ac, NEEDLES3), make_mesh(["cpu"] * 8, data=4, seq=2),
                               inner="pallas")
    staged = mesh.stage(hay * 25)
    short = dataclasses.replace(staged, plan=dataclasses.replace(staged.plan, overlap=4))
    i, g, dev = next(iter(mesh.shards()))
    with pytest.raises(ValueError, match="max_needle_bytes"):
        mesh.shard_call("sticky", short, i, g, dev, use_bitap=False)


def test_b3_callers_pass_the_plans_overlap(monkeypatch):
    seen = []
    real = pallas_scan.dense_contains

    def spy(*a, **kw):
        seen.append((a[7:10], kw))
        return real(*a, **kw)

    monkeypatch.setattr(pallas_scan, "dense_contains", spy)
    monkeypatch.setattr(bitap_scan, "dense_contains", spy)
    eng = DenseAcEngine(_machine(ac, ["needleword"]), device=CPU, n_streams=64, t_tile=32)
    st = eng.stage(np.frombuffer(b"x" * 3000 + b"needleword" + b"y" * 3000, np.uint8))
    K = st.plan.overlap
    assert K == 9 and eng.contains_staged(st)
    assert seen == [((0, 64, K), {})]
    seen.clear()
    assert eng.contains_staged_early(st, n_segments=4)
    assert seen == [((q * 16, q * 16 + 16, K), {}) for q in range(4)]
    # The bitap engine's trap fallback (the composed machine's sticky scan).
    seen.clear()
    ci = BitapAcEngine(_composed(ac, case_dfa, ["kilo", "fix"]), device=CPU, n_streams=64,
                       t_tile=32, layout=plan_bitap_ci(_composed(ac, case_dfa, ["kilo", "fix"])))
    sci = ci.stage(("xx KİLX xx FİQ " * 40).encode())  # İ, and no match
    monkeypatch.setattr(ci, "_trapped_streams", lambda trap, st: None)
    assert not ci.contains_staged(sci)
    assert seen == [((0, 64, sci.plan.overlap), {})] and sci.plan.overlap >= ci.overlap


def test_mesh_dense_sticky_site_passes_the_plans_overlap():
    m = _machine(ac, NEEDLES3)
    eng = DistributedAcEngine(m, make_mesh(["cpu"] * 8, data=4, seq=2), inner="pallas")
    assert eng.sticky_route(use_bitap=False) == "dense"
    staged = eng.stage(synth_corpus(NEEDLES3, 1 << 14, hit_fraction=0.01, seed=2))
    for i, g, dev in eng.shards():
        fn, args, kw = eng.shard_call("sticky", staged, i, g, dev, use_bitap=False)
        assert fn is dense_contains and kw == {"overlap": staged.plan.overlap}
        whole = PLAIN[fn](*args, **kw)
        assert torch.equal(fn(*args, **kw), whole)
        run = _b3_run(args)
        got = seg.entry_over_segments(run, args[0], args[3], 0, args[6],
                                      overlap=staged.plan.overlap, segments=3)
        assert torch.equal(got, whole)
    assert eng.contains_any(staged)
