"""The segmented schedule of the bitmap kernels B6 and B13
(``alfred_margaret_tpu_torch/kernels/segments.py``: ``word_segment_schedule``
and ``bits_over_segments``), which ``csrc/matchbits.cu`` and the bits mode of
``csrc/comb16_grouped.cu`` run on the card (``csrc/stage.cuh``).

* The split: segments are cut at word boundaries, every step of ``[0, T)``
  lies in exactly one segment's own range, each scan starts on a word at
  least ``overlap`` bytes before its range, and the rule that picks the
  segment counts keeps B9's, B11's, B15's and B17's picks at the main paths'
  shapes.
* Exactness: the plain version run over every segment of the schedule (its
  counts summed, each segment's own words kept) equals the whole-stream plain
  version in counts and in every bitmap word, for the dense step at packing 1
  and 2, the one-word bitap step, the comb16 step and a composed IgnoreCase
  machine on the dense and the comb16 steps; at k = 1, 2, 3, 5 and 16
  segments, T = 32, 96 and 320 steps and S = 1, 7 and 130 streams; with
  ragged warm-ups and vends, every stream padded, single-byte needles
  (overlap 0), and a NUL needle whose hits on the right-pad zeros stay in
  the bitmap.  Once, on a staged corpus, it equals the JAX bitmap kernel in
  interpret mode.

Tolerance: exact equality of every count and every bit.
"""

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.ops.pallas_scan import PallasAcEngine

from alfred_margaret_tpu_torch.kernels import matchbits, matchbits_plain
from alfred_margaret_tpu_torch.kernels import segments as seg
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine
from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine, _zero_inert

from test_torch_comb16 import random_needles
from test_torch_matches import PACK2, jax_bits
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
KW = dict(device=CPU, n_streams=128, t_tile=32)
NEEDLES3 = ["tshirt", "shirts", "shorts"]
SINGLES = ["a", "e", " ", "z"]
NUL = [b"\x00\x00", b"x", b"a\x00"]
CI = ["straße", "kelvin", "shirt", "ǆx"]


def _machine(needles):
    return ac.build([(n, i) for i, n in enumerate(needles)])


def _composed(needles):
    m = _machine(needles)
    return case_dfa.compose_build(list(zip(m.needles, m.values)), machine=m)


# family: (engine class, machine builder, needles, the step its bits_args take)
FAMILIES = {
    "dense_packing1": (DenseAcEngine, _machine, NEEDLES3, "dense"),
    "dense_packing2": (DenseAcEngine, _machine, PACK2, "dense"),
    "bitap_one_word": (BitapAcEngine, _machine, NEEDLES3, "bitap"),
    "comb16": (Comb16AcEngine, _machine, random_needles(5, 30), "comb16"),
    "ignorecase_dense": (DenseAcEngine, _composed, CI, "dense"),
    "ignorecase_comb16": (Comb16AcEngine, _composed, CI, "comb16"),
    "singles_dense": (DenseAcEngine, _machine, SINGLES, "dense"),
    "singles_bitap": (BitapAcEngine, _machine, SINGLES, "bitap"),
    "nul_dense": (DenseAcEngine, _machine, NUL, "dense"),
}
_TABLES = {}


def family(name):
    """(step, tables, overlap, machine) of a family, built once: the step's
    tables from the engine's ``bits_args`` and the stream plan's overlap."""
    if name not in _TABLES:
        cls, build, needles, step = FAMILIES[name]
        m = build(needles)
        eng = cls(m, **KW)
        st = eng.stage(np.frombuffer(b"x" * 64, np.uint8))
        args = eng.bits_args(st)
        assert args[3] == step
        if name == "dense_packing2":
            assert eng.comp.packing == 2
        if name == "dense_packing1":
            assert eng.comp.packing == 1
        _TABLES[name] = (step, args[4:], st.plan.overlap, m)
    return _TABLES[name]


def streams_of(m, T, S, seed, padded=False):
    """(streams [T, S] uint8, warm, vend): bytes drawn mostly from the
    needles' bytes, ragged warm-ups and vends (some streams fully padded),
    zeros past each vend as on the right-pad of a staging."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"".join(m.needles) + b"ABZ \xc3\x9f\x00", np.uint8)
    x = alphabet[rng.integers(0, len(alphabet), size=(T, S))]
    if padded:
        vend = np.zeros(S, np.int64)
    else:
        vend = rng.integers(0, T + 1, size=S)
        vend[rng.random(S) < 0.2] = 0
        vend[rng.random(S) < 0.3] = T
    warm = np.minimum(rng.integers(0, 12, size=S), vend)
    x[np.arange(T)[:, None] >= vend[None, :]] = 0
    return (torch.from_numpy(np.ascontiguousarray(x)), torch.from_numpy(warm).int(),
            torch.from_numpy(vend).int())


# -- the split and its rules -------------------------------------------------------


@pytest.mark.parametrize("T", [0, 32, 96, 320, 4224])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 16])
@pytest.mark.parametrize("K", [0, 5, 31, 32, 70])
def test_word_schedule_cuts_words_and_covers_every_step_once(T, k, K):
    sched = seg.word_segment_schedule(T, k, K)
    assert len(sched) == k
    covered = np.zeros(T, np.int64)
    for start, lo, hi in sched:
        assert lo % 32 == 0 and hi % 32 == 0 and start % 32 == 0
        assert start <= lo <= hi
        if lo < hi:
            # The scan has read at least overlap + 1 bytes by its range's first step.
            assert start == 0 or lo - start >= K
            assert start > lo - K - 32
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert sched[0][1] == 0 and sched[-1][2] == T


def test_pick_segments_keeps_the_main_paths_picks():
    """The main paths' picks on an H100 (132 SMs) at S = 32768, T = 4224:
    B9 (config 5's eleven groups, comb 512 and aux 128 words a group) k = 8
    with four groups a block; B11 (28.7 KiB a block, six groups two a block)
    k = 8; B15 and B17 (30.0 KiB a block) k = 16; and on the mesh's 16384-
    stream shards S4 and S5 k = 16.  The bitmap scans take the same rule, at
    most one segment a word: B6 and B13 k = 16 at full width and on a
    4096-stream shard (S8)."""
    d9 = seg.grouped_design(32768, 4224, 10, 11, 512, 128, 132)
    assert (d9.segments, d9.chunk) == (8, 4)
    assert seg.pick_segments(32768, 4224, 10, 29389, 132, n_chunks=3) == 8
    for S in (32768, 16384):
        assert seg.pick_segments(S, 4224, 10, 30720, 132) == 16
    for S in (32768, 4096):
        assert seg.bits_design(S, 4224, 5, seg.dense_bits_smem_bytes(128), 132).segments == 16
        assert seg.bits_design(S, 4224, 5, seg.bitap_bits_smem_bytes(), 132).segments == 16
        assert seg.bits_design(S, 4224, 7, seg.chunk_smem_bytes(1, 1024, 256), 132).segments == 16
    # Without an overlap one segment; never more segments than words.
    assert seg.bits_design(32768, 4224, None, 20_000, 132).segments == 1
    assert seg.bits_design(128, 64, 0, 20_000, 132).segments == 2
    assert seg.bits_design(128, 0, 3, 20_000, 132).segments == 1


def test_bits_smem_mirrors_the_sources():
    """The shared memory the rule is given is each kernel's own layout:
    B13 as B9's one-group chunk, B6's bitap step its 256-word table and the
    count fields, then two tiles."""
    _, tables, _, _ = family("comb16")
    assert seg.chunk_smem_bytes(1, tables[1].numel(), tables[2].numel()) == (
        4 * ((seg.REP_WORDS + seg.RANGE_SLOTS + 2 * tables[1].numel() + 2 * tables[2].numel()
              + 128 + 3) & ~3) + 2 * seg.T_TILE * seg.BLOCK_STREAMS)
    assert seg.bitap_bits_smem_bytes() == 4 * 316 + 8192
    assert seg.dense_bits_smem_bytes(130) == 4 * (2048 + 132) + 8192


# -- B6 and B13 over the schedule --------------------------------------------------


def _same(got, want):
    assert got[0].dtype == got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("k", [1, 2, 3, 5, 16])
def test_bits_over_segments_equal_whole_streams(name, k):
    step, tables, K, m = family(name)
    if name.startswith("singles"):
        assert K == 0
    for T in (32, 96, 320):
        for S in (1, 7, 130):
            s, w, v = streams_of(m, T, S, seed=T * 1000 + S * 10 + k)
            want = matchbits_plain(s, w, v, step, *tables)
            _same(seg.bits_over_segments(matchbits_plain, s, w, v, step, *tables, overlap=K,
                                         segments=k), want)
    # Every stream padded: zero bytes and vend 0.
    s, w, v = streams_of(m, 96, 7, seed=k, padded=True)
    want = matchbits_plain(s, w, v, step, *tables)
    assert int(want[0].abs().sum()) == 0
    _same(seg.bits_over_segments(matchbits_plain, s, w, v, step, *tables, overlap=K,
                                 segments=k), want)
    if name == "nul_dense":
        # The machine is not zero-inert: its pad hits are in the bitmap.
        assert not _zero_inert(m)
        assert int(torch.count_nonzero(want[1])) > 0


def test_wrapper_takes_the_overlap_and_runs_the_plain_version_on_the_cpu():
    step, tables, K, m = family("comb16")
    s, w, v = streams_of(m, 96, 7, seed=3)
    want = matchbits_plain(s, w, v, step, *tables)
    _same(matchbits(s, w, v, step, *tables, overlap=K), want)
    _same(matchbits(s, w, v, step, *tables), want)
    _same(matchbits_plain(s, w, v, step, *tables, overlap=K), want)
    with pytest.raises(ValueError, match="overlap"):
        matchbits(s, w, v, step, *tables, overlap=-1)


def test_bits_over_segments_equal_jax_interpret():
    """Held once against the JAX bitmap kernel in interpret mode on a staged
    corpus (``tests/test_torch_matches.py``'s ``jax_bits``)."""
    m = _machine(NEEDLES3)
    hay = b"short tshirts and shorts galore " * 40
    data = np.frombuffer(hay, np.uint8)
    jeng = PallasAcEngine(m, interpret=True, n_streams=128, t_tile=32)
    want_counts, want_bits = jax_bits(jeng, jeng.stage(data))
    eng = DenseAcEngine(m, **KW)
    st = eng.stage(data)
    args = eng.bits_args(st)
    counts, bits = seg.bits_over_segments(matchbits_plain, *args, overlap=st.plan.overlap,
                                          segments=3)
    live = st.live_np
    np.testing.assert_array_equal(counts.numpy()[live], want_counts[live])
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    assert int(counts.numpy()[live].astype(np.int64).sum()) == ac.count_matches(m, hay)
