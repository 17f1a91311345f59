"""Out-of-core streaming on the port: ``ops/streaming.py`` over the port's
engines, and ``MatchEngine``'s streaming of haystacks past the budget.

Mirrors ``tests/test_streaming.py`` on the port's engines (``device="cpu"``,
the kernels' plain versions): chunks of 64, 96 and 517 KiB, matches
straddling every cut, matches and contains, comb16, a memmap, the mesh on
eight CPU shards, and a ``stage`` over the budget that stays off the device.
Beside those: the bitap engine with a trap track and İ, Kelvin K and ẞ
written across the cuts, the composed IgnoreCase and lowering routes through
``MatchEngine``, the grouped engine, the ``CapacityError`` fallback of
``contains_any``, and the port's ``StreamingScanner`` against the JAX one
over a JAX engine in interpret mode.  Every answer is held against the JAX
package's on the whole corpus.  Tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest

import alfred_margaret_tpu as jamt
from alfred_margaret_tpu.bench.dataformat import synth_corpus as jax_synth_corpus
from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.native.cpp_engine import CppAcEngine as JaxCpp
from alfred_margaret_tpu.ops import streaming as jstreaming
from alfred_margaret_tpu.ops.pallas_scan import PallasAcEngine

from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, MatchEngine, Searcher
from alfred_margaret_tpu_torch import engine as tengine
from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.ops import streaming
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine
from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine
from alfred_margaret_tpu_torch.ops.comb_scan import make_engine
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine
from alfred_margaret_tpu_torch.ops.streaming import StreamingScanner, _slice_u8
from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, make_mesh
from alfred_margaret_tpu_torch.utils import config

from test_torch_grouped import MID
from test_torch_slice import _sticky_overflow_needles
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = "cpu"
NEEDLES = ["tshirt", "shirts", "shorts", "ort", "t"]
NEEDLES3 = ["tshirt", "shirts", "shorts"]
#: İ (length-changing unlowering), Kelvin K and ẞ, the trap encodings.
TRAPS = ("İ", "K", "ẞ")


def _machines(needles):
    pairs = [(n, i) for i, n in enumerate(needles)]
    return ac.build(pairs), jac.build(pairs)


def _want(jm, data):
    """The JAX package's count and match arrays over the whole corpus (its
    host C++ engine)."""
    eng = JaxCpp(jm)
    return eng.count(data), eng.matches_arrays(data)


def _same_matches(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def setup():
    m, jm = _machines(NEEDLES)
    corpus = synth_corpus(NEEDLES, 1 << 19, hit_fraction=0.01, seed=4)
    assert corpus == jax_synth_corpus(NEEDLES, 1 << 19, hit_fraction=0.01, seed=4)
    data = np.frombuffer(corpus, np.uint8)
    engines = {"dense": DenseAcEngine(m, device=CPU, n_streams=512, t_tile=64),
               "bitap": make_engine(m, CPU, n_streams=512, t_tile=64)}
    assert type(engines["bitap"]) is BitapAcEngine
    return m, jm, data, engines, _want(jm, data)


@pytest.mark.parametrize("kind", ["dense", "bitap"])
@pytest.mark.parametrize("chunk_kb", [64, 96, 517])  # non-dividing sizes too
def test_streaming_count_exact(setup, chunk_kb, kind):
    m, jm, data, engines, (count, _) = setup
    sc = StreamingScanner(engines[kind], m, chunk_bytes=chunk_kb << 10)
    assert sc.W == jstreaming.StreamingScanner(None, jm, chunk_bytes=chunk_kb << 10).W == 5
    assert sc.count(data) == count == jac.count_matches(jm, data.tobytes())


@pytest.mark.parametrize("kind", ["dense", "bitap"])
def test_streaming_boundary_straddles(setup, kind):
    """Matches exactly straddling every chunk boundary, and ending one byte
    before it, are neither lost nor double counted."""
    m, jm, _, engines, _ = setup
    chunk = 4096
    buf = bytearray(b"z" * 5 * chunk)
    for i in range(1, 5):
        b = i * chunk
        buf[b - 3 : b + 3] = b"tshirt"  # straddles the boundary
        buf[b - 7 : b - 1] = b"shorts"  # ends 1 before the boundary
    data = np.frombuffer(bytes(buf), np.uint8)
    sc = StreamingScanner(engines[kind], m, chunk_bytes=chunk)
    count, want = _want(jm, data)
    assert sc.count(data) == count == jac.count_matches(jm, bytes(buf))
    _same_matches(sc.matches_arrays(data), want)


@pytest.mark.parametrize("kind", ["dense", "bitap"])
def test_streaming_matches_and_contains(setup, kind):
    m, _, data, engines, (_, want) = setup
    sc = StreamingScanner(engines[kind], m, chunk_bytes=96 << 10)
    _same_matches(sc.matches_arrays(data), want)
    assert sc.contains(data) is True
    assert sc.contains(np.frombuffer(b"z" * 300000, np.uint8)) is False


def test_streaming_comb16():
    rng = np.random.default_rng(7)
    needles = list(dict.fromkeys(
        "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(4, 9)))
        for _ in range(110)
    ))[:100]
    m, jm = _machines(needles)
    data = np.frombuffer(synth_corpus(needles, 3 << 17, hit_fraction=0.01, seed=5), np.uint8)
    eng = make_engine(m, CPU, n_streams=512, t_tile=64)
    assert type(eng) is Comb16AcEngine
    sc = StreamingScanner(eng, m, chunk_bytes=1 << 17)
    count, want = _want(jm, data)
    assert sc.count(data) == count > 0
    assert sc.contains(data) is True
    _same_matches(sc.matches_arrays(data), want)


def test_streaming_memmap(tmp_path, setup):
    """An ``np.memmap`` source: each chunk is a view of the file, and a
    staged chunk holds that chunk only (with its prefix)."""
    m, _, data, engines, (count, want) = setup
    path = tmp_path / "corpus.bin"
    path.write_bytes(data.tobytes())
    mm = np.memmap(str(path), dtype=np.uint8, mode="r")
    view = _slice_u8(mm, 1000, 5000)
    assert np.shares_memory(view, mm) and len(view) == 4000
    eng = engines["dense"]
    seen = []

    def stage(x):
        st = DenseAcEngine.stage(eng, x)
        seen.append(len(st.data_np))
        return st

    sc = StreamingScanner(eng, m, chunk_bytes=128 << 10)
    eng.stage = stage
    try:
        assert sc.count(mm) == count
        _same_matches(sc.matches_arrays(mm), want)
        assert sc.contains(mm) is True
    finally:
        del eng.stage
    # Four chunks for count and matches; contains stops at the first.
    assert len(seen) == 9 and max(seen) <= (128 << 10) + sc.W


def test_streaming_over_mesh(tmp_path):
    """A memmap streamed through the whole eight-shard CPU mesh: every chunk
    is scanned by all the shards, and the answers are the JAX package's."""
    m, jm = _machines(NEEDLES)
    corpus = synth_corpus(NEEDLES, 3 << 17, hit_fraction=0.01, seed=11)
    path = tmp_path / "corpus.bin"
    path.write_bytes(corpus)
    mm = np.memmap(str(path), dtype=np.uint8, mode="r")
    dist = DistributedAcEngine(m, make_mesh([CPU] * 8, data=4, seq=2))
    sc = StreamingScanner(dist, m, chunk_bytes=1 << 17)  # 3 chunks
    count, want = _want(jm, np.frombuffer(corpus, np.uint8))
    assert sc.count(mm) == count
    assert sc.contains(mm) is True
    assert sc.contains(np.frombuffer(b"z" * 100000, np.uint8)) is False
    _same_matches(sc.matches_arrays(mm), want)


def test_streaming_grouped():
    m, jm = _machines(MID)
    frags = [x.encode() for x in MID[:40]] + [b"zqzq ", b"\x00"]
    rng = np.random.default_rng(3)
    data = np.frombuffer(b"".join(frags[i] for i in rng.integers(0, len(frags), 30000)), np.uint8)
    eng = GroupedAcEngine(m, device=CPU, max_rows=5, n_streams=2048)
    assert eng.n_groups > 1
    sc = StreamingScanner(eng, m, chunk_bytes=100 << 10)
    assert len(list(sc._chunks(len(data)))) >= 2
    count, want = _want(jm, data)
    assert sc.count(data) == count > 0
    assert sc.contains(data) is True
    assert sc.contains(np.frombuffer(b"zqzq " * 30000, np.uint8)) is False
    _same_matches(sc.matches_arrays(data), want)


def test_port_scanner_matches_jax_scanner():
    """The port's ``StreamingScanner`` over the port's engine against the JAX
    ``StreamingScanner`` over the JAX engine in interpret mode, chunk for
    chunk (the JAX extraction in interpret mode is left to the JAX
    package's own tests: it takes minutes)."""
    m, jm = _machines(NEEDLES)
    corpus = synth_corpus(NEEDLES, (1 << 17) + 777, hit_fraction=0.01, seed=4)
    data = np.frombuffer(corpus, np.uint8)
    got = StreamingScanner(DenseAcEngine(m, device=CPU, n_streams=128, t_tile=64), m,
                           chunk_bytes=64 << 10)
    want = jstreaming.StreamingScanner(PallasAcEngine(jm, n_streams=128, t_tile=64, interpret=True), jm,
                               chunk_bytes=64 << 10)
    assert list(got._chunks(len(data))) == list(want._chunks(len(data)))
    for a, b in got._chunks(len(data)):
        pre = max(0, a - got.W)
        assert (streaming._cold_prefix_count(m, _slice_u8(data, pre, a))
                == jstreaming._cold_prefix_count(jm, jstreaming._slice_u8(data, pre, a)))
    assert got.count(data) == want.count(data) == jac.count_matches(jm, corpus)
    assert got.contains(data) is want.contains(data) is True


# -- MatchEngine: streaming past the budget --------------------------------------------


@pytest.fixture
def budget_1mb(monkeypatch):
    """A streaming budget of 2 MiB: chunks of 1 MiB (``EngineConfig`` is
    frozen, so the whole default is replaced)."""
    monkeypatch.setattr(config, "DEFAULT", dataclasses.replace(config.DEFAULT, stream_chunk_mb=1))


def _spy_stages(monkeypatch, eng):
    """Record the length of every haystack ``eng`` stages."""
    seen = []
    stage = type(eng).stage

    def spy(x):
        seen.append(len(x))
        return stage(eng, x)

    monkeypatch.setattr(eng, "stage", spy)
    return seen


def _corpus(needles, n, seed, case=CASE_SENSITIVE):
    raw = synth_corpus(needles, n, hit_fraction=0.01, seed=seed)
    if case is IGNORE_CASE:  # letters uppercased at random
        a = np.frombuffer(raw, np.uint8).copy()
        up = np.random.default_rng(seed).random(len(a)) < 0.5
        up &= (a >= 97) & (a <= 122)
        a[up] -= 32
        raw = a.tobytes()
    return raw


def _answers(s, hay):
    ends, vids = s.all_matches_arrays(hay)
    return s.count_matches(hay), s.contains_any(hay), ends.tolist(), vids.tolist()


def test_stage_over_budget_skips_device_residency(budget_1mb, monkeypatch):
    """A corpus past the budget is not staged whole by ``Searcher.stage``,
    ``MatchEngine.stage`` or ``adopt_staged``: the handle keeps the host
    bytes, and count, contains_any and matches stream chunk by chunk; a
    one-shot haystack past the budget streams too."""
    n = (5 << 19) + 12345  # three chunks, the last ragged
    hay = synth_corpus(NEEDLES3, n, hit_fraction=0.01, seed=13)
    s = Searcher.build(CASE_SENSITIVE, NEEDLES3, device=CPU)
    seen = _spy_stages(monkeypatch, s._engine.device_engine())
    staged = s.stage(hay)
    assert staged.device is None and len(staged.data) == n and seen == []
    want = _answers(jamt.Searcher.build(jamt.CASE_SENSITIVE, NEEDLES3, engine="cpp"), hay)
    assert _answers(s, staged) == want
    # Three chunks for count and matches each; contains_any stops at the
    # first chunk with a hit.
    assert len(seen) == 7 and max(seen) <= (1 << 20) + 5
    seen.clear()
    assert _answers(s, hay) == want and len(seen) == 7
    other = Searcher.build(CASE_SENSITIVE, ["shirts", "tshirt"], device=CPU)
    adopted = other.adopt_staged(staged)
    assert adopted.device is None and adopted.data is staged.data
    assert other.count_matches(adopted) == jamt.Searcher.build(
        jamt.CASE_SENSITIVE, ["shirts", "tshirt"], engine="cpp").count_matches(hay)
    # Under the budget the handle is staged whole, as before.
    assert s.stage(hay[: 2 << 20]).device is not None


def test_value_presence_stages_whole(budget_1mb, monkeypatch):
    """``value_presence`` does not stream, as in the JAX package: it stages
    the haystack whole."""
    n = (5 << 19) + 7
    hay = synth_corpus(NEEDLES3, n, hit_fraction=0.01, seed=2)
    s = Searcher.build(CASE_SENSITIVE, NEEDLES3 + ["zzzz"], device=CPU)
    seen = _spy_stages(monkeypatch, s._engine.device_engine())
    assert s.contains_all(s.stage(hay)) is False
    assert seen == [n]


def test_bitap_trap_across_cuts(budget_1mb, monkeypatch):
    """The composed IgnoreCase machine's byte-class bitap with its trap
    track, streamed: İ, Kelvin K and ẞ written across every chunk cut (and
    ``TSHİRT`` around them), against the JAX ``Searcher`` on the whole
    corpus.  A chunk's prefix starts inside a code point there."""
    monkeypatch.setattr(MatchEngine, "AUTO_COMPOSE_BYTES", 0)
    n = (5 << 19) + 999
    a = np.frombuffer(_corpus(NEEDLES3, n, 21, IGNORE_CASE), np.uint8).copy()
    for k in (1, 2):
        cut = k << 20
        for off, t in zip((-1, -9, -17), TRAPS):
            enc = t.encode()
            a[cut + off : cut + off + len(enc)] = np.frombuffer(enc, np.uint8)
        word = "TSHİRTs".encode()
        a[cut + 5 : cut + 5 + len(word)] = np.frombuffer(word, np.uint8)
        a[cut - 40 : cut - 40 + len(word)] = np.frombuffer(word, np.uint8)
    hay = a.tobytes()
    s = Searcher.build(IGNORE_CASE, NEEDLES3, device=CPU)
    ci = s._engine._composed(IGNORE_CASE)
    eng = ci.device_engine()
    assert type(eng) is BitapAcEngine and eng.bitap_tables.trapmask is not None
    seen = _spy_stages(monkeypatch, eng)
    want = _answers(jamt.Searcher.build(jamt.IGNORE_CASE, NEEDLES3, engine="cpp"), hay)
    assert _answers(s, hay) == want
    assert _answers(s, s.stage(hay)) == want
    assert len(seen) == 14 and max(seen) <= (1 << 20) + ci.machine.max_needle_bytes - 1


def test_lowering_route_streams(budget_1mb, monkeypatch):
    """IgnoreCase on the lowering path: the whole haystack is lowered on the
    host, the lowered bytes stream, and the ends map back to raw."""
    monkeypatch.setattr(tengine, "COMPOSED_CI_MAX_STATES", 0)
    hay = _corpus(NEEDLES3, (5 << 19) + 3, 8, IGNORE_CASE)
    hay = hay[: 1 << 20] + "İKẞ TSHİRTS".encode() + hay[1 << 20:]
    s = Searcher.build(IGNORE_CASE, NEEDLES3, device=CPU)
    seen = _spy_stages(monkeypatch, s._engine.device_engine())
    want = _answers(jamt.Searcher.build(jamt.IGNORE_CASE, NEEDLES3, engine="cpp"), hay)
    assert _answers(s, hay) == want
    staged = s.stage(hay)
    assert staged.lowered is not None and staged.device is None and not staged.composed
    assert _answers(s, staged) == want
    assert s._engine._ci is None and len(seen) == 14


def test_contains_any_capacity_fallback_streams(budget_1mb, monkeypatch):
    """A sticky view that overflows the table answers ``count > 0``, and
    past the budget that count streams."""
    needles = _sticky_overflow_needles()
    s = Searcher.build(CASE_SENSITIVE, needles, engine="device", device=CPU)
    eng = s._engine.device_engine()
    assert type(eng) is DenseAcEngine
    seen = _spy_stages(monkeypatch, eng)
    miss = b"0123456789 " * ((5 << 19) // 11)
    hit = miss[: 1 << 20] + needles[40].encode() + miss[1 << 20:]
    ref = jamt.Searcher.build(jamt.CASE_SENSITIVE, needles, engine="cpp")
    for hay in (hit, miss):
        assert s.contains_any(hay) is ref.contains_any(hay)
        assert s.contains_any(s.stage(hay)) is ref.contains_any(hay)
    # Each call: the first chunk, whose sticky scan overflows, then the
    # streamed count's three chunks.
    assert len(seen) == 16 and max(seen) <= (1 << 20) + eng.overlap
