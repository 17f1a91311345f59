"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``; every test skips unless ``torch.cuda.is_available()``.  Run
on a host with an NVIDIA Hopper card from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which this file does
not use.)

The checks of ``chip_smoke.py``'s kernel phase at pytest size: the outputs
of each kernel equal its plain version's on the same device tensors (exact:
per-stream counts, sticky entries, hit registers, presence planes, hit
bitmaps, comb16 and comb32 final bases, dense, comb16 and comb32 packed
states, screen planes, the grouped kernels' summed counts and hit masks),
``final_states`` and the extraction without the host corpus equal the host
C++ engine's, the reference scan engine runs on the card, the answers equal
``ac.count_matches``, ``ac.all_matches`` and the port's host C++ engine, the
wrappers raise on bad inputs, and each launch adds one to the wrapper's
count.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.kernels import (
    bitap_contains,
    bitap_contains_plain,
    bitap_count,
    bitap_presence,
    bitap_presence_plain,
    comb16_contains,
    comb16_contains_grouped,
    comb16_contains_grouped_plain,
    comb16_contains_plain,
    comb16_count,
    comb16_count_grouped,
    comb16_states,
    comb16_states_plain,
    comb_contains,
    comb_contains_plain,
    comb_count,
    comb_states,
    comb_states_plain,
    dense_contains,
    dense_contains_plain,
    dense_count,
    dense_states,
    dense_states_plain,
    filter_contains,
    filter_contains_plain,
    matchbits,
    matchbits_plain,
)
from alfred_margaret_tpu_torch.kernels.matchbits import matchbits_design
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap
from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine
from alfred_margaret_tpu_torch.ops.comb_scan import CombAcEngine
from alfred_margaret_tpu_torch.ops.filter_scan import attach_filter
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine
from alfred_margaret_tpu_torch.ops.xla_scan import (
    StreamPlan,
    XlaAcEngine,
    build_streams,
    stage_streams_device,
)

from _torch_count_fixtures import EMBEDDED_KSS, REGISTER, REGISTER_V3, V3, V8, plant_traps
from _torch_count_fixtures import PACK2 as PACK30
from _torch_count_fixtures import V2 as TWO_WORDS

pytestmark = pytest.mark.gpu

NEEDLES3 = ["tshirt", "shirts", "shorts"]
NUL = ["a\x00b", "\x00\x00", "xyz"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _machine(needles):
    return ac.build([(n, i) for i, n in enumerate(needles)])


def _kernel_vs_plain(eng, data):
    st = eng.stage(data)
    k = eng.stream_counts(st)
    torch.cuda.synchronize()
    p = eng.stream_counts_plain(st)
    live = torch.from_numpy(st.live_np).to(k.device)
    assert torch.equal(k[live], p[live])
    total = eng.count_staged(st)
    assert total == ac.count_matches(eng.machine, data.tobytes())
    return total


@pytest.mark.parametrize("needles", [NEEDLES3, ["ab", "b", "abc", "zz"], ["x", "x", "yy", "x"], TWO_WORDS])
@pytest.mark.parametrize("n_streams", [1024, 1000])
def test_bitap_kernel_matches_plain(cuda, needles, n_streams):
    m = _machine(needles)
    data = np.frombuffer(synth_corpus(needles, 1 << 18, hit_fraction=0.03, seed=2), np.uint8)
    eng = BitapAcEngine(m, layout=plan_bitap(m, max_words=2), device=cuda, n_streams=n_streams)
    assert _kernel_vs_plain(eng, data) > 0


@pytest.mark.parametrize("needles", [NEEDLES3, PACK30, NUL])
@pytest.mark.parametrize("n_streams", [1024, 1000])
def test_dense_kernel_matches_plain(cuda, needles, n_streams):
    m = _machine(needles)
    data = np.frombuffer(synth_corpus(needles, 1 << 18, hit_fraction=0.03, seed=3), np.uint8)
    eng = DenseAcEngine(m, device=cuda, n_streams=n_streams)
    assert _kernel_vs_plain(eng, data) > 0


def test_tiny_corpus_head_streams(cuda):
    # L < K: most streams are empty and the head streams read from data[0].
    for cls in (BitapAcEngine, DenseAcEngine):
        eng = cls(_machine(NEEDLES3), device=cuda, n_streams=4096)
        data = np.frombuffer(b"tshirtshirtsshorts" * 3, np.uint8)
        assert _kernel_vs_plain(eng, data) == 15


def test_staging_on_card_equals_build_streams(cuda):
    data = np.random.default_rng(4).integers(0, 8, size=5000).astype(np.uint8)
    for n, S, L, K, T in [(5000, 128, 40, 5, 64), (100, 64, 2, 5, 32), (5000, 1, 5000, 3, 5003)]:
        streams, _, _ = stage_streams_device(data[:n], StreamPlan(n, S, L, K, T), cuda)
        # build_streams: the host layout, pinned to the JAX package's own by
        # test_torch_layout.py.
        want, _, _ = build_streams(data[:n], StreamPlan(n, S, L, K, T))
        np.testing.assert_array_equal(streams.cpu().numpy(), want)


def test_wrappers_raise_on_bad_inputs_and_count_launches(cuda):
    m = _machine(NEEDLES3)
    data = np.frombuffer(b"tshirts and shorts " * 100, np.uint8)
    dense = DenseAcEngine(m, device=cuda, n_streams=256)
    bitap = BitapAcEngine(m, device=cuda, n_streams=256)
    st = dense.stage(data)
    d0, b0 = dense_count.launches, bitap_count.launches
    dense.stream_counts(st)
    bitap.stream_counts(st)
    assert (dense_count.launches, bitap_count.launches) == (d0 + 1, b0 + 1)
    dense.stream_counts_plain(st)
    bitap.stream_counts_plain(st)
    assert (dense_count.launches, bitap_count.launches) == (d0 + 1, b0 + 1)

    non_contig = torch.zeros(st.streams.shape[1], st.streams.shape[0],
                             dtype=torch.uint8, device=cuda).T
    for fn, args in ((dense_count, dense._kernel_args(st)), (bitap_count, bitap._kernel_args(st))):
        for bad in (st.streams.int(), non_contig, st.streams.cpu()):
            with pytest.raises(ValueError):
                fn(bad, *args[1:])
    assert (dense_count.launches, bitap_count.launches) == (d0 + 1, b0 + 1)


@pytest.mark.parametrize("needles", [NEEDLES3, PACK30, NUL, ["needleword"]])
@pytest.mark.parametrize("n_streams", [1024, 1000])
def test_dense_contains_matches_plain(cuda, needles, n_streams):
    m = _machine(needles)
    for frac in (0.0, 0.001):
        data = np.frombuffer(synth_corpus(needles, 1 << 18, hit_fraction=frac, seed=5), np.uint8)
        eng = DenseAcEngine(m, device=cuda, n_streams=n_streams)
        st = eng.stage(data)
        args = eng.sticky_args(st)
        k = dense_contains(*args)
        torch.cuda.synchronize()
        assert torch.equal(k, dense_contains_plain(*args))
        seg = n_streams // 4
        parts = [dense_contains(*eng.sticky_args(st, s, min(s + seg, n_streams)))
                 for s in range(0, n_streams, seg)]
        assert torch.equal(torch.cat(parts), k)
        want = ac.count_matches(m, data.tobytes()) > 0
        assert eng.contains_staged(st) == eng.contains_staged_early(st, n_segments=4) == want


@pytest.mark.parametrize("needles", [NEEDLES3, ["x", "x", "yy", "x"], TWO_WORDS, TWO_WORDS + ["hotel", "india", "juliett", "kilo", "lima", "mike"]])
@pytest.mark.parametrize("n_streams", [1024, 1000])
def test_bitap_sticky_kernels_match_plain(cuda, needles, n_streams):
    m = _machine(needles)
    data = np.frombuffer(synth_corpus(needles, 1 << 18, hit_fraction=0.001, seed=6), np.uint8)
    eng = BitapAcEngine(m, device=cuda, n_streams=n_streams)
    st = eng.stage(data)
    args, cargs, pargs = eng.sticky_bitap_args(st), eng.contains_args(st), eng.presence_args(st)
    hits, planes = bitap_contains(*cargs), bitap_presence(*pargs)
    torch.cuda.synchronize()
    assert torch.equal(hits, bitap_contains_plain(*cargs))
    assert torch.equal(bitap_contains(*args), hits)  # one segment
    assert torch.equal(planes, bitap_presence_plain(*pargs))
    assert torch.equal(bitap_presence(*args), planes)  # one segment
    assert planes.shape == (eng.bitap.n_words, n_streams)
    assert eng.contains_staged(st) == (ac.count_matches(m, data.tobytes()) > 0)
    seen = {x.value for x in ac.all_matches(m, data.tobytes())}
    present = eng.needle_presence_staged(st)
    assert present.tolist() == [i in seen for i in range(len(needles))]


@pytest.mark.parametrize("kind,needles", [
    ("bitap", NEEDLES3), ("bitap", ["x", "x", "yy", "x"]), ("bitap", TWO_WORDS),
    ("dense", NEEDLES3), ("dense", PACK30), ("dense", NUL), ("comb16", "config 2"),
])
@pytest.mark.parametrize("n_streams", [1024, 1000])
def test_matchbits_matches_plain(cuda, kind, needles, n_streams):
    """B6 (dense and bitap steps) and B13 (comb16 step), with the stream
    plan's overlap (in segments) and without (one segment), equal the plain
    version in every count and every bitmap word; the words of the bitmap
    land on memory filled with ones first, so a word no segment writes would
    show."""
    needles = CONFIG2 if needles == "config 2" else needles
    m = _machine(needles)
    data = np.frombuffer(synth_corpus(needles, 1 << 18, hit_fraction=0.03, seed=7), np.uint8)
    cls = {"bitap": BitapAcEngine, "dense": DenseAcEngine, "comb16": Comb16AcEngine}[kind]
    eng = cls(m, device=cuda, n_streams=n_streams)
    st = eng.stage(data)
    args = eng.bits_args(st)
    assert args[3] == ("dense" if kind == "bitap" and eng.bitap.n_words > 1 else kind)
    pc, pb = matchbits_plain(*args)
    for overlap in (st.plan.overlap, None):
        d = matchbits_design(st.streams, *args[3:], overlap=overlap)
        assert d.segments == 1 if overlap is None else d.segments > 1
        del d
        # Freed at once: the caching allocator hands these blocks to counts and bits.
        torch.full_like(pc, -1), torch.full_like(pb, -1)
        counts, bits = matchbits(*args, overlap=overlap)
        torch.cuda.synchronize()
        assert torch.equal(counts, pc)
        assert torch.equal(bits, pb)
    ends, vids = eng.matches_arrays_staged(st)
    want = ac.all_matches(m, data.tobytes())
    assert len(ends) == len(want) > 0
    assert [(int(e), int(v)) for e, v in zip(ends, vids)] == [(x.pos, x.value) for x in want]


def test_new_wrappers_count_launches_and_raise(cuda):
    m = _machine(NEEDLES3)
    data = np.frombuffer(b"tshirts and shorts " * 100, np.uint8)
    dense = DenseAcEngine(m, device=cuda, n_streams=256)
    bitap = BitapAcEngine(m, device=cuda, n_streams=256)
    st = dense.stage(data)
    calls = [
        (dense_contains, dense_contains_plain, dense.sticky_args(st)),
        (bitap_contains, bitap_contains_plain, bitap.contains_args(st)),
        (bitap_presence, bitap_presence_plain, bitap.sticky_bitap_args(st)),
        (matchbits, matchbits_plain, bitap.bits_args(st)),
        (matchbits, matchbits_plain, dense.bits_args(st)),
    ]
    for fn, plain, args in calls:
        before = fn.launches
        fn(*args)
        plain(*args)
        assert fn.launches == before + 1
        bad_args = (st.streams.cpu(),) + tuple(args[1:])
        with pytest.raises(ValueError):
            fn(*bad_args)
        if fn is dense_contains:  # B3 takes the plan's overlap last
            assert args[-1] == st.plan.overlap
            with pytest.raises(ValueError):
                fn(*args[:-1], -1)
        assert fn.launches == before + 1


def _random_needles(seed, n):
    rng = np.random.default_rng(seed)
    return list(dict.fromkeys(
        "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(4, 9)))
        for _ in range(int(n * 1.1))
    ))[:n]


CONFIG2 = ["abc", "abcd", "bcd", "c"] + _random_needles(7, 100)[4:]
COMB16_SETS = {
    "config2": CONFIG2,
    "nested": ["a", "aa", "aaa", "aaaa", "aaaaa"] + _random_needles(13, 80),
    "n150": _random_needles(21, 150),
    "no_shorts": [n for n in CONFIG2 if len(n) >= 4],
    "nul": CONFIG2[:60] + ["a\x00b", "\x00\x00x"],
}


@pytest.mark.parametrize("name", sorted(COMB16_SETS))
@pytest.mark.parametrize("n_streams", [1024, 1000])
def test_comb16_kernels_match_plain(cuda, name, n_streams):
    needles = COMB16_SETS[name]
    m = _machine(needles)
    data = np.frombuffer(synth_corpus(needles, 1 << 18, hit_fraction=0.02, seed=8), np.uint8)
    eng = Comb16AcEngine(m, device=cuda, n_streams=n_streams)
    st = eng.stage(data)
    live = torch.from_numpy(st.live_np).to(cuda)
    assert _kernel_vs_plain(eng, data) > 0  # B8
    args = eng.sticky_args(st)
    bases = comb16_contains(*args)  # B10
    torch.cuda.synchronize()
    assert torch.equal(bases[live], comb16_contains_plain(*args)[live])
    args = eng.bits_args(st)
    counts, bits = matchbits(*args, overlap=st.plan.overlap)  # B13
    torch.cuda.synchronize()
    pc, pb = matchbits_plain(*args)
    assert torch.equal(counts[live], pc[live]) and torch.equal(bits, pb)
    if eng._filter_tables is not None:  # B14, whole and in the rule's segments
        args = (st.streams, st.vend, *eng._filter_tables.args())
        for over in (None, st.plan.overlap):
            planes = filter_contains(*args, over)
            torch.cuda.synchronize()
            assert torch.equal(planes, filter_contains_plain(*args))
    else:
        assert name == "nul"
    host = CppAcEngine(m)
    assert eng.contains_staged(st) == (host.first_hit(data) >= 0)
    ends, vids = eng.matches_arrays_staged(st)
    hends, hvids = host.matches_arrays(data)
    assert np.array_equal(ends, hends) and np.array_equal(vids, hvids)


def test_comb16_wrappers_count_launches_and_raise(cuda):
    eng = Comb16AcEngine(_machine(CONFIG2), device=cuda, n_streams=256)
    st = eng.stage(np.frombuffer(b"abcd and bcd " * 100, np.uint8))
    calls = [
        (comb16_count, eng._kernel_args(st)),
        (comb16_contains, eng.sticky_args(st)),
        (matchbits, eng.bits_args(st)),
        (filter_contains, (st.streams, st.vend, *eng._filter_tables.args(), st.plan.overlap)),
    ]
    for fn, args in calls:
        before = fn.launches
        fn(*args)
        assert fn.launches == before + 1
        with pytest.raises(ValueError):
            fn(st.streams.cpu(), *args[1:])
        assert fn.launches == before + 1
    # B10's and B14's overlap, and B14's restart: bad values raise without a
    # launch.
    sargs, fargs = calls[1][1], calls[3][1]
    assert sargs[-1] == fargs[-1] == st.plan.overlap
    for fn, args in ((comb16_contains, (*sargs[:-1], -1)), (filter_contains, (*fargs[:-1], -1)),
                     (filter_contains, (*fargs[:-2], 3, st.plan.overlap)),
                     (filter_contains, (*fargs[:-2], st.plan.overlap + 3, st.plan.overlap))):
        before = fn.launches
        with pytest.raises(ValueError):
            fn(*args)
        assert fn.launches == before


def _config5(n):
    """The first ``n`` needles of ``BASELINE.json`` config 5 (drawn as
    ``alfred_margaret_tpu/bench/configs.py`` draws them)."""
    rng = np.random.default_rng(7)
    list("".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(4, 9)))
         for _ in range(110))
    return list(dict.fromkeys(
        "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(5, 12)))
        for _ in range(11000)
    ))[:n]


#: Needle sets that overflow one table at ``max_rows`` and engage both fused
#: kernels: random needles, and NUL-bearing ones (not zero-inert).
GROUPED_SETS = {
    "mid": (_random_needles(17, 150), 5),
    "nul": (_random_needles(9, 60) + ["a\x00b", "\x00\x00x"], 4),
}


@pytest.mark.parametrize("name", sorted(GROUPED_SETS))
@pytest.mark.parametrize("n_streams", [1024, 1000])
def test_grouped_kernels_match_plain(cuda, name, n_streams):
    needles, max_rows = GROUPED_SETS[name]
    m = _machine(needles)
    data = np.frombuffer(synth_corpus(needles, 1 << 18, hit_fraction=0.02, seed=8), np.uint8)
    eng = GroupedAcEngine(m, device=cuda, max_rows=max_rows, n_streams=n_streams)
    st = eng.stage(data)
    assert eng._fused_setup() is not None and eng._fused_sticky_setup() is not None
    counts = eng.stream_counts(st)  # B9
    torch.cuda.synchronize()
    assert torch.equal(counts, eng.stream_counts_plain(st))
    args = eng.sticky_args(st)
    hits = comb16_contains_grouped(*args)  # B11
    torch.cuda.synchronize()
    assert torch.equal(hits, comb16_contains_grouped_plain(*args))
    host = CppAcEngine(m)
    assert eng.count_staged(st) == host.count(data) > 0
    assert eng.contains_staged(st) == (host.first_hit(data) >= 0)
    ends, vids = eng.matches_arrays_staged(st)
    hends, hvids = host.matches_arrays(data)
    assert np.array_equal(ends, hends) and np.array_equal(vids, hvids)
    assert np.array_equal(eng.value_presence_staged(st, len(needles)),
                          host.value_presence(data, len(needles)))


def test_filter_twelve_words_matches_plain(cuda):
    m = _machine(_config5(1000))
    eng = DenseAcEngine(_machine(["zz"]), device=cuda, n_streams=1000,
                        overlap=m.max_needle_bytes - 1)
    assert attach_filter(eng, m, max_words=12) and eng._filter_lay.n_words == 12
    digits = b"0123456789 ,;:!" * 20000
    for data in (digits, digits[:100000] + b"qwertyuiop" + digits, synth_corpus(
            _config5(1000)[:500], 1 << 18, hit_fraction=0.01, seed=11)):
        st = eng.stage(np.frombuffer(data, np.uint8))
        args = (st.streams, st.vend, *eng._filter_tables.args())
        planes = filter_contains(*args)
        torch.cuda.synchronize()
        assert torch.equal(planes, filter_contains_plain(*args))


def test_grouped_wrappers_count_launches_and_raise(cuda):
    needles, max_rows = GROUPED_SETS["mid"]
    eng = GroupedAcEngine(_machine(needles), device=cuda, max_rows=max_rows, n_streams=256)
    st = eng.stage(np.frombuffer(" ".join(needles).encode() * 3, np.uint8))
    assert eng._fused_sticky_setup() is not None
    calls = [
        (comb16_count_grouped, (st.streams, st.warm, st.vend, eng._fused.tables)),
        (comb16_contains_grouped, eng.sticky_args(st)),
    ]
    for fn, args in calls:
        before = fn.launches
        fn(*args)
        assert fn.launches == before + 1
        with pytest.raises(ValueError):
            fn(st.streams.cpu(), *args[1:])
        assert fn.launches == before + 1


def test_screen_count_matches_plain_and_b9(cuda):
    """The grouped engine's count on config 5's first 1,000 needles: the
    suffix screen's kernel equals its plain version per stream, with the
    same screen passes on the device counter, and B9 over every group (its
    fused tables built directly); ``count_staged`` launches it once."""
    from alfred_margaret_tpu_torch.kernels import screen_count, screen_count_plain

    needles = _config5(1000)
    m = _machine(needles)
    eng = GroupedAcEngine(m, device=cuda)
    assert eng._screen is not None and eng._screen.bits == 17
    data = np.frombuffer(synth_corpus(needles, 1 << 20, hit_fraction=0.01, seed=27), np.uint8)
    st = eng.stage(data)
    tables = eng._screen
    tables.passes.zero_()
    k = screen_count(st.streams, st.warm, st.vend, tables, st.plan.overlap)
    torch.cuda.synchronize()
    k_passes = int(tables.passes)
    tables.passes.zero_()
    p = screen_count_plain(st.streams, st.warm, st.vend, tables)
    assert torch.equal(k, p) and k_passes == int(tables.passes) > 0
    assert torch.equal(k, eng.stream_counts(st))  # B9
    before = screen_count.launches
    assert eng.count_staged(st) == CppAcEngine(m).count(data) > 0
    assert screen_count.launches == before + 1


#: Needle sets that overflow comb16 and take comb32: random needles, config
#: 5's first 300, counts of up to 5 per state, and NUL-bearing needles (not
#: zero-inert).
COMB32_SETS = {
    "n200": _random_needles(22, 200),
    "config5_300": _config5(300),
    "nested": ["a", "aa", "aaa", "aaaa", "aaaaa"] + _random_needles(31, 120),
    "nul": _random_needles(22, 200)[:150] + ["a\x00b", "\x00\x00x"],
}


@pytest.mark.parametrize("name", sorted(COMB32_SETS))
@pytest.mark.parametrize("n_streams", [1024, 1000])
def test_comb32_kernels_match_plain(cuda, name, n_streams):
    needles = COMB32_SETS[name]
    m = _machine(needles)
    data = np.frombuffer(synth_corpus([x for x in needles if "\x00" not in x], 1 << 18,
                                      hit_fraction=0.02, seed=8), np.uint8)
    eng = CombAcEngine(m, device=cuda, n_streams=n_streams)
    st = eng.stage(data)
    live = torch.from_numpy(st.live_np).to(cuda)
    assert _kernel_vs_plain(eng, data) > 0  # B15
    args = eng.sticky_args(st)
    bases = comb_contains(*args)  # B16
    torch.cuda.synchronize()
    assert torch.equal(bases[live], comb_contains_plain(*args)[live])
    args = eng.states_args(st)
    pk = comb_states(*args)  # B17
    torch.cuda.synchronize()
    assert torch.equal(pk, comb_states_plain(*args))
    host = CppAcEngine(m)
    assert eng.contains_staged(st) == (host.first_hit(data) >= 0)
    ends, vids = eng.matches_arrays_staged(st)
    hends, hvids = host.matches_arrays(data)
    assert np.array_equal(ends, hends) and np.array_equal(vids, hvids)


def test_comb32_wrappers_count_launches_and_raise(cuda):
    eng = CombAcEngine(_machine(COMB32_SETS["n200"]), device=cuda, n_streams=256)
    st = eng.stage(np.frombuffer(" ".join(COMB32_SETS["n200"]).encode() * 3, np.uint8))
    calls = [
        (comb_count, eng._kernel_args(st)),
        (comb_contains, eng.sticky_args(st)),
        (comb_states, eng.states_args(st)),
    ]
    for fn, args in calls:
        before = fn.launches
        fn(*args)
        assert fn.launches == before + 1
        with pytest.raises(ValueError):
            fn(st.streams.cpu(), *args[1:])
        # Each takes the plan's overlap last: a negative one raises.
        assert args[-1] == st.plan.overlap
        with pytest.raises(ValueError):
            fn(*args[:-1], -1)
        assert fn.launches == before + 1
    by_step = dict(matchbits.launches_by_step)
    c16 = Comb16AcEngine(_machine(CONFIG2), device=cuda, n_streams=256)
    matchbits(*c16.bits_args(c16.stage(np.frombuffer(b"abcd " * 100, np.uint8))))
    assert matchbits.launches_by_step == {**by_step, "comb16": by_step["comb16"] + 1}


#: Machines of the packed-states kernels: B5 on the bitap, packing-2 and NUL
#: dense tables, B12 on comb16 sets with and without a minimized table set.
STATES_SETS = {
    "bitap": (BitapAcEngine, NEEDLES3),
    "packing2": (DenseAcEngine, PACK30),
    "nul": (DenseAcEngine, NUL),
    "config2": (Comb16AcEngine, CONFIG2),
    "nested16": (Comb16AcEngine, COMB16_SETS["nested"]),
    "n200": (CombAcEngine, COMB32_SETS["n200"]),
}


@pytest.mark.parametrize("name", sorted(STATES_SETS))
@pytest.mark.parametrize("n_streams", [1024, 1000])
def test_states_kernels_match_plain(cuda, name, n_streams):
    import dataclasses

    engine, needles = STATES_SETS[name]
    m = _machine(needles)
    data = np.frombuffer(synth_corpus([x for x in needles if "\x00" not in x], 1 << 18,
                                      hit_fraction=0.02, seed=9), np.uint8)
    eng = engine(m, device=cuda, n_streams=n_streams)
    st = eng.stage(data)
    args = eng.states_args(st)
    kernel, plain = {
        BitapAcEngine: (dense_states, dense_states_plain),
        DenseAcEngine: (dense_states, dense_states_plain),
        Comb16AcEngine: (comb16_states, comb16_states_plain),
        CombAcEngine: (comb_states, comb_states_plain),
    }[engine]
    pk = kernel(*args)  # B5, B12 or B17
    torch.cuda.synchronize()
    assert pk.shape == (st.plan.time_len, n_streams) and torch.equal(pk, plain(*args))
    host = CppAcEngine(m)
    assert np.array_equal(eng.final_states_staged(st), host.final_states(data))
    with_host = eng.match_positions_staged(st)
    bare = eng.match_positions_staged(dataclasses.replace(st, data_np=None))
    assert all(np.array_equal(a, b) for a, b in zip(bare, with_host))
    ends, vids = eng.matches_arrays_staged(dataclasses.replace(st, data_np=None))
    hends, hvids = host.matches_arrays(data)
    assert len(ends) > 0 and np.array_equal(ends, hends) and np.array_equal(vids, hvids)


def test_states_wrappers_count_launches_and_raise(cuda):
    d = DenseAcEngine(_machine(PACK30), device=cuda, n_streams=256)
    c = Comb16AcEngine(_machine(CONFIG2), device=cuda, n_streams=256)
    hay = np.frombuffer(b"abcd and bcd " * 100, np.uint8)
    for fn, eng in ((dense_states, d), (comb16_states, c)):
        st = eng.stage(hay)
        args = eng.states_args(st)
        before = fn.launches
        fn(*args)
        assert fn.launches == before + 1
        with pytest.raises(ValueError):
            fn(args[0].cpu(), *args[1:])
        # B5 and B12 take the plan's overlap last.
        assert args[-1] == st.plan.overlap
        with pytest.raises(ValueError):
            fn(*args[:-1], -1)
        assert fn.launches == before + 1


def test_reference_engine_on_the_card(cuda):
    needles = [""] + _random_needles(3, 600)
    m = _machine(needles)
    data = synth_corpus(needles[1:], 1 << 16, hit_fraction=0.02, seed=4)
    eng = XlaAcEngine(m, device=cuda)
    host = CppAcEngine(m)
    assert eng.count(data) == host.count(data)
    assert np.array_equal(eng.final_states(data), host.final_states(data))
    hit = np.flatnonzero(eng.state_hits(data))
    assert np.array_equal(ac.presence_of_states(m, hit, len(needles)),
                          host.value_presence(data, len(needles)))


# -- IgnoreCase: the trap parts of B2, B4 and B7 ------------------------------------

#: (needles, embedded trap, trap register) of the three byte-class layouts.
CI_LAYOUTS = [
    (["dress", "shoe", "shorts"], False, False),
    (["kilo", "fix"], True, False),
    (["tshirt", "shirts", "shorts", "kilo", "café"], False, True),
]


def _ci_engine(needles, device, n_streams):
    from alfred_margaret_tpu_torch.models import case_dfa
    from alfred_margaret_tpu_torch.ops.bitap_scan import plan_bitap_ci

    m = _machine(needles)
    cm = case_dfa.compose_build(list(zip(m.needles, m.values)), machine=m)
    return m, BitapAcEngine(cm, layout=plan_bitap_ci(cm, max_words=2), device=device,
                            n_streams=n_streams)


def _ci_corpus(needles, seed, traps):
    rng = np.random.default_rng(seed)
    text = bytearray(synth_corpus(needles, 1 << 18, hit_fraction=0.02, seed=seed))
    for i in np.flatnonzero(rng.random(len(text)) < 0.5):
        if 97 <= text[i] <= 122:
            text[i] -= 32
    for k, t in enumerate(traps):
        pos = (k + 1) * len(text) // (len(traps) + 1)
        text[pos:pos] = t.encode()
    return bytes(text)


@pytest.mark.parametrize("needles,embedded,register", CI_LAYOUTS)
@pytest.mark.parametrize("n_streams", [1024, 1000])
def test_trap_kernels_match_plain(cuda, needles, embedded, register, n_streams):
    from alfred_margaret_tpu_torch.kernels import bitap_count_plain
    from alfred_margaret_tpu_torch.utils.case import IGNORE_CASE

    m, eng = _ci_engine(needles, cuda, n_streams)
    lay = eng.bitap
    assert (any(w.trap_endmask for w in lay.words), lay.trap is not None) == (embedded, register)
    data = _ci_corpus(needles, 8, ["KİLO", "KKILO FİX", "Å STRAẞE"])
    st = eng.stage(data)
    kargs, sargs = eng._kernel_args(st), eng.presence_args(st)
    cargs = eng.contains_args(st)
    before = (bitap_count.launches_trap, bitap_contains.launches_trap, bitap_presence.launches_trap)
    outs = [(bitap_count(*kargs), bitap_count_plain(*kargs)),
            (bitap_contains(*cargs), bitap_contains_plain(*cargs)),
            (bitap_presence(*sargs), bitap_presence_plain(*sargs))]
    torch.cuda.synchronize()
    for k, p in outs:
        for a, b in zip(k if isinstance(k, tuple) else (k,), p if isinstance(p, tuple) else (p,)):
            assert torch.equal(a.cpu(), b.cpu())
    after = (bitap_count.launches_trap, bitap_contains.launches_trap, bitap_presence.launches_trap)
    assert after == tuple(b + lay.has_trap for b in before)
    exp = ac.count_matches(m, data, IGNORE_CASE)
    assert eng.count_staged(st) == exp > 0 and eng.contains_staged(st)
    if lay.has_trap:
        assert outs[0][0][1].any() and eng.needle_presence_staged(st) is None


def test_ignore_case_searcher_on_the_card(cuda):
    from alfred_margaret_tpu_torch import IGNORE_CASE, Searcher

    needles = ["kilo", "fix", "tshirt"]
    data = _ci_corpus(needles, 9, ["KİLO", "FİX"])
    s = Searcher.build(IGNORE_CASE, needles)
    assert s.device == cuda
    st = s.stage(data)
    assert st.composed and isinstance(s._engine._ci.device_engine(), BitapAcEngine)
    m = s.automaton
    assert s.count_matches(st) == ac.count_matches(m, data, IGNORE_CASE)
    ends, _ = s.all_matches_arrays(st)
    assert ends.tolist() == [x.pos for x in ac.all_matches(m, data, IGNORE_CASE)]
    assert s.contains_any(st) and s.contains_all(st)


# -- the sharded engine on one card ---------------------------------------------------


def _shard_launches_match_plain(eng, st, step):
    """Each shard's launch of ``step`` equals its plain version; returns the
    kernels launched."""
    from alfred_margaret_tpu_torch.parallel.shard import PLAIN

    kernels = set()
    for i, g, dev in eng.shards():
        kernel, args, kw = eng.shard_call(step, st, i, g, dev)
        out = kernel(*args, **kw)
        torch.cuda.synchronize()
        plain = PLAIN[kernel](*args, **kw)
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        plain if isinstance(plain, tuple) else (plain,)):
            assert torch.equal(a, b), (kernel.__name__, i, g)
        kernels.add(kernel.__name__)
    return kernels


def test_mesh_on_one_card(cuda):
    """A (2,1,2) mesh of cuda:0: each shard's count, sticky, states and bitmap
    launches equal their plain versions, and the answers the host C++
    engine's."""
    from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, make_mesh

    needles = _random_needles(3, 30)
    m = _machine(needles)
    data = np.frombuffer(synth_corpus(needles, 1 << 20, hit_fraction=0.01, seed=12), np.uint8)
    eng = DistributedAcEngine(m, make_mesh([cuda] * 4, data=2, needle=2))
    assert eng.inner == "pallas" and eng.count_route() == "comb16"
    st = eng.stage(data)
    assert {dev for _, dev in st.blocks} == {cuda}
    assert _shard_launches_match_plain(eng, st, "count") == {"comb16_count_grouped"}
    sticky = {"comb16": "comb16_contains_base", "dense": "dense_contains"}[eng.sticky_route()]
    assert _shard_launches_match_plain(eng, st, "sticky") == {sticky}
    assert _shard_launches_match_plain(eng, st, "states") == {"dense_states"}
    assert _shard_launches_match_plain(eng, st, "bits") == {"matchbits"}
    host = CppAcEngine(m)
    assert eng.count_staged(st) == host.count(data) > 0
    assert eng.contains_any(st) is True
    ends, vids = eng.matches_arrays(st)
    hends, hvids = host.matches_arrays(data)
    assert np.array_equal(ends, hends) and np.array_equal(vids, hvids)


def test_b11_one_group_kernel_matches_plain(cuda):
    """B11's one-group mode on config 2's four needle groups ((2,1,4) on
    cuda:0) over a hit corpus and the digits corpus: each shard's final bases
    equal the plain version's; the wrapper counts its launches and raises on
    a CPU tensor and on more than one group."""
    from alfred_margaret_tpu_torch.kernels import comb16_contains_base
    from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, make_mesh

    m = _machine(CONFIG2)
    eng = DistributedAcEngine(m, make_mesh([cuda] * 8, data=2, needle=4))
    assert eng.sticky_route() == "comb16"
    host = CppAcEngine(m)
    for data in (synth_corpus(CONFIG2, 1 << 20, hit_fraction=0.01, seed=4),
                 b"0123456789 ,;:!" * 50000):
        data = np.frombuffer(data, np.uint8)
        st = eng.stage(data)
        assert _shard_launches_match_plain(eng, st, "sticky") == {"comb16_contains_base"}
        assert eng.contains_any(st) == (host.first_hit(data) >= 0)
        assert eng.count_staged(st) == host.count(data)
    i, g, dev = eng.shards()[0]
    _, args, _ = eng.shard_call("sticky", st, i, g, dev)
    before = comb16_contains_base.launches
    comb16_contains_base(*args)
    assert comb16_contains_base.launches == before + 1
    with pytest.raises(ValueError):
        comb16_contains_base(args[0].cpu(), *args[1:])
    every = eng._sticky16_tables()  # the four groups' tables, on the host
    every = dataclasses.replace(every, **{
        k: getattr(every, k).to(cuda)
        for k in ("classmap", "comb", "aux", "root_row", "segtable", "gscal")})
    with pytest.raises(ValueError, match="one group"):
        comb16_contains_base(args[0], args[1], every)
    assert comb16_contains_base.launches == before + 1


# -- B9 and B15's segmented designs at the edge shapes ---------------------------------

#: (T, S): T below a tile; S not a multiple of 128 with byte-wise staging
#: (S % 16 != 0) and with 16-byte copies (S % 16 == 0); a full block count.
EDGE_SHAPES = [(20, 1000), (300, 200), (300, 1040), (1000, 4096)]


def _edge_streams(needles, T, S, K, seed, device):
    """[T, S] windows of a hit corpus at random offsets, with random
    warm-ups in [0, K] and ragged vends (a tenth of the streams padded)."""
    rng = np.random.default_rng(seed)
    data = np.frombuffer(synth_corpus([x for x in needles if "\x00" not in x], 1 << 16,
                                      hit_fraction=0.05, seed=seed), np.uint8)
    off = rng.integers(0, len(data) - T, S)
    streams = np.ascontiguousarray(data[off[None, :] + np.arange(T)[:, None]])
    warm = rng.integers(0, K + 1, S)
    vend = rng.integers(0, T + 1, S)
    vend[rng.random(S) < 0.1] = 0

    def dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)

    return dev(streams, torch.uint8), dev(warm, torch.int32), dev(vend, torch.int32)


#: Needle sets the screen takes at the edge shapes: config 5's first 300
#: (keys of 5 bytes), needles of 8 to 16 bytes (keys of 8), and needles
#: holding NUL (a 4-byte key).
SCREEN_SETS = {
    "config5_300": _config5(300),
    "long": [x * 2 for x in _random_needles(41, 80)] + ["abcdefgh", "0123456789abcdef"],
    "nul": _random_needles(43, 60) + ["a\x00bc", "\x00\x00\x00\x00", "xy\x00z"],
}


@pytest.mark.parametrize("shape", [(5, 300), (15, 1000), *EDGE_SHAPES])
def test_screen_count_matches_plain_at_edge_shapes(cuda, shape):
    """``screen_count`` with the plan's overlap (segments by its rule, short
    last tiles) and without, on ragged warm-ups and vends, equals its plain
    version and counts its passes alike; an overlap under the longest needle
    less one raises before any launch."""
    from alfred_margaret_tpu_torch.kernels.screen_count import (
        plan_screen,
        screen_count,
        screen_count_plain,
    )

    T, S = shape
    for name, needles in SCREEN_SETS.items():
        m = _machine(needles)
        tables = plan_screen(m, cuda)
        assert tables is not None, name
        K = m.max_needle_bytes - 1
        streams, warm, vend = _edge_streams(needles, T, S, K, T + S, cuda)
        tables.passes.zero_()
        want = screen_count_plain(streams, warm, vend, tables)
        want_passes = int(tables.passes)
        before = screen_count.launches
        for overlap in (K, None):
            tables.passes.zero_()
            assert torch.equal(screen_count(streams, warm, vend, tables, overlap), want), name
            assert int(tables.passes) == want_passes, name
        assert screen_count.launches == before + 2
        with pytest.raises(ValueError):
            screen_count(streams, warm, vend, tables, K - 1)
        assert screen_count.launches == before + 2


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_b15_matches_plain_at_edge_shapes(cuda, shape):
    """B15 as ``comb_count`` launches it, with the plan's overlap (the
    streams cut into the segments its rule picks) and without (one
    segment), equals the plain version: exact counts."""
    from alfred_margaret_tpu_torch.kernels.comb import comb_count_plain

    T, S = shape
    for name in ("n200", "nested", "nul"):
        m = _machine(COMB32_SETS[name])
        eng = CombAcEngine(m, device=cuda, n_streams=1024)
        K = m.max_needle_bytes - 1
        streams, warm, vend = _edge_streams(COMB32_SETS[name], T, S, K, T + S, cuda)
        tabs = eng.tables.args()
        want = comb_count_plain(streams, warm, vend, *tabs)
        before = comb_count.launches
        assert torch.equal(comb_count(streams, warm, vend, *tabs, K), want), name
        assert torch.equal(comb_count(streams, warm, vend, *tabs), want), name
        assert comb_count.launches == before + 2
        with pytest.raises(ValueError):
            comb_count(streams, warm, vend, *tabs, -1)
        assert comb_count.launches == before + 2


_BUILT = {}


def _as_groups(t16, G, rows=None):
    """``G`` copies of one comb16 table set as B9's group tables, its comb
    padded with zero rows to ``rows`` (inert: no probe window reaches past
    the real table), its count ranges in ``gscal``."""
    from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16GroupTables

    comb = t16.comb
    if rows is not None:
        comb = torch.nn.functional.pad(comb, (0, rows * 128 - comb.numel()))
    root = torch.tensor([t16.root_cb], dtype=torch.int32, device=comb.device)

    def stack(x):
        return x.unsqueeze(0).expand(G, -1).contiguous()

    return Comb16GroupTables(
        classmap=stack(t16.classmap), comb=stack(comb), aux=stack(t16.aux),
        root_row=stack(t16.root_row), segtable=stack(t16.segtable),
        gscal=stack(torch.cat([root, t16.ranges])),
        gscal_host=((t16.root_cb, *t16.ranges.tolist()),) * G, BB=t16.BB,
        owner_mask=t16.owner_mask, CB=t16.CB, sticky=False)


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_b9_matches_plain_at_edge_shapes(cuda, shape):
    """B9 as ``comb16_count_grouped`` launches it, with the plan's overlap
    and without, equals the plain version: config 5's eleven groups (three
    chunks of groups), one group alone (the mesh's S5), and a set with counts
    of up to 5 (six count ranges) padded near ``MAX_ROWS`` in three groups,
    which needs a block per group."""
    from alfred_margaret_tpu_torch.kernels.comb16_grouped import (
        comb16_grouped_design,
        comb16_count_grouped_plain,
    )

    T, S = shape
    m5, eng5 = _config5_engine(cuda)
    f5 = eng5._fused_setup().tables
    nested = _machine(COMB16_SETS["nested"])
    big = _as_groups(Comb16AcEngine(nested, device=cuda, n_streams=1024).tables, 3, rows=46)
    cases = [("config 5", f5, m5, _config5(1000)), ("one group", f5.group(0), m5, _config5(1000)),
             ("near MAX_ROWS", big, nested, COMB16_SETS["nested"])]
    for label, tabs, m, needles in cases:
        K = m.max_needle_bytes - 1
        streams, warm, vend = _edge_streams(needles, T, S, K, T * S, cuda)
        want = comb16_count_grouped_plain(streams, warm, vend, tabs)
        assert int(want.sum()) > 0
        chunk = comb16_grouped_design(streams, tabs, K).chunk
        if label != "one group":
            assert chunk < tabs.n_groups, (label, chunk)  # several chunks of groups
        before = comb16_count_grouped.launches
        assert torch.equal(comb16_count_grouped(streams, warm, vend, tabs, K), want), label
        assert torch.equal(comb16_count_grouped(streams, warm, vend, tabs), want), label
        assert comb16_count_grouped.launches == before + 2
        with pytest.raises(ValueError):
            comb16_count_grouped(streams, warm, vend, tabs, -1)
        assert comb16_count_grouped.launches == before + 2


def test_b9_refuses_what_no_block_holds(cuda, monkeypatch):
    """A chunk whose tables pass a block's shared memory is refused by the
    launch, and the wrapper raises the error and counts no launch."""
    from alfred_margaret_tpu_torch.kernels import comb16_grouped
    from alfred_margaret_tpu_torch.kernels.segments import Design

    nested = _machine(COMB16_SETS["nested"])
    big = _as_groups(Comb16AcEngine(nested, device=cuda, n_streams=1024).tables, 8, rows=46)
    streams, warm, vend = _edge_streams(COMB16_SETS["nested"], 64, 256, 4, 1, cuda)
    monkeypatch.setattr(comb16_grouped, "comb16_grouped_design",
                        lambda *args: Design(1, 8))
    before = comb16_count_grouped.launches
    with pytest.raises(RuntimeError, match="CUDA kernel launch failed"):
        comb16_count_grouped(streams, warm, vend, big, 4)
    assert comb16_count_grouped.launches == before


# -- B11 (both modes) and B17's segmented designs at the edge shapes -------------------

#: The edge shapes and one stream alone.
EDGE_SHAPES_ONE = EDGE_SHAPES + [(300, 1)]
SINGLES = ["a", "e", " ", "z"]  # overlap 0


def _sticky_groups(sticky16, G):
    """``G`` copies of one comb16 sticky table set as B11's group tables."""
    from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16GroupTables

    dev = sticky16.comb.device

    def stack(x):
        return x.unsqueeze(0).expand(G, -1).contiguous()

    gscal = torch.tensor([[sticky16.root_cb, sticky16.absorb]] * G, dtype=torch.int32, device=dev)
    return Comb16GroupTables(
        classmap=stack(sticky16.classmap), comb=stack(sticky16.comb), aux=stack(sticky16.aux),
        root_row=stack(sticky16.root_row), segtable=stack(sticky16.segtable), gscal=gscal,
        gscal_host=((sticky16.root_cb, sticky16.absorb),) * G, BB=sticky16.BB,
        owner_mask=sticky16.owner_mask, CB=sticky16.CB, sticky=True)


def _config5_engine(cuda):
    if "config5" not in _BUILT:  # the grouped build takes ~20 s: once per module
        m5 = _machine(_config5(1000))
        _BUILT["config5"] = (m5, GroupedAcEngine(m5, device=cuda, n_streams=1024))
    return _BUILT["config5"]


@pytest.mark.parametrize("shape", EDGE_SHAPES_ONE)
def test_b11_matches_plain_at_edge_shapes(cuda, shape):
    """B11 as ``comb16_contains_grouped`` launches it and its one-group mode
    ``comb16_contains_base``, with the plan's overlap (segments and chunks
    of groups by the rules) and without (one segment), equal the plain
    versions: config 5's sticky groups, one of them alone (the mesh's S4),
    and single bytes (overlap 0) in three copies; with every stream padded,
    no hit and the root bases."""
    from alfred_margaret_tpu_torch.kernels.comb16_grouped import (
        comb16_contains_base,
        comb16_contains_base_plain,
        comb16_grouped_design,
    )

    T, S = shape
    m5, eng5 = _config5_engine(cuda)
    y5 = eng5._fused_sticky_setup().tables
    singles = _sticky_groups(
        Comb16AcEngine(_machine(SINGLES), device=cuda, n_streams=1024).sticky_tables(), 3)
    cases = [("config 5", y5, m5.max_needle_bytes - 1, _config5(1000)),
             ("singles", singles, 0, SINGLES)]
    for label, tabs, K, needles in cases:
        streams, warm, vend = _edge_streams(needles, T, S, K, T + S + 2, cuda)
        padded = torch.zeros_like(vend)
        want = comb16_contains_grouped_plain(streams, vend, tabs)
        if S > 1:
            assert 0 < int(want.sum()) < S, label
        assert comb16_grouped_design(streams, tabs, K).segments >= 1
        before = comb16_contains_grouped.launches
        assert torch.equal(comb16_contains_grouped(streams, vend, tabs, K), want), label
        assert torch.equal(comb16_contains_grouped(streams, vend, tabs), want), label
        assert not comb16_contains_grouped(streams, padded, tabs, K).any(), label
        assert comb16_contains_grouped.launches == before + 3
        with pytest.raises(ValueError):
            comb16_contains_grouped(streams, vend, tabs, -1)
        with pytest.raises(ValueError):
            comb16_contains_grouped(streams.cpu(), vend, tabs, K)
        assert comb16_contains_grouped.launches == before + 3
        for g in (0, tabs.n_groups - 1):
            one = tabs.group(g)
            want = comb16_contains_base_plain(streams, vend, one)
            before = comb16_contains_base.launches
            assert torch.equal(comb16_contains_base(streams, vend, one, K), want), (label, g)
            assert torch.equal(comb16_contains_base(streams, vend, one), want), (label, g)
            roots = comb16_contains_base(streams, padded, one, K)
            assert (roots == int(one.gscal[0, 0])).all(), (label, g)
            assert comb16_contains_base.launches == before + 3
            with pytest.raises(ValueError):
                comb16_contains_base(streams, vend, one, -1)
            assert comb16_contains_base.launches == before + 3


@pytest.mark.parametrize("shape", EDGE_SHAPES_ONE)
def test_b17_matches_plain_at_edge_shapes(cuda, shape):
    """B17 as ``comb_states`` launches it, with the plan's overlap (each
    segment writing its own rows) and without, equals the plain version in
    every ``[T, S]`` entry; on single bytes with overlap 0, and on a stream
    block of zero bytes (padding)."""
    T, S = shape
    for name, needles in (("n200", COMB32_SETS["n200"]), ("nested", COMB32_SETS["nested"]),
                          ("nul", COMB32_SETS["nul"]), ("singles", SINGLES)):
        m = _machine(needles)
        eng = CombAcEngine(m, device=cuda, n_streams=1024)
        K = m.max_needle_bytes - 1
        assert K > 0 or name == "singles"
        streams, _, _ = _edge_streams(needles, T, S, K, T * S + 3, cuda)
        tabs = eng.full_tables.args()
        want = comb_states_plain(streams, *tabs)
        assert int((want >> 27).sum()) > 0 or S == 1, name
        before = comb_states.launches
        assert torch.equal(comb_states(streams, *tabs, K), want), name
        assert torch.equal(comb_states(streams, *tabs), want), name
        zero = torch.zeros_like(streams)
        assert torch.equal(comb_states(zero, *tabs, K), comb_states_plain(zero, *tabs)), name
        assert comb_states.launches == before + 3
        with pytest.raises(ValueError):
            comb_states(streams, *tabs, -1)
        with pytest.raises(ValueError):
            comb_states(streams.cpu(), *tabs, K)
        assert comb_states.launches == before + 3


# -- B1 and B2's segmented designs at the edge shapes ---------------------------------


def _bitap_edge_engines(cuda):
    """(label, needles, BitapAcEngine) of B2's edge tests: 1, 2, 3 and 8
    words, single bytes (overlap 0), and the composed IgnoreCase layouts with
    an embedded trap and with a trap register beside one and two words."""
    from alfred_margaret_tpu_torch.models import case_dfa
    from alfred_margaret_tpu_torch.ops.bitap_scan import plan_bitap_ci

    if "bitap" not in _BUILT:
        out = []
        for label, needles, words in (("V = 1", NEEDLES3, 1), ("V = 2", TWO_WORDS, 2),
                                      ("V = 3", V3, 3), ("V = 8", V8, 8),
                                      ("singles", SINGLES, 1)):
            m = _machine(needles)
            lay = plan_bitap(m, max_words=words)
            assert lay.n_words == words, label
            out.append((label, needles, BitapAcEngine(m, layout=lay, device=cuda,
                                                      n_streams=1024)))
        for label, needles, VT in (("embedded trap", EMBEDDED_KSS, 1),
                                   ("trap register", REGISTER, 2),
                                   ("trap register, 2 words", REGISTER_V3, 3)):
            m = _machine(needles)
            cm = case_dfa.compose_build(list(zip(m.needles, m.values)), machine=m)
            eng = BitapAcEngine(cm, layout=plan_bitap_ci(cm, max_words=2), device=cuda,
                                n_streams=1024)
            assert eng.bitap.has_trap and len(eng.bitap.all_words()) == VT, label
            out.append((label, needles, eng))
        _BUILT["bitap"] = out
    return _BUILT["bitap"]


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("shape", EDGE_SHAPES_ONE)
def test_b2_matches_plain_at_edge_shapes(cuda, shape):
    """B2 as ``bitap_count`` launches it, with the plan's overlap (segments
    by the rule) and without (one segment), equals the plain version: counts
    and, on the trap layouts, the trap plane, with trap encodings written
    across the segment cuts; zero bytes (padding) count nothing and trap
    nothing.  Each launch adds one to the wrapper's counts."""
    from alfred_margaret_tpu_torch.kernels import bitap_count_plain
    from alfred_margaret_tpu_torch.kernels.bitap_count import bitap_count_design

    T, S = shape
    for label, needles, eng in _bitap_edge_engines(cuda):
        K = eng.overlap
        assert K >= eng.bitap_tables.max_track_bytes - 1
        streams, warm, _ = _edge_streams(needles, T, S, K, T + 7 * S, cuda)
        t = eng.bitap_tables
        trap = t.trapmask is not None
        if trap:
            k = bitap_count_design(streams, t.btab, t.field_bit, K).segments
            a = streams.cpu().numpy().copy()
            plant_traps(a, k, K)
            streams = torch.from_numpy(a).to(cuda)
        args = (streams, t.btab, t.seed, t.endmask, t.field_start, t.field_bit, t.field_weight,
                warm, t.trapmask)
        want = _outs(bitap_count_plain(*args))
        if trap and S > 1 and T > 20:
            assert want[1].any(), label
        before = (bitap_count.launches, bitap_count.launches_trap)
        for over in (K, None):
            got = _outs(bitap_count(*args, overlap=over))
            assert len(got) == 1 + trap and all(map(torch.equal, got, want)), (label, over)
        zero = _outs(bitap_count(torch.zeros_like(streams), *args[1:], overlap=K))
        assert not any(x.any() for x in zero), label
        after = (before[0] + 3, before[1] + 3 * trap)
        assert (bitap_count.launches, bitap_count.launches_trap) == after
        with pytest.raises(ValueError):
            bitap_count(*args, overlap=-1)
        with pytest.raises(ValueError):
            bitap_count(streams.cpu(), *args[1:], overlap=K)
        assert (bitap_count.launches, bitap_count.launches_trap) == after


@pytest.mark.parametrize("shape", EDGE_SHAPES_ONE)
def test_b1_matches_plain_at_edge_shapes(cuda, shape):
    """B1 as ``dense_count`` launches it, with the plan's overlap (segments
    by the rule) and without, equals the plain version: packing 1 and 2, a
    NUL-bearing machine that is not zero-inert, single bytes (overlap 0);
    every stream padded counts nothing.  Each launch adds one to the
    wrapper's count."""
    from alfred_margaret_tpu_torch.kernels import dense_count_plain
    from alfred_margaret_tpu_torch.ops.pallas_scan import _zero_inert

    T, S = shape
    for label, needles in (("packing 1", NEEDLES3), ("packing 2", PACK30), ("NUL", NUL),
                           ("singles", SINGLES)):
        m = _machine(needles)
        eng = DenseAcEngine(m, device=cuda, n_streams=1024)
        assert (eng.comp.packing == 2) == (label == "packing 2")
        assert _zero_inert(m) == (label != "NUL")
        K = m.max_needle_bytes - 1
        streams, warm, vend = _edge_streams(needles, T, S, K, 3 * T + S, cuda)
        t = eng.tables
        args = (streams, t.classmap, t.table, warm, vend, t.packing, t.state_bits)
        want = dense_count_plain(*args)
        if S > 1 and T > 20:
            assert int(want.sum()) > 0, label
        before = dense_count.launches
        assert torch.equal(dense_count(*args, overlap=K), want), label
        assert torch.equal(dense_count(*args), want), label
        padded = (*args[:4], torch.zeros_like(vend), *args[5:])
        assert not dense_count(*padded, overlap=K).any(), label
        assert dense_count.launches == before + 3
        with pytest.raises(ValueError):
            dense_count(*args, overlap=-1)
        with pytest.raises(ValueError):
            dense_count(streams.cpu(), *args[1:], overlap=K)
        assert dense_count.launches == before + 3


# -- B4 (with its trap part, and the mesh's S3) and B8 on the segmented pipeline -------

#: Segment counts the launches are forced to, beside the rule's.
FORCED_KS = (1, 2, 3, 7, 16, 64)


@pytest.mark.parametrize("shape", EDGE_SHAPES_ONE)
def test_b4_matches_plain_at_edge_shapes(cuda, shape, monkeypatch):
    """B4 as ``bitap_contains`` launches it, with the plan's overlap (the
    rule's segments, then k = 1 to 64 forced) and without (one segment),
    equals the plain version: hits and, on the trap layouts, the trap plane,
    with trap encodings written across the segment cuts; zero bytes
    (padding) hit nothing and trap nothing.  Each launch adds one to the
    wrapper's counts."""
    from alfred_margaret_tpu_torch.kernels.segments import Design

    sticky_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.bitap_contains")
    T, S = shape
    rule = sticky_mod.bitap_contains_design
    for label, needles, eng in _bitap_edge_engines(cuda):
        t = eng.bitap_tables
        if t.btab.shape[0] > sticky_mod.MAX_WORDS:
            continue  # eight words: B2 only
        K = eng.overlap
        streams, _, _ = _edge_streams(needles, T, S, K, 5 * T + S, cuda)
        trap = t.trapmask is not None
        k = rule(streams, t.btab, K).segments
        if trap:
            a = streams.cpu().numpy().copy()
            plant_traps(a, k, K)
            streams = torch.from_numpy(a).to(cuda)
        args = (streams, t.btab, t.seed, t.endmask, t.trapmask)
        want = _outs(bitap_contains_plain(*args))
        if trap and S > 1 and T > 20:
            assert want[1].any(), label
        before = (bitap_contains.launches, bitap_contains.launches_trap)
        n = 0
        for over, forced in [(K, None), (None, None)] + [(K, f) for f in FORCED_KS]:
            if forced is not None:
                monkeypatch.setattr(sticky_mod, "bitap_contains_design",
                                    lambda *a, f=forced: Design(f))
            got = _outs(bitap_contains(*args, overlap=over))
            monkeypatch.setattr(sticky_mod, "bitap_contains_design", rule)
            assert len(got) == 1 + trap and all(map(torch.equal, got, want)), (label, over, forced)
            n += 1
        zero = _outs(bitap_contains(torch.zeros_like(streams), *args[1:], overlap=K))
        assert not any(x.any() for x in zero), label
        after = (before[0] + n + 1, before[1] + (n + 1) * trap)
        assert (bitap_contains.launches, bitap_contains.launches_trap) == after
        with pytest.raises(ValueError):
            bitap_contains(*args, overlap=-1)
        with pytest.raises(ValueError):
            bitap_contains(streams.cpu(), *args[1:], overlap=K)
        assert (bitap_contains.launches, bitap_contains.launches_trap) == after


@pytest.mark.parametrize("shape", EDGE_SHAPES_ONE)
def test_b7_matches_plain_at_edge_shapes(cuda, shape, monkeypatch):
    """B7 as ``bitap_presence`` launches it, with the plan's overlap (the
    rule's segments, then k = 1 to 64 forced) and without (one segment),
    equals the plain version plane for plane, trap bits included, with trap
    encodings written across the segment cuts; zero bytes (padding) flag
    nothing.  Each launch adds one to the wrapper's counts."""
    from alfred_margaret_tpu_torch.kernels.segments import Design

    sticky_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.bitap_contains")
    T, S = shape
    rule = sticky_mod.bitap_presence_design
    for label, needles, eng in _bitap_edge_engines(cuda):
        t = eng.bitap_tables
        if t.btab.shape[0] > sticky_mod.MAX_WORDS:
            continue  # eight words: B2 only
        K = eng.overlap
        streams, _, _ = _edge_streams(needles, T, S, K, 7 * T + S, cuda)
        trap = t.trapmask is not None
        k = rule(streams, t.btab, K).segments
        if trap:
            a = streams.cpu().numpy().copy()
            plant_traps(a, k, K)
            streams = torch.from_numpy(a).to(cuda)
        args = (streams, t.btab, t.seed, t.endmask, t.trapmask)
        want = bitap_presence_plain(*args)
        assert want.shape == (t.btab.shape[0], S), label
        if S > 1 and T > 20:
            assert want.any(), label
        before = (bitap_presence.launches, bitap_presence.launches_trap)
        n = 0
        for over, forced in [(K, None), (None, None)] + [(K, f) for f in FORCED_KS]:
            if forced is not None:
                monkeypatch.setattr(sticky_mod, "bitap_presence_design",
                                    lambda *a, f=forced: Design(f))
            got = bitap_presence(*args, overlap=over)
            monkeypatch.setattr(sticky_mod, "bitap_presence_design", rule)
            assert torch.equal(got, want), (label, over, forced)
            n += 1
        assert not bitap_presence(torch.zeros_like(streams), *args[1:], overlap=K).any(), label
        after = (before[0] + n + 1, before[1] + (n + 1) * trap)
        assert (bitap_presence.launches, bitap_presence.launches_trap) == after
        with pytest.raises(ValueError):
            bitap_presence(*args, overlap=-1)
        with pytest.raises(ValueError):
            bitap_presence(streams.cpu(), *args[1:], overlap=K)
        assert (bitap_presence.launches, bitap_presence.launches_trap) == after


@pytest.mark.parametrize("shape", EDGE_SHAPES_ONE)
def test_b8_matches_plain_at_edge_shapes(cuda, shape, monkeypatch):
    """B8 as ``comb16_count`` launches it, with the plan's overlap (the
    rule's segments, then k = 1 to 64 forced) and without, equals the plain
    version: config 2, the nested set (four count ranges), a NUL-bearing set,
    single bytes (overlap 0) and a composed IgnoreCase machine; every stream
    padded counts nothing."""
    from alfred_margaret_tpu_torch.kernels.comb16 import comb16_count_plain
    from alfred_margaret_tpu_torch.kernels.segments import Design
    from alfred_margaret_tpu_torch.models import case_dfa

    comb16_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.comb16")
    T, S = shape
    rule = comb16_mod.comb16_count_design
    ci = _random_needles(47, 40) + ["straße", "kelvin"]
    cm = _machine(ci)
    cases = [(name, COMB16_SETS[name], _machine(COMB16_SETS[name]))
             for name in ("config2", "nested", "nul")]
    cases += [("singles", SINGLES, _machine(SINGLES)),
              ("ignorecase", ci, case_dfa.compose_build(list(zip(cm.needles, cm.values)),
                                                        machine=cm))]
    for label, needles, m in cases:
        eng = Comb16AcEngine(m, device=cuda, n_streams=1024)
        K = m.max_needle_bytes - 1
        streams, warm, vend = _edge_streams(needles, T, S, K, 9 * T + S, cuda)
        args = (streams, warm, vend, *eng.tables.args())
        want = comb16_count_plain(*args)
        if S > 1 and T > 20:
            assert int(want.sum()) > 0, label
        before = comb16_count.launches
        n = 0
        for over, forced in [(K, None), (None, None)] + [(K, f) for f in FORCED_KS]:
            if forced is not None:
                monkeypatch.setattr(comb16_mod, "comb16_count_design",
                                    lambda *a, f=forced: Design(f))
            got = comb16_count(*args, overlap=over)
            monkeypatch.setattr(comb16_mod, "comb16_count_design", rule)
            assert torch.equal(got, want), (label, over, forced)
            n += 1
        padded = (*args[:2], torch.zeros_like(vend), *args[3:])
        assert not comb16_count(*padded, overlap=K).any(), label
        assert comb16_count.launches == before + n + 1
        with pytest.raises(ValueError):
            comb16_count(*args, overlap=-1)
        with pytest.raises(ValueError):
            comb16_count(streams.cpu(), *args[1:], overlap=K)
        assert comb16_count.launches == before + n + 1


def test_s3_on_one_card(cuda):
    """The mesh's S3 on a (4,2,1) mesh of cuda:0: each shard's sticky bitap
    launch, with the plan's overlap, equals its plain version, CaseSensitive
    and on the composed IgnoreCase machine's trap layout; the answers equal
    the host C++ engine's."""
    from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, Searcher
    from alfred_margaret_tpu_torch.parallel import make_mesh

    mesh = make_mesh([cuda] * 8, data=4, seq=2)
    hit = np.frombuffer(synth_corpus(NEEDLES3, 1 << 20, hit_fraction=0.001, seed=13), np.uint8)
    miss = np.frombuffer(b"shirt short tshir " * 60000, np.uint8)
    ci = np.frombuffer(_ci_corpus(["kilo", "fix"], 10, ["KİLO"]), np.uint8)
    for case, needles, datas in ((CASE_SENSITIVE, NEEDLES3, (hit, miss)),
                                 (IGNORE_CASE, ["kilo", "fix"], (ci,))):
        s = Searcher.build(case, needles)
        eng = s.distributed(mesh)
        assert eng.sticky_route() == "bitap"
        for data in datas:
            st = eng.stage(data)
            assert _shard_launches_match_plain(eng, st, "sticky") == {"bitap_contains"}
            assert eng.contains_any(st) == s.contains_any(s.stage(data))


# -- B3 (with the mesh's S6) and B12 on the segmented pipeline -------------------------

#: B3's and B12's shapes: the edge shapes, and S below a block and not a
#: multiple of 16 with T not a multiple of most k.
EDGE_SHAPES_B3 = EDGE_SHAPES_ONE + [(37, 100)]
#: Whole-code-point needles whose composed IgnoreCase machine fits the dense
#: table.
CI_DENSE = ["straße", "ǆx", "kelvin", "tshirt", "ab"]


@pytest.mark.parametrize("shape", EDGE_SHAPES_B3)
def test_b3_matches_plain_at_edge_shapes(cuda, shape, monkeypatch):
    """B3 as ``dense_contains`` launches it, with the plan's overlap (the
    rule's segments, then k = 1 to 64 forced) and without (one segment),
    equals the plain version entry for entry, over the whole stream range
    and ranges whose start is not a multiple of 16 or whose end falls inside
    a block: packing 1 and 2, a NUL-bearing machine, single bytes (overlap
    0) and a composed IgnoreCase machine with İ, Kelvin K and ẞ written
    across the cuts; every stream padded keeps the root entry.  Each launch
    adds one to the wrapper's count."""
    from alfred_margaret_tpu_torch.kernels.segments import Design
    from alfred_margaret_tpu_torch.models import case_dfa

    dense_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.dense_contains")
    T, S = shape
    rule = dense_mod.dense_contains_design
    cm = _machine(CI_DENSE)
    cases = [(label, needles, _machine(needles)) for label, needles in (
        ("packing 1", NEEDLES3), ("packing 2", PACK30), ("NUL", NUL), ("singles", SINGLES))]
    cases.append(("ignorecase", CI_DENSE,
                  case_dfa.compose_build(list(zip(cm.needles, cm.values)), machine=cm)))
    for label, needles, m in cases:
        t = DenseAcEngine(m, device=cuda, n_streams=1024).sticky_tables()
        assert t.packing == 2 or label != "packing 2"
        K = t.min_overlap
        streams, _, vend = _edge_streams(needles, T, S, K, 7 * T + S, cuda)
        if label == "ignorecase":
            a = streams.cpu().numpy().copy()
            plant_traps(a, rule(streams, t.table, K).segments, K)
            streams = torch.from_numpy(a).to(cuda)
        head = (streams, t.classmap, t.table, vend, t.packing, t.state_bits, t.absorb)
        whole = dense_contains_plain(*head)
        if S > 1 and T > 20:  # single bytes match in every live stream
            assert (whole == t.absorb).any(), label
            assert label == "singles" or ((whole != t.absorb) & (vend > 0)).any(), label
        before = dense_contains.launches
        n = 0
        for s0, s1 in sorted({(0, S), (min(3, S - 1), S), (0, max(1, S - 5)),
                              (S // 3, min(S, S // 3 + 130))}):
            want = whole[s0:s1]
            for over, forced in [(K, None), (None, None)] + [(K, f) for f in FORCED_KS]:
                if forced is not None:
                    monkeypatch.setattr(dense_mod, "dense_contains_design",
                                        lambda *a, f=forced: Design(f))
                got = dense_contains(*head, s0, s1, overlap=over)
                monkeypatch.setattr(dense_mod, "dense_contains_design", rule)
                assert torch.equal(got, want), (label, s0, s1, over, forced)
                n += 1
        padded = (*head[:3], torch.zeros_like(vend), *head[4:])
        assert not dense_contains(*padded, overlap=K).any(), label
        assert dense_contains.launches == before + n + 1
        with pytest.raises(ValueError):
            dense_contains(*head, overlap=-1)
        with pytest.raises(ValueError):
            dense_contains(streams.cpu(), *head[1:], overlap=K)
        assert dense_contains.launches == before + n + 1


@pytest.mark.parametrize("shape", EDGE_SHAPES_B3)
def test_b12_matches_plain_at_edge_shapes(cuda, shape, monkeypatch):
    """B12 as ``comb16_states`` launches it, with the plan's overlap (the
    rule's segments, then k = 1 to 64 forced) and without, equals the plain
    version in every ``[T, S]`` entry: the full tables of config 2, the
    nested set (four count ranges), a NUL-bearing set, single bytes (overlap
    0) and a composed IgnoreCase machine."""
    from alfred_margaret_tpu_torch.kernels.segments import Design
    from alfred_margaret_tpu_torch.models import case_dfa

    comb16_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.comb16")
    T, S = shape
    rule = comb16_mod.comb16_count_design
    ci = _random_needles(47, 40) + ["straße", "kelvin"]
    cm = _machine(ci)
    cases = [(name, COMB16_SETS[name], _machine(COMB16_SETS[name]))
             for name in ("config2", "nested", "nul")]
    cases += [("singles", SINGLES, _machine(SINGLES)),
              ("ignorecase", ci, case_dfa.compose_build(list(zip(cm.needles, cm.values)),
                                                        machine=cm))]
    for label, needles, m in cases:
        ft = Comb16AcEngine(m, device=cuda, n_streams=1024).full_tables
        K = m.max_needle_bytes - 1
        streams, _, _ = _edge_streams(needles, T, S, K, 11 * T + S, cuda)
        args = (streams, ft.classmap, ft.comb, ft.aux, ft.root_row, ft.segtable, ft.BB,
                ft.owner_mask, ft.CB, ft.root_cb)
        want = comb16_states_plain(*args)
        before = comb16_states.launches
        n = 0
        for over, forced in [(K, None), (None, None)] + [(K, f) for f in FORCED_KS]:
            if forced is not None:
                monkeypatch.setattr(comb16_mod, "comb16_count_design",
                                    lambda *a, f=forced: Design(f))
            got = comb16_states(*args, overlap=over)
            monkeypatch.setattr(comb16_mod, "comb16_count_design", rule)
            assert torch.equal(got, want), (label, over, forced)
            n += 1
        assert comb16_states.launches == before + n
        with pytest.raises(ValueError):
            comb16_states(*args, overlap=-1)
        with pytest.raises(ValueError):
            comb16_states(streams.cpu(), *args[1:], overlap=K)
        assert comb16_states.launches == before + n


def test_s6_on_one_card(cuda):
    """The mesh's S6 on a (4,2,1) mesh of cuda:0: each shard's dense sticky
    launch, with the plan's overlap, equals its plain version on a hit and a
    miss corpus; the answers equal the single-device ``Searcher``'s."""
    from alfred_margaret_tpu_torch import CASE_SENSITIVE, Searcher
    from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, make_mesh

    mesh = make_mesh([cuda] * 8, data=4, seq=2)
    hit = np.frombuffer(synth_corpus(NEEDLES3, 1 << 20, hit_fraction=0.001, seed=13), np.uint8)
    miss = np.frombuffer(b"shirt short tshir " * 60000, np.uint8)
    s = Searcher.build(CASE_SENSITIVE, NEEDLES3)
    eng = DistributedAcEngine(s.automaton, mesh)
    eng._bitap_lay = None  # the mesh's dense steps
    assert eng.sticky_route() == "dense"
    for data in (hit, miss):
        st = eng.stage(data)
        assert _shard_launches_match_plain(eng, st, "sticky") == {"dense_contains"}
        i, g, dev = eng.shards()[0]
        assert eng.shard_call("sticky", st, i, g, dev)[2] == {"overlap": st.plan.overlap}
        assert eng.contains_any(st) == s.contains_any(s.stage(data))


# -- B14 and B10 on the segmented pipeline ------------------------------------------------


def _filter_cases(device):
    """(label, needles, machine, B14 tables) on 0, 1, 3 and 12 candidate
    words: short needles only, one word beside two shorts, config 2's
    screen and config 5's 1,000 needles in twelve words."""
    from alfred_margaret_tpu_torch.ops.filter_scan import FilterTables, plan_filter

    out = []
    for label, needles, words in (("V = 0", ["ab", "c", "xyz", "qq"], 3),
                                  ("V = 1", ["ab", "xyz", "qrstuvw"], 3),
                                  ("V = 3", CONFIG2, 3), ("V = 12", _config5(1000), 12)):
        m = _machine(needles)
        lay = plan_filter(m, max_words=words)
        assert lay.n_words == int(label[4:]), label
        out.append((label, needles, m, FilterTables.from_layout(lay, device)))
    return out


@pytest.mark.parametrize("shape", EDGE_SHAPES_ONE)
def test_b14_matches_plain_at_edge_shapes(cuda, shape, monkeypatch):
    """B14 as ``filter_contains`` launches it, with the layout's restart and
    the plan's overlap (the rule's segments, then k = 1 to 64 forced) and
    without (one segment), equals the
    plain version plane for plane: 0, 1, 3 and 12 words, ragged S, odd vends
    (the last pair reads a byte past vend), vend 0, every stream padded.
    Each launch adds one to the wrapper's count; a restart the plan's
    overlap cannot hold and a negative overlap raise without a launch."""
    from alfred_margaret_tpu_torch.kernels.segments import Design

    fmod = importlib.import_module("alfred_margaret_tpu_torch.kernels.filter_contains")
    T, S = shape
    rule = fmod.filter_contains_design
    for label, needles, m, tabs in _filter_cases(cuda):
        K = m.max_needle_bytes - 1
        streams, _, vend = _edge_streams(needles, T, S, K, 7 * T + S, cuda)
        if S > 2:
            vend[:2] = torch.tensor([1, 0], dtype=torch.int32)  # an odd vend and 0
        args = (streams, vend, *tabs.args())
        want = filter_contains_plain(*args)
        if S > 1 and T > 20 and label != "V = 0":
            assert want.any(), label
        before = filter_contains.launches
        n = 0
        for over, forced in [(K, None), (None, None)] + [(K, f) for f in FORCED_KS]:
            if forced is not None:
                monkeypatch.setattr(fmod, "filter_contains_design",
                                    lambda *a, f=forced: Design(f))
            got = filter_contains(*args, over)
            monkeypatch.setattr(fmod, "filter_contains_design", rule)
            assert torch.equal(got, want), (label, over, forced)
            n += 1
        padded = (streams, torch.zeros_like(vend), *tabs.args())
        assert not filter_contains(*padded, K).any(), label
        assert filter_contains.launches == before + n + 1
        for bad in ((*args[:-1], tabs.restart + 1, K),  # odd
                    (*args[:-1], 0, K),
                    (*args[:-1], (K + 2) // 2 * 2 + 2, K),  # more than the plan warms
                    (*args, -1)):
            with pytest.raises(ValueError):
                filter_contains(*bad)
        with pytest.raises(ValueError):
            filter_contains(streams.cpu(), *args[1:], K)
        assert filter_contains.launches == before + n + 1


@pytest.mark.parametrize("shape", EDGE_SHAPES_ONE)
def test_b10_matches_plain_at_edge_shapes(cuda, shape, monkeypatch):
    """B10 as ``comb16_contains`` launches it, with the plan's overlap (the
    rule's segments, then k = 1 to 64 forced) and without (one segment),
    equals the plain version base for base: config 2, the nested set, a
    NUL-bearing set, single bytes (overlap 0) and a composed IgnoreCase
    machine; ragged S, odd vends, vend 0, every stream padded (the root
    base).  Each launch adds one to the wrapper's count; a negative overlap
    and a bad absorbing base raise without a launch."""
    from alfred_margaret_tpu_torch.kernels.segments import Design
    from alfred_margaret_tpu_torch.models import case_dfa

    comb16_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.comb16")
    T, S = shape
    rule = comb16_mod.comb16_count_design
    ci = _random_needles(47, 40) + ["straße", "kelvin"]
    cm = _machine(ci)
    cases = [(name, COMB16_SETS[name], _machine(COMB16_SETS[name]))
             for name in ("config2", "nested", "nul")]
    cases += [("singles", SINGLES, _machine(SINGLES)),
              ("ignorecase", ci, case_dfa.compose_build(list(zip(cm.needles, cm.values)),
                                                        machine=cm))]
    absorbed = 0
    for label, needles, m in cases:
        eng = Comb16AcEngine(m, device=cuda, n_streams=1024)
        t = eng.sticky_tables()
        K = m.max_needle_bytes - 1
        streams, _, vend = _edge_streams(needles, T, S, K, 11 * T + S, cuda)
        if S > 2:
            vend[:2] = torch.tensor([1, 0], dtype=torch.int32)
        args = (streams, vend, *t.sticky_args())
        want = comb16_contains_plain(*args)
        absorbed += int((want == t.absorb).sum())
        before = comb16_contains.launches
        n = 0
        for over, forced in [(K, None), (None, None)] + [(K, f) for f in FORCED_KS]:
            if forced is not None:
                monkeypatch.setattr(comb16_mod, "comb16_count_design",
                                    lambda *a, f=forced: Design(f))
            got = comb16_contains(*args, over)
            monkeypatch.setattr(comb16_mod, "comb16_count_design", rule)
            assert torch.equal(got, want), (label, over, forced)
            n += 1
        padded = (streams, torch.zeros_like(vend), *t.sticky_args())
        assert bool((comb16_contains(*padded, K) == t.root_cb).all()), label
        assert comb16_contains.launches == before + n + 1
        with pytest.raises(ValueError):
            comb16_contains(*args, -1)
        with pytest.raises(ValueError):
            comb16_contains(*args[:-1], 1 << t.BB, K)
        with pytest.raises(ValueError):
            comb16_contains(streams.cpu(), *args[1:], K)
        assert comb16_contains.launches == before + n + 1
    if S > 1 and T > 20:
        assert absorbed > 0


# -- B5 (with the mesh's S7) and B16 on the segmented pipeline ----------------------------


@pytest.mark.parametrize("shape", EDGE_SHAPES_B3)
def test_b5_matches_plain_at_edge_shapes(cuda, shape, monkeypatch):
    """B5 as ``dense_states`` launches it, with the plan's overlap (the
    rule's segments, then k = 1 to 64 forced) and without (one segment),
    equals the plain version in every ``[T, S]`` entry: packing 1 and 2, a
    NUL-bearing machine that is not zero-inert, single bytes (overlap 0) and
    a composed IgnoreCase machine with İ, Kelvin K and ẞ written across the
    cuts; ragged S, T not a multiple of the tile, every stream padded (zero
    bytes).  Each launch adds one to the wrapper's count; a negative overlap
    raises without a launch."""
    from alfred_margaret_tpu_torch.kernels.segments import Design
    from alfred_margaret_tpu_torch.models import case_dfa
    from alfred_margaret_tpu_torch.ops.pallas_scan import _zero_inert

    dense_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.dense_count")
    T, S = shape
    rule = dense_mod.dense_states_design
    cm = _machine(CI_DENSE)
    cases = [(label, needles, _machine(needles)) for label, needles in (
        ("packing 1", NEEDLES3), ("packing 2", PACK30), ("NUL", NUL), ("singles", SINGLES))]
    cases.append(("ignorecase", CI_DENSE,
                  case_dfa.compose_build(list(zip(cm.needles, cm.values)), machine=cm)))
    for label, needles, m in cases:
        t = DenseAcEngine(m, device=cuda, n_streams=1024).tables
        if label != "ignorecase":
            assert (t.packing == 2) == (label == "packing 2")
            assert _zero_inert(m) == (label != "NUL")
        K = t.min_overlap
        assert K == m.max_needle_bytes - 1
        streams, _, _ = _edge_streams(needles, T, S, K, 13 * T + S, cuda)
        if label == "ignorecase":
            a = streams.cpu().numpy().copy()
            plant_traps(a, rule(streams, t.table, K).segments, K)
            streams = torch.from_numpy(a).to(cuda)
        args = (streams, t.classmap, t.table, t.packing, t.state_bits)
        want = dense_states_plain(*args)
        before = dense_states.launches
        n = 0
        for over, forced in [(K, None), (None, None)] + [(K, f) for f in FORCED_KS]:
            if forced is not None:
                monkeypatch.setattr(dense_mod, "dense_states_design",
                                    lambda *a, f=forced: Design(f))
            got = dense_states(*args, overlap=over)
            monkeypatch.setattr(dense_mod, "dense_states_design", rule)
            assert torch.equal(got, want), (label, over, forced)
            n += 1
        zero = torch.zeros_like(streams)
        assert torch.equal(dense_states(zero, *args[1:], overlap=K),
                           dense_states_plain(zero, *args[1:])), label
        assert dense_states.launches == before + n + 1
        with pytest.raises(ValueError):
            dense_states(*args, overlap=-1)
        with pytest.raises(ValueError):
            dense_states(streams.cpu(), *args[1:], overlap=K)
        assert dense_states.launches == before + n + 1


def test_s7_on_one_card(cuda):
    """The mesh's S7 on a (2,1,4) mesh of cuda:0: each shard's dense states
    launch, with the plan's overlap, equals its plain version; the
    extraction without the host corpus (the states route) equals the
    single-device ``Searcher``'s."""
    import dataclasses

    from alfred_margaret_tpu_torch import CASE_SENSITIVE, Searcher
    from alfred_margaret_tpu_torch.parallel import make_mesh

    s = Searcher.build(CASE_SENSITIVE, CONFIG2)
    eng = s.distributed(make_mesh([cuda] * 8, data=2, seq=1, needle=4))
    data = np.frombuffer(synth_corpus(CONFIG2, 1 << 20, hit_fraction=0.01, seed=17), np.uint8)
    st = eng.stage(data)
    assert _shard_launches_match_plain(eng, st, "states") == {"dense_states"}
    i, g, dev = eng.shards()[0]
    assert eng.shard_call("states", st, i, g, dev)[2] == {"overlap": st.plan.overlap}
    ends, vids = eng.matches_arrays(dataclasses.replace(st, data_np=None))
    want_ends, want_vids = s.all_matches_arrays(s.stage(data))
    assert len(ends) > 0 and np.array_equal(ends, want_ends) and np.array_equal(vids, want_vids)


@pytest.mark.parametrize("shape", EDGE_SHAPES_B3)
def test_b16_matches_plain_at_edge_shapes(cuda, shape, monkeypatch):
    """B16 as ``comb_contains`` launches it, with the plan's overlap (the
    rule's segments, then k = 1 to 64 forced) and without (one segment),
    equals the plain version base for base: config 5's 300 needles, the
    nested set, a NUL-bearing set, single bytes (overlap 0) and a composed
    IgnoreCase machine the dispatcher sends to comb32, with İ, Kelvin K and
    ẞ written across the cuts; ragged S, T not a multiple of the tile, vend
    T and 0, every stream padded (the root base).  Each launch adds one to
    the wrapper's count; a negative overlap and a root base equal to the
    absorbing one raise without a launch."""
    from alfred_margaret_tpu_torch.kernels.segments import Design
    from alfred_margaret_tpu_torch.models import case_dfa

    comb_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.comb")
    T, S = shape
    rule = comb_mod.comb_count_design
    ci = _random_needles(47, 120) + ["straße", "kelvin"]
    cm = _machine(ci)
    cases = [(name, COMB32_SETS[name], _machine(COMB32_SETS[name]))
             for name in ("config5_300", "nested", "nul")]
    cases += [("singles", SINGLES, _machine(SINGLES)),
              ("ignorecase", ci, case_dfa.compose_build(list(zip(cm.needles, cm.values)),
                                                        machine=cm))]
    absorbed = 0
    for label, needles, m in cases:
        t = CombAcEngine(m, device=cuda, n_streams=1024).sticky_tables()
        K = t.min_overlap
        assert K == m.max_needle_bytes - 1
        streams, _, vend = _edge_streams(needles, T, S, K, 17 * T + S, cuda)
        if S > 2:
            vend[:2] = torch.tensor([T, 0], dtype=torch.int32)
        if label == "ignorecase":
            a = streams.cpu().numpy().copy()
            plant_traps(a, rule(streams, t.comb, t.def_table, K).segments, K)
            streams = torch.from_numpy(a).to(cuda)
        args = (streams, vend, *t.sticky_args())
        want = comb_contains_plain(*args)
        absorbed += int((want == t.absorb).sum())
        before = comb_contains.launches
        n = 0
        for over, forced in [(K, None), (None, None)] + [(K, f) for f in FORCED_KS]:
            if forced is not None:
                monkeypatch.setattr(comb_mod, "comb_count_design", lambda *a, f=forced: Design(f))
            got = comb_contains(*args, over)
            monkeypatch.setattr(comb_mod, "comb_count_design", rule)
            assert torch.equal(got, want), (label, over, forced)
            n += 1
        padded = (streams, torch.zeros_like(vend), *t.sticky_args())
        assert bool((comb_contains(*padded, K) == t.root_base).all()), label
        assert comb_contains.launches == before + n + 1
        with pytest.raises(ValueError):
            comb_contains(*args, -1)
        with pytest.raises(ValueError):
            comb_contains(*args[:-1], t.root_base, K)
        with pytest.raises(ValueError):
            comb_contains(streams.cpu(), *args[1:], K)
        assert comb_contains.launches == before + n + 1
    if S > 1 and T > 20:
        assert absorbed > 0


# -- the Replacer, the Splitter and adopt_staged on the card --------------------------

REPLACER_PATHS = {
    # config 4's pairs: no replacement can create a match, the batched splice
    "batched": [("tshirt", "TEE"), ("shirts", "SHIRT"), ("shorts", "S"), ("ee", "f")],
    # replacements that create lower-priority matches: the incremental loop
    "incremental": [("tshirt", "shirts"), ("shirts", "shorts"), ("shorts", "x")],
}


@pytest.mark.parametrize("path", ["batched", "incremental", "full_rescan"])
def test_replacer_paths_on_a_staged_handle(cuda, path, monkeypatch):
    from alfred_margaret_tpu_torch import CASE_SENSITIVE, Replacer
    from alfred_margaret_tpu_torch import replacer as trep

    if path == "full_rescan":
        monkeypatch.setattr(trep, "INCREMENTAL", False)
    pairs = REPLACER_PATHS["batched" if path == "batched" else "incremental"]
    hay = synth_corpus(NEEDLES3, 1 << 20, hit_fraction=0.01, seed=9)
    r = Replacer.build(CASE_SENSITIVE, pairs, device=cuda)
    st = r.searcher.stage(hay)
    assert st.device.streams.device.type == "cuda"
    matchbits.launches = 0
    got = r.run(st)
    assert matchbits.launches >= 1  # the first pass's extraction on the card
    want = hay
    for n, s in pairs:
        want = want.replace(n.encode(), s.encode())
    assert got == want == Replacer.build(CASE_SENSITIVE, pairs, engine="cpp", device=cuda).run(hay)
    assert r.run(hay) == want


def test_splitter_on_the_card(cuda):
    from alfred_margaret_tpu_torch import Splitter

    hay = synth_corpus(NEEDLES3, 1 << 20, hit_fraction=0.01, seed=3)
    sp = Splitter.build(b"shorts", device=cuda)
    parts = sp.split(hay)
    assert parts == hay.split(b"shorts") and len(parts) > 100
    upper = hay.upper()
    got = sp.split_ignore_case(upper)
    assert got == Splitter.build(b"shorts", engine="cpp", device=cuda).split_ignore_case(upper)
    assert len(got) == len(parts)


def test_adopt_staged_reuses_and_restages_on_the_card(cuda):
    from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, Searcher

    hay = synth_corpus(NEEDLES3 + ["dress", "kilo"], 1 << 20, hit_fraction=0.02, seed=4)
    st0 = Searcher.build(CASE_SENSITIVE, NEEDLES3, device=cuda).stage(hay)
    short = Searcher.build_needle_id_searcher(CASE_SENSITIVE, ["dress", "kilo", "shirt"],
                                              device=cuda)
    st1 = short.adopt_staged(st0)
    assert st1.device is st0.device  # overlap 5 covers needles of up to 6 bytes
    longer = Searcher.build_needle_id_searcher(IGNORE_CASE, NEEDLES3, device=cuda)
    st2 = longer.adopt_staged(st0)
    assert st2.composed and st2.device is not st0.device  # the composed machine needs 10
    for s, st in ((short, st1), (longer, st2)):
        cpp = Searcher.build_needle_id_searcher(s.case_sensitivity, [n for n, _ in s.needles],
                                                engine="cpp", device=cuda)
        assert s.count_matches(st) == cpp.count_matches(hay) > 0
        assert s.contains_any(st) and s.contains_all(st) == cpp.contains_all(hay)


def test_boyer_moore_ac_route_on_the_card(cuda):
    """Existence over a haystack above ``AC_ROUTE_THRESHOLD`` takes the AC
    route on the searcher's device, and answers as the host C++ engine."""
    from alfred_margaret_tpu_torch import boyer_moore as bm
    from alfred_margaret_tpu_torch import boyer_moore_ci as bmci

    hay = synth_corpus(NEEDLES3, 1 << 20, hit_fraction=0.02, seed=6)
    for mod, text, absent in ((bm, hay, "SHORTS"), (bmci, hay.upper(), "tshirt9")):
        for needles in (NEEDLES3, NEEDLES3 + [absent]):
            s = mod.Searcher.build(needles, device=cuda)
            cpp = mod.Searcher.build(needles, engine="cpp", device="cpu")
            assert s.contains_any(text) is cpp.contains_any(text) is True
            assert s.contains_all(text) is cpp.contains_all(text) is (needles == NEEDLES3)
            assert s._ac_searcher().device.type == "cuda"


# -- streaming past the budget on the card ------------------------------------------


@pytest.fixture
def budget_1mb(monkeypatch):
    """Chunks of 1 MiB: haystacks past 2 MiB stream."""
    from alfred_margaret_tpu_torch.utils import config

    monkeypatch.setattr(config, "DEFAULT", dataclasses.replace(config.DEFAULT, stream_chunk_mb=1))


def _staged_chunks(monkeypatch, eng):
    """Record the length and device of every chunk ``eng`` stages."""
    seen = []
    stage = type(eng).stage

    def spy(x):
        st = stage(eng, x)
        seen.append((len(x), st.streams.device.type))
        return st

    monkeypatch.setattr(eng, "stage", spy)
    return seen


@pytest.mark.parametrize("case", ["cs", "ci"])
def test_streamed_operations_on_the_card(cuda, budget_1mb, monkeypatch, case):
    """count, contains_any (a hit and a miss) and all_matches_arrays over a
    haystack past the budget: every chunk is staged on the card and scanned
    by its kernels (B2, B4, B6; the composed IgnoreCase machine's trap parts
    with İ across the cuts), the answers equal the host C++ engine's over the
    whole haystack, and ``stage`` keeps such a haystack on the host."""
    from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, MatchEngine, Searcher

    n = (5 << 19) + 12345  # three chunks, the last ragged
    hay = bytearray(synth_corpus(NEEDLES3, n, hit_fraction=0.01, seed=17))
    if case == "ci":
        monkeypatch.setattr(MatchEngine, "AUTO_COMPOSE_BYTES", 0)
        hay = bytearray(bytes(hay).upper())
        for cut in (1 << 20, 2 << 20):
            w = "TSHİRT".encode()
            hay[cut - 3 : cut - 3 + len(w)] = w
    hay = bytes(hay)
    mode = IGNORE_CASE if case == "ci" else CASE_SENSITIVE
    s = Searcher.build(mode, NEEDLES3, device=cuda)
    miss = Searcher.build(mode, ["tshirt9", "shorts9"], device=cuda)
    eng = s._engine._composed(mode) if case == "ci" else s._engine
    miss_eng = miss._engine._composed(mode) if case == "ci" else miss._engine
    host = CppAcEngine(eng.machine)
    seen = _staged_chunks(monkeypatch, eng.device_engine())
    seen_miss = _staged_chunks(monkeypatch, miss_eng.device_engine())
    for w in (bitap_count, bitap_contains, matchbits):
        w.launches = 0
    assert s.count_matches(hay) == host.count(hay) > 0
    assert s.contains_any(hay) is True
    assert miss.contains_any(hay) is (CppAcEngine(miss_eng.machine).first_hit(hay) >= 0) is False
    for g, w in zip(s.all_matches_arrays(hay), host.matches_arrays(hay)):
        np.testing.assert_array_equal(g, w)
    assert bitap_count.launches == 3 and bitap_contains.launches == 1 + 3
    assert matchbits.launches == 3
    assert len(seen) == 3 + 1 + 3 and len(seen_miss) == 3
    assert all(dev == "cuda" and k <= (1 << 20) + 16 for k, dev in seen + seen_miss)
    staged = s.stage(hay)
    assert staged.device is None
    assert s.count_matches(staged) == host.count(hay)


@pytest.mark.parametrize("engine,kernel", [("auto", bitap_count), ("pallas", dense_count)])
def test_count_matches_protocol_on_the_card(cuda, tmp_path, monkeypatch, capsys, engine, kernel):
    """``count-matches`` on the card over two bench-format files: ``auto``
    takes the bitap engine (B2), ``pallas`` the dense engine (B1); every
    round's count equals the host C++ engine's, and the stderr total is
    their sum."""
    from alfred_margaret_tpu_torch import cli
    from alfred_margaret_tpu_torch.bench.dataformat import write_bench_file

    files, want = [], 0
    for i, size in enumerate((1 << 20, (1 << 18) + 7)):
        hay = synth_corpus(NEEDLES3, size, hit_fraction=0.01, seed=40 + i).decode()
        files.append(str(tmp_path / f"{i}.txt"))
        write_bench_file(files[-1], NEEDLES3, hay)
        want += CppAcEngine(_machine(NEEDLES3)).count(hay.encode())
    monkeypatch.setenv("AMT_ENGINE", engine)
    monkeypatch.setenv("AMT_ROUNDS", "2")
    kernel.launches = 0
    assert cli.main(["count-matches", *files]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 2 and all(len(line.split("\t")) == 3 and line.endswith("\t")
                                   for line in lines)
    assert int(err.strip().splitlines()[-1]) == want > 0
    assert kernel.launches >= 4  # two rounds over two files


def _launch_counters():
    """Every kernel wrapper that counts its launches, once each (the
    modules by name: the package exports wrappers under some modules'
    names)."""
    mods = [importlib.import_module(f"alfred_margaret_tpu_torch.kernels.{name}")
            for name in ("bitap_contains", "bitap_count", "comb", "comb16", "comb16_grouped",
                         "dense_contains", "dense_count", "filter_contains", "matchbits")]
    return [f for m in mods for f in vars(m).values()
            if callable(f) and getattr(f, "__module__", None) == m.__name__
            and hasattr(f, "launches")]


@pytest.mark.parametrize("needles", [NEEDLES3, PACK30, CONFIG2], ids=["bitap", "dense", "comb16"])
def test_one_launch_span_a_kernel_launch(cuda, tmp_path, needles):
    """Under the profiler every kernel launch opens one ``amt.launch`` span
    (``kernels/common.py:launch``): a staged count, ``contains_any``,
    ``contains_all`` and ``all_matches_arrays`` on the card."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from alfred_margaret_tpu_torch import CASE_SENSITIVE, Searcher

    s = Searcher.build(CASE_SENSITIVE, needles, device=cuda)
    st = s.stage(synth_corpus(needles, 1 << 22, hit_fraction=0.01, seed=23))
    counters = _launch_counters()
    before = sum(f.launches for f in counters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s.count_matches(st)
        s.contains_any(st)
        s.contains_all(st)
        s.all_matches_arrays(st)
        torch.cuda.synchronize()
    launched = sum(f.launches for f in counters) - before
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "amt.launch"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert len(spans) == launched >= 4
    assert len(kernels) >= launched
