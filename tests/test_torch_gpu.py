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

pytestmark = pytest.mark.gpu

NEEDLES3 = ["tshirt", "shirts", "shorts"]
TWO_WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf"]
PACK30 = [bytes([97 + i % 11, 98 + (i * 3) % 9, 99 + i % 7]).decode() for i in range(30)]
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
    args = eng.sticky_bitap_args(st)
    hits, planes = bitap_contains(*args), bitap_presence(*args)
    torch.cuda.synchronize()
    assert torch.equal(hits, bitap_contains_plain(*args))
    assert torch.equal(planes, bitap_presence_plain(*args))
    assert planes.shape == (eng.bitap.n_words, n_streams)
    assert eng.contains_staged(st) == (ac.count_matches(m, data.tobytes()) > 0)
    seen = {x.value for x in ac.all_matches(m, data.tobytes())}
    present = eng.needle_presence_staged(st)
    assert present.tolist() == [i in seen for i in range(len(needles))]


@pytest.mark.parametrize("kind,needles", [
    ("bitap", NEEDLES3), ("bitap", ["x", "x", "yy", "x"]), ("bitap", TWO_WORDS),
    ("dense", NEEDLES3), ("dense", PACK30), ("dense", NUL),
])
@pytest.mark.parametrize("n_streams", [1024, 1000])
def test_matchbits_matches_plain(cuda, kind, needles, n_streams):
    m = _machine(needles)
    data = np.frombuffer(synth_corpus(needles, 1 << 18, hit_fraction=0.03, seed=7), np.uint8)
    cls = BitapAcEngine if kind == "bitap" else DenseAcEngine
    eng = cls(m, device=cuda, n_streams=n_streams)
    st = eng.stage(data)
    args = eng.bits_args(st)
    counts, bits = matchbits(*args)
    torch.cuda.synchronize()
    pc, pb = matchbits_plain(*args)
    live = torch.from_numpy(st.live_np).to(cuda)
    assert torch.equal(counts[live], pc[live])
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
        (bitap_contains, bitap_contains_plain, bitap.sticky_bitap_args(st)),
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
    counts, bits = matchbits(*args)  # B13
    torch.cuda.synchronize()
    pc, pb = matchbits_plain(*args)
    assert torch.equal(counts[live], pc[live]) and torch.equal(bits, pb)
    if eng._filter_tables is not None:  # B14
        args = (st.streams, st.vend, *eng._filter_tables.args())
        planes = filter_contains(*args)
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
        (filter_contains, (st.streams, st.vend, *eng._filter_tables.args())),
    ]
    for fn, args in calls:
        before = fn.launches
        fn(*args)
        assert fn.launches == before + 1
        with pytest.raises(ValueError):
            fn(st.streams.cpu(), *args[1:])
        assert fn.launches == before + 1


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
    for fn, args in ((dense_states, d.states_args(d.stage(hay))),
                     (comb16_states, c.states_args(c.stage(hay)))):
        before = fn.launches
        fn(*args)
        assert fn.launches == before + 1
        with pytest.raises(ValueError):
            fn(args[0].cpu(), *args[1:])
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
    kargs, sargs = eng._kernel_args(st), eng.sticky_bitap_args(st)
    before = (bitap_count.launches_trap, bitap_contains.launches_trap, bitap_presence.launches_trap)
    outs = [(bitap_count(*kargs), bitap_count_plain(*kargs)),
            (bitap_contains(*sargs), bitap_contains_plain(*sargs)),
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
