"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``; every test skips unless ``torch.cuda.is_available()``.  Run
on a host with an NVIDIA Hopper card from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which this file does
not use.)

The checks of ``chip_smoke.py``'s kernel phase at pytest size: the outputs
of each kernel equal its plain version's on the same device tensors (exact:
per-stream counts, sticky entries, hit registers, presence planes, hit
bitmaps), the answers equal ``ac.count_matches`` and ``ac.all_matches``, the
wrappers raise on bad inputs, and each launch adds one to the wrapper's
count.
"""

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.bench.dataformat import synth_corpus
from alfred_margaret_tpu.models import ac

from alfred_margaret_tpu_torch.kernels import (
    bitap_contains,
    bitap_contains_plain,
    bitap_count,
    bitap_presence,
    bitap_presence_plain,
    dense_contains,
    dense_contains_plain,
    dense_count,
    matchbits,
    matchbits_plain,
)
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine
from alfred_margaret_tpu_torch.ops.xla_scan import StreamPlan, build_streams, stage_streams_device

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
