"""The staging ring of ``ops/xla_scan.py``: the text crosses to the device in
slices through a fixed two-half host buffer a device (pinned on CUDA).

On the CPU (the ring unpinned) with the slice cut to a few KiB: every size
around the slice's edges and every kind of source gives ``build_streams``'s
streams byte for byte, the source is only read, the ring is one buffer of a
fixed size whatever the text's, and two threads staging at once keep to
their own bytes.  A slice copied on the intra-op threads (``Tensor.copy_``
from ``PARALLEL_COPY_BYTES``) and one copied by ``np.copyto`` give the same
streams, for every kind of source and a threshold cut to 1,000 bytes, and
slices past ATen's grain split across four threads; a read-only source is
viewed without a copy or a warning.  On the card (``gpu``-marked, skipped
inside the fixture without CUDA; run with ``python -m pytest --noconftest
-m gpu tests/test_torch_staging.py``): the ring is pinned and reused, documents
staged back to back each keep their bytes, and a streamed count over many
slices equals the host C++ engine's.  Imports nothing of JAX.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.ops import xla_scan
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine
from alfred_margaret_tpu_torch.ops.streaming import StreamingScanner
from alfred_margaret_tpu_torch.ops.xla_scan import StreamPlan, build_streams, stage_streams_device
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
SLICE = 4096
NEEDLES3 = ["tshirt", "shirts", "shorts"]

#: Text sizes around the slice's edges; the last has a tail of 3 bytes, below
#: the overlap of every plan below.
SIZES = [0, 1, SLICE - 1, SLICE, SLICE + 1, 7 * SLICE + 1234, 3 * SLICE + 3]


@pytest.fixture
def small_ring(monkeypatch):
    """Slices of ``SLICE`` bytes, on rings made afresh for the test."""
    monkeypatch.setattr(xla_scan, "RING_SLICE_BYTES", SLICE)
    monkeypatch.setattr(xla_scan, "_RINGS", {})


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    # Plenty of NULs and repeats, so any misplaced byte shows.
    return rng.integers(0, 8, size=n).astype(np.uint8)


def _plan(n, S, K, t_tile=32):
    """The kernel engines' plan (``DenseAcEngine._plan``)."""
    L = max(1, -(-n // S))
    return StreamPlan(n, S, L, K, -(-(L + K) // t_tile) * t_tile)


def _sources(data, tmp_path):
    """``data`` as each kind of source a staging reads."""
    path = tmp_path / "doc.bin"
    data.tofile(path)
    raw = data.tobytes()
    return {
        "bytes": raw,
        "frombuffer": np.frombuffer(raw, dtype=np.uint8),
        "memoryview": memoryview(raw),
        "memmap": np.memmap(path, dtype=np.uint8, mode="r", shape=(len(data),))
        if len(data) else np.frombuffer(b"", dtype=np.uint8),
    }


def _check(data, plan, device, src=None):
    streams, warm, vend = stage_streams_device(data if src is None else src, plan, device)
    want, wwarm, wvend = build_streams(data, plan)
    assert streams.dtype == torch.uint8 and streams.is_contiguous()
    np.testing.assert_array_equal(streams.cpu().numpy(), want)
    np.testing.assert_array_equal(warm, wwarm)
    np.testing.assert_array_equal(vend, wvend)


# -- on the CPU ---------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("S,K", [(8, 5), (64, 7), (1, 0), (3, 9)])
def test_staging_equals_build_streams_at_the_slice_edges(small_ring, n, S, K):
    _check(_data(n, seed=n + S), _plan(n, S, K), CPU)


@pytest.mark.parametrize("kind", ["bytes", "frombuffer", "memoryview", "memmap"])
@pytest.mark.parametrize("n", [0, SLICE + 1, 5 * SLICE + 77])
def test_each_source_is_staged_and_left_unchanged(small_ring, tmp_path, kind, n):
    data = _data(n, seed=3)
    src = _sources(data, tmp_path)[kind]
    _check(data, _plan(n, 16, 5), CPU, src)
    np.testing.assert_array_equal(np.frombuffer(bytes(src), dtype=np.uint8), data)
    assert (tmp_path / "doc.bin").read_bytes() == data.tobytes()


def test_read_only_and_writable_arrays_are_only_read(small_ring):
    data = _data(3 * SLICE + 11, seed=4)
    keep = data.copy()
    ro = data.copy()
    ro.flags.writeable = False
    for src in (data, ro):
        _check(keep, _plan(len(keep), 32, 5), CPU, src)
        np.testing.assert_array_equal(src, keep)


def test_one_ring_of_fixed_size_a_device(small_ring):
    for n in (10, 9 * SLICE + 5, SLICE, 100 * SLICE):
        _check(_data(n, seed=n), _plan(n, 64, 5), CPU)
    (ring,) = xla_scan._RINGS.values()
    assert ring.buf.numel() == 2 * SLICE and not ring.buf.is_pinned()
    ptr = ring.buf.data_ptr()
    _check(_data(3 * SLICE, seed=9), _plan(3 * SLICE, 8, 5), CPU)
    assert list(xla_scan._RINGS.values()) == [ring] and ring.buf.data_ptr() == ptr


def test_strided_and_wider_sources_are_staged_as_bytes(small_ring):
    """A strided uint8 view is read as it is; another dtype or a 2-D array
    is converted to contiguous bytes first, as ``build_streams`` sees it."""
    base = _data(6 * SLICE + 10, seed=11)
    strided = base[::3]
    want = np.ascontiguousarray(strided)
    _check(want, _plan(len(want), 16, 5), CPU, strided)
    np.testing.assert_array_equal(base, _data(6 * SLICE + 10, seed=11))
    wide = want.astype(np.int32)
    _check(want, _plan(len(want), 16, 5), CPU, wide)
    grid = want[: 2 * (len(want) // 2)].reshape(2, -1)
    _check(grid.reshape(-1), _plan(grid.size, 8, 3), CPU, grid)


#: The parallel copy's threshold in these tests: a few slices' worth of
#: lengths fall below it, at it and past it.
SPLIT = 1000
SPLIT_SIZES = [SPLIT - 1, SPLIT, SPLIT + 1, 3 * SLICE + SPLIT - 1, 2 * SLICE + SPLIT + 5,
               5 * SLICE + 77]


@pytest.fixture
def four_torch_threads():
    """Four intra-op threads, so that the parallel copy splits its slices."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _split_slices(fn):
    """``fn()``'s result and its number of ``amt.stage.host.split`` spans."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = fn()
    return got, sum(e.count for e in prof.key_averages() if e.key == "amt.stage.host.split")


def _split_source(kind, data, tmp_path):
    """``data`` as a source of ``kind``, and whether torch can view it."""
    if kind == "strided":
        base = np.zeros(3 * len(data), dtype=np.uint8)
        base[::3] = data
        return base[::3], True
    if kind == "reversed":
        return data[::-1].copy()[::-1], False
    if kind == "ndarray":
        return data.copy(), True
    return _sources(data, tmp_path)[kind], True


@pytest.mark.parametrize("n", SPLIT_SIZES)
@pytest.mark.parametrize("kind", ["ndarray", "bytes", "memoryview", "strided", "reversed"])
@pytest.mark.parametrize("path", ["parallel", "serial"])
def test_parallel_and_serial_copies_stage_the_same_bytes(small_ring, four_torch_threads,
                                                         monkeypatch, tmp_path, path, kind, n):
    """Each slice of ``PARALLEL_COPY_BYTES`` or more goes through
    ``Tensor.copy_`` on the intra-op threads, a shorter one (and every slice
    of a negative-stride source) through ``np.copyto``; both give
    ``build_streams``'s streams byte for byte."""
    monkeypatch.setattr(xla_scan, "PARALLEL_COPY_BYTES", SPLIT if path == "parallel" else 1 << 62)
    data = _data(n, seed=n + 7)
    src, viewable = _split_source(kind, data, tmp_path)
    _, split = _split_slices(lambda: _check(data, _plan(n, 16, 5), CPU, src))
    slices = [min(SLICE, n - off) for off in range(0, n, SLICE)]
    want = sum(m >= SPLIT for m in slices) if path == "parallel" and viewable else 0
    assert split == want
    np.testing.assert_array_equal(np.frombuffer(bytes(src), dtype=np.uint8)
                                  if kind in ("bytes", "memoryview") else src, data)


@pytest.mark.parametrize("kind", ["ndarray", "bytes", "strided"])
def test_slices_past_the_grain_split_across_threads(four_torch_threads, monkeypatch, tmp_path,
                                                    kind):
    """Slices of 256 KiB, past ATen's grain of 32 KiB, so that ``copy_``
    hands each to several threads; the tail of 100 KiB too."""
    monkeypatch.setattr(xla_scan, "RING_SLICE_BYTES", 256 << 10)
    monkeypatch.setattr(xla_scan, "PARALLEL_COPY_BYTES", 64 << 10)
    monkeypatch.setattr(xla_scan, "_RINGS", {})
    n = 3 * (256 << 10) + (100 << 10) + 3
    data = _data(n, seed=13)
    src, _ = _split_source(kind, data, tmp_path)
    _, split = _split_slices(lambda: _check(data, _plan(n, 64, 5), CPU, src))
    assert split == 4


def test_read_only_source_is_viewed_without_a_copy_or_a_warning(small_ring, four_torch_threads,
                                                                monkeypatch, tmp_path):
    monkeypatch.setattr(xla_scan, "PARALLEL_COPY_BYTES", SPLIT)
    data = _data(4 * SLICE + 3, seed=12)
    srcs = _sources(data, tmp_path)
    for kind in ("bytes", "memoryview", "memmap"):
        ro = np.frombuffer(srcs[kind], dtype=np.uint8) if kind != "memmap" else srcs[kind]
        assert not ro.flags.writeable
        view = xla_scan._host_view(ro)
        assert view.data_ptr() == ro.ctypes.data and view.numel() == len(data)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _, split = _split_slices(lambda: _check(data, _plan(len(data), 16, 5), CPU, ro))
        assert split == 4
    assert xla_scan._host_view(data[::-1]) is None


def test_two_threads_keep_to_their_own_bytes(small_ring):
    """The ring's lock: two stagings at once never share a half."""
    docs = [_data(40 * SLICE + 17 * i, seed=20 + i) for i in range(2)]
    errors = []

    def stage(doc):
        try:
            for _ in range(5):
                _check(doc, _plan(len(doc), 16, 5), CPU)
        except AssertionError as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=stage, args=(d,)) for d in docs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


@pytest.mark.parametrize("cls", [BitapAcEngine, DenseAcEngine])
def test_engine_count_over_many_slices(small_ring, cls):
    m = ac.build([(n, i) for i, n in enumerate(NEEDLES3)])
    data = np.frombuffer(synth_corpus(NEEDLES3, 20 * SLICE + 99, hit_fraction=0.03, seed=5),
                         np.uint8)
    eng = cls(m, device=CPU, n_streams=64)
    st = eng.stage(data)
    np.testing.assert_array_equal(st.streams.numpy(), build_streams(data, st.plan)[0])
    assert eng.count_staged(st) == ac.count_matches(m, data.tobytes()) > 0


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _host_count(m, data):
    from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine

    return CppAcEngine(m).count(data)


@pytest.mark.gpu
def test_ring_is_pinned_and_reused_on_the_card(cuda):
    for n in (1 << 20, 3 * xla_scan.RING_SLICE_BYTES + 12345, 100):
        _check(_data(n, seed=n % 97), _plan(n, 32768, 5), cuda)
        ring = xla_scan._RINGS[cuda]
        assert ring.buf.is_pinned()
        assert ring.buf.numel() == 2 * xla_scan.RING_SLICE_BYTES
        if n == 1 << 20:
            ptr = ring.buf.data_ptr()
        assert ring.buf.data_ptr() == ptr


@pytest.mark.gpu
@pytest.mark.parametrize("slice_bytes", [64 << 10, None])
def test_back_to_back_documents_keep_their_bytes_on_the_card(cuda, monkeypatch, slice_bytes):
    """Two documents staged one after the other, then both scanned: the
    second one's host copies wait for the first one's copies in flight."""
    if slice_bytes is not None:
        monkeypatch.setattr(xla_scan, "RING_SLICE_BYTES", slice_bytes)
        monkeypatch.setattr(xla_scan, "_RINGS", {})
    m = ac.build([(n, i) for i, n in enumerate(NEEDLES3)])
    eng = BitapAcEngine(m, device=cuda)
    docs = [np.frombuffer(synth_corpus(NEEDLES3, (40 << 20) + 4321 * i, hit_fraction=0.01,
                                       seed=30 + i), np.uint8) for i in range(2)]
    staged = [eng.stage(d) for d in docs]
    for d, st in zip(docs, staged):
        np.testing.assert_array_equal(st.streams.cpu().numpy(), build_streams(d, st.plan)[0])
        want = _host_count(m, d)
        assert eng.count_staged(st) == want > 0
        assert int(eng.stream_counts_plain(st)[torch.from_numpy(st.live_np).to(cuda)].sum()) == want


@pytest.mark.gpu
def test_streamed_count_over_many_slices_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(xla_scan, "RING_SLICE_BYTES", 1 << 20)
    monkeypatch.setattr(xla_scan, "_RINGS", {})
    m = ac.build([(n, i) for i, n in enumerate(NEEDLES3)])
    data = np.frombuffer(synth_corpus(NEEDLES3, (50 << 20) + 777, hit_fraction=0.01, seed=40),
                         np.uint8)
    sc = StreamingScanner(BitapAcEngine(m, device=cuda), m, chunk_bytes=16 << 20)
    assert sc.count(data) == _host_count(m, data) > 0
    assert xla_scan._RINGS[cuda].buf.is_pinned()
