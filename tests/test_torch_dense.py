"""Kernel B1 (dense DFA count) of the PyTorch port against the JAX kernel.

The same numpy corpus goes through the JAX ``PallasAcEngine`` in interpret
mode (its ``[R, 128]`` per-stream counts from ``_get_count_fn``) and through
the port's ``DenseAcEngine`` on the CPU, where the wrapper runs the kernel's
plain torch version.  Tolerance: exact integer equality, per stream on live
streams and in total; totals also equal ``ac.count_matches`` and the host
C++ engine.  The cases mirror the count cases of ``test_pallas_engine.py``.
"""

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.bench.dataformat import synth_corpus
from alfred_margaret_tpu.models import ac
from alfred_margaret_tpu.native.build import NativeUnavailable
from alfred_margaret_tpu.native.cpp_engine import CppAcEngine
from alfred_margaret_tpu.ops.pallas_scan import PallasAcEngine

from alfred_margaret_tpu_torch.kernels import dense_count
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine, _zero_inert

CPU = torch.device("cpu")


def _machine(needles):
    return ac.build([(n, i) for i, n in enumerate(needles)])


def _host_count(m, data):
    try:
        return CppAcEngine(m).count(data)
    except NativeUnavailable:
        return None


def jax_stream_counts(jeng: PallasAcEngine, data: np.ndarray):
    """Per-stream counts of the JAX dense kernel: (int32 [S], live bool [S])."""
    st = jeng.stage(data)
    fn = jeng._get_count_fn(st.plan.time_len)
    out = fn(
        jeng._bscal_for(st), jeng._classmap_dev, jeng._table_dev,
        st.warm_t, st.vend_t, st.streams_dev,
    )
    return np.asarray(out).reshape(-1), st.live_np.reshape(-1)


def check_against_jax(m, hay: bytes, n_streams=256, t_tile=32, **jkw):
    data = np.frombuffer(hay, dtype=np.uint8)
    jeng = PallasAcEngine(m, n_streams=n_streams, t_tile=t_tile, interpret=True, **jkw)
    want, live = jax_stream_counts(jeng, data)
    eng = DenseAcEngine(m, device=CPU, n_streams=n_streams, t_tile=t_tile)
    st = eng.stage(data)
    got = eng.stream_counts(st)
    assert got.dtype == torch.int32 and got.shape == (n_streams,)
    np.testing.assert_array_equal(st.live_np, live)
    np.testing.assert_array_equal(got.numpy()[live], want[live])
    exp = ac.count_matches(m, hay)
    assert eng.count_staged(st) == exp
    assert int(want[live].astype(np.int64).sum()) == exp
    host = _host_count(m, data)
    assert host is None or host == exp
    return eng, exp


_RNG7 = np.random.default_rng(7)
FUZZ = [
    ([bytes(_RNG7.choice(list(b"abAB"), size=_RNG7.integers(1, 5))) for _ in range(5)],
     bytes(_RNG7.choice(list(b"abAB"), size=2000)))
    for _ in range(3)
]
_RNG11 = np.random.default_rng(11)
RANDOM_3000 = bytes(_RNG11.integers(0, 256, size=3000, dtype=np.uint8).tolist())
PACK_NEEDLES = [bytes([97 + i % 11, 98 + (i * 3) % 9, 99 + i % 7]) for i in range(24)]

CASES = [
    ("readme", ["tshirt", "shirts", "shorts"], b"short tshirts and shorts galore " * 40,
     dict(t_tile=64, unroll=4)),
    ("fuzz0", FUZZ[0][0], FUZZ[0][1], dict(n_streams=128)),
    ("fuzz1", FUZZ[1][0], FUZZ[1][1], dict(n_streams=128)),
    ("fuzz2", FUZZ[2][0], FUZZ[2][1], dict(n_streams=128)),
    ("fold_0x7f", [b"a\x7fb", b"\x7f\x7f"],
     (b"xa\x7fb caf\xc3\xa9 \x7f\x7f\x7f \xc3\xa9z" * 50)[:997], {}),
    ("fold_non_ascii", [b"caf\xc3\xa9", b"ab"],
     (b"xa\x7fb caf\xc3\xa9 \x7f\x7f\x7f \xc3\xa9z" * 50)[:997], {}),
    ("wpairs_small", [b"ab", b"bc"], RANDOM_3000, {}),
    ("wpairs_scattered", [bytes([16 * i, 16 * i + 1]) for i in range(16)], RANDOM_3000, {}),
    ("fold_ascii", [b"ab", b"bc"], b"ab\x7fbc\x80ab\xffab" * 30, {}),
    ("packing2", PACK_NEEDLES, (b"".join(PACK_NEEDLES[:5]) + b"zzz") * 60, {}),
    ("nul_counts", [b"\x00\x00", b"x"], b"x\x00\x00x" * 7, {}),
    ("nul_padded_none", [b"ab", b"\x00"], b"qr", {}),
    ("nul_padded_one", [b"ab", b"\x00"], b"q\x00r", {}),
    ("odd_t_tile", ["tshirt", "shirts", "shorts"], b"x" * 2000 + b"tshirt" + b"y" * 95,
     dict(n_streams=128, t_tile=24, unroll=3)),
    ("bench_64k", ["tshirt", "shirts", "shorts"],
     synth_corpus(["tshirt", "shirts", "shorts"], 1 << 16, hit_fraction=0.05, seed=1), {}),
    ("binary", ["ab", "ba", "\x01\x02"],
     np.random.default_rng(7).integers(0, 256, size=20000).astype(np.uint8).tobytes(), {}),
]


@pytest.mark.parametrize("name,needles,hay,kw", CASES, ids=[c[0] for c in CASES])
def test_dense_counts_match_jax_kernel(name, needles, hay, kw):
    m = _machine(needles)
    eng, _ = check_against_jax(m, hay, **kw)
    if name == "packing2":
        assert eng.comp.packing == 2
    if name.startswith("nul"):
        assert not _zero_inert(m)


def test_empty_haystack():
    eng = DenseAcEngine(_machine([b"x"]), device=CPU, n_streams=256, t_tile=64)
    assert eng.count(b"") == 0


def test_shared_staging_nul_machine():
    # A staging made by a zero-inert machine's engine, counted by a NUL
    # machine's engine (adopt_staged): exact, like the JAX grouped passes.
    m_inert, m_nul = _machine([b"abcd"]), _machine([b"\x00y"])
    e_inert = DenseAcEngine(m_inert, device=CPU, n_streams=256, t_tile=64)
    e_nul = DenseAcEngine(m_nul, device=CPU, n_streams=256, t_tile=64)
    data = np.frombuffer(b"q\x00y abcd zz", dtype=np.uint8)
    st = e_inert.stage(data)
    assert e_nul.adopt_staged(st) is st
    assert e_nul.count_staged(st) == ac.count_matches(m_nul, data.tobytes()) == 1
    assert e_inert.count_staged(st) == 1


def test_adopt_staged_rejects_other_layouts():
    m = _machine(["tshirt"])
    st = DenseAcEngine(m, device=CPU, n_streams=256, t_tile=64).stage(b"a tshirt" * 10)
    assert DenseAcEngine(m, device=CPU, n_streams=128, t_tile=64).adopt_staged(st) is None
    assert DenseAcEngine(m, device=CPU, n_streams=256, t_tile=48).adopt_staged(st) is None
    longer = _machine(["tshirt" * 3])
    assert DenseAcEngine(longer, device=CPU, n_streams=256, t_tile=64).adopt_staged(st) is None


def test_wrapper_input_checks():
    eng = DenseAcEngine(_machine(["ab"]), device=CPU, n_streams=8, t_tile=8)
    st = eng.stage(b"abab" * 8)
    t = eng.tables
    args = [st.streams, t.classmap, t.table, st.warm, st.vend, t.packing, t.state_bits]
    assert dense_count(*args).tolist() == eng.stream_counts(st).tolist()
    bad = [
        (0, st.streams.int()),  # dtype
        (0, st.streams.T.contiguous().T),  # non-contiguous
        (1, t.classmap[:128]),  # shape
        (2, torch.zeros(48 * 128 + 1, dtype=torch.int32)),  # table over the kernel's budget
        (3, st.warm.long()),
        (5, 3),  # packing
    ]
    for i, v in bad:
        a = list(args)
        a[i] = v
        with pytest.raises(ValueError):
            dense_count(*a)

