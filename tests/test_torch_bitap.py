"""Kernel B2 (bitap count) of the PyTorch port against the JAX kernel.

The same numpy corpus goes through the JAX ``BitapAcEngine`` in interpret
mode (its ``[R, 128]`` per-stream counts from ``_get_bitap_count_fn``) and
through the port's ``BitapAcEngine`` on the CPU, where the wrapper runs the
kernel's plain torch version.  Both engines plan the same layout.
Tolerance: exact integer equality, per stream on live streams and in total;
totals also equal ``ac.count_matches`` and the host C++ engine.  The cases
mirror ``test_bitap.py``'s count cases.
"""

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.bench.dataformat import synth_corpus
from alfred_margaret_tpu.models import ac
from alfred_margaret_tpu.native.build import NativeUnavailable
from alfred_margaret_tpu.native.cpp_engine import CppAcEngine
from alfred_margaret_tpu.ops.bitap_scan import BitapAcEngine as JaxBitapAcEngine

from alfred_margaret_tpu_torch.kernels import bitap_count
from alfred_margaret_tpu_torch.ops.bitap_scan import (
    BitapAcEngine,
    BitapLayout,
    WordLayout,
    plan_bitap,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")


def _machine(needles):
    return ac.build([(n, i) for i, n in enumerate(needles)])


def jax_stream_counts(jeng: JaxBitapAcEngine, data: np.ndarray):
    """Per-stream counts of the JAX bitap kernel: (int32 [S], live bool [S])."""
    st = jeng.stage(data)
    fn = jeng._get_bitap_count_fn(st.plan.time_len)
    out = fn(jeng._bscal_for(st), jeng._btab_dev, st.warm_t, st.streams_dev)
    return np.asarray(out).reshape(-1), st.live_np.reshape(-1)


def check_against_jax(needles, hay: bytes, n_streams=256, t_tile=32):
    m = _machine(needles)
    data = np.frombuffer(hay, dtype=np.uint8)
    jeng = JaxBitapAcEngine(m, n_streams=n_streams, t_tile=t_tile, interpret=True)
    want, live = jax_stream_counts(jeng, data)
    eng = BitapAcEngine(m, device=CPU, n_streams=n_streams, t_tile=t_tile)
    assert eng.bitap.n_words == jeng.bitap.n_words
    st = eng.stage(data)
    got = eng.stream_counts(st)
    assert got.dtype == torch.int32 and got.shape == (n_streams,)
    np.testing.assert_array_equal(st.live_np, live)
    np.testing.assert_array_equal(got.numpy()[live], want[live])
    exp = ac.count_matches(m, hay)
    assert eng.count_staged(st) == exp
    assert int(want[live].astype(np.int64).sum()) == exp
    try:
        assert CppAcEngine(m).count(data) == exp
    except NativeUnavailable:
        pass
    return eng, exp


NEEDLES3 = ["tshirt", "shirts", "shorts"]
ND30 = "abcdefghijklmnopqrstuvwxyz1234"
_RNG11 = np.random.default_rng(11)
MULTIWORD = list(dict.fromkeys(
    "".join(_RNG11.choice(list("abcdef"), size=int(_RNG11.integers(3, 9)))) for _ in range(12)
))


def _fuzz_case(seed):
    rng = np.random.default_rng(seed)
    needles = list(dict.fromkeys(
        "".join(rng.choice(list("abAB12"), size=int(rng.integers(1, 8))))
        for _ in range(int(rng.integers(7, 20)))
    ))
    frags = needles + ["ab", "1", "BBA"]
    hay = "".join(frags[i] for i in rng.integers(0, len(frags), size=int(rng.integers(30, 400))))
    return needles, hay.encode()


CASES = [
    ("headline", NEEDLES3, synth_corpus(NEEDLES3, 1 << 15, hit_fraction=0.05, seed=1)),
    ("suffix_overlap", ["ab", "b", "abc", "zz"], b"zabcabzzzb" * 300),
    ("duplicates", ["x", "x", "yy", "x"], b"xyxyyxx" * 200),
    ("non_ascii", ["café", "écl"], "un café éclair café".encode() * 100),
    ("single_byte", ["a"], b"banana" * 500),
    ("max_track", [ND30], (ND30 + "pad").encode() * 40),
    ("multiword", MULTIWORD, synth_corpus(MULTIWORD, 1 << 15, hit_fraction=0.08, seed=4)),
    ("fuzz77", *_fuzz_case(77)),
    ("fuzz78", *_fuzz_case(78)),
    ("binary", ["ab", "ba", "\x01\x02"],
     np.random.default_rng(7).integers(0, 256, size=20000).astype(np.uint8).tobytes()),
    ("stream_boundaries", NEEDLES3, b"tshirtshirtsshorts" * 700),
]


@pytest.mark.parametrize("name,needles,hay", CASES, ids=[c[0] for c in CASES])
def test_bitap_counts_match_jax_kernel(name, needles, hay):
    eng, exp = check_against_jax(needles, hay)
    if name in ("headline", "multiword"):
        assert exp > 0
    if name == "multiword":
        assert 2 <= eng.bitap.n_words <= 3
    if name == "duplicates":
        assert sorted(w for _, _, w in eng.bitap.words[0].fields) == [1, 3]


def test_ineligible_machine_raises():
    with pytest.raises(ValueError):
        BitapAcEngine(_machine(["a\x00b"]), device=CPU)


def test_trap_layout_not_implemented():
    """A layout with a standalone trap register builds tables over both words
    and counts: the register (endmask 0, no fields) never counts, and a
    trap that never fires leaves the count exact."""
    m = _machine(NEEDLES3)
    lay = plan_bitap(m)
    trap = WordLayout(seed=1, endmask=2, btab=np.zeros(256, np.int64), fields=())
    eng = BitapAcEngine(m, layout=BitapLayout(words=lay.words, unroll=lay.unroll, trap=trap),
                        device=CPU, n_streams=8, t_tile=8)
    t = eng.bitap_tables
    assert t.btab.shape == (2, 256) and t.endmask.tolist() == [lay.words[0].endmask, 0]
    assert t.trapmask.tolist() == [0, 2] and t.field_start.tolist()[-2:] == [3, 3]
    hay = b"tshirts shorts " * 40
    st = eng.stage(hay)
    counts, trapped = eng.stream_counts(st)
    assert not trapped.any()
    assert eng.count_staged(st) == int(counts.sum()) == ac.count_matches(m, hay)


def test_wrapper_input_checks():
    eng = BitapAcEngine(_machine(NEEDLES3), device=CPU, n_streams=8, t_tile=8)
    st = eng.stage(b"tshirts " * 8)
    args = list(eng._kernel_args(st))
    assert bitap_count(*args).tolist() == eng.stream_counts(st).tolist()
    bad = [
        (0, st.streams.int()),  # dtype
        (0, st.streams.T.contiguous().T),  # non-contiguous
        (1, torch.zeros(9, 256, dtype=torch.int32)),  # V over the kernel's 8 words
        (2, args[2].long()),  # seed dtype
        (4, args[4][:1]),  # field_start shape
        (7, st.warm[:4]),  # warm shape
    ]
    for i, v in bad:
        a = list(args)
        a[i] = v
        with pytest.raises(ValueError):
            bitap_count(*a)
