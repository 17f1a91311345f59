"""Kernel B6 (hit bitmap) and match extraction of the PyTorch port against
the JAX package.

The same numpy corpus goes through the JAX engines in interpret mode and
through the port's engines on the CPU, where the wrapper runs the kernel's
plain torch version.  Tolerance: exact integer and bit equality.

* The kernel: counts per live stream, and the whole ``[T / 32, S]`` bitmap,
  rebuilt on the JAX side from ``_get_bits_fn``'s compacted ``(word index,
  word)`` pairs (all of them: ``n <= cap``, touched blocks ``<= bcap``).
* Extraction: positions and states equal ``match_positions_staged_bits``,
  and ``matches_arrays_staged`` equals the JAX engine's and ``ac.all_matches``.
"""

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.bench.dataformat import synth_corpus
from alfred_margaret_tpu.models import ac
from alfred_margaret_tpu.ops.bitap_scan import BitapAcEngine as JaxBitapAcEngine
from alfred_margaret_tpu.ops.pallas_scan import PallasAcEngine

from alfred_margaret_tpu_torch.kernels import dense_states, matchbits
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine, _zero_inert
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
NEEDLES3 = ["tshirt", "shirts", "shorts"]
# Small machines: the JAX bitmap kernel's compile in interpret mode grows
# with the packed table's rows.
PACK2 = ["abc", "bcd", "cde", "dea", "eab", "ace", "bda", "ceb", "dac", "ebd"]  # 1 row, packing 2
TWO_WORDS = ["aaaaaaaaaaaaaaab", "bbbbbbbbbbbbbbba"]  # 32 track bits: two bitap words
_RNG3 = np.random.default_rng(3)
ABCDEF = bytes(_RNG3.choice(list(b"abcdef"), size=6000).astype(np.uint8))


def _machine(needles):
    return ac.build([(n, i) for i, n in enumerate(needles)])


def _p2(v):
    """Capacity rounding of ``match_positions_staged_bits``."""
    v = int(v) + 1
    if v <= (1 << 16):
        return 1 << int(np.ceil(np.log2(v)))
    return -(-v // (1 << 16)) * (1 << 16)


def jax_bits(jeng, st):
    """(counts [S], bitmap [T / 32, S]) of the JAX bitmap kernel, from the
    compiled function ``match_positions_staged_bits`` used first."""
    T, S = st.plan.time_len, jeng.S
    nwords = T // 32 * S
    cap = min(1 << 14, _p2(nwords))
    bcap = min(1 << 12, _p2(nwords // 512))
    assert cap >= nwords
    fn = jeng._get_bits_fn(T, cap, bcap)
    counts, wwn = fn(
        jeng._bscal_for(st), *jeng._bits_tables()[0], st.warm_t, st.vend_t, st.streams_dev
    )
    wwn = np.asarray(wwn)
    n, nb = int(wwn[0, -1]), int(wwn[1, -1])
    assert n <= cap and nb <= bcap
    bits = np.zeros(nwords, dtype=np.int32)
    bits[wwn[0, :n]] = wwn[1, :n]
    return np.asarray(counts).reshape(-1), bits.reshape(T // 32, S)


CASES = [
    # name, engine kind, needles, haystack, engine arguments
    ("dense_packing1", "dense", NEEDLES3, b"short tshirts and shorts galore " * 40, {}),
    ("dense_packing2", "dense", PACK2, ABCDEF, {}),
    ("nul_not_zero_inert", "dense", [b"\x00\x00", b"x", b"a\x00"], b"x\x00\x00xa\x00" * 30, {}),
    ("bitap_one_word", "bitap", NEEDLES3,
     synth_corpus(NEEDLES3, 1 << 15, hit_fraction=0.05, seed=1), {}),
    ("bitap_duplicates", "bitap", ["x", "x", "yy", "x"], b"xyxyyxx" * 200, {}),
    ("bitap_two_words", "bitap", TWO_WORDS, b"ab" * 3000 + TWO_WORDS[0].encode() * 20, {}),
]


@pytest.mark.parametrize("name,kind,needles,hay,kw", CASES, ids=[c[0] for c in CASES])
def test_match_bits_and_positions_match_jax(name, kind, needles, hay, kw):
    kw = {"n_streams": 256, "t_tile": 32, **kw}
    m = _machine(needles)
    data = np.frombuffer(hay, dtype=np.uint8)
    jcls, cls = (PallasAcEngine, DenseAcEngine) if kind == "dense" else (JaxBitapAcEngine, BitapAcEngine)
    jeng = jcls(m, interpret=True, **kw)
    st = jeng.stage(data)
    jeng._bits_cap_hint, jeng._bits_bcap_hint = 1 << 14, 1 << 12
    want_pos, want_states = jeng.match_positions_staged_bits(st)
    want_counts, want_bits = jax_bits(jeng, st)

    eng = cls(m, device=CPU, **kw)
    pst = eng.stage(data)
    live = pst.live_np
    args = eng.bits_args(pst)
    assert args[3] == ("bitap" if kind == "bitap" and eng.bitap.n_words == 1 else "dense")
    counts, bits = matchbits(*args)
    assert counts.dtype == bits.dtype == torch.int32
    assert bits.shape == (pst.plan.time_len // 32, kw["n_streams"])
    np.testing.assert_array_equal(counts.numpy()[live], want_counts[live])
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    assert int(counts.numpy()[live].astype(np.int64).sum()) == ac.count_matches(m, hay)

    pos, states = eng.match_positions_staged(pst)
    assert pos.dtype == states.dtype == np.int64
    np.testing.assert_array_equal(pos, want_pos)
    np.testing.assert_array_equal(states, want_states)

    ends, vids = eng.matches_arrays_staged(pst)
    jends, jvids = jeng.matches_arrays_staged(st)
    np.testing.assert_array_equal(ends, jends)
    np.testing.assert_array_equal(vids, jvids)
    assert ends.dtype == np.int64 and vids.dtype == np.int32
    oracle = ac.all_matches(m, hay)
    assert [(int(e), int(v)) for e, v in zip(ends, vids)] == [(x.pos, x.value) for x in oracle]
    if name == "nul_not_zero_inert":
        assert not _zero_inert(m)
        # Pad hits are in the bitmap and nowhere else.
        assert int(np.unpackbits(bits.numpy().view(np.uint8)).sum()) > len(set(ends.tolist()))
    if name == "dense_packing2":
        assert eng.comp.packing == 2
    if name == "bitap_two_words":
        assert eng.bitap.n_words == 2


def test_matches_arrays_empty_and_miss():
    eng = DenseAcEngine(_machine([b"zzz"]), device=CPU, n_streams=128, t_tile=32)
    for hay in (b"", b"abcabc" * 100):
        ends, vids = eng.matches_arrays(hay)
        assert len(ends) == len(vids) == 0
        assert ends.dtype == np.int64 and vids.dtype == np.int32


def test_extraction_without_bitmap_needs_b5(monkeypatch):
    # Without the host corpus, or with t_tile % 32 != 0, extraction goes
    # through the packed states (B5) and gives the bitmap route's answer.
    m = _machine(NEEDLES3)
    hay = np.frombuffer(b"a tshirt " * 50, np.uint8)
    want = ac.all_matches(m, hay)
    calls = []
    monkeypatch.setattr(DenseAcEngine, "packed_states",
                        lambda self, st: calls.append(1) or dense_states(*self.states_args(st)))
    odd = DenseAcEngine(m, device=CPU, n_streams=128, t_tile=24)
    ends, vids = odd.matches_arrays_staged(odd.stage(hay))
    assert [(int(e), int(v)) for e, v in zip(ends, vids)] == [(x.pos, x.value) for x in want]
    assert len(calls) == 1
    eng = BitapAcEngine(m, device=CPU, n_streams=128, t_tile=32)
    st = eng.stage(hay)
    bits_route = eng.match_positions_staged(st)
    assert len(calls) == 1
    st.data_np = None
    for got, w in zip(eng.match_positions_staged(st), bits_route):
        np.testing.assert_array_equal(got, w)
    assert len(calls) == 2


def test_matchbits_input_checks():
    eng = DenseAcEngine(_machine(["ab"]), device=CPU, n_streams=8, t_tile=32)
    st = eng.stage(b"xxab" * 8)
    args = list(eng.bits_args(st))
    bad = [
        (0, st.streams[:16].contiguous()),  # T not a multiple of 32
        (0, st.streams.int()),  # dtype
        (1, st.warm[:4]),  # warm shape
        (3, "comb"),  # step family
        (6, 3),  # packing
    ]
    for i, v in bad:
        a = list(args)
        a[i] = v
        with pytest.raises(ValueError):
            matchbits(*a)
    beng = BitapAcEngine(_machine(TWO_WORDS), device=CPU, n_streams=8, t_tile=32)
    assert beng.bitap.n_words == 2
    t = beng.bitap_tables
    with pytest.raises(ValueError):  # the bitap step takes one word
        matchbits(st.streams, st.warm, st.vend, "bitap", t.btab, t.seed, t.endmask,
                  t.field_start, t.field_bit, t.field_weight)
