"""Kernels B3 (dense sticky scan), B4 (bitap sticky scan) and B7 (bitap
presence planes) of the PyTorch port against the JAX kernels.

The same numpy corpus goes through the JAX engines in interpret mode and
through the port's engines on the CPU, where the wrappers run the kernels'
plain torch versions.  Tolerance: exact integer and bit equality.

* B3: the final sticky entries of every live stream equal the JAX kernel's
  run with the strict boundary scalars (the state held from ``vend`` on, as
  the port holds it); with the engine's own scalars the JAX kernel lets pads
  move a stream that did not hit back to the root on machines whose zero
  byte is inert, so there the hit flags per live stream are compared.  The
  JAX tables, passed through ``convert.sticky_tables_from_jax``, give the
  same entries.
* B4: the hit register of every stream.
* B7: the ``[V, S]`` planes of every stream, and the per-needle presence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfred_margaret_tpu.bench.dataformat import synth_corpus
from alfred_margaret_tpu.models import ac
from alfred_margaret_tpu.ops.bitap_scan import BitapAcEngine as JaxBitapAcEngine
from alfred_margaret_tpu.ops.pallas_scan import PallasAcEngine, _boundary_scalars

from alfred_margaret_tpu_torch import convert
from alfred_margaret_tpu_torch.kernels import bitap_contains, bitap_presence, dense_contains
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine, _zero_inert

CPU = torch.device("cpu")
NEEDLES3 = ["tshirt", "shirts", "shorts"]
PACK_NEEDLES = [bytes([97 + i % 11, 98 + (i * 3) % 9, 99 + i % 7]) for i in range(24)]
TWO_WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf"]
_RNG11 = np.random.default_rng(11)
MULTIWORD = list(dict.fromkeys(
    "".join(_RNG11.choice(list("abcdef"), size=int(_RNG11.integers(3, 9)))) for _ in range(12)
))
_RNG7 = np.random.default_rng(7)
FUZZ_NEEDLES = [bytes(_RNG7.choice(list(b"abAB"), size=_RNG7.integers(1, 5))) for _ in range(5)]
FUZZ_HAY = bytes(_RNG7.choice(list(b"abAB"), size=2000))


def _machine(needles):
    return ac.build([(n, i) for i, n in enumerate(needles)])


# -- B3: the dense sticky scan ----------------------------------------------------

DENSE_CASES = [
    ("readme", NEEDLES3, b"short tshirts and shorts galore " * 40, dict(t_tile=64)),
    ("miss", NEEDLES3, b"short shirt and sport " * 90, {}),
    ("fuzz", FUZZ_NEEDLES, FUZZ_HAY, dict(n_streams=128)),
    ("packing2", PACK_NEEDLES, (b"".join(PACK_NEEDLES[:5]) + b"zzz") * 60, {}),
    ("fold_non_ascii", [b"caf\xc3\xa9", b"ab"], (b"xa\x7fb caf\xc3\xa9 \x7f\x7f\x7f \xc3\xa9z" * 50)[:997], {}),
    ("nul_counts", [b"\x00\x00", b"x"], b"x\x00\x00x" * 7, {}),
    ("nul_padded_none", [b"ab", b"\x00"], b"qr", {}),
    ("bench_64k", NEEDLES3, synth_corpus(NEEDLES3, 1 << 16, hit_fraction=0.002, seed=1), {}),
]


@pytest.mark.parametrize("name,needles,hay,kw", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_sticky_entries_match_jax_kernel(name, needles, hay, kw):
    kw = {"n_streams": 256, "t_tile": 32, **kw}
    m = _machine(needles)
    data = np.frombuffer(hay, dtype=np.uint8)
    jeng = PallasAcEngine(m, interpret=True, **kw)
    st = jeng.stage(data)
    c = jeng._sticky_setup()
    fn = jeng._get_contains_fn(st.plan.time_len)
    vend = np.asarray(st.vend_t).reshape(-1)
    strict = jnp.asarray(_boundary_scalars(st.warm_np, vend, False))
    want = np.asarray(fn(strict, c["cm"], c["tab"], st.vend_t, st.streams_dev)).reshape(-1)
    own = np.asarray(fn(jeng._bscal_for(st), c["cm"], c["tab"], st.vend_t, st.streams_dev)).reshape(-1)

    eng = DenseAcEngine(m, device=CPU, **kw)
    pst = eng.stage(data)
    live = pst.live_np
    np.testing.assert_array_equal(live, st.live_np.reshape(-1))
    tabs = eng.sticky_tables()
    assert tabs.absorb == c["absorb_pk"]
    got = dense_contains(*eng.sticky_args(pst))
    assert got.dtype == torch.int32 and got.shape == (kw["n_streams"],)
    np.testing.assert_array_equal(got.numpy()[live], want[live])
    np.testing.assert_array_equal(got.numpy()[live] == tabs.absorb, own[live] == c["absorb_pk"])

    # The JAX engine's own tables, fed to the port's kernel.
    comp = c["comp"]
    jt = convert.sticky_tables_from_jax(
        np.asarray(c["cm"]), np.asarray(c["tab"]), comp.n_states, comp.k, comp.packing,
        c["absorb_pk"], CPU,
    )
    for f in ("packing", "state_bits", "absorb"):
        assert getattr(jt, f) == getattr(tabs, f), f
    assert torch.equal(jt.classmap, tabs.classmap) and torch.equal(jt.table, tabs.table)
    fed = dense_contains(pst.streams, jt.classmap, jt.table, pst.vend, jt.packing,
                         jt.state_bits, jt.absorb)
    assert torch.equal(fed, got)

    exp = ac.count_matches(m, hay) > 0
    assert eng.contains_staged(pst) == jeng.contains_staged(st) == exp
    assert eng.contains(hay) == exp
    if name == "packing2":
        assert tabs.packing == 2
    if name.startswith("nul"):
        assert not _zero_inert(m)
    if name == "miss":
        assert not exp


def test_contains_staged_early_segments():
    # Mirrors test_pallas_engine.py::test_contains_staged_early_segments:
    # the segmented scan answers as the one-shot scan at every K, on
    # hit-first, hit-last, hit-middle and no-hit corpora.
    m = _machine(["needleword"])
    eng = DenseAcEngine(m, device=CPU, n_streams=512, t_tile=32)
    base = b"x" * (64 << 10)
    cases = {
        "first": b"needleword" + base,
        "last": base + b"needleword",
        "none": base,
        "mid": base[: 30 << 10] + b"needleword" + base[30 << 10 :],
    }
    for name, corpus in cases.items():
        st = eng.stage(np.frombuffer(corpus, dtype=np.uint8))
        want = eng.contains_staged(st)
        assert want == (b"needleword" in corpus), name
        whole = dense_contains(*eng.sticky_args(st))
        for k in (1, 2, 3, 4):
            assert eng.contains_staged_early(st, n_segments=k) == want, (name, k)
            seg = 512 // k if 512 % k == 0 else 512 // 2
            parts = [dense_contains(*eng.sticky_args(st, s, s + seg)) for s in range(0, 512, seg)]
            assert torch.equal(torch.cat(parts), whole), (name, k)
    # Default sizing: one segment per CONTAINS_SEG_BYTES of streams.
    st = eng.stage(np.frombuffer(cases["mid"], dtype=np.uint8))
    assert eng.contains_staged_early(st) is True
    eng.CONTAINS_SEG_BYTES = st.plan.time_len * 512 // 4  # K = 4
    assert eng.contains_staged_early(st) is True
    assert eng.contains_staged_early(eng.stage(np.frombuffer(cases["none"], np.uint8))) is False


def test_dense_contains_input_checks():
    eng = DenseAcEngine(_machine(["ab"]), device=CPU, n_streams=8, t_tile=8)
    st = eng.stage(b"xxab" * 8)
    args = list(eng.sticky_args(st))
    assert dense_contains(*args).tolist() == dense_contains(*args[:7]).tolist()
    bad = [
        (0, st.streams.int()),  # dtype
        (1, args[1][:128]),  # classmap shape
        (3, st.vend[:4]),  # vend shape
        (4, 3),  # packing
        (7, 8), (8, 9),  # stream range
    ]
    for i, v in bad:
        a = list(args)
        a[i] = v
        with pytest.raises(ValueError):
            dense_contains(*a)


# -- B4 and B7: the bitap sticky scans ---------------------------------------------

BITAP_CASES = [
    ("headline", NEEDLES3, synth_corpus(NEEDLES3, 1 << 15, hit_fraction=0.01, seed=1)),
    ("suffix_overlap", ["ab", "b", "abc", "zz"], b"zabcabzzzb" * 300),
    ("duplicates", ["x", "x", "yy", "x"], b"xyxyyxx" * 200),
    ("non_ascii", ["café", "écl"], "un café éclair café".encode() * 100),
    ("two_words", TWO_WORDS, synth_corpus(TWO_WORDS, 1 << 14, hit_fraction=0.01, seed=4)),
    ("multiword", MULTIWORD, synth_corpus(MULTIWORD, 1 << 14, hit_fraction=0.02, seed=4)),
    ("miss", NEEDLES3, b"short shirt and sport " * 300),
    ("binary", ["ab", "ba", "\x01\x02"],
     np.random.default_rng(7).integers(0, 256, size=20000).astype(np.uint8).tobytes()),
]


@pytest.mark.parametrize("name,needles,hay", BITAP_CASES, ids=[c[0] for c in BITAP_CASES])
def test_bitap_sticky_planes_match_jax_kernels(name, needles, hay):
    m = _machine(needles)
    data = np.frombuffer(hay, dtype=np.uint8)
    jeng = JaxBitapAcEngine(m, n_streams=256, t_tile=32, interpret=True)
    st = jeng.stage(data)
    T = st.plan.time_len
    V = jeng.bitap.n_words
    want_hits = np.asarray(jeng._get_bitap_contains_fn(T)(jeng._btab_dev, st.streams_dev)).reshape(-1)
    want_planes = np.asarray(
        jeng._get_bitap_presence_fn(T)(jeng._btab_dev, st.streams_dev)
    ).reshape(V, -1)

    eng = BitapAcEngine(m, device=CPU, n_streams=256, t_tile=32)
    assert eng.bitap.n_words == V
    pst = eng.stage(data)
    hits = bitap_contains(*eng.sticky_bitap_args(pst))
    planes = bitap_presence(*eng.sticky_bitap_args(pst))
    assert hits.dtype == planes.dtype == torch.int32 and planes.shape == (V, 256)
    np.testing.assert_array_equal(hits.numpy(), want_hits)
    np.testing.assert_array_equal(planes.numpy(), want_planes)
    # The JAX engine's mask table, fed to the port's kernels.
    jt = convert.bitap_tables_from_jax(np.asarray(jeng._btab_dev), eng.bitap, CPU)
    assert torch.equal(bitap_presence(pst.streams, jt.btab, jt.seed, jt.endmask), planes)

    exp = ac.count_matches(m, hay) > 0
    assert eng.contains_staged(pst) == eng.contains_staged_early(pst) == jeng.contains_staged(st) == exp
    pres = eng.needle_presence_staged(pst)
    assert pres.dtype == bool
    np.testing.assert_array_equal(pres, jeng.needle_presence_staged(st))
    seen = {bytes(x.value) for x in ac.all_matches(ac.build([(n, n) for n in m.needles]), hay)}
    np.testing.assert_array_equal(pres, [bytes(n) in seen for n in m.needles])
    if name == "two_words":
        assert V == 2
    if name == "miss":
        assert not exp


def test_bitap_sticky_input_checks():
    eng = BitapAcEngine(_machine(NEEDLES3), device=CPU, n_streams=8, t_tile=8)
    st = eng.stage(b"tshirts " * 8)
    args = eng.sticky_bitap_args(st)
    bad = [
        (0, st.streams.int()),  # dtype
        (1, torch.zeros(4, 256, dtype=torch.int32)),  # V over the kernels' 3 words
        (2, args[2].long()),  # seed dtype
        (3, args[3][:0]),  # endmask shape
    ]
    for fn in (bitap_contains, bitap_presence):
        for i, v in bad:
            a = list(args)
            a[i] = v
            with pytest.raises(ValueError):
                fn(*a)
