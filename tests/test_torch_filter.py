"""The stride-2 candidate screen of the PyTorch port (kernel B14) against the
JAX package.

* Planner pins: ``_chains``, ``_entries``, ``_pack`` and ``plan_filter`` are
  numpy copies; each gives the original's layouts (seeds, end masks, pair
  tables, short-needle compares) on seeded needle sets, and ``None`` where
  the original declines.
* The kernel: B14's two planes, from its plain torch version, equal the JAX
  kernel's in interpret mode on every live stream (both freeze each stream
  at its valid end; the JAX kernel only where some stream ends inside a
  tile, which is the same for live streams), also on the JAX engine's own
  tables through ``convert.filter_tables_from_jax``.
* ``attach_filter`` and ``filter_contains``: the switches that disable the
  screen, and the strike and reset rule.

Tolerance: exact equality of every layout, plane and verdict.
"""

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.bench.dataformat import synth_corpus
from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.ops import comb16_scan as j16
from alfred_margaret_tpu.ops import filter_scan as jfilter

from alfred_margaret_tpu_torch import convert
from alfred_margaret_tpu_torch.kernels import filter_contains as filter_kernel
from alfred_margaret_tpu_torch.kernels.filter_contains import filter_contains_plain
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.ops import comb16_scan as t16
from alfred_margaret_tpu_torch.ops import filter_scan as tfilter

from test_torch_comb16 import CONFIG2, N150, NESTED, random_needles
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
N97 = [n for n in CONFIG2 if len(n) >= 4]
SHORTS_ONLY = ["ab", "c", "xyz", "qq"]

PLAN_SETS = [
    ("config2", CONFIG2),
    ("no_shorts", N97),
    ("nested", NESTED),
    ("n150", N150),
    ("shorts_only", SHORTS_ONLY),
    ("too_many_shorts", ["a", "b", "c", "d", "e", "f", "g", "h", "ij", "kl"]),
    ("nul", ["abcd", "a\x00b"]),
    ("empty_needle", ["", "abcde"]),
    ("long_needle", ["x" * 70, "abcde"]),
    ("too_many_words", random_needles(41, 400)),
    ("non_ascii", ["café", "éclair", "ü"]),
]


def _machines(needles):
    pairs = [(n, i) for i, n in enumerate(needles)]
    return jac.build(pairs), ac.build(pairs)


def _assert_layout_equal(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None
    assert got.n_words == want.n_words and got.shorts == want.shorts
    for gw, ww in zip(got.words, want.words):
        assert (gw.seed, gw.endmask) == (ww.seed, ww.endmask)
        assert gw.btab.dtype == ww.btab.dtype
        np.testing.assert_array_equal(gw.btab, ww.btab)


@pytest.mark.parametrize("max_words", [1, 3])
@pytest.mark.parametrize("name,needles", PLAN_SETS, ids=[c[0] for c in PLAN_SETS])
def test_plan_filter_matches_jax(name, needles, max_words):
    jm, tm = _machines(needles)
    want = jfilter.plan_filter(jm, max_words=max_words)
    _assert_layout_equal(tfilter.plan_filter(tm, max_words=max_words), want)
    if max_words == 3 and name in ("config2", "no_shorts", "nested", "n150", "shorts_only"):
        assert want is not None
    if name == "config2" and max_words == 3:
        assert (want.n_words, len(want.shorts)) == (3, 3)


def test_filter_helpers_match_jax():
    for nd in (b"abcd", b"abcde", b"x", b"\xc3\xa9clair"):
        assert tfilter._chains(nd) == jfilter._chains(nd)
        for chain in tfilter._chains(nd):
            for con in chain:
                assert tfilter._entries(con) == jfilter._entries(con)
    longs = sorted((n.encode() for n in N97), key=lambda n: (len(n), n))
    shorts = ((0xFFFFFF, 0x616263),)
    for k in (1, 5, 7, 14):
        for max_words in (1, 2, 3):
            _assert_layout_equal(tfilter._pack(longs, shorts, k, max_words),
                                 jfilter._pack(longs, shorts, k, max_words))
    assert (tfilter.BUCKET_K, tfilter.MAX_SHORTS, tfilter.WORD_BITS, tfilter.FILTER_STRIKES) == (
        jfilter.BUCKET_K, jfilter.MAX_SHORTS, jfilter.WORD_BITS, jfilter.FILTER_STRIKES)


# -- the kernel against the JAX kernel (interpret mode) ------------------------------

#: The corpus of ``alfred_margaret_tpu/bench/configs.py`` config 2b: digits and
#: punctuation.  Its byte pairs share the screen's hash buckets with the
#: needles' letters, so long needles' chains fire on it in both packages.
DIGITS = b"0123456789 ,;:!"


def fire_free(n: int, seed: int = 0) -> bytes:
    """``n`` random bytes over ``b"0 "``: no chain of config 2's screen fires."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(b"0 ", np.uint8), n).astype(np.uint8).tobytes()


KERNEL_CASES = [
    # name, needles, corpus
    ("config2", CONFIG2, synth_corpus(CONFIG2, 6 << 10, hit_fraction=0.02, seed=1)),
    ("no_shorts", N97, (DIGITS * 300)[:3000] + N97[7].encode() + DIGITS * 100),
    ("shorts_only_v0", SHORTS_ONLY, fire_free(3000) + b"xyz" + fire_free(2000, 1)),
    ("fire_free", CONFIG2, fire_free(5000, 2)),
]


@pytest.mark.parametrize("name,needles,hay", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def test_filter_planes_match_jax_kernel(name, needles, hay):
    jm, tm = _machines(needles)
    data = np.frombuffer(hay, dtype=np.uint8)
    jeng = j16.Comb16PallasAcEngine(jm, n_streams=128, t_tile=32, interpret=True)
    eng = t16.Comb16AcEngine(tm, device=CPU, n_streams=128, t_tile=32)
    assert jeng._filter_lay is not None and eng._filter_tables is not None
    _assert_layout_equal(eng._filter_lay, jeng._filter_lay)
    st, pst = jeng.stage(data), eng.stage(data)
    T = st.plan.time_len
    jverdict = jfilter.filter_contains(jeng, st)  # compiles the JAX kernel
    want = np.asarray(jeng._filter_fns[T](
        jfilter._strict_bscal(st), jeng._filter_btab, st.vend_t, st.streams_dev
    )).reshape(2, -1)
    live = pst.live_np
    got = filter_kernel(pst.streams, pst.vend, *eng._filter_tables.args())
    assert got.dtype == torch.int32 and got.shape == (2, 128)
    np.testing.assert_array_equal(got.numpy()[:, live], want[:, live])
    assert tfilter.filter_contains(eng, pst) == jverdict
    # The JAX engine's pair table, fed to the port's kernel.
    tabs = convert.filter_tables_from_jax(jeng, CPU)
    for f, v in eng._filter_tables.__dict__.items():
        assert (torch.equal(v, getattr(tabs, f)) if torch.is_tensor(v)
                else v == getattr(tabs, f)), f
    assert torch.equal(filter_kernel(pst.streams, pst.vend, *tabs.args()), got)
    if name == "shorts_only_v0":
        assert eng._filter_lay.n_words == 0 and jverdict is True
    if name == "no_shorts":
        assert not eng._filter_lay.shorts and jverdict is None
    if name == "fire_free":
        assert jverdict is False


def test_filter_plane_semantics():
    """The planes against a direct reading of the screen: plane 0 flags a
    short needle ending at any valid byte of the stream, including the last
    one, and never in the padding."""
    _, tm = _machines(["ab", "xyz", "qrstuvw"])
    eng = t16.Comb16AcEngine(tm, device=CPU, n_streams=8, t_tile=32)
    lay = eng._filter_lay
    assert lay.n_words == 1 and len(lay.shorts) == 2
    for hay, want in ((b"0" * 31 + b"a" + b"b", True), (b"0" * 40 + b"xy", False),
                      (b"0" * 20 + b"xyz" + b"0" * 20, True), (b"0" * 43, False)):
        st = eng.stage(np.frombuffer(hay, np.uint8))
        planes = filter_kernel(st.streams, st.vend, *eng._filter_tables.args())
        assert bool(planes[0][torch.from_numpy(st.live_np)].any()) is want, hay
    st = eng.stage(np.frombuffer(b"0000qrstuvw0000", np.uint8))
    planes = filter_kernel(st.streams, st.vend, *eng._filter_tables.args())
    assert bool(planes[1].any()) and not bool(planes[0].any())


def test_filter_wrapper_checks_inputs():
    _, tm = _machines(CONFIG2)
    eng = t16.Comb16AcEngine(tm, device=CPU, n_streams=8, t_tile=32)
    st = eng.stage(b"abc0" * 40)
    args = [st.streams, st.vend, *eng._filter_tables.args()]
    assert torch.equal(filter_kernel(*args), filter_contains_plain(*args))
    bad = [
        (0, st.streams[:31].contiguous()),  # odd T
        (0, st.streams.int()),  # dtype
        (1, st.vend[:3]),  # vend shape
        (2, torch.zeros(4, 128, dtype=torch.int32)),  # btab rows != the words' count
        (3, args[3][:1]),  # seed shape
        (3, torch.zeros(13, dtype=torch.int32)),  # V over the kernel's 12 words
        (5, torch.zeros(9, dtype=torch.int32)),  # K over the kernel's 8 shorts
    ]
    for i, v in bad:
        a = list(args)
        a[i] = v
        with pytest.raises(ValueError):
            filter_kernel(*a)


# -- attach_filter and the strike rule -------------------------------------------------


def test_attach_filter_switches(monkeypatch):
    _, tm = _machines(CONFIG2)
    assert t16.Comb16AcEngine(tm, device=CPU, n_streams=8, t_tile=32)._filter_tables is not None
    assert t16.Comb16AcEngine(tm, device=CPU, n_streams=8, t_tile=40)._filter_tables is None
    # The JAX package's AMT_FILTER=0 changes nothing here: the screen is
    # attached and answers; detaching it is the unscreened control.
    monkeypatch.setenv("AMT_FILTER", "0")
    eng = t16.Comb16AcEngine(tm, device=CPU, n_streams=8, t_tile=32)
    assert eng._filter_lay is not None and eng._filter_tables is not None
    st = eng.stage(np.frombuffer(fire_free(600), np.uint8))
    assert tfilter.filter_contains(eng, st) is False
    eng._filter_tables = None
    assert tfilter.filter_contains(eng, st) is None


def test_filter_strikes_and_reset(monkeypatch):
    _, tm = _machines(N97)
    eng = t16.Comb16AcEngine(tm, device=CPU, n_streams=64, t_tile=32)
    calls = []
    monkeypatch.setattr(tfilter, "filter_kernel",
                        lambda *a: calls.append(1) or filter_contains_plain(*a))
    fire = eng.stage(np.frombuffer(synth_corpus(N97, 1 << 12, hit_fraction=0.05, seed=2), np.uint8))
    clean = eng.stage(np.frombuffer(fire_free(3000), np.uint8))
    assert tfilter.filter_contains(eng, fire) is None and eng._filter_strikes == 1
    assert tfilter.filter_contains(eng, clean) is False and eng._filter_strikes == 0
    for k in range(1, tfilter.FILTER_STRIKES + 1):
        assert tfilter.filter_contains(eng, fire) is None and eng._filter_strikes == k
    n = len(calls)
    assert tfilter.filter_contains(eng, clean) is None  # disabled: the screen is not run
    assert len(calls) == n and eng._filter_strikes == tfilter.FILTER_STRIKES
    assert eng.contains_staged(clean) is False and eng.contains_staged(fire) is True
