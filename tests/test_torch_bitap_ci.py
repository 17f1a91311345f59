"""Kernels B2, B4 and B7 with their trap parts, the trap recovery, and the
composed-machine grouping fault, on the CPU.

The same composed IgnoreCase machine, byte-class layout and numpy corpus go
through the JAX ``BitapAcEngine`` in interpret mode (its ``[R, 128]``
outputs: counts and trap plane, hits and trap plane, presence planes, as
``tests/test_bitap_ci.py`` runs it: ``n_streams=256``, ``t_tile=32``) and
through the port's ``BitapAcEngine`` on the CPU, where the wrappers run the
kernels' plain torch versions on the tables ``convert.bitap_tables_from_jax``
makes of the JAX engine's.  Three layouts: trapless, trap tracks embedded in
a match word, and a standalone trap register.  Tolerance: exact equality,
stream by stream.

The recovery tests hold the port's answers against the scalar IgnoreCase
oracle (``ac.count_matches(m, data, IGNORE_CASE)``) on corpora whose traps
fire in a few streams (recounted on the host) or in many (the dense kernels
B1 and B3 on the composed machine), each route forced to be the one taken.
"""

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.models import case_dfa as jcase_dfa
from alfred_margaret_tpu.ops.bitap_scan import BitapAcEngine as JaxBitapAcEngine
from alfred_margaret_tpu.ops.bitap_scan import plan_bitap_ci as jplan_bitap_ci

from alfred_margaret_tpu_torch import IGNORE_CASE, Searcher, convert
from alfred_margaret_tpu_torch import engine as tengine
from alfred_margaret_tpu_torch.kernels import (
    bitap_contains,
    bitap_contains_plain,
    bitap_count,
    bitap_presence,
)
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops import comb_scan
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap_ci
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
KW = dict(n_streams=256, t_tile=32)


def _composed(acmod, cdmod, needles):
    m = acmod.build([(n, i) for i, n in enumerate(needles)])
    return m, cdmod.compose_build(list(zip(m.needles, m.values)), machine=m)


def _scramble(text: bytes, seed: int) -> bytes:
    """ASCII letters uppercased at random, from a seeded generator."""
    a = np.frombuffer(text, np.uint8).copy()
    up = (a >= 97) & (a <= 122) & (np.random.default_rng(seed).random(len(a)) < 0.5)
    a[up] -= 32
    return a.tobytes()


def _corpus(needles, n_words, seed, traps=()):
    rng = np.random.default_rng(seed)
    words = list(needles) + ["xyz", "shirt", "kil", "ab"]
    text = " ".join(words[i] for i in rng.integers(0, len(words), size=n_words)).encode()
    text = _scramble(text, seed)
    for pos, t in traps:  # write the trap-bearing words at fixed offsets
        text = text[:pos] + t.encode() + text[pos:]
    return text


#: (name, needles, expected layout: (n_words, embedded trap, trap register))
LAYOUTS = [
    ("trapless", ["dress", "shoe", "shorts"], (1, False, False)),
    ("embedded_trap", ["kilo", "fix"], (1, True, False)),
    ("trap_register", ["tshirt", "shirts", "shorts", "kilo", "café"], (1, False, True)),
]
TRAPS = ("KİLO", "KKILO", "FİX", "STRAẞE", "Å")


@pytest.mark.parametrize("name,needles,shape", LAYOUTS, ids=[c[0] for c in LAYOUTS])
def test_trap_kernels_match_jax_kernels(name, needles, shape):
    m, cm = _composed(ac, case_dfa, needles)
    jm, jcm = _composed(jac, jcase_dfa, needles)
    lay, jlay = plan_bitap_ci(cm, max_words=2), jplan_bitap_ci(jcm, max_words=2)
    assert (lay.n_words, any(w.trap_endmask for w in lay.words), lay.trap is not None) == shape
    data = np.frombuffer(
        _corpus(needles, 1500, 3, traps=[(900, TRAPS[0]), (4000, TRAPS[1]), (7000, TRAPS[2])]),
        np.uint8)
    jeng = JaxBitapAcEngine(jcm, layout=jlay, interpret=True, **KW)
    jst = jeng.stage(data)
    T = jst.plan.time_len
    out = jeng._get_bitap_count_fn(T)(jeng._bscal_for(jst), jeng._btab_dev, jst.warm_t,
                                      jst.streams_dev)
    hout = jeng._get_bitap_contains_fn(T)(jeng._btab_dev, jst.streams_dev)
    jpres = np.asarray(jeng._get_bitap_presence_fn(T)(jeng._btab_dev, jst.streams_dev))

    eng = BitapAcEngine(cm, layout=lay, device=CPU, **KW)
    st = eng.stage(data)
    np.testing.assert_array_equal(st.live_np, jst.live_np.reshape(-1))
    tabs = convert.bitap_tables_from_jax(np.asarray(jeng._btab_dev), lay, CPU)
    for f in ("btab", "seed", "endmask", "field_start", "field_bit", "field_weight", "trapmask"):
        a, b = getattr(tabs, f), getattr(eng.bitap_tables, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    kargs = eng._kernel_args(st)
    sargs = eng.sticky_bitap_args(st)
    got_count, got_hits, got_pres = bitap_count(*kargs), bitap_contains(*sargs), bitap_presence(*sargs)
    VT = len(lay.all_words())
    assert jpres.shape[0] == VT and tuple(got_pres.shape) == (VT, KW["n_streams"])
    np.testing.assert_array_equal(got_pres.numpy(), jpres.reshape(VT, -1))
    if not lay.has_trap:
        np.testing.assert_array_equal(got_count.numpy(), np.asarray(out).reshape(-1))
        np.testing.assert_array_equal(got_hits.numpy(), np.asarray(hout).reshape(-1))
    else:
        for g, w in zip((*got_count, *got_hits), (*out, *hout)):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(-1))
        assert got_count[1].any() and got_hits[1].any()  # the traps fired
    exp = ac.count_matches(m, data, IGNORE_CASE)
    assert exp > 0 and eng.count_staged(st) == exp == jeng.count_staged(jst)
    assert eng.contains_staged(st) and jeng.contains_staged(jst)
    want = jeng.needle_presence_staged(jst)
    got = eng.needle_presence_staged(st)
    assert (got is None) == (want is None) == lay.has_trap
    if got is not None:
        np.testing.assert_array_equal(got, want)


def _recovery_engine(needles):
    m, cm = _composed(ac, case_dfa, needles)
    lay = plan_bitap_ci(cm, max_words=2)
    assert lay.has_trap
    return m, BitapAcEngine(cm, layout=lay, device=CPU, **KW)


def _forbid(monkeypatch, eng, name):
    def boom(*_a, **_k):
        raise AssertionError(f"{name} must not run on this corpus")

    monkeypatch.setattr(eng, name, boom)


def test_localized_recovery_matches_the_oracle(monkeypatch):
    """Traps in a few streams: only those streams are re-counted on the host,
    and the dense fallback never runs."""
    m, eng = _recovery_engine(["kilo", "fix", "tshirt"])
    text = _corpus(["kilo", "fix", "tshirt"], 3000, 7,
                   traps=[(500, "KİLO"), (9000, "fİx"), (15000, "KKILO")])
    st = eng.stage(text)
    counts, trap = (o.numpy() for o in eng.stream_counts(st))
    trapped = eng._trapped_streams(trap, st)
    assert 0 < len(trapped) <= 32
    _forbid(monkeypatch, eng, "_dense_count_staged")
    exp = ac.count_matches(m, text, IGNORE_CASE)
    assert eng.count_staged(st) == exp > int(counts[st.live_np].sum())
    assert eng.contains_staged(st)
    # A corpus whose only match hides behind a trap: decided on the host.
    lone = b"zz " * 3000 + "FİX".encode() + b" zz" * 3000
    st2 = eng.stage(lone)
    hits, trap2 = (o.numpy() for o in bitap_contains(*eng.sticky_bitap_args(st2)))
    assert not hits.any() and trap2.any()
    assert eng.contains_staged(st2) and eng.count_staged(st2) == 1
    assert ac.count_matches(m, lone, IGNORE_CASE) == 1


def test_dense_fallback_matches_the_oracle(monkeypatch):
    """Traps in more than ``max(32, 1%)`` of the live streams, or no host
    corpus: the dense kernels on the composed machine decide."""
    m, eng = _recovery_engine(["kilo", "fix", "tshirt"])
    text = ("tshirt KİLO xx fix " * 800).encode()
    st = eng.stage(text)
    _, trap = (o.numpy() for o in eng.stream_counts(st))
    assert eng._trapped_streams(trap, st) is None and (trap[st.live_np] != 0).sum() > 32
    _forbid(monkeypatch, eng, "_host_count_stream")
    exp = ac.count_matches(m, text, IGNORE_CASE)
    assert eng.count_staged(st) == exp
    assert eng.contains_staged(st)
    lone = b"zz " * 3000 + "FİX".encode() + b" zz" * 3000
    bare = eng.stage(lone)
    bare.data_np = None  # no host corpus: the dense sticky scan (B3) decides
    assert eng.contains_staged(bare) and eng.count_staged(bare) == 1
    miss = eng.stage(b"zz " * 3000 + "İ".encode() + b" zz" * 3000)
    miss.data_np = None
    assert not eng.contains_staged(miss) and eng.count_staged(miss) == 0
    assert eng.needle_presence_staged(st) is None


def test_trap_wrappers_check_their_inputs():
    _, eng = _recovery_engine(["kilo"])
    st = eng.stage(b"kilo " * 50)
    args = eng.sticky_bitap_args(st)
    assert torch.equal(bitap_contains(*args)[0], bitap_contains_plain(*args)[0])
    with pytest.raises(ValueError):  # trap mask of the wrong shape
        bitap_contains(*args[:4], args[4][:0])
    with pytest.raises(ValueError):  # trap mask of the wrong dtype
        bitap_presence(*args[:4], args[4].long())
    # The trap kernels hold at most 3 words (the CaseSensitive B2 holds 8).
    z4 = torch.zeros(4, dtype=torch.int32)
    four = (st.streams, torch.zeros(4, 256, dtype=torch.int32), z4, z4)
    with pytest.raises(ValueError, match="1..3"):
        bitap_contains(*four, z4)
    empty = torch.zeros(0, dtype=torch.int32)
    count_args = (*four, torch.zeros(5, dtype=torch.int32), empty, empty, st.warm)
    assert bitap_count(*count_args).shape == (st.streams.shape[1],)
    with pytest.raises(ValueError, match="1..3"):
        bitap_count(*count_args, z4)


def test_grouped_engine_over_a_composed_machine_is_wrong():
    """The fault the composed gate repairs: the grouped engine builds its
    groups from ``machine.needles``, so over a composed machine it scans raw
    bytes case-sensitively and misses every uppercase match.  The port's
    ``Searcher`` declines to compose where only the grouped engine would
    hold the machine, and gives the oracle's answer through the lowering
    path."""
    rng = np.random.default_rng(4)
    needles = list(dict.fromkeys(
        "".join(chr(97 + c) for c in rng.integers(0, 26, size=int(rng.integers(4, 8))))
        for _ in range(24)))
    m, cm = _composed(ac, case_dfa, needles)
    text = " ".join(needles[i] for i in rng.integers(0, len(needles), size=400)).upper().encode()
    exp = ac.count_matches(m, text, IGNORE_CASE)
    assert exp > 0 and ac.count_matches(cm, text) == exp
    grouped = GroupedAcEngine(cm, device=CPU, max_rows=1, n_streams=64, t_tile=32)
    assert grouped.n_groups > 1
    assert grouped.count(text) != exp  # the fault
    assert grouped.count(text) == 0

    def small_tables(machine, device="cuda", **kw):
        return comb_scan.make_engine(machine, device, **dict(kw, max_rows=1))

    s = Searcher.build(IGNORE_CASE, needles, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "make_engine", small_tables)
        mp.setattr(tengine.MatchEngine, "AUTO_COMPOSE_BYTES", 0)
        staged = s.stage(text)
        assert s._engine._ci is None and not staged.composed and staged.lowered is not None
        assert isinstance(s._engine.device_engine(), GroupedAcEngine)
        assert s.count_matches(staged) == exp
        ends, _ = s.all_matches_arrays(staged)
        assert [e for e, _ in ac.all_matches(m, text, IGNORE_CASE)] == ends.tolist()


def test_config5_600_declines_the_composed_engine():
    """Config 5's first 600 needles pass the CaseSensitive state gate, but
    their composed machine fits no single-pass engine: ``_composed`` returns
    None and IgnoreCase takes the lowering path."""
    rng = np.random.default_rng(7)
    for _ in range(110):  # config 2's draws come first
        rng.integers(0, 26, size=rng.integers(4, 9))
    n600 = list(dict.fromkeys(
        "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(5, 12)))
        for _ in range(11000)))[:600]
    m = ac.build([(n, i) for i, n in enumerate(n600)])
    assert m.n_states <= tengine.COMPOSED_CI_MAX_STATES
    eng = tengine.MatchEngine(m, device="cpu")
    assert eng._composed(IGNORE_CASE) is None
