"""The reference scan engine of the PyTorch port against the JAX package.

* ``XlaAcEngine`` (torch gathers, one time step at a time, on the CPU here)
  gives the JAX ``XlaAcEngine``'s ``count``, ``final_states`` and
  ``state_hits`` on seeded corpora (numpy ``default_rng``), with and
  without ``bucket``, over the same stream plan and streams.
* ``MatchEngine(engine="xla")``, and the ``device`` backend on a set that
  no kernel table and no grouping holds (an empty needle beside 600 random
  ones), give the JAX ``MatchEngine(engine="xla")``'s and the python
  oracle's count, containsAny, matches and value presence, through
  ``Searcher`` too, staged and unstaged.  Small sets with an empty needle
  stay on the dense engine.

Tolerance: exact equality of every count, state, flag and match.
"""

import numpy as np
import pytest
import torch

import alfred_margaret_tpu as jamt
from alfred_margaret_tpu.bench.dataformat import synth_corpus
from alfred_margaret_tpu.engine import MatchEngine as JaxMatchEngine
from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.ops import xla_scan as jxla

from alfred_margaret_tpu_torch import CASE_SENSITIVE, MatchEngine, Searcher
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.ops import xla_scan as txla
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine

from test_torch_slice import LARGE
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")


def _machines(needles):
    pairs = [(n, i) for i, n in enumerate(needles)]
    return jac.build(pairs), ac.build(pairs)


def _random_hay(needles, n, seed):
    """``n`` bytes over the needles' alphabet, NUL and space, with needles
    written in at random places."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(bytes(sorted({b for x in needles for b in x.encode()} | {0, 32})),
                             np.uint8)
    hay = bytearray(rng.choice(alphabet, n).astype(np.uint8).tobytes())
    for x in needles:
        if x:
            at = int(rng.integers(0, max(1, n - len(x))))
            hay[at : at + len(x)] = x.encode()
    return bytes(hay[:n])


CASES = [
    ("bench", ["tshirt", "shirts", "shorts"], 5000),
    ("nul", ["a\x00b", "\x00\x00", "xyz"], 3000),
    ("empty_needle", ["", "ab", "b", "abc"], 2000),
    ("nested", ["a", "aa", "aaa", "ba", "aab"], 7000),
]


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("name,needles,n", CASES, ids=[c[0] for c in CASES])
def test_scans_match_jax_xla_engine(name, needles, n, bucket):
    jm, tm = _machines(needles)
    hay = _random_hay(needles, n, seed=n)
    jeng = jxla.XlaAcEngine(jm, max_streams=64, bucket=bucket)
    eng = txla.XlaAcEngine(tm, max_streams=64, bucket=bucket, device=CPU)
    data = np.frombuffer(hay, np.uint8)
    plan, streams, _, _ = eng._streams(data)
    jplan, (jstreams, _, _) = jeng._streams(data)
    assert (plan.n, plan.n_streams, plan.emit_len, plan.overlap, plan.time_len) == (
        jplan.n, jplan.n_streams, jplan.emit_len, jplan.overlap, jplan.time_len)
    np.testing.assert_array_equal(streams.numpy(), jstreams)
    assert eng.count(hay) == jeng.count(hay) == jac.count_matches(jm, hay)
    fs = eng.final_states(hay)
    assert fs.dtype == np.int32
    np.testing.assert_array_equal(fs, jeng.final_states(hay))
    hits = eng.state_hits(hay)
    assert hits.dtype == bool and hits.shape == (tm.n_states,)
    np.testing.assert_array_equal(hits, jeng.state_hits(hay))
    assert eng.count(b"") == 0 and len(eng.final_states(b"")) == 0
    assert not eng.state_hits(b"").any()


@pytest.fixture(scope="module")
def empty_large():
    """An empty needle beside 600 random ones: no kernel table holds the
    set, and no grouping can split it."""
    needles = [""] + LARGE
    jm, tm = _machines(needles)
    hay = synth_corpus(LARGE, 1 << 13, hit_fraction=0.05, seed=21)
    return needles, jm, tm, hay


def test_device_backend_falls_back_to_the_reference_engine(empty_large):
    _, _, tm, _ = empty_large
    me = MatchEngine(tm, "device", device=CPU)
    assert type(me.device_engine()) is txla.XlaAcEngine
    assert me.device_engine() is me._xla_engine()
    # Small sets with an empty needle stay on the dense engine.
    small = MatchEngine(ac.build([("", 0), ("ab", 1), ("b", 2)]), "device", device=CPU)
    assert type(small.device_engine()) is DenseAcEngine


@pytest.mark.parametrize("engine", ["xla", "device", "auto"])
def test_operations_match_jax_xla_and_oracle(empty_large, engine):
    needles, jm, tm, hay = empty_large
    jme = JaxMatchEngine(jm, "xla")
    want_count = jme.count(hay, jamt.CASE_SENSITIVE)
    want_any = jme.contains_any(hay, jamt.CASE_SENSITIVE)
    want_m = jme.matches(hay, jamt.CASE_SENSITIVE)
    want_p = jme.value_presence(hay, jamt.CASE_SENSITIVE)
    oracle = MatchEngine(tm, "python", device=CPU)
    assert want_count == oracle.count(hay, CASE_SENSITIVE) == ac.count_matches(tm, hay)
    np.testing.assert_array_equal(want_p, oracle.value_presence(hay, CASE_SENSITIVE))
    me = MatchEngine(tm, engine, device=CPU)
    staged = me.stage(hay, CASE_SENSITIVE)
    assert staged.device is None  # the reference engine keeps only the bytes
    for h in (hay, staged):
        assert me.count(h, CASE_SENSITIVE) == want_count
        assert me.contains_any(h, CASE_SENSITIVE) is want_any is True
        got_m = me.matches(h, CASE_SENSITIVE)
        np.testing.assert_array_equal(got_m.ends, want_m.ends)
        np.testing.assert_array_equal(got_m.value_ids, want_m.value_ids)
        assert got_m.ends.dtype == np.int64 and got_m.value_ids.dtype == np.int32
        np.testing.assert_array_equal(me.value_presence(h, CASE_SENSITIVE), want_p)
    assert type(me._xla) is txla.XlaAcEngine and me._device_eng in (None, me._xla)


def test_searcher_on_the_reference_engine(empty_large):
    needles, _, _, hay = empty_large
    ref = jamt.Searcher.build(jamt.CASE_SENSITIVE, needles, engine="python")
    for engine in ("xla", "device"):
        s = Searcher.build(CASE_SENSITIVE, needles, engine=engine, device=CPU)
        for h in (hay, s.stage(hay)):
            assert s.count_matches(h) == ref.count_matches(hay)
            assert s.contains_any(h) is ref.contains_any(hay)
            assert s.contains_all(h) is ref.contains_all(hay)
            assert s.all_matches(h) == ref.all_matches(hay)
    short = hay[:300]
    s = Searcher.build(CASE_SENSITIVE, needles, engine="xla", device=CPU)
    assert s.all_matches(short) == ref.all_matches(short)
    assert s.all_matches(b"") == [] and s.count_matches(b"") == 0
    with pytest.raises(ValueError, match="unknown engine"):
        Searcher.build(CASE_SENSITIVE, needles, engine="pallas", device=CPU)
