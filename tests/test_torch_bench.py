"""The port's bench modules, serving demo, trace and table generator against
the JAX package's.

``bench/micro.py`` gives the JAX ``micro``'s ``result`` for every
(scenario, impl); ``bench/configs.py``'s needle draws are the JAX
``configs.py``'s (restated below from its lines 79-86 and 239-245) and each
config passes its gates at a small size (config 5 on its first 300
needles), its answer the JAX package's on the same corpus (its host C++
engine's count, or its ``Searcher``'s); ``bench/scaling.py``'s rows on CPU
shards hold the JAX host C++ engine's counts; the serving demo runs on the
CPU, its printed counts the JAX automaton's; ``utils/trace.py``
records the JAX ``ScanStats`` fields and writes a Chrome trace; and
``utils/_gen_unicode_tables.py`` writes the port's frozen table.
Tolerance: exact equality.  Everything runs with ``device="cpu"`` (the
kernels' plain versions); without it the entry points raise on a host
without CUDA.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from alfred_margaret_tpu import IGNORE_CASE as JAX_IGNORE_CASE
from alfred_margaret_tpu import Searcher as JaxSearcher
from alfred_margaret_tpu.bench import micro as jmicro
from alfred_margaret_tpu.bench.dataformat import synth_corpus as jsynth_corpus
from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.native.cpp_engine import CppAcEngine as JaxCppAcEngine
from alfred_margaret_tpu.utils import trace as jtrace

from alfred_margaret_tpu_torch.bench import configs, micro, scaling
from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.examples import serving_demo
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.utils import trace

from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

K = 1024


def _jax_corpus(needles, n_bytes, seed):
    """The JAX ``synth_corpus`` at hit fraction 0.01, which the port's
    copy must give byte for byte."""
    want = jsynth_corpus(needles, n_bytes, hit_fraction=0.01, seed=seed)
    assert synth_corpus(needles, n_bytes, hit_fraction=0.01, seed=seed) == want
    return want


def _jax_count(needles, corpus) -> int:
    """The JAX package's host C++ engine's count of ``needles`` in ``corpus``."""
    return JaxCppAcEngine(jac.build([(n, i) for i, n in enumerate(needles)])).count(corpus)


def _jax_draws():
    """``alfred_margaret_tpu/bench/configs.py:79-86`` (config 2) and
    ``:239-245`` (config 5), restated: one generator, config 2's 110 draws
    first."""
    rng = np.random.default_rng(7)
    needles100 = list(
        dict.fromkeys(
            "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(4, 9)))
            for _ in range(110)
        )
    )[:100]
    needles100[:4] = ["abc", "abcd", "bcd", "c"]
    needles10k = list(
        dict.fromkeys(
            "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(5, 12)))
            for _ in range(11000)
        )
    )[:10000]
    return needles100, needles10k


def test_config_draws_equal_jax():
    needles100, needles10k = _jax_draws()
    assert configs.config2_needles() == needles100
    assert configs.config5_needles(10000) == needles10k
    assert configs.config5_needles(300) == needles10k[:300]
    assert len(set(needles10k)) == 10000


def test_micro_results_equal_jax(monkeypatch, capsys):
    """Every (scenario, impl) row's ``result``; the timing loop runs each
    implementation once here."""
    for mod in (micro, jmicro):
        monkeypatch.setattr(mod, "timed", lambda fn, min_rounds=5: (fn(), 1e-3)[1])
    assert jmicro.main() == 0
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert micro.main(["--device", "cpu"]) == 0
    got = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(got) == len(want) == 44
    assert [(g["scenario"], g["impl"], g["result"]) for g in got] == [
        (w["scenario"], w["impl"], w["result"]) for w in want]
    assert all(set(g) == set(w) for g, w in zip(got, want))


CONFIG_CASES = [
    (configs.config1, dict(big=0, n_bytes=64 * K)),
    (configs.config2, dict(big=192 * K)),
    (configs.config2b, dict(big=192 * K)),
    (configs.config3, dict(big=192 * K)),
    (configs.config4, dict(big=0, n_bytes=192 * K)),
    (configs.config5, dict(big=192 * K, n_needles=300)),
]


@pytest.mark.parametrize("config,kw", CONFIG_CASES, ids=[c[0].__name__ for c in CONFIG_CASES])
def test_configs_pass_their_gates(config, kw, monkeypatch, capsys):
    """Each config at a small size: its gates pass (they raise), it prints
    one JSON line, and its answer is the JAX package's on the same corpus
    (configs 2b and 4 answer in their gates alone: verdicts and a bit-exact
    output)."""
    monkeypatch.setattr(configs, "_best", lambda fn, rounds=3: (fn(), 1e-3)[1])
    row = config(device="cpu", **kw)
    assert json.loads(capsys.readouterr().out) == row
    big = kw["big"]
    if config is configs.config1:
        want = _jax_count(configs.NEEDLES3, _jax_corpus(configs.NEEDLES3, kw["n_bytes"], 3)) > 0
        assert row["result"] is want is True and row["bytes"] == kw["n_bytes"]
    elif config is configs.config2:
        needles, _ = _jax_draws()
        want = _jax_count(needles, _jax_corpus(needles, big, 5))
        assert row["matches"] == want > 0
        assert row["parity"] == "cpp-exact+nfa-independent+naive"
    elif config is configs.config3:
        # ``alfred_margaret_tpu/bench/configs.py:174-177``, restated.
        words = ["İstanbul", "STRASSE", "straße", "Zürich", "K", "Å", "ǳoo", "TShirt"]
        unit = " ".join(words) + " filler "
        corpus3 = (unit * (big // len(unit.encode()))).encode()
        want = JaxSearcher.build(JAX_IGNORE_CASE, ["istanbul", "straße", "zürich", "tshirt"],
                                 engine="cpp").count_matches(corpus3)
        assert row["matches"] == want > 0 and row["parity"] == "scalar-oracle-exact"
    elif config is configs.config5:
        needles = _jax_draws()[1][:300]
        want = _jax_count(needles, _jax_corpus(needles[:500], big, 11))
        assert row["matches"] == want > 0 and row["needles"] == 300
        assert row["steady_state_mb_per_sec"] is None and "device backend" in row[
            "steady_state_note"]
    assert all(v is not None for k, v in row.items() if k != "steady_state_mb_per_sec")


def test_configs_main_runs_every_config_in_order(monkeypatch):
    seen = []
    monkeypatch.setattr(configs, "CONFIGS", tuple(
        (lambda big, device, f=f: seen.append((f.__name__, big, device))) for f in configs.CONFIGS))
    assert configs.main(["--mb", "3", "--device", "cpu"]) == 0
    assert seen == [(f.__name__, 3 << 20, "cpu") for f in
                    (configs.config1, configs.config2, configs.config2b, configs.config3,
                     configs.config4, configs.config5)]


def test_scaling_invariance_on_cpu_shards():
    m = ac.build([(n, i) for i, n in enumerate(scaling.NEEDLES)])
    row = scaling.invariance(m, lambda n: scaling.shard_devices("cpu", n), n_bytes=1 << 18)
    want = _jax_count(scaling.NEEDLES, _jax_corpus(scaling.NEEDLES, 1 << 18, 7))
    assert row == {"invariance": "ok", "shapes": 10, "count": want} and want > 0
    assert scaling.shard_devices("cpu", 4) == [torch.device("cpu")] * 4


def test_scaling_rows_on_cpu(monkeypatch, capsys):
    """``main`` at 1 MiB per shard on one and two CPU shards: the two-shard
    row shares its device and says so."""
    monkeypatch.setattr(scaling, "SIZES", (1, 2))
    monkeypatch.setattr(scaling, "invariance", lambda *a, **kw: {"invariance": "ok"})
    assert scaling.main(["1", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows[0] == {"invariance": "ok"}
    one, two = rows[1:]
    assert "virtual_mesh" not in one and two["virtual_mesh"] is True
    assert two["distinct_devices"] == 1 and two["device"] == "cpu"
    for row, n in ((one, 1), (two, 2)):
        want = _jax_count(scaling.NEEDLES, _jax_corpus(scaling.NEEDLES, n << 20, 3))
        assert row["count"] == want > 0 and row["corpus_mb"] == n


def test_serving_demo_on_cpu(capsys):
    """The demo's steps pass on the CPU, and the counts it prints for its
    staged scans and its needle-set swap are the JAX automaton's on the
    same corpus."""
    serving_demo.main("cpu", 1 << 20)
    out = capsys.readouterr().out
    assert out.rstrip().endswith("serving demo: ALL STEPS EXACT")
    assert "mesh count over 4 shards of cpu: exact" in out
    needles = ["tshirt", "shirts", "shorts", "hoodie"]
    corpus = _jax_corpus(needles[:3], 1 << 20, 42)
    want = jac.count_matches(jac.build([(n, i) for i, n in enumerate(needles)]), corpus)
    want2 = jac.count_matches(jac.build([("short", 0), ("tshir", 1)]), corpus)
    assert f"staged scans: {want} matches x3, exact" in out and want > 0
    assert f"needle-set swap via adopt_staged: {want2} matches, exact" in out and want2 > 0


def test_trace_profile_records_and_writes_a_trace(tmp_path):
    """The JAX ``ScanStats`` fields, recorded in the block's stats and the
    aggregate, and a Chrome trace whose ``label`` span the idle-share reader
    finds (no device events on the CPU: idle share 1)."""
    agg = trace.ScanStats()
    with trace.profile(4096, label="count", trace_dir=str(tmp_path), stats=agg) as st:
        torch.arange(1000).sum()
    assert list(st.as_dict()) == list(jtrace.ScanStats().as_dict())
    assert st.scans == agg.scans == 1 and st.bytes_scanned == 4096 and st.seconds > 0
    assert st.as_dict() == agg.as_dict()
    before = trace.GLOBAL_STATS.scans
    with trace.profile(10) as st2:
        pass
    assert st2.scans == 1 and trace.GLOBAL_STATS.scans == before + 1
    (path,) = glob.glob(os.path.join(str(tmp_path), "count.*.json"))
    got = trace.device_idle_share(path, "count")
    assert got["idle_share"] == 1.0 and got["busy_us"] == 0 and got["kernel"] == 0
    assert got["top"] == []
    with pytest.raises(ValueError, match="no 'scan' span"):
        trace.device_idle_share(path)


def test_device_idle_share_unions_intervals(tmp_path):
    """Overlapping kernels count once, a copy beside them adds, events past
    the span are clipped, host events are not device time."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "scan", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 110, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 120, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 150, "dur": 10},
        {"ph": "X", "cat": "gpu_memset", "name": "s", "ts": 190, "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sum", "ts": 100, "dur": 100},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace.device_idle_share(str(path))
    assert got == {"wall_us": 100.0, "busy_us": 50.0, "idle_share": 0.5, "kernel": 2,
                   "gpu_memcpy": 1, "gpu_memset": 1,
                   "top": [["k1", 20.0], ["k2", 20.0], ["c", 10.0], ["s", 10.0]]}


def test_unicode_table_generator_writes_the_frozen_table(tmp_path, monkeypatch):
    from alfred_margaret_tpu_torch.utils import _gen_unicode_tables as gen

    frozen = os.path.join(os.path.dirname(gen.__file__), "_data", "lower_pairs.npy")
    monkeypatch.setattr(gen, "__file__", str(tmp_path / "_gen_unicode_tables.py"))
    gen.main()
    np.testing.assert_array_equal(np.load(tmp_path / "_data" / "lower_pairs.npy"),
                                  np.load(frozen))


def test_entry_points_raise_without_cuda():
    """Without ``--device cpu`` the tools run on the card, and raise on a
    host without one: nothing moves to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: micro.main([]), lambda: configs.main(["--mb", "1"]),
                 lambda: scaling.main(["1"]), lambda: serving_demo.main(corpus_bytes=4096),
                 lambda: configs.config1(0)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
