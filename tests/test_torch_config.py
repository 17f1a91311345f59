"""The port's runtime configuration (``utils/config.py``) and its 64-bit host
bitap oracle (``native/cpp_engine.py``'s ``CppBitapEngine``), against the
JAX package's.

Each ``AMT_`` knob the port keeps is read as the JAX ``EngineConfig.from_env``
reads it; ``AMT_ENGINE`` names the backend of ``engine="auto"``,
``AMT_VALIDATE`` catches a device count that the host C++ engine disputes,
and ``AMT_COMPOSED_CI`` and ``AMT_STREAM_CHUNK_MB`` reach the engine at
import.  The host bitap oracle mirrors ``tests/test_bitap.py``'s
``test_host_bitap_oracle`` and ``test_fuzz_vs_host_oracle`` and
``tests/test_native.py``'s ``test_host_ci_bitap_oracle``: its planners give
the JAX planners' tables, and its counts and first hits equal the JAX
engine's, the automaton's and the port's bitap engine's.  Tolerance: exact
equality.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.models import case_dfa as jcase_dfa
from alfred_margaret_tpu.native import cpp_engine as jcpp
from alfred_margaret_tpu.native.build import NativeUnavailable
from alfred_margaret_tpu.utils import config as jconfig
from alfred_margaret_tpu.utils.case import IGNORE_CASE as JAX_IGNORE_CASE

from alfred_margaret_tpu_torch import CASE_SENSITIVE, MatchEngine, Searcher
from alfred_margaret_tpu_torch import engine as tengine
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.native import cpp_engine
from alfred_margaret_tpu_torch.ops.comb_scan import make_engine
from alfred_margaret_tpu_torch.utils import config, utf8

from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("AMT_ENGINE", "AMT_VALIDATE", "AMT_COMPOSED_CI", "AMT_STREAM_CHUNK_MB")
#: The knobs the port keeps, by field.
FIELDS = ("engine", "validate", "composed_ci_max_states", "stream_chunk_mb")


@pytest.mark.parametrize("env", [
    {},
    {"AMT_ENGINE": "cpp", "AMT_VALIDATE": "1", "AMT_COMPOSED_CI": "17",
     "AMT_STREAM_CHUNK_MB": "3"},
    {"AMT_ENGINE": "device", "AMT_VALIDATE": "", "AMT_COMPOSED_CI": "0",
     "AMT_STREAM_CHUNK_MB": ""},
    {"AMT_VALIDATE": "0", "AMT_N_STREAMS": "256", "AMT_T_TILE": "32", "AMT_INTERPRET": "1"},
], ids=["defaults", "set", "empty", "not-kept"])
def test_knobs_read_as_jax(monkeypatch, env):
    for k in KNOBS + ("AMT_N_STREAMS", "AMT_T_TILE", "AMT_INTERPRET"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = config.EngineConfig.from_env(), jconfig.EngineConfig.from_env()
    assert [f.name for f in dataclasses.fields(got)] == list(FIELDS)
    assert {f: getattr(got, f) for f in FIELDS} == {f: getattr(want, f) for f in FIELDS}
    if not env:
        assert got == config.EngineConfig() and got.stream_chunk_mb == 128


def test_defaults_reach_the_engine():
    """``AMT_COMPOSED_CI`` and ``AMT_STREAM_CHUNK_MB`` as a fresh interpreter
    imports them: the engine's gate and the streaming budget follow."""
    code = ("from alfred_margaret_tpu_torch import engine; from alfred_margaret_tpu_torch.utils "
            "import config; print(engine.COMPOSED_CI_MAX_STATES, config.DEFAULT.stream_chunk_mb, "
            "engine.MatchEngine._over_budget(6 << 20), engine.MatchEngine._over_budget(7 << 20))")
    env = {k: v for k, v in os.environ.items() if not k.startswith("AMT_")}
    env.update(AMT_COMPOSED_CI="7", AMT_STREAM_CHUNK_MB="3")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["7", "3", "False", "True"]
    assert tengine.COMPOSED_CI_MAX_STATES == config.DEFAULT.composed_ci_max_states


def test_amt_engine_overrides_auto(monkeypatch):
    m = ac.build([("tshirt", 0), ("shirts", 1)])
    monkeypatch.setattr(config, "DEFAULT", dataclasses.replace(config.DEFAULT, engine="cpp"))
    assert MatchEngine(m, device="cpu").engine == "cpp"
    assert MatchEngine(m, "python", device="cpu").engine == "python"  # only "auto" is resolved
    s = Searcher.build(CASE_SENSITIVE, ["tshirt", "shirts"], device="cpu")
    hay = b"tshirts " * 2000
    assert s._engine.engine == "cpp" and s.count_matches(hay) == 4000
    assert s._engine._device_eng is None  # the device engine was never built
    # The JAX package's name of the device backend is not the port's.
    monkeypatch.setattr(config, "DEFAULT", dataclasses.replace(config.DEFAULT, engine="pallas"))
    with pytest.raises(ValueError, match="unknown engine 'pallas'"):
        MatchEngine(m, device="cpu")


def test_amt_validate_catches_a_mismatch(monkeypatch):
    needles = ["tshirt", "shirts", "shorts"]
    pairs = [(n, i) for i, n in enumerate(needles)]
    m = ac.build(pairs)
    hay = b"tshirtshirtsshorts " * 1000
    want = jac.count_matches(jac.build(pairs), hay)
    monkeypatch.setattr(config, "DEFAULT", dataclasses.replace(config.DEFAULT, validate=True))
    me = MatchEngine(m, device="cpu")
    assert me.count(hay, CASE_SENSITIVE) == want  # the device count agrees
    eng = me.device_engine()
    monkeypatch.setattr(eng, "count", lambda data: want - 1)  # a forced fault
    with pytest.raises(AssertionError,
                       match=f"device count {want - 1} != host C\\+\\+ engine {want}"):
        me.count(hay, CASE_SENSITIVE)
    monkeypatch.setattr(config, "DEFAULT", dataclasses.replace(config.DEFAULT, validate=False))
    me = MatchEngine(m, device="cpu")
    monkeypatch.setattr(me.device_engine(), "count", lambda data: want - 1)
    assert me.count(hay, CASE_SENSITIVE) == want - 1  # unchecked without the knob


# -- the host bitap oracle ------------------------------------------------------------


def _jax_engine(jm):
    try:
        return jcpp.CppBitapEngine(jm)
    except NativeUnavailable:
        pytest.skip("the JAX package's native library does not build here")


def _same_plan(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert tuple(got[1:3]) == tuple(want[1:3])


@pytest.mark.parametrize("needles,hay", [
    (["ab", "b", "abc", "ab"], b"zabcabzb" * 3000),  # duplicates and a suffix
    (["a\x00b"], b"xa\x00ba\x00b" * 2000),  # NUL is fine on the host
    (["tshirt", "shirts", "shorts"], b"tshirtshirtsshorts" * 500),
], ids=["dups", "nul", "bench"])
def test_host_bitap_oracle(needles, hay):
    pairs = [(n, i) for i, n in enumerate(needles)]
    m, jm = ac.build(pairs), jac.build(pairs)
    _same_plan(cpp_engine.plan_host_bitap(m), jcpp.plan_host_bitap(jm))
    got, want = cpp_engine.CppBitapEngine(m), _jax_engine(jm)
    exp = jac.count_matches(jm, hay)
    data = np.frombuffer(hay, np.uint8)
    for nt in (1, 4):
        assert got.count(data, n_threads=nt) == want.count(data, n_threads=nt) == exp
    assert got.first_hit(hay) == want.first_hit(hay) > 0
    assert got.contains(hay) is want.contains(hay) is (exp > 0)
    assert got.count(b"") == 0 and got.first_hit(b"") == -1 and not got.contains(b"zz")
    # 65 track bits: ineligible, as in the JAX package
    for n in (64, 65):
        _same_plan(cpp_engine.plan_host_bitap(ac.build([("x" * n, 0)])),
                   jcpp.plan_host_bitap(jac.build([("x" * n, 0)])))
    assert cpp_engine.plan_host_bitap(ac.build([("x" * 65, 0)])) is None
    with pytest.raises(ValueError, match="not host-bitap eligible"):
        cpp_engine.CppBitapEngine(ac.build([("", 0), ("a", 1)]))


def test_fuzz_vs_host_oracle():
    """Random needle sets over six letters: the host oracle, the JAX one, the
    port's bitap engine (plain versions) and the automaton agree."""
    rng = np.random.default_rng(42)
    alphabet = "abAB12"
    for trial in range(25):
        needles = ["".join(rng.choice(list(alphabet), size=int(rng.integers(1, 6))))
                   for _ in range(int(rng.integers(1, 6)))]
        pairs = [(n, i) for i, n in enumerate(needles)]
        m, jm = ac.build(pairs), jac.build(pairs)
        frags = needles + ["ab", "1", "BBA"]
        hay = "".join(frags[i] for i in rng.integers(0, len(frags),
                                                     size=int(rng.integers(10, 300)))).encode()
        exp = jac.count_matches(jm, hay)
        host = cpp_engine.CppBitapEngine(m)
        assert host.count(hay) == _jax_engine(jm).count(hay) == exp, (trial, needles)
        eng = make_engine(m, "cpu", n_streams=256, t_tile=32)
        st = eng.stage(np.frombuffer(hay, np.uint8))
        assert eng.count_staged(st) == exp and eng.contains_staged(st) == (exp > 0)


def test_host_ci_bitap_oracle():
    """The byte-class host bitap over a composed case-folding machine, with
    its trap register: a Kelvin sign fires the trap and the composed DFA
    answers."""
    low = [utf8.lower_str(n) for n in ["Kilo", "dress", "kilo"]]
    pairs = [(n, i) for i, n in enumerate(low)]
    m, jm = ac.build(pairs), jac.build(pairs)
    cm = case_dfa.compose_build(list(zip(m.needles, m.values)), machine=m)
    jcm = jcase_dfa.compose_build(list(zip(jm.needles, jm.values)), machine=jm)
    got_plan, want_plan = cpp_engine.plan_host_bitap_ci(cm), jcpp.plan_host_bitap_ci(jcm)
    _same_plan(got_plan[:3], want_plan[:3])
    _same_plan(got_plan[3], want_plan[3])
    assert got_plan[3] is not None  # 'i' and 'k' letters
    got, want = cpp_engine.CppBitapEngine(cm), _jax_engine(jcm)
    kelvin = ("KILO dress " * 50).encode()
    for hay in (("KILO dress kIlO DRESS xx " * 300).encode(), kelvin, b"zzz qq"):
        exp = jac.count_matches(jm, hay, JAX_IGNORE_CASE)
        assert got.count(hay) == want.count(hay) == exp
        assert got.contains(hay) is want.contains(hay) is (exp > 0)
        assert (got.first_hit(hay) >= 0) is (want.first_hit(hay) >= 0)
    assert got._trap_fires(np.frombuffer(kelvin, np.uint8))
    assert cpp_engine.plan_host_bitap_ci(m) is None  # a CaseSensitive machine
    assert cpp_engine.plan_host_bitap(cm) is None  # a composed one
