"""The segmented schedule of B12, the comb16 states scan ``comb16_states``,
which ``csrc/comb16_grouped.cu`` runs on the card as the states mode of its
one-group scan (``csrc/stage.cuh``).

* The rule: B12 takes B8's design (B9's rule for one group, with the
  block's shared memory for the full tables): k = 16 at config 2's full
  tables on the main path's 32768 streams and on a 4096-stream shard, one
  segment without an overlap.
* Exactness: the plain version run over every segment from its scan start,
  each keeping the rows of its own range (``stitch_segments`` of
  ``alfred_margaret_tpu_torch/kernels/segments.py``), equals the unsplit
  plain version in every ``[T, S]`` entry, before ``warm``, past ``vend``
  and on padding, and that equals the JAX kernel (``_make_c16_states_kernel``)
  in interpret mode, at k = 1, 2, 3 and 5 with T = 40; on config 2's 100
  needles and a NUL-bearing set (config 2's first 60 and two NUL needles),
  both against JAX, and on the nested set (four count ranges) and a composed
  IgnoreCase machine.
* The plumbing: ``Comb16AcEngine.states_args`` ends with the plan's overlap,
  and ``packed_states`` passes it to the wrapper.

Tolerance: exact equality of every entry.
"""

import importlib

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.ops import comb16_scan as j16

from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.kernels import segments as seg
from alfred_margaret_tpu_torch.kernels.comb16 import comb16_states, comb16_states_plain
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops import comb16_scan as t16

from test_torch_comb16 import CONFIG2, NESTED, NUL
from test_torch_count_segments import KW, _composed, _machine
from test_torch_segments import CI, _layout_cases
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

comb16_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.comb16")
CPU = torch.device("cpu")
KS = [1, 2, 3, 5]

#: name: (needles, composed, held against the JAX kernel)
B12_CASES = {
    "config2": (CONFIG2, False, True),
    "nul": (NUL, False, True),
    "nested": (NESTED, False, False),
    "ignorecase": (CI[:12] + ["straße", "kelvin"], True, False),
}
_B12 = {}


def _b12_case(name):
    """(JAX states [T, S] or None, the port's staging, the engine, B12's args
    without the overlap) of a case, built once."""
    if name not in _B12:
        needles, composed, jax = B12_CASES[name]
        tm = _composed(ac, case_dfa, needles) if composed else _machine(ac, needles)
        eng = t16.Comb16AcEngine(tm, device=CPU, **KW)
        hay = synth_corpus([x for x in needles if "\x00" not in x], 1300, hit_fraction=0.05,
                           seed=len(name)) + "".join(needles[-2:]).encode() * 3
        if composed:
            a = np.frombuffer(hay, np.uint8).copy()
            a[(a >= 97) & (a <= 122) & (np.random.default_rng(2).random(len(a)) < 0.5)] -= 32
            hay = a.tobytes()
        data = np.frombuffer(hay, np.uint8)
        pst = eng.stage(data)
        want = None
        if jax:
            jeng = j16.Comb16PallasAcEngine(_machine(jac, needles), interpret=True, **KW)
            st = jeng.stage(data)
            want = np.asarray(jeng._states_call(st)).reshape(st.plan.time_len, -1)
        args = eng.states_args(pst)
        assert args[-1] == pst.plan.overlap
        _B12[name] = (want, pst, eng, args[:-1])
    return _B12[name]


def test_b12_design_follows_the_rule(monkeypatch):
    monkeypatch.setattr(comb16_mod, "sm_count", lambda _dev: 132)
    full = t16.Comb16AcEngine(_machine(ac, CONFIG2), device=CPU, n_streams=8,
                              t_tile=8).full_tables
    cw, aw = full.comb.numel(), full.aux.numel()
    for S in (32768, 4096):
        wide = torch.zeros(4224, S, dtype=torch.uint8)
        d = comb16_mod.comb16_count_design(wide, full.comb, full.aux, 7)
        assert d.as_dict() == {"k": 16, "t_tile": seg.T_TILE, "Gc": 1}
        assert d == seg.grouped_design(S, 4224, 7, 1, cw, aw, 132)
        assert comb16_mod.comb16_count_design(wide, full.comb, full.aux).segments == 1


@pytest.mark.parametrize("name", list(B12_CASES))
@pytest.mark.parametrize("k", KS)
def test_b12_segments_equal_unsplit_and_jax(name, k):
    want, pst, eng, args = _b12_case(name)
    K, T = pst.plan.overlap, pst.plan.time_len
    assert T == 40 and _layout_cases(pst)["padded"]
    if name == "config2":
        assert eng.c16_full is not eng.c16  # the full tables, not the count-minimized
    if name == "ignorecase":
        assert eng.machine.composed_ci
    whole = comb16_states_plain(*args)
    assert whole.shape == (T, 128) and whole.dtype == torch.int32
    if want is not None:
        np.testing.assert_array_equal(whole.numpy(), want)
    assert int(((whole >> 15) & 1).sum()) > 0  # count bits survive in the entries
    assert torch.equal(comb16_states(*args, K), whole)  # the wrapper's CPU path
    got = seg.stitch_segments(comb16_states_plain, args[0], *args[1:], overlap=K, segments=k)
    assert got.dtype == torch.int32 and torch.equal(got, whole)


def test_b12_packed_states_pass_the_plans_overlap(monkeypatch):
    seen = []
    real = t16.comb16_states

    def spy(*a, **kw):
        seen.append(a[10] if len(a) > 10 else kw.get("overlap"))
        return real(*a, **kw)

    monkeypatch.setattr(t16, "comb16_states", spy)
    _, pst, eng, args = _b12_case("nul")
    got = eng.packed_states(pst)
    assert seen == [pst.plan.overlap] and torch.equal(got, comb16_states_plain(*args))
