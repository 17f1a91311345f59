"""The port's dispatch on the CPU: the needle set and the device alone choose
the engine and its route, and each engine answers value presence itself.

* The JAX package's path switches (``AMT_BITAP``, ``AMT_FILTER``,
  ``AMT_FUSED_GROUPS``, ``AMT_DIST_COMB16``), each set to ``"0"``, change
  nothing in the port: ``make_engine`` still takes bitap, comb16 and comb32
  for the sets that need them, the grouped engine still counts in one B9
  pass, a comb16 engine still attaches its screen, and the sharded engine's
  count routes stay bitap and comb16.
* ``MatchEngine.value_presence`` on the bitap engine (B7's needle flags, and
  the extraction route where a trap fired), the comb16 engine and the
  grouped engine (its groups comb16, or bitap and comb32, each group's
  engine answering for itself) equals the presence that ``ac.all_matches``
  gives.

Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, MatchEngine
from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.kernels import comb16_count_grouped_plain
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops import grouped as tgrouped
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap_ci
from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine
from alfred_margaret_tpu_torch.ops.comb_scan import CombAcEngine, make_engine
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine
from alfred_margaret_tpu_torch.parallel import DistributedAcEngine

from test_torch_comb16 import CONFIG2
from test_torch_grouped import MID, MID_HAY
from test_torch_parallel import _comb16_set, _mesh
from test_torch_slice import BIG, NEEDLES3
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")


def _machine(needles):
    return ac.build([(n, i) for i, n in enumerate(needles)])


@pytest.mark.parametrize("name", ["AMT_BITAP", "AMT_FILTER", "AMT_FUSED_GROUPS",
                                  "AMT_DIST_COMB16"])
def test_path_switches_change_nothing(monkeypatch, name):
    monkeypatch.setenv(name, "0")
    for needles, kind in ((NEEDLES3, BitapAcEngine), (CONFIG2, Comb16AcEngine),
                          (BIG, CombAcEngine)):
        assert type(make_engine(_machine(needles), "cpu")) is kind
    calls = []
    monkeypatch.setattr(tgrouped, "comb16_count_grouped",
                        lambda *a: calls.append(1) or comb16_count_grouped_plain(*a))
    tm = _machine(MID)
    g = GroupedAcEngine(tm, device=CPU, max_rows=5, n_streams=256, t_tile=64)
    assert g._screen is not None  # the suffix screen counts the set
    assert g.count(MID_HAY) == ac.count_matches(tm, MID_HAY)
    assert calls == []
    g._screen = None  # B9, its fused tables built at this first count
    assert g.count(MID_HAY) == ac.count_matches(tm, MID_HAY)
    assert calls == [1]
    c16 = Comb16AcEngine(_machine(CONFIG2), device=CPU, n_streams=16, t_tile=32)
    assert c16._filter_lay is not None and c16._filter_tables is not None
    assert DistributedAcEngine(_machine(NEEDLES3), _mesh(2, 2), inner="pallas").count_route() \
        == "bitap"
    needles, _ = _comb16_set(70, 100)
    assert DistributedAcEngine(_machine(needles), _mesh(2, 1, 2),
                               inner="pallas").count_route() == "comb16"


def _bitap():
    m = _machine(NEEDLES3 + ["zqzq"])
    return m, None, synth_corpus(NEEDLES3, 8 << 10, hit_fraction=0.02, seed=3), BitapAcEngine


def _bitap_trap():
    """The composed machine's byte-class bitap with trap tracks, on a corpus
    whose traps fire (KİLO), scanned as raw bytes."""
    m = _machine(["kilo", "fix", "tshirt", "zqzq"])
    cm = case_dfa.compose_build(list(zip(m.needles, m.values)), machine=m)
    lay = plan_bitap_ci(cm, max_words=2)
    assert lay.has_trap
    eng = BitapAcEngine(cm, layout=lay, device=CPU, n_streams=256, t_tile=32)
    return m, (cm, eng), ("tshirt KİLO xx fix " * 200).encode(), BitapAcEngine


def _comb16():
    hay = synth_corpus(CONFIG2[:50], 8 << 10, hit_fraction=0.02, seed=4)
    return _machine(CONFIG2), None, hay, Comb16AcEngine


def _grouped(max_rows=5):
    m = _machine(MID)
    eng = GroupedAcEngine(m, device=CPU, max_rows=max_rows, n_streams=256, t_tile=64)
    return m, (m, eng), MID_HAY[: len(MID_HAY) // 2], GroupedAcEngine


def _grouped_bitap():
    """Two rows a table: most groups take bitap, which answers by B7."""
    case = _grouped(max_rows=2)
    kinds = {type(e) for e in case[1][1].engines}
    assert BitapAcEngine in kinds and CombAcEngine in kinds
    return case


@pytest.mark.parametrize("case", [_bitap, _bitap_trap, _comb16, _grouped, _grouped_bitap],
                         ids=["bitap", "bitap_trap", "comb16", "grouped", "grouped_bitap"])
def test_value_presence_is_the_engines_own(monkeypatch, case):
    m, built, hay, kind = case()
    trap = case is _bitap_trap
    want = np.zeros(len(m.values), dtype=bool)
    for x in ac.all_matches(m, hay, IGNORE_CASE if trap else CASE_SENSITIVE):
        want[x.value] = True
    assert want.any() and not want.all()
    if built is None:
        me = MatchEngine(m, "device", device="cpu")
    else:
        scan_machine, eng = built
        me = MatchEngine(scan_machine, "device", device="cpu")
        me._device_eng = eng
    eng = me.device_engine()
    assert type(eng) is kind
    flags = []
    if kind is BitapAcEngine:
        b7 = eng.needle_presence_staged
        monkeypatch.setattr(eng, "needle_presence_staged",
                            lambda st: flags.append(b7(st)) or flags[-1])
    got = me.value_presence(hay, CASE_SENSITIVE)
    assert got.dtype == bool and len(got) == len(m.values)
    np.testing.assert_array_equal(got, want)
    if kind is BitapAcEngine:
        assert len(flags) == 1 and (flags[0] is None) == trap
