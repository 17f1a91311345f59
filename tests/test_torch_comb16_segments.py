"""The segmented schedule of B8, the comb16 count ``comb16_count``, which
``csrc/comb16_grouped.cu`` runs on the card as a one-group mode of B9's
scan (``csrc/stage.cuh``).

* Exactness: B8's plain version run over every segment of a schedule and
  summed per stream (``run_segments`` of
  ``alfred_margaret_tpu_torch/kernels/segments.py``) equals the unsplit
  plain version at k = 1, 2, 3, 7, 16 and 64 with T = 40, not a multiple
  of 3, 7, 16 or 64: on config 2's first 60 needles (four of them nested),
  the nested set ``a .. aaaaa`` (four count ranges), held against the JAX
  kernel (``_make_c16_count_kernel``) in interpret mode on the same staged
  corpus, and the composed IgnoreCase machine of a comb16 set (overlap
  ``max_raw_match_bytes + 4``); on stagings with stream 0, fully padded
  streams and streams whose vend falls inside a later segment's warm-up.
* The plumbing: ``Comb16AcEngine.stream_counts``, which the grouped
  engine's per-group passes call too, passes the plan's overlap.

Tolerance: exact equality of every count.
"""

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.ops import comb16_scan as j16

from alfred_margaret_tpu_torch.kernels import segments as seg
from alfred_margaret_tpu_torch.kernels.comb16 import comb16_count, comb16_count_plain
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops import comb16_scan as t16
from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine

from test_torch_comb16 import CONFIG2, NESTED, _machines, random_needles
from test_torch_count_segments import KS, _spy
from test_torch_segments import _layout_cases
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
#: T = 40 steps on the stagings below.
KW = dict(n_streams=128, t_tile=40)
#: Whole-code-point lowercase needles whose composed machine comb16 holds.
CI = random_needles(47, 40) + ["straße", "kelvin"]

#: name: (needles, corpus bytes, composed, held against the JAX kernel)
B8_CASES = {
    "config2_60": (CONFIG2[:60], 2600, False, False),
    "nested": (NESTED, 2600, False, True),
    "ignorecase": (CI, 2600, True, False),
}
_B8 = {}


def _hay(needles, n, seed, composed):
    rng = np.random.default_rng(seed)
    words = [x.encode() for x in needles]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), n // 4))
    if composed:  # raw bytes in mixed case
        a = np.frombuffer(text, np.uint8).copy()
        a[(a >= 97) & (a <= 122) & (rng.random(len(a)) < 0.5)] -= 32
        text = a.tobytes()
    return text[:n]


def _b8_case(name):
    """(JAX counts or None, the port's staging, the engine, B8's args
    without the overlap) of a case, built once."""
    if name not in _B8:
        needles, n, composed, jax = B8_CASES[name]
        jm, tm = _machines(needles)
        if composed:
            tm = case_dfa.compose_build(list(zip(tm.needles, tm.values)), machine=tm)
        eng = Comb16AcEngine(tm, device=CPU, **KW)
        data = np.frombuffer(_hay(needles, n, len(name), composed), np.uint8)
        pst = eng.stage(data)
        want = None
        if jax:
            jeng = j16.Comb16PallasAcEngine(jm, interpret=True, **KW)
            st = jeng.stage(data)
            np.testing.assert_array_equal(pst.warm_np, np.asarray(st.warm_np).reshape(-1))
            want = np.asarray(jeng._get_count_fn(st.plan.time_len)(
                jeng._bscal_for(st), jeng._classmap_dev, jeng._comb_dev, jeng._aux_dev,
                jeng._rootseg_dev, st.warm_t, st.vend_t, st.streams_dev,
            )).reshape(-1)
        args = eng._kernel_args(pst)
        assert args[-1] == pst.plan.overlap
        _B8[name] = (want, pst, eng, args[:-1])
    return _B8[name]


@pytest.mark.parametrize("name", list(B8_CASES))
@pytest.mark.parametrize("k", KS)
def test_b8_segments_equal_unsplit_and_jax(name, k):
    want, pst, eng, args = _b8_case(name)
    streams, warm, vend = args[:3]
    K, T, live = pst.plan.overlap, pst.plan.time_len, pst.live_np
    assert T == 40
    cases = _layout_cases(pst)
    assert cases["stream 0"] and cases["padded"]
    if name == "nested":
        assert len(eng.c16.count_ranges) == 4
    if name == "ignorecase":
        assert eng.machine.composed_ci and K == eng.machine.max_needle_bytes - 1
    whole = comb16_count_plain(*args)
    if want is not None:
        np.testing.assert_array_equal(whole.numpy()[live], want[live])
    got = seg.run_segments(comb16_count_plain, *args, overlap=K, segments=k)
    assert got.dtype == torch.int32 and torch.equal(got, whole)
    assert int(got.sum()) > 0
    assert eng.count_staged(pst) == int(got.numpy()[live].astype(np.int64).sum())
    assert eng.count_staged(pst) == ac.count_matches(eng.machine, pst.data_np.tobytes())
    # The wrapper on the CPU runs the plain version, whatever the overlap.
    assert torch.equal(comb16_count(*args, overlap=K), whole)
    if k == 7:
        # Streams whose vend lies inside a later segment's warm-up count
        # nothing there, and still all their matches.
        v = vend.numpy()
        assert any(((v > start) & (v <= lo)).any()
                   for start, lo, _ in seg.segment_schedule(T, k, K)[1:])


def test_comb16_engine_passes_the_plans_overlap(monkeypatch):
    seen = []
    _spy(monkeypatch, t16, "comb16_count", 13, seen)
    m = ac.build([(x, i) for i, x in enumerate(CONFIG2)])
    eng = Comb16AcEngine(m, device=CPU, n_streams=16, t_tile=8)
    hay = b"abcd and bcd, " * 40
    st = eng.stage(hay)
    assert eng.count_staged(st) == ac.count_matches(m, hay) > 0
    assert seen == [st.plan.overlap] == [m.max_needle_bytes - 1]
    assert eng._kernel_args(st)[13] == st.plan.overlap
    assert torch.equal(comb16_count(*eng._kernel_args(st)), eng.stream_counts_plain(st))
