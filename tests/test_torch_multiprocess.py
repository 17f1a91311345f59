"""The port's sharded engine across two processes: the counterpart of
``experiments/multiproc_smoke.py`` on ``torch.distributed``.

Two spawned processes join one gloo group through a ``file://`` rendezvous
under the test's temporary directory; each holds 4 CPU shards of a global
8-shard data mesh (``make_mesh(["cpu"] * 8, data=8)`` after
``init_distributed``), on the kernels' plain versions (``inner="pallas"``)
and on the ``xla`` inner.  The global count and ``contains_any`` must equal
the port's host C++ engine's in both processes; extraction, which needs every
shard in one process, raises.  The run has its own 120 s limit.
"""

import os
import subprocess
import sys

import numpy as np

from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEEDLES = ["tshirt", "shirts", "shorts", "short"]

CHILD = r"""
import sys
import torch
torch.set_num_threads(1)
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, init_distributed, make_mesh

rank, rdv, want_count = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
hay = open(sys.argv[4], "rb").read()
assert init_distributed("file://" + rdv, world_size=2, rank=rank) == 2
mesh = make_mesh(["cpu"] * 8, data=8)
assert mesh.world_size == 2 and mesh.ranks.reshape(-1).tolist() == [0] * 4 + [1] * 4
m = ac.build([(n, i) for i, n in enumerate(sys.argv[5].split(","))])
for inner in ("pallas", "xla"):
    eng = DistributedAcEngine(m, mesh, inner=inner)
    assert len(eng.shards()) == 4
    st = eng.stage(hay)
    assert sorted({i for i, _ in st.blocks}) == list(range(4 * rank, 4 * rank + 4))
    got = eng.count(st)
    assert got == want_count, (rank, inner, got, want_count)
    assert eng.contains_any(st) is True
    assert eng.contains_any(b"zzz qqq " * 200) is False
    try:
        eng.matches_arrays(st)
        raise AssertionError("matches_arrays ran across processes")
    except NotImplementedError:
        pass
print(f"rank {rank}: global count {got} ok", flush=True)
# Leave the group before the interpreter exits: gloo's threads, torn down at
# exit instead, can abort the process (SIGABRT) after the checks passed.
torch.distributed.destroy_process_group()
"""


def test_two_process_distributed_count(tmp_path):
    rng = np.random.default_rng(13)
    frags = [n.encode() for n in NEEDLES] + [b"zzzz", b"qq xx", b"sh"]
    hay = b"".join(frags[i] for i in rng.integers(0, len(frags), 8000))
    m = ac.build([(n, i) for i, n in enumerate(NEEDLES)])
    want = CppAcEngine(m).count(np.frombuffer(hay, np.uint8))
    assert want == ac.count_matches(m, hay) > 0
    (tmp_path / "hay").write_bytes(hay)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", CHILD, str(rank), str(tmp_path / "rdv"), str(want),
             str(tmp_path / "hay"), ",".join(NEEDLES)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(2)
    ]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        assert f"rank {rank}: global count {want} ok" in out
