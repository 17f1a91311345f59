"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared whole:
the port's name begins with the JAX package's)."""

import json
import subprocess
import sys

from perfbench.tests.tiny import REPO

CHECK = r"""
import glob, importlib.util, json, os, runpy, sys
sys.path.insert(0, REPO)
top = lambda: {m.split(".")[0] for m in list(sys.modules)}
runpy.run_path(os.path.join(REPO, "perfbench", "run.py"), run_name="perfbench_run")
import perfbench.reference, perfbench.corpus, perfbench.stats, perfbench.work
after_reference = top()
from perfbench import harness
for kind in ("end_to_end", "metrics", "ops", "loops"):
    for path in sorted(glob.glob(os.path.join(REPO, "perfbench", kind, "*.py"))):
        harness.module(kind, os.path.basename(path)[:-3])
for sub in ("configs", "traffic"):
    for path in glob.glob(os.path.join(REPO, "perfbench", sub, "*.json")):
        json.load(open(path))
import perfbench.control, perfbench.program, perfbench.tracing
print(json.dumps({"all": sorted(top()), "reference": sorted(after_reference)}))
"""


def test_no_jax_and_a_reference_free_of_the_program():
    out = subprocess.run([sys.executable, "-c", CHECK.replace("REPO", repr(REPO))],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("jax", "jaxlib", "flax", "alfred_margaret_tpu"):
        assert name not in got["all"], name
    assert "alfred_margaret_tpu_torch" not in got["reference"]
    assert "alfred_margaret_tpu_torch" not in got["all"]  # imported only inside a run
