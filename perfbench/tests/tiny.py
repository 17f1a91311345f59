"""A copy of the benchmark at sizes a CPU test can run.

``tiny_root(tmp)`` copies ``BENCHMARK.json`` and ``perfbench/`` into
``tmp`` and shrinks every traffic mix (three resident corpora of 1 MiB,
three ingest documents of 1 MiB, streamed ones of 3 MiB + 12,345 bytes in
chunks of 1 MiB); ``run_cell`` runs one cell there in a fresh interpreter
on the CPU through ``harness.run``, past ``run.py``'s look for a card, the
program imported from the repository.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = {
    "resident": {"bytes": 1 << 20, "documents": 3, "warmup_ops": 3},
    "ingest_stream": {"bytes": (3 << 20) + 12345, "warmup_ops": 1,
                      "env": {"AMT_STREAM_CHUNK_MB": "1"}},
    "ingest_whole": {"bytes": 1 << 20, "documents": 3, "warmup_ops": 1},
}


def tiny_root(tmp) -> str:
    root = str(tmp)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "perfbench"), os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, over in TINY.items():
        path = os.path.join(root, "perfbench", "traffic", name + ".json")
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            mix = json.load(f)
        mix.update(over)
        with open(path, "w") as f:
            json.dump(mix, f)
    return root


def run_cell(root: str, cell: str, seed: int, *, seconds: float = 0.5, trace: bool = False,
             fault: str = "") -> dict:
    """The result of one CPU run of ``cell`` in ``root`` (with ``fault``
    planted under the timed path, see ``faults.py``)."""
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{root!r}, {REPO!r}]\n"
        "from perfbench import harness, program\n"
        f"if {fault!r}:\n"
        "    from perfbench.tests import faults\n"
        f"    faults.install(program, {fault!r})\n"
        f"r = harness.run({root!r}, {cell!r}, {seed}, {seconds}, {trace}, device='cpu')\n"
        "r['forbidden'] = harness.forbidden_modules()\n"
        "print(json.dumps(r))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("AMT_")}
    env["OMP_NUM_THREADS"] = "2"  # several of these run at once under xdist
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
