"""What decides ``correct``: a sound run passes, the control fails, and a
run with the timed path broken underneath comes out not correct, once for
each fault a cell can have (``faults.py``).  One card: no exchange between
cards to leave out."""

import json
import os
import subprocess
import sys

import pytest

from perfbench import harness, reference
from perfbench.tests.tiny import REPO, run_cell, tiny_root

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]
SEED = 2**31 + 99


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    r = run_cell(root, cell, SEED)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r
    assert r["checks"] == {"max_abs_err": {"value": 0, "limit": 0},
                           "wrong_answers": {"value": 0, "limit": 0}}
    assert r["forbidden"] == []


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    """The reference with occurrences across 64-byte cuts lost (the chip
    runs the control at the cell's size with 4 KiB cuts, ``control.py``)
    lands above the limit 0 on every document of three seeds."""
    c = harness.load_cell(root, cell)
    needles = [n.encode() for n in c.config["needles"]]
    for seed in (1, 2, 3):
        for doc in harness.make_documents(c, seed, "cpu"):
            gap = abs(reference.count(doc, needles, "cpu")
                      - reference.count(doc, needles, "cpu", cut=64))
            assert gap > 0


def test_control_script_runs(root):
    out = subprocess.run([sys.executable, os.path.join(root, "perfbench", "control.py"),
                          "--workload", CELLS[-1], "--seeds", "4,5,6",
                          "--cut", "64", "--device", "cpu"],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.path.dirname(root),
                              "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    least = int(out.stdout.strip().splitlines()[-1].split("max_abs_err over 3 seeds ")[1]
                .split()[0])
    assert least > 0


FAULTS = [(cell, f) for cell in CELLS for f in ("altered", "half", "unchanged", "stale")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_under_the_timed_path_is_not_correct(root, cell, fault):
    r = run_cell(root, cell, SEED, fault=fault)
    assert not r["correct"], json.dumps(r)
    assert r["failed"] >= 1 and r["checks"]["max_abs_err"]["value"] > 0
