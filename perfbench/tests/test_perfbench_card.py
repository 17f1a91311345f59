"""``run.py`` on and off the card.  Off it, the run fails and prints no
result; on it (``gpu``-marked, skipped without a card), a short run of the
first cell is correct and says which card it ran on."""

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench.tests.tiny import REPO

RUN = os.path.join(REPO, "perfbench", "run.py")


def _run(*args, timeout=600):
    return subprocess.run([sys.executable, RUN, *args], capture_output=True, text=True,
                          cwd=REPO, timeout=timeout)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run("--workload", "ref3.count.resident", "--seed", str(2**31 + 5),
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", ["0", "1"])
def test_short_run_on_the_card(cuda, trace):
    out = _run("--workload", "ref3.count.resident", "--seed", str(2**31 + 11),
               "--seconds", "2", "--trace", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["kind"] == torch.cuda.get_device_name()
    assert list(r)[-1] == "checks"
    if trace == "1":
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert 0 < r["metrics"]["count_roofline_pct"]["value"] <= 105
    else:
        assert set(r["metrics"]) == {"scan_GBps", "query_ms_p95", "setup_s"}
