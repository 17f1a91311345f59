"""``BENCHMARK.json`` within the benchmark's contract: its keys, names,
units and lengths, and every file it names present."""

import json
import os
import re

import pytest

from perfbench import harness
from perfbench.tests.tiny import REPO

PATH = os.path.join(REPO, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATHS = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    assert os.path.getsize(PATH) <= 64 << 10
    with open(PATH) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATHS.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(REPO, p))
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    for w in bench["command"]:
        if "/" in w or w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in bench["paths"]), w
            assert os.path.isfile(os.path.join(REPO, w))
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(REPO, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_workloads(bench):
    ws = bench["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        path = os.path.join(REPO, "perfbench", "traffic", w["traffic"] + ".json")
        with open(path) as f:
            mix = json.load(f)
        assert harness.module("ops", mix["op"]).SPAN and harness.module("loops", mix["loop"])


def _cells(metric, bench):
    return metric.get("workloads", [w["name"] for w in bench["workloads"]])


def test_metrics(bench):
    e2e, pl = bench["end_to_end"], bench["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(pl) <= 128
    names = [m["name"] for m in e2e + pl]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e + pl:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(_cells(m, bench)) <= cells
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert os.path.isfile(os.path.join(REPO, "perfbench", "end_to_end", m["name"] + ".py"))
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25
    by_name = {m["name"]: m for m in e2e}
    layers = {}
    for m in pl:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in by_name
        # Every cell that reads the metric reports the metric it moves.
        assert set(_cells(m, bench)) <= set(_cells(by_name[m["moves"]], bench))
        assert harness.module("metrics", m["name"]).read  # its file, or its base's
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        assert any(w in _cells(m, bench) for m in e2e if m["name"] != "setup_s")
        assert any(w in _cells(m, bench) for m in pl)


def test_layers_are_named_in_perf_md(bench):
    with open(os.path.join(REPO, "PERF.md")) as f:
        perf = f.read()
    for layer in {m["layer"] for m in bench["per_layer"]}:
        assert f"| {layer} |" in perf, layer
