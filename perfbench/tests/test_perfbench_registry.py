"""The harness finds a configuration, a mix, an operation, a loop and a
metric by name: a later change adds them as new files and entries, editing
no file that is there."""

import hashlib
import json
import os

from perfbench.tests.tiny import run_cell, tiny_root

THROWAWAY_METRIC = '''"""Screens of the traced window, counted from the benchmark's spans."""


def read(run):
    return float(len(run.trace.spans.get("screen", []))) or None
'''

# An operation that is not a count: ``contains_any`` of a staged corpus.
THROWAWAY_OP = '''"""contains_any of a staged corpus."""

from perfbench import program, reference

SPAN = "screen"


def prepare(config, docs, device):
    searcher = program.build_searcher(config, device)
    staged = [searcher.stage(d) for d in docs]
    return lambda i: searcher.contains_any(staged[i])


def expected(config, doc, device):
    return reference.count(doc, [n.encode() for n in config["needles"]], device) > 0


def error(answer, want):
    return int(bool(answer) != bool(want))
'''

# A loop that is not the closed loop: each document once, twice over.
THROWAWAY_LOOP = '''"""Each document in turn, then again, whatever the seconds."""

import time

from perfbench.tracing import span as open_span


def drive(call, sizes, seconds, span, window):
    with open_span("window"):
        window.start = time.perf_counter()
        for d in list(range(len(sizes))) * 2:
            with open_span(span):
                t0 = time.perf_counter()
                got = call(d)
            window.record(t0, time.perf_counter(), sizes[d], d, got)
        window.end = time.perf_counter()
'''


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "perfbench")):
        for f in files:
            if "__pycache__" not in d:
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_throwaway_config_mix_and_metric(tmp_path):
    root = tiny_root(tmp_path)
    before = _digests(root)
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "configs", "tiny2.json"), "w") as f:
        json.dump({"name": "tiny2", "source": "a test", "case": "CaseSensitive",
                   "needles": ["ab", "bab", "zz"], "reduced": []}, f)
    with open(os.path.join(pb, "configs", "tiny_absent.json"), "w") as f:
        json.dump({"name": "tiny_absent", "source": "a test", "case": "CaseSensitive",
                   "needles": ["qqqqqqq", "zzzzzzzz"], "reduced": []}, f)
    with open(os.path.join(pb, "traffic", "tiny_mix.json"), "w") as f:
        json.dump({"bytes": 200_000, "documents": 2, "hit_fraction": 0.05, "word_min": 3,
                   "word_max": 9, "op": "count_staged", "loop": "closed", "warmup_ops": 1,
                   "env": {}}, f)
    with open(os.path.join(pb, "traffic", "tiny_screen.json"), "w") as f:
        json.dump({"bytes": 200_000, "documents": 2, "hit_fraction": 0.0, "word_min": 3,
                   "word_max": 9, "op": "tiny_contains", "loop": "tiny_twice",
                   "warmup_ops": 1, "env": {}}, f)
    with open(os.path.join(pb, "ops", "tiny_contains.py"), "w") as f:
        f.write(THROWAWAY_OP)
    with open(os.path.join(pb, "loops", "tiny_twice.py"), "w") as f:
        f.write(THROWAWAY_LOOP)
    with open(os.path.join(pb, "metrics", "screens_traced.py"), "w") as f:
        f.write(THROWAWAY_METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name in ("tiny2", "tiny_absent"):
        bench["configs"].append({"name": name, "source": "a test",
                                 "file": f"perfbench/configs/{name}.json", "reduced": [],
                                 "why": "a test"})
    bench["workloads"].append({"name": "tiny2.count", "config": "tiny2",
                               "traffic": "tiny_mix", "chips": 1, "why": "a test"})
    bench["workloads"].append({"name": "tiny_absent.screen", "config": "tiny_absent",
                               "traffic": "tiny_screen", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "scan_GBps" in (m["name"], m.get("moves")) or m["name"] == "query_ms_p95":
            m["workloads"].append("tiny2.count")
        if m["name"] == "scan_GBps":
            m["workloads"].append("tiny_absent.screen")
    bench["per_layer"].append({"name": "screens_traced", "unit": "1", "better": "higher",
                               "source": "program_span", "layer": "a test",
                               "moves": "scan_GBps", "workloads": ["tiny_absent.screen"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited

    plain = run_cell(root, "tiny2.count", 5, seconds=0.3)
    assert plain["correct"] and plain["attempted"] >= 1
    assert set(plain["metrics"]) == {"scan_GBps", "query_ms_p95", "setup_s"}
    traced = run_cell(root, "tiny2.count", 5, seconds=0.3, trace=True)
    assert traced["correct"] and traced["attempted"] >= 1
    # The device's readers find no device work on the CPU and leave their
    # metrics out.
    assert traced["metrics"] == {}
    # ``checks`` is the result's last key (``run_cell`` adds ``forbidden``).
    assert list(traced)[-2:] == ["checks", "forbidden"] and traced["forbidden"] == []

    # The new operation and loop: four screens, each answered False.
    screen = run_cell(root, "tiny_absent.screen", 6, seconds=0.3, trace=True)
    assert screen["correct"] and screen["attempted"] == 4 and screen["failed"] == 0
    assert screen["metrics"] == {"screens_traced": {"value": 4.0, "unit": "1"}}
