"""One run of one cell: set-up, warm-up, the window, the check, the line.

Everything that belongs to one configuration, traffic mix, operation, loop
or metric is a file of its own, found by the name that ``BENCHMARK.json``
or the mix gives:

* a cell's configuration is the JSON file its ``configs`` entry names
  (``perfbench/configs/<config>.json``): the needles, the case mode, the
  guarantee, the source;
* its traffic mix is ``perfbench/traffic/<traffic>.json``, data that this
  module reads: the documents (``bytes``, ``documents``, the word draw),
  the operation ``op``, the loop ``loop``, ``warmup_ops`` and the
  deployment's runtime settings ``env`` (``AMT_*``);
* the operation is ``perfbench/ops/<op>.py``: ``SPAN``, the name of the
  span around each call; ``prepare(config, docs, device)``, which builds the
  program and returns the call ``f(d)`` on document ``d``;
  ``expected(config, doc, device)``, the reference's answer; and
  ``error(answer, expected)``, 0 where the answer is right;
* the loop is ``perfbench/loops/<loop>.py``: ``drive(call, sizes, seconds,
  span, window)``, which opens the span ``window`` around the window and
  the span ``span`` around each call, and records each operation with
  ``window.record``;
* each end-to-end metric is ``perfbench/end_to_end/<name>.py`` and each
  per-layer metric ``perfbench/metrics/<name>.py``: a ``read`` function
  that returns the number, or None where it finds nothing to read.  A
  metric ``<base>.<part>`` with no file of its own is read by
  ``<base>.py``: one quantity split by the end-to-end metric it moves.

The program is imported only after the mix's settings are in the
environment (``utils/config.py`` reads them at import), and only inside
:func:`run`.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))

#: Top-level modules that no run may hold once its window has closed: the
#: JAX package and JAX itself (names compared whole, since the port's name
#: begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "alfred_margaret_tpu")


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """The top-level names of ``FORBIDDEN`` that ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# -- finding a cell's files by name ----------------------------------------------


@dataclass
class Cell:
    entry: dict  # the cell's entry of ``workloads``
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    its mix and the metrics it reports.  Raises ``KeyError`` for a name the
    file does not have."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[entry["config"]]["file"]))
    mix = _load_json(os.path.join(root, "perfbench", "traffic", entry["traffic"] + ".json"))
    return Cell(
        entry=entry, config=config, mix=mix,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def module(kind: str, name: str):
    """The module ``perfbench/<kind>/<name>.py``, or, for a dotted name
    with no file of its own, that of the name before its last dot."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path) and "." in name:
        return module(kind, name.rsplit(".", 1)[0])
    mod_name = "perfbench_%s_%s" % (kind, name.replace(".", "_").replace("-", "_"))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None or not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str) -> Callable:
    """The ``read`` function of metric ``name`` (``kind`` ``end_to_end`` or
    ``metrics``)."""
    return module(kind, name).read


def apply_env(mix: dict) -> None:
    """The deployment's runtime settings: every ``AMT_*`` variable the mix
    does not set is removed, so that nothing of the caller's environment
    changes what is measured."""
    for k in [k for k in os.environ if k.startswith("AMT_")]:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in mix.get("env", {}).items()})


# -- the data and the window ------------------------------------------------------


def make_documents(cell: Cell, seed: int, device) -> List[bytes]:
    """The mix's documents as host bytes, each drawn whole from the seed on
    ``device`` and copied to the host."""
    from perfbench import corpus

    mix, needles = cell.mix, [n.encode() for n in cell.config["needles"]]
    docs = []
    for i in range(int(mix["documents"])):
        buf = corpus.generate(int(mix["bytes"]), needles, corpus.stream_seed(seed, i),
                              hit_fraction=float(mix["hit_fraction"]),
                              word_min=int(mix["word_min"]), word_max=int(mix["word_max"]),
                              device=device)
        docs.append(corpus.to_host_bytes(buf))
        del buf
    return docs


@dataclass
class Op:
    start: float
    end: float
    n_bytes: int
    doc: int
    answer: Any


@dataclass
class Window:
    setup_s: float
    start: float = 0.0
    end: float = 0.0
    ops: List[Op] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def record(self, start: float, end: float, n_bytes: int, doc: int, answer) -> None:
        self.ops.append(Op(start, end, n_bytes, doc, answer))


# -- the traced run's readers ------------------------------------------------------


@dataclass
class TracedRun:
    """What a per-layer reader reads: the trace, the window and the card."""

    trace: object
    window: Window
    kind: str
    peaks: dict

    def peak(self, key: str) -> Optional[float]:
        return self.peaks.get(self.kind, {}).get(key)

    def idle_pct(self) -> Optional[float]:
        w = self.trace.window()
        if w is None or not self.trace.device or w[1] <= w[0]:
            return None
        return 100.0 * (1.0 - self.trace.busy(*w) / (w[1] - w[0]))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({type(e).__name__})"
    return out


# -- one run ---------------------------------------------------------------------


def run(root: str, name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
        t0: Optional[float] = None) -> dict:
    """One run of cell ``name``; returns the result line's object.  The
    caller has checked that the cell's cards are there."""
    t0 = time.perf_counter() if t0 is None else t0

    def stamp(step: str) -> None:
        log(f"set-up: {step} by {time.perf_counter() - t0:.3f} s")

    cell = load_cell(root, name)
    mix, config = cell.mix, cell.config
    apply_env(mix)
    import torch

    from perfbench import tracing
    from perfbench.stats import percentile

    op = module("ops", mix["op"])
    loop = module("loops", mix["loop"])
    cuda = torch.device(device).type == "cuda"
    log(f"cell {name} seed {seed} seconds {seconds} trace {int(trace)} device {device}")
    stamp("imports")
    if cuda:
        torch.empty(1, device=device)
        torch.cuda.synchronize()
        stamp("CUDA context")

    docs = make_documents(cell, seed, device)
    sizes = [len(d) for d in docs]
    stamp(f"{len(docs)} document(s) of {sizes[0]} bytes made")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    call = op.prepare(config, docs, device)
    stamp(f"program built, {mix['op']} prepared")
    for i in range(int(mix["warmup_ops"])):
        call(i % len(docs))
    stamp(f"{mix['warmup_ops']} warm-up operation(s)")

    window = Window(setup_s=time.perf_counter() - t0)
    out_dir = os.path.join(root, "perfbench_out")
    trace_path = os.path.join(out_dir, f"{name}.trace.json") if trace else None
    if trace_path:
        os.makedirs(out_dir, exist_ok=True)
    with tracing.profiled(trace_path):
        loop.drive(call, sizes, seconds, op.SPAN, window)
    log(f"window: {len(window.ops)} operations in {window.seconds:.6f} s")
    if window.ops:
        ms = [(o.end - o.start) * 1e3 for o in window.ops]
        log("window: operation ms min %.4f median %.4f p95 %.4f max %.4f"
            % (min(ms), percentile(ms, 50), percentile(ms, 95), max(ms)))

    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del call
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    want = {d: op.expected(config, docs[d], device) for d in sorted({o.doc for o in window.ops})}
    errors = [op.error(o.answer, want[o.doc]) for o in window.ops]
    checks = {
        "max_abs_err": {"value": max(errors, default=0), "limit": 0},
        "wrong_answers": {"value": sum(e != 0 for e in errors), "limit": 0},
    }
    correct = (checks["max_abs_err"]["value"] <= 0 and checks["wrong_answers"]["value"] <= 0
               and len(window.ops) >= 1)
    log(f"reference: {want} in {time.perf_counter() - t:.3f} s")

    e2e = {m["name"]: reader("end_to_end", m["name"])(window) for m in cell.end_to_end}
    for k, v in e2e.items():
        log(f"end-to-end{' (traced)' if trace else ''}: {k} = {v!r}")
    result = {"correct": bool(correct), "attempted": len(window.ops),
              "failed": checks["wrong_answers"]["value"], "metrics": {}}
    result["device"] = device_info = {
        "platform": "gpu" if cuda else torch.device(device).type,
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": int(cell.entry["chips"]),
        "memory_peak_bytes": int(memory_peak),
    }
    if trace:
        traced = TracedRun(trace=tracing.Trace.load(trace_path), window=window,
                           kind=device_info["kind"],
                           peaks=_load_json(os.path.join(HERE, "peaks.json")))
        lo, hi = traced.trace.window()
        device_info["busy_s"] = traced.trace.busy(lo, hi) * 1e-6
        device_info["window_s"] = (hi - lo) * 1e-6
        for m in cell.per_layer:
            v = reader("metrics", m["name"])(traced)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": traced.trace.device_ops(lo, hi),
                               "idle_gaps": traced.trace.idle_breakdown(lo, hi)}
        if cuda:
            log(f"card and power limit: {power_limit()}")
    else:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end if e2e[m["name"]] is not None}
    result["checks"] = checks
    return result


__all__ = ["Cell", "FORBIDDEN", "Op", "TracedRun", "Window", "forbidden_modules",
           "load_cell", "make_documents", "module", "reader", "run"]
