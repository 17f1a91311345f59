"""The port's command-line tools and the reference protocol against the JAX
package's.

``python -m alfred_margaret_tpu_torch.cli``: ``dump-automaton`` prints
byte for byte what the JAX package's ``debug_build_dot`` prints, with the
same usage text and exit codes; ``count-matches`` (``bench/countmatches.py``)
prints the reference protocol (tab-separated nanoseconds per round, a
trailing tab, one line per file; the total count on stderr's last line) for
each of the JAX engine names, mapped to the port's engines, with the JAX
``countmatches``'s count and ``count_naive``'s.  The bench data files
(``parse_bench_file``, ``write_bench_file``) give the JAX functions' bytes;
``driver.run_benchmark`` runs the port's ``count-matches`` on the CPU, and
``report.summarize`` of its ``.stats`` is the JAX one's.  Tolerance: exact
equality.  Everything runs with ``device="cpu"`` (the kernels' plain
versions); without it the entry points raise on a host without CUDA.
"""

import os
import subprocess
import sys

import pytest
import torch

from alfred_margaret_tpu.bench import countmatches as jcountmatches
from alfred_margaret_tpu.bench import dataformat as jdata
from alfred_margaret_tpu.bench import report as jreport
from alfred_margaret_tpu.models import ac as jac

from alfred_margaret_tpu_torch import cli
from alfred_margaret_tpu_torch.bench import countmatches, dataformat, driver, report
from alfred_margaret_tpu_torch.bench.naive import count_naive

from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = ["tshirt", "shirts", "shorts"]

DOT_SETS = [
    ("bench", BENCH),
    ("ab_bc", ["ab", "bc"]),
    ("quote", ['a"b', '"', "x\"y\"z"]),
    ("non_ascii", ["İstanbul", "ß"]),
    ("duplicates", ["ab", "ab", "b", "b", "abc"]),
]


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if not k.startswith("AMT_")}
    env.update(kw)
    return env


@pytest.mark.parametrize("name,needles", DOT_SETS, ids=[c[0] for c in DOT_SETS])
def test_dump_automaton_equals_jax(name, needles, capsys):
    assert cli.main(["dump-automaton", *needles]) == 0
    out = capsys.readouterr().out
    assert out == jac.debug_build_dot(needles)
    assert out.startswith("digraph {\n") and out.endswith("}\n")


def test_dump_automaton_module_equals_jax_module():
    """The acceptance line: the two ``python -m ... cli dump-automaton``
    print the same bytes."""
    outs = []
    for pkg in ("alfred_margaret_tpu_torch", "alfred_margaret_tpu"):
        proc = subprocess.run([sys.executable, "-m", f"{pkg}.cli", "dump-automaton", *BENCH],
                              cwd=REPO, env=_env(JAX_PLATFORMS="cpu"), capture_output=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout)
    assert outs[0] == outs[1] and outs[0].count(b" -> ") > 10


@pytest.mark.parametrize("argv,err", [
    ([], None), (["dump-automaton"], "usage: dump-automaton NEEDLE [NEEDLE...]"),
    (["frobnicate"], "unknown command 'frobnicate'"),
])
def test_usage_and_exit_codes(argv, err, capsys):
    assert cli.main(argv) == 2
    out, stderr = capsys.readouterr()
    if err is None:
        assert "dump-automaton" in out and "count-matches" in out
    else:
        assert err in stderr


@pytest.fixture
def bench_files(tmp_path):
    """Two bench-format files (UTF-8 and UTF-16LE) and their naive count."""
    sets = [(BENCH, dataformat.synth_corpus(BENCH, 1 << 15, hit_fraction=0.05, seed=3).decode(),
             "utf-8"),
            (["ab", "bc", "b", "b"], "abcab ßbc " * 700 + "ab", "utf-16-le")]
    paths, naive = [], 0
    for i, (needles, hay, enc) in enumerate(sets):
        paths.append(str(tmp_path / f"data{i}.txt"))
        dataformat.write_bench_file(paths[-1], needles, hay, encoding=enc)
        naive += count_naive(needles, hay)
    return paths, naive


def _protocol(out: str, err: str, n_files: int, rounds: int) -> int:
    lines = out.split("\n")
    assert lines[-1] == "" and len(lines) == n_files + 1
    for line in lines[:-1]:
        fields = line.split("\t")
        assert fields[-1] == "" and len(fields) == rounds + 1
        assert all(int(t) > 0 for t in fields[:-1])
    return int(err.strip().splitlines()[-1])


@pytest.mark.parametrize("engine", countmatches.ENGINES)
def test_count_matches_equals_jax(engine, bench_files, monkeypatch, capsys):
    paths, naive = bench_files
    monkeypatch.setenv("AMT_ROUNDS", "2")
    want = {}
    for jengine in ("cpp", "python"):
        monkeypatch.setenv("AMT_ENGINE", jengine)
        assert jcountmatches.main(paths) == 0
        out, err = capsys.readouterr()
        want[jengine] = _protocol(out, err, 2, 2)
    monkeypatch.setenv("AMT_ENGINE", engine)
    assert cli.main(["count-matches", "--device", "cpu", *paths]) == 0
    out, err = capsys.readouterr()
    assert _protocol(out, err, 2, 2) == want["cpp"] == want["python"] == naive > 0


def test_count_matches_engines_and_device(bench_files, monkeypatch, capsys):
    """The port's engine behind each JAX name, an unknown name, and the
    device: ``cuda`` (the default) raises without CUDA, whatever the
    engine."""
    from alfred_margaret_tpu_torch.engine import MatchEngine
    from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine
    from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine
    from alfred_margaret_tpu_torch.ops.xla_scan import XlaAcEngine

    paths, naive = bench_files
    hay = dataformat.parse_bench_file(paths[0])[1].encode()
    used = {}
    for name, cls in (("device", DenseAcEngine), ("xla", XlaAcEngine), ("cpp", CppAcEngine)):
        monkeypatch.setattr(cls, "count", lambda self, text, name=name: used.setdefault(name, 7))
    monkeypatch.setattr(MatchEngine, "count", lambda self, text, case: used.setdefault("auto", 7))
    for name in ("device", "xla", "cpp", "auto"):
        assert countmatches.count_with_engine(BENCH, hay, name, "cpu") == 7
    assert set(used) == {"device", "xla", "cpp", "auto"}
    used.clear()
    assert countmatches.count_with_engine(BENCH, hay, "pallas", "cpu") == 7  # the JAX name
    assert set(used) == {"device"}
    monkeypatch.setenv("AMT_ENGINE", "tpu")
    assert countmatches.main(["--device", "cpu", *paths]) == 2
    assert "unknown AMT_ENGINE 'tpu'" in capsys.readouterr().err
    if not torch.cuda.is_available():
        for engine in ("auto", "cpp"):
            monkeypatch.setenv("AMT_ENGINE", engine)
            with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
                cli.main(["count-matches", *paths])


def test_count_matches_module_in_a_process(bench_files):
    """``python -m alfred_margaret_tpu_torch.cli count-matches`` in a fresh
    interpreter, as ``bench/driver.py`` runs it."""
    paths, naive = bench_files
    proc = subprocess.run(
        [sys.executable, "-m", "alfred_margaret_tpu_torch.cli", "count-matches", "--device",
         "cpu", *paths], cwd=REPO, env=_env(AMT_ENGINE="auto", AMT_ROUNDS="3"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert _protocol(proc.stdout, proc.stderr, 2, 3) == naive


@pytest.mark.parametrize("encoding", ["utf-8", "utf-16-le"])
def test_bench_files_equal_jax(tmp_path, encoding):
    needles = ["tshirt", "café", "日本", "x"]
    hay = "a tshirt café\n\nsecond paragraph 日本\r\nend"
    got, want = tmp_path / "port.txt", tmp_path / "jax.txt"
    dataformat.write_bench_file(str(got), needles, hay, encoding=encoding)
    jdata.write_bench_file(str(want), needles, hay, encoding=encoding)
    assert got.read_bytes() == want.read_bytes()
    for path in (got, want):
        parsed = dataformat.parse_bench_file(str(path))
        assert parsed == jdata.parse_bench_file(str(path))
        assert parsed == (needles, hay.replace("\r\n", "\n"))
    crlf = tmp_path / "crlf.txt"
    crlf.write_bytes("ab\r\n\r\ncd\r\nef".encode(encoding))
    assert dataformat.parse_bench_file(str(crlf)) == jdata.parse_bench_file(str(crlf)) == (
        ["ab"], "cd\nef")


def test_driver_and_report_on_the_port(tmp_path, bench_files, monkeypatch, capsys):
    """``driver.run_benchmark`` of the port's ``count-matches`` on the CPU,
    2 runs: the counts agree between runs, ``.results`` holds the total and
    ``.stats`` two blocks of two lines; ``report.summarize`` of it is the JAX
    one's."""
    paths, naive = bench_files
    data = tmp_path / "data"
    data.mkdir()
    for p in paths:
        os.replace(p, data / os.path.basename(p))
    (data / "notes.md").write_text("not a data file")
    monkeypatch.setenv("AMT_ENGINE", "auto")
    monkeypatch.setenv("AMT_ROUNDS", "2")
    monkeypatch.chdir(REPO)
    prefix = str(tmp_path / "port")
    driver.run_benchmark(
        f"{sys.executable} -m alfred_margaret_tpu_torch.cli count-matches --device cpu",
        prefix, str(data), runs=2)
    assert "Found 2 files to benchmark." in capsys.readouterr().out
    assert open(prefix + ".results").read() == f"{naive}\n"
    blocks = [b for b in open(prefix + ".stats").read().split("\n\n") if b.strip()]
    assert len(blocks) == 2 and all(len(b.strip().splitlines()) == 2 for b in blocks)
    got = report.summarize(prefix + ".stats")
    assert got == jreport.summarize(prefix + ".stats") and " ± " in got
    with pytest.raises(RuntimeError, match="failed with"):
        driver.run_benchmark(f"{sys.executable} -c exit(3)", prefix, str(data), 1)
