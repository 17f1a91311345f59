"""Command-line tools of the port.

``dump-automaton``: emit the trie + failure links of an Aho-Corasick
automaton as Graphviz Dot, mirroring the reference's ``dump-automaton``
executable (``app/dump-automaton/Main.hs:9-19``):

    python -m alfred_margaret_tpu_torch.cli dump-automaton one two three > a.dot

``count-matches``: the benchmark binary (see ``bench.countmatches``), on the
card unless ``--device cpu`` is given:

    python -m alfred_margaret_tpu_torch.cli count-matches [--device cpu] FILE...
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    cmd, *rest = argv
    if cmd == "dump-automaton":
        if not rest:
            print("usage: dump-automaton NEEDLE [NEEDLE...]", file=sys.stderr)
            return 2
        from .models.ac import debug_build_dot

        sys.stdout.write(debug_build_dot(rest))
        return 0
    if cmd == "count-matches":
        from .bench.countmatches import main as cm_main

        return cm_main(rest)
    print(f"unknown command {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
