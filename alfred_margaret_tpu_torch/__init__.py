"""alfred_margaret_tpu_torch: the PyTorch and CUDA port of alfred_margaret_tpu.

Counts, tests for and lists the Aho-Corasick matches of a needle set over a
corpus staged on an NVIDIA Hopper GPU, through CUDA kernels written by hand
for ``sm_90a``, in three tiers by needle-set size: bitap (shift-AND)
registers for small sets, the dense byte-class DFA table, and the 16-bit
three-tier comb16 table, with its stride-2 containsAny screen, for sets of
about 30 to 150 needles that overflow the dense table.  Module names mirror
the JAX package's, which stays the reference the port is tested against.
This package imports ``torch`` and nothing of ``jax`` or of the JAX package:
the host layers it needs (automaton builder, host C++ engine, case and UTF-8
helpers, corpus synthesis) are its own copies, pinned to the originals by
the tests.

Every entry point runs on ``device="cuda"`` unless the caller asks for
``"cpu"``, where the kernels' plain torch versions run (the tests use
them); without a CUDA device, ``"cuda"`` raises.
"""

from .engine import MatchEngine
from .ops.comb_scan import make_engine
from .searcher import Searcher
from .utils.case import CASE_SENSITIVE, IGNORE_CASE, CaseSensitivity
from .utils.device import toolchain_report

__all__ = [
    "CASE_SENSITIVE",
    "IGNORE_CASE",
    "CaseSensitivity",
    "MatchEngine",
    "Searcher",
    "make_engine",
    "toolchain_report",
]
