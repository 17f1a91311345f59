"""alfred_margaret_tpu_torch: the PyTorch and CUDA port of alfred_margaret_tpu.

Counts all Aho-Corasick matches of a needle set over a corpus staged on an
NVIDIA Hopper GPU, through two CUDA kernels written by hand for ``sm_90a``:
the bitap (shift-AND) count kernel for small needle sets and the dense
byte-class DFA count kernel for the rest.  Module names mirror the JAX
package's, which stays the reference the port is tested against.  This
package imports ``torch`` and never ``jax``; the automaton builder, the host
C++ engine and the case/UTF-8 helpers are shared with the JAX package by
import, since those modules are jax-free.

Devices are explicit: every engine takes ``device="cuda"`` or ``"cpu"``.  On
the CPU the kernels' plain torch versions run; the tests use them.
"""

from alfred_margaret_tpu.utils.case import CASE_SENSITIVE, IGNORE_CASE, CaseSensitivity

from .engine import MatchEngine
from .ops.comb_scan import make_engine
from .searcher import Searcher
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
