"""alfred_margaret_tpu_torch: the PyTorch and CUDA port of alfred_margaret_tpu.

Counts, tests for and lists the Aho-Corasick matches of a needle set over a
corpus staged on an NVIDIA Hopper GPU, through CUDA kernels written by hand
for ``sm_90a``, in four tiers by needle-set size: bitap (shift-AND)
registers for small sets, the dense byte-class DFA table, the 16-bit
three-tier comb16 table, with its stride-2 containsAny screen, for sets of
about 30 to 150 needles that overflow the dense table, and the
needle-grouped engine for larger sets (a thousand needles and more), which
counts and answers containsAny over all its groups in one fused launch
each; ``parallel`` shards the scan over a mesh of devices (which may
repeat: eight shards on one card).  On top of the scans sit the
reference's operations: ``Searcher`` (with ``adopt_staged``, the needle-set
swap over a staged corpus), ``Replacer`` (priority-ordered sequential
replacement, each pass one extraction on the card and the splices on the
host) and ``Splitter``; ``boyer_moore`` and ``boyer_moore_ci`` are the
single-needle Boyer-Moore families, whose scans run on the host and whose
existence queries over large haystacks take ``Searcher`` on the device.
Module names mirror
the JAX package's, which stays the reference the port is tested against.
This package imports ``torch`` and nothing of ``jax`` or of the JAX package:
the host layers it needs (automaton builder, host C++ engine, case and UTF-8
helpers, corpus synthesis) are its own copies, pinned to the originals by
the tests.

Every entry point runs on ``device="cuda"`` unless the caller asks for
``"cpu"``, where the kernels' plain torch versions run (the tests use
them); without a CUDA device, ``"cuda"`` raises.
"""

from . import parallel
from .engine import MatchEngine
from .ops.comb_scan import make_engine
from .ops.grouped import GroupedAcEngine
from .searcher import Searcher
from .replacer import Payload, Replacer
from .splitter import Splitter
from .utils.case import CASE_SENSITIVE, IGNORE_CASE, CaseSensitivity
from .utils.device import toolchain_report

__all__ = [
    "CASE_SENSITIVE",
    "IGNORE_CASE",
    "CaseSensitivity",
    "GroupedAcEngine",
    "MatchEngine",
    "Payload",
    "Replacer",
    "Searcher",
    "Splitter",
    "make_engine",
    "parallel",
    "toolchain_report",
]
