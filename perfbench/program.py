"""The system under test: the one place the benchmark builds the port.

An operation file (``perfbench/ops/<op>.py``) builds its searcher through
:func:`build_searcher`, looked up on this module at call time, so that a
test can put a broken program in its place (``tests/faults.py``).
"""

from __future__ import annotations


def build_searcher(config: dict, device):
    """The port's ``Searcher`` for the configuration's needles and case."""
    from alfred_margaret_tpu_torch.searcher import Searcher
    from alfred_margaret_tpu_torch.utils.case import CaseSensitivity

    case = CaseSensitivity.from_json(config["case"])
    return Searcher.build(case, config["needles"], device=device)


__all__ = ["build_searcher"]
