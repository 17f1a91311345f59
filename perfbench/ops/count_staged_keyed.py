"""A resident count checked by the keyed reference: ``count_staged``'s
program, span and check, with the expected answer from
``reference_keyed``, which makes one pass per needle length rather than
one per needle (the configurations with many needles)."""

from perfbench import reference_keyed
from perfbench.ops.count_staged import SPAN, error, prepare


def expected(config, doc, device):
    return reference_keyed.count(doc, [n.encode() for n in config["needles"]], device)


__all__ = ["SPAN", "error", "expected", "prepare"]
