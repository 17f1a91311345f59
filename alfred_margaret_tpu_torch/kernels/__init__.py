"""Hand-written CUDA kernels of the port, their plain torch versions and the
nvcc build.  Nothing here compiles or imports a GPU toolchain at import time."""

from .bitap_contains import (
    bitap_contains,
    bitap_contains_plain,
    bitap_presence,
    bitap_presence_plain,
)
from .bitap_count import bitap_count, bitap_count_plain
from .comb16 import comb16_contains, comb16_contains_plain, comb16_count, comb16_count_plain
from .dense_contains import dense_contains, dense_contains_plain
from .dense_count import dense_count, dense_count_plain
from .filter_contains import filter_contains, filter_contains_plain
from .matchbits import matchbits, matchbits_plain

#: Every kernel wrapper; each keeps its own ``launches`` count.
WRAPPERS = (
    dense_count, bitap_count, dense_contains, bitap_contains, matchbits, bitap_presence,
    comb16_count, comb16_contains, filter_contains,
)

__all__ = [
    "WRAPPERS",
    "bitap_contains",
    "bitap_contains_plain",
    "bitap_count",
    "bitap_count_plain",
    "bitap_presence",
    "bitap_presence_plain",
    "comb16_contains",
    "comb16_contains_plain",
    "comb16_count",
    "comb16_count_plain",
    "dense_contains",
    "dense_contains_plain",
    "dense_count",
    "dense_count_plain",
    "filter_contains",
    "filter_contains_plain",
    "matchbits",
    "matchbits_plain",
]
