"""Hand-written CUDA kernels of the port, their plain torch versions and the
nvcc build.  Nothing here compiles or imports a GPU toolchain at import time."""

from .bitap_count import bitap_count, bitap_count_plain
from .dense_count import dense_count, dense_count_plain

__all__ = ["bitap_count", "bitap_count_plain", "dense_count", "dense_count_plain"]
