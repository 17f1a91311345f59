"""Corpus bytes of every query completed in the window over the window's
seconds, in GB/s (10^9 bytes)."""


def read(window):
    if not window.ops:
        return None
    return sum(op.n_bytes for op in window.ops) / window.seconds / 1e9
