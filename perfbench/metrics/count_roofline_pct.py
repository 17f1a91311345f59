"""The count kernels' share of their roofline over the traced window: the
least time the card could take to read each query's corpus once at its
published bandwidth (``peaks.json``, ``work.count_bytes``), summed over the
window's queries, over the time in which a kernel ran in the window, in %.
Window totals and not each query's span: the profiler's device clock is
not aligned with the host's to the tens of microseconds, so a kernel can
seem to start before the span that launched it."""

from perfbench.work import count_bytes


def read(run):
    peak = run.peak("hbm_bytes_per_s")
    w = run.trace.window()
    if peak is None or w is None or not run.window.ops:
        return None
    kernel_us = run.trace.busy(*w, ("kernel",))
    if kernel_us <= 0:
        return None
    least_s = sum(count_bytes(op.n_bytes) for op in run.window.ops) / peak
    return 100.0 * least_s / (kernel_us * 1e-6)
