"""Passes of the needle-grouped engine per query: the port's
``amt.group.pass`` spans that start in the traced window over the window's
operations.  A pass is one count over the staged text: one fused B9 launch
over every group, or one group's own count where the engine runs its
groups one by one, so it reads 1 under B9 and the number of groups
otherwise.  None where the trace has no such span."""


def read(run):
    w = run.trace.window()
    if w is None or not run.window.ops:
        return None
    lo, hi = w
    n = sum(1 for a, _ in run.trace.spans.get("amt.group.pass", []) if lo <= a < hi)
    return n / len(run.window.ops) if n else None
