"""Suffix-screen passes of the needle-grouped engine per query: the port's
``amt.group.screen`` spans that start in the traced window over the
window's operations.  The grouped engine opens one around each launch of
``screen_count``, its count where the needle set suits the screen, so it
reads 1 where that kernel counts every query.  None where the trace has no
such span (a program that counts with B9 or the groups' own passes)."""


def read(run):
    w = run.trace.window()
    if w is None or not run.window.ops:
        return None
    lo, hi = w
    n = sum(1 for a, _ in run.trace.spans.get("amt.group.screen", []) if lo <= a < hi)
    return n / len(run.window.ops) if n else None
