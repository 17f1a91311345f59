"""The share of the host's copies of the text made on the intra-op threads,
in %: of the union of the port's ``amt.stage.host`` spans inside the
traced window, the part that its ``amt.stage.host.split`` spans (a ring
slice copied by ``Tensor.copy_`` on several threads) cover.  None where
the window holds no such span."""

from perfbench.tracing import union


def _clipped(run, name, lo, hi):
    return union((max(a, lo), min(b, hi)) for a, b in run.trace.spans.get(name, []))


def read(run):
    w = run.trace.window()
    if w is None:
        return None
    lo, hi = w
    host = _clipped(run, "amt.stage.host", lo, hi)
    split = _clipped(run, "amt.stage.host.split", lo, hi)
    total = sum(b - a for a, b in host)
    if not split or total <= 0:
        return None
    # Both lists are disjoint and in order: one walk over the two.
    covered, i, j = 0.0, 0, 0
    while i < len(host) and j < len(split):
        (a, b), (c, d) = host[i], split[j]
        covered += max(0.0, min(b, d) - max(a, c))
        if b < d:
            i += 1
        else:
            j += 1
    return 100.0 * covered / total
