"""Host time a query spends while the card does nothing for it: the mean
query span less the card's busy time in the traced window over its
queries, in ms (window totals, for the reason ``count_roofline_pct``
gives)."""


def read(run):
    spans = run.trace.spans.get("query", [])
    w = run.trace.window()
    if not spans or w is None or not run.trace.device:
        return None
    span_us = sum(b - a for a, b in spans)
    return (span_us - run.trace.busy(*w)) / len(spans) / 1e3
