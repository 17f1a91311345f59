"""A resident count: each document staged once in set-up by
``Searcher.stage``, then ``count_matches`` of the staged handle, which
rescans it on the card every time."""

from perfbench import program, reference

#: The span the window opens around each call.
SPAN = "query"


def prepare(config, docs, device):
    searcher = program.build_searcher(config, device)
    staged = [searcher.stage(d) for d in docs]
    return lambda i: searcher.count_matches(staged[i])


def expected(config, doc, device):
    return reference.count(doc, [n.encode() for n in config["needles"]], device)


def error(answer, want):
    return abs(int(answer) - int(want))
