"""A one-shot count: ``count_matches`` of a host ``bytes`` document, which
the program stages (whole, or in ``StreamingScanner``'s chunks past its
budget) and scans in the same call."""

from perfbench import program, reference

#: The span the window opens around each call.
SPAN = "ingest"


def prepare(config, docs, device):
    searcher = program.build_searcher(config, device)
    return lambda i: searcher.count_matches(docs[i])


def expected(config, doc, device):
    return reference.count(doc, [n.encode() for n in config["needles"]], device)


def error(answer, want):
    return abs(int(answer) - int(want))
