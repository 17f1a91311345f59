"""Faults planted under the timed path, for the test that the check sees
them: each wraps the searcher that ``program.build_searcher`` returns.

* ``altered``: every answer one more than the program's;
* ``half``: the count of the first half of the text, doubled (half of the
  work left out, the rest scaled up);
* ``unchanged``: the count's state returned as it started, 0;
* ``stale``: the first operation's answer, every time after (a cached
  answer), which documents in turn tell apart.
"""

from __future__ import annotations


class Broken:
    def __init__(self, inner, fault: str):
        self.inner, self.fault, self.last = inner, fault, None

    def stage(self, text):
        return self.inner.stage(text)

    def count_matches(self, text) -> int:
        if self.fault == "altered":
            return self.inner.count_matches(text) + 1
        if self.fault == "half":
            data = bytes(getattr(text, "data", text))
            return 2 * self.inner.count_matches(data[: len(data) // 2])
        if self.fault == "unchanged":
            return 0
        if self.fault == "stale":
            if self.last is None:
                self.last = self.inner.count_matches(text)
            return self.last
        raise ValueError(f"unknown fault {self.fault!r}")


def install(program, fault: str) -> None:
    build = program.build_searcher
    program.build_searcher = lambda config, device: Broken(build(config, device), fault)
