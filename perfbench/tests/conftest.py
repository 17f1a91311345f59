"""The small sizes of the mixes that ``tiny.TINY`` does not list: a mix
that is a field-for-field copy of another but for its operation takes that
mix's small sizes, so every cell runs at a CPU test's size."""

from perfbench.tests import tiny

tiny.TINY.setdefault("resident_keyed", tiny.TINY["resident"])
