"""Case sensitivity mode.

TPU-native counterpart of the reference's two-valued enum
(``src/Data/Text/CaseSensitivity.hs:14-17``). Serializable to/from JSON with
the same string spellings the reference's aeson instances produce, so searcher
configs round-trip between the two implementations.
"""

from __future__ import annotations

import enum


class CaseSensitivity(enum.Enum):
    CASE_SENSITIVE = "CaseSensitive"
    IGNORE_CASE = "IgnoreCase"

    def to_json(self) -> str:
        return self.value

    @staticmethod
    def from_json(value: str) -> "CaseSensitivity":
        return CaseSensitivity(value)


CASE_SENSITIVE = CaseSensitivity.CASE_SENSITIVE
IGNORE_CASE = CaseSensitivity.IGNORE_CASE
