"""Runtime configuration of the port.

A copy of ``alfred_margaret_tpu/utils/config.py`` with the knobs the port's
engine reads, overridable from the environment (prefix ``AMT_``):

  AMT_ENGINE       auto | python | cpp | xla | device, or the JAX
                   package's ``pallas``, read as ``device`` (``ALIASES``);
                   ``MatchEngine`` resolves ``engine="auto"`` through it,
                   and ``bench.countmatches`` picks its engine by it
  AMT_VALIDATE     1 -> cross-check every device count against the host C++
                   engine and raise on a mismatch
  AMT_COMPOSED_CI  max automaton states for which IgnoreCase scans build
                   the composed case-folding DFA (models.case_dfa) and scan
                   raw bytes; 0 disables composition entirely
  AMT_STREAM_CHUNK_MB  out-of-core chunk size: device scans of inputs
                   larger than 2x this stream through fixed-size staged
                   chunks (ops.streaming) instead of staging the whole
                   corpus on the card

The JAX package's ``AMT_N_STREAMS``, ``AMT_T_TILE`` and ``AMT_INTERPRET``
are not read: the port's engines take their stream plan as arguments, and
the port has no interpret mode (its kernels' plain versions run on the CPU).

Knobs read at point of use (not part of this dataclass):

  AMT_PREFILTER    1/0 force/disable the host 5-byte-window prefilter
                   engine (native.prefilter)
  AMT_BITAP        0 keeps bitap-eligible sets on the dense engine
                   (ops.comb_scan.make_engine)
  AMT_FILTER       0 disables the stride-2 containsAny screen
                   (ops.filter_scan)
  AMT_FUSED_GROUPS 0 runs the grouped engine's groups one pass each
                   (ops.grouped)
  AMT_HOST_CLASS   0 disables the host byte-class packed table
                   (native.cpp_engine; builds lazily at the cumulative-
                   bytes break-even)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else default


#: The JAX package's names of the port's engines, as ``AMT_ENGINE`` may
#: give them.
ALIASES = {"pallas": "device"}


def engine_name(name: str) -> str:
    """``name`` in the port's vocabulary: an alias of ``ALIASES`` mapped,
    any other name as it is."""
    return ALIASES.get(name, name)


@dataclass(frozen=True)
class EngineConfig:
    engine: str = "auto"
    validate: bool = False
    composed_ci_max_states: int = 4096
    stream_chunk_mb: int = 128

    @staticmethod
    def from_env() -> "EngineConfig":
        return EngineConfig(
            engine=engine_name(os.environ.get("AMT_ENGINE", "auto")),
            validate=bool(os.environ.get("AMT_VALIDATE")),
            composed_ci_max_states=_env_int("AMT_COMPOSED_CI", 4096),
            stream_chunk_mb=_env_int("AMT_STREAM_CHUNK_MB", 128),
        )


DEFAULT = EngineConfig.from_env()

__all__ = ["EngineConfig", "DEFAULT", "ALIASES", "engine_name"]
