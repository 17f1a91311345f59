"""The per-shard scans of the ``xla`` inner: the full byte DFA as torch
gathers over one shard's ``[T, S_local]`` streams, one time step at a time.

Counterpart of ``alfred_margaret_tpu/parallel/xla_scan_local.py``, whose
bodies are ``lax.scan`` loops under ``shard_map``; like them these run no
kernel.  Counts are int64.
"""

from __future__ import annotations

import torch


def local_scan_counts(delta_flat, mc, streams_ts, warm_start, valid_end) -> torch.Tensor:
    """int64 [S_local]: per stream of ``streams_ts`` ([T, S_local] uint8),
    the matches ending at t in ``[warm_start[s], valid_end[s])``, scanned
    from the root with ``delta_flat`` (int64 ``[n_states * 256]``) and the
    per-state counts ``mc`` (int64 ``[n_states]``)."""
    S = streams_ts.shape[1]
    states = torch.zeros(S, dtype=torch.int64, device=streams_ts.device)
    counts = torch.zeros(S, dtype=torch.int64, device=streams_ts.device)
    warm, vend = warm_start.long(), valid_end.long()
    for t in range(streams_ts.shape[0]):
        states = delta_flat[states * 256 + streams_ts[t].long()]
        counts += torch.where((warm <= t) & (t < vend), mc[states], 0)
    return counts


def local_scan_states(delta_flat, streams_ts) -> torch.Tensor:
    """int64 [T, S_local]: the state each stream enters at every step."""
    S = streams_ts.shape[1]
    states = torch.zeros(S, dtype=torch.int64, device=streams_ts.device)
    out = torch.empty(streams_ts.shape, dtype=torch.int64, device=streams_ts.device)
    for t in range(streams_ts.shape[0]):
        states = delta_flat[states * 256 + streams_ts[t].long()]
        out[t] = states
    return out


__all__ = ["local_scan_counts", "local_scan_states"]
