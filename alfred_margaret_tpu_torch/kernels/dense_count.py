"""B1 ``dense_count``: per-stream match counts of the packed byte-class DFA.

Wrapper of ``csrc/dense_count.cu``, which replaces the Pallas kernel
``alfred_margaret_tpu/ops/pallas_scan.py:_make_count_kernel``.  A CUDA tensor
launches the kernel; a CPU tensor runs :func:`dense_count_plain`, the same
function as a torch loop over time.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

from . import build

#: Table words the kernel holds in shared memory (kMaxTableWords in the .cu):
#: MAX_ROWS rows of 128 entries.
MAX_TABLE_WORDS = 48 * 128


def _check_inputs(streams, classmap, table, warm, vend, packing, state_bits):
    if packing not in (1, 2):
        raise ValueError(f"packing must be 1 or 2, got {packing}")
    if not 0 < state_bits < 32:
        raise ValueError(f"state_bits out of range: {state_bits}")
    if streams.dtype != torch.uint8 or streams.dim() != 2:
        raise ValueError("streams must be a [T, S] uint8 tensor")
    S = streams.shape[1]
    want = {"classmap": (classmap, (256,)), "warm": (warm, (S,)), "vend": (vend, (S,))}
    for name, (x, shape) in want.items():
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be int32 of shape {shape}")
    if table.dtype != torch.int32 or table.dim() != 1:
        raise ValueError("table must be a 1-D int32 tensor")
    if not 0 < table.numel() <= MAX_TABLE_WORDS:
        raise ValueError(f"table must hold 1..{MAX_TABLE_WORDS} words, got {table.numel()}")
    for name, x in (("streams", streams), ("classmap", classmap), ("table", table),
                    ("warm", warm), ("vend", vend)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != streams.device:
            raise ValueError(f"{name} is on {x.device}, streams on {streams.device}")


def dense_count_plain(streams, classmap, table, warm, vend, packing: int, state_bits: int):
    """Plain torch version of the kernel: one gather chain per time step."""
    T, S = streams.shape
    dev = streams.device
    cm = classmap.long()
    tab = table.long() & 0xFFFFFFFF  # entries are unsigned
    mask = (1 << state_bits) - 1
    warm, vend = warm.long(), vend.long()
    sbase = torch.zeros(S, dtype=torch.int64, device=dev)
    counts = torch.zeros(S, dtype=torch.int64, device=dev)
    for t in range(T):
        idx = sbase + cm[streams[t].long()]
        if packing == 1:
            v = tab[idx]
        else:
            v = (tab[idx >> 1] >> ((idx & 1) << 4)) & 0xFFFF
        sbase = v & mask
        live = (warm <= t) & (t < vend)
        counts += torch.where(live, v >> state_bits, 0)
    return counts.to(torch.int32)


def dense_count(streams, classmap, table, warm, vend, packing: int, state_bits: int):
    """int32 [S] counts of the matches ending at t in [warm[s], vend[s]) of
    each stream of ``streams`` ([T, S] uint8), scanned from the root.

    ``classmap`` [256] maps bytes to classes; ``table`` holds the packed
    entries ``count << state_bits | next_state * k`` (``packing`` 1: one per
    int32, 2: two 16-bit entries per int32, low half first)."""
    _check_inputs(streams, classmap, table, warm, vend, packing, state_bits)
    if streams.device.type == "cpu":
        return dense_count_plain(streams, classmap, table, warm, vend, packing, state_bits)
    if streams.device.type != "cuda":
        raise ValueError(f"unsupported device {streams.device}")
    lib = build.load().lib
    T, S = streams.shape
    out = torch.empty(S, dtype=torch.int32, device=streams.device)
    with torch.cuda.device(streams.device):
        err = lib.amt_dense_count(
            streams.data_ptr(), T, S,
            classmap.data_ptr(), table.data_ptr(), table.numel(),
            warm.data_ptr(), vend.data_ptr(),
            packing, state_bits,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    build.check(err)
    dense_count.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
dense_count.launches = 0

__all__ = ["dense_count", "dense_count_plain"]
