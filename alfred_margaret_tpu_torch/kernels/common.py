"""What every kernel wrapper does around its launch: check the inputs, pick
the plain version for a CPU tensor, and launch on the current CUDA stream.

Nothing here falls back: a CUDA tensor launches the kernel or raises."""

from __future__ import annotations

import torch

from ..utils import trace
from . import build


def check_streams(streams) -> tuple:
    """``(T, S)`` of ``streams``; raises ``ValueError`` unless it is a
    contiguous ``[T, S]`` uint8 tensor."""
    if streams.dtype != torch.uint8 or streams.dim() != 2:
        raise ValueError("streams must be a [T, S] uint8 tensor")
    if not streams.is_contiguous():
        raise ValueError("streams must be contiguous")
    return tuple(streams.shape)


def check_tables(device, want: dict) -> None:
    """Raise ``ValueError`` unless every ``name: (tensor, shape)`` of ``want``
    is a contiguous int32 tensor of that shape on ``device``."""
    for name, (x, shape) in want.items():
        if x.dtype != torch.int32 or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must be int32 of shape {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, streams on {device}")


def check_packed(table, packing: int, state_bits: int, max_words: int) -> None:
    """Raise ``ValueError`` unless ``table`` is a packed dense table the
    kernels hold in shared memory (1..``max_words`` words) and ``packing``
    and ``state_bits`` describe a valid entry layout."""
    if packing not in (1, 2):
        raise ValueError(f"packing must be 1 or 2, got {packing}")
    if not 0 < state_bits < 32:
        raise ValueError(f"state_bits out of range: {state_bits}")
    if table.dim() != 1 or not 0 < table.numel() <= max_words:
        raise ValueError(f"table must be 1-D with 1..{max_words} words, got {tuple(table.shape)}")


def check_overlap(overlap) -> None:
    """Raise ``ValueError`` unless ``overlap`` (a segmented scan's warm-up)
    is None or >= 0."""
    if overlap is not None and overlap < 0:
        raise ValueError(f"overlap must be >= 0, got {overlap}")


def on_cpu(streams) -> bool:
    """True for a CPU tensor (the wrapper runs the plain version); False for
    a CUDA tensor; raises for any other device."""
    if streams.device.type == "cpu":
        return True
    if streams.device.type != "cuda":
        raise ValueError(f"unsupported device {streams.device}")
    return False


def launch(entry: str, device, *args) -> None:
    """Call the C entry point ``entry`` of the kernels' library with ``args``
    and the current CUDA stream of ``device``; raise if the launch failed."""
    with trace.span("amt.launch"):
        lib = build.load().lib
        with torch.cuda.device(device):
            err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    build.check(err)


__all__ = ["check_overlap", "check_packed", "check_streams", "check_tables", "launch", "on_cpu"]
