"""Explicit device selection and the toolchain probe.

Counterpart of the device handling spread over ``alfred_margaret_tpu/engine.py``
(``_jax_backend``): there the JAX backend is discovered and the engine falls
back to host engines on its own.  Here every engine is given its device
(``"cuda"`` or ``"cpu"``) and nothing moves from CUDA to the CPU by itself: a
CUDA device on a host without one raises.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises on anything but an available
    CUDA device or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for but torch.cuda.is_available() is false"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' or 'cpu'")
    return dev


def nvcc_path() -> Optional[str]:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or the first ``nvcc`` on ``PATH``; None when there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cand = os.path.join(home, "bin", "nvcc")
            if os.access(cand, os.X_OK):
                return cand
    return shutil.which("nvcc")


def nvidia_smi_line() -> Optional[str]:
    """``name, power.limit`` of the first card as ``nvidia-smi`` reports it,
    or None without ``nvidia-smi``."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    proc = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=30,
    )
    if proc.returncode != 0:
        return None
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def toolchain_report() -> dict:
    """What the host offers the port: torch and its CUDA version, the card,
    its power limit and the CUDA compiler."""
    has_cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "gpu": torch.cuda.get_device_name(0) if has_cuda else None,
        "gpu_count": torch.cuda.device_count() if has_cuda else 0,
        "nvidia_smi": nvidia_smi_line(),
        "nvcc": nvcc_path(),
    }


__all__ = ["nvcc_path", "nvidia_smi_line", "resolve_device", "toolchain_report"]
