"""Weak-scaling measurement over a device mesh.

Usage (the shards of one card, or of the CPU):

    python -m alfred_margaret_tpu_torch.bench.scaling [MB_PER_SHARD] [--device cuda|cpu]

Weak scaling: corpus bytes grow with the shard count (fixed bytes per
shard); perfect scaling keeps wall time flat.  The harness prints one JSON
line per mesh size with bytes/s and efficiency vs the 1-shard run.  The
counterpart of ``alfred_margaret_tpu/bench/scaling.py``: there a mesh is
the JAX devices (a virtual CPU mesh, or TPU chips); here the shards of a
mesh of n = 1, 2, 4 and 8 are the visible CUDA cards taken in turn,
repeated when there are fewer cards than shards (``make_mesh(["cuda:0"] *
n, ...)`` on one card), or the CPU under ``--device cpu``.  Each shard
launches the port's kernels on its own block (their plain versions on the
CPU).

CAVEAT for meshes whose shards share a device: the shards run one after
another on it, so the efficiency numbers reflect that sharing, not a
multi-card interconnect — the run validates the scaling *protocol*
(identical counts at every size and shape) rather than hardware scaling.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models import ac
from ..parallel import DistributedAcEngine, make_mesh
from ..utils.device import resolve_device
from .dataformat import synth_corpus

NEEDLES = ["tshirt", "shirts", "shorts"]
SIZES = (1, 2, 4, 8)


def shard_devices(device, n: int):
    """``n`` shard devices: the visible CUDA cards in turn (repeated when
    there are fewer), or the CPU ``n`` times."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [cards[i % len(cards)] for i in range(n)]


def invariance(machine, devices_for, sizes=SIZES, n_bytes: int = 4 * 1024 * 1024) -> dict:
    """Mesh-shape count invariance: the same corpus must count identically
    on EVERY mesh size and shape (data/seq/needle factorizations) — the
    correctness half of the scaling story.  Returns the JSON row; raises
    ``AssertionError`` when a count differs."""
    inv_corpus = np.frombuffer(
        synth_corpus(NEEDLES, n_bytes, hit_fraction=0.01, seed=7),
        dtype=np.uint8,
    )
    inv_counts = {}
    for n_dev in sizes:
        shapes = [(n_dev, 1, 1)]
        if n_dev % 2 == 0:
            shapes += [(n_dev // 2, 2, 1), (n_dev // 2, 1, 2)]
        for d, sq, nd in shapes:
            eng = DistributedAcEngine(
                machine, make_mesh(devices_for(n_dev), data=d, seq=sq, needle=nd), inner="pallas")
            inv_counts[(d, sq, nd)] = eng.count(inv_corpus)
    assert len(set(inv_counts.values())) == 1, f"count varies by mesh: {inv_counts}"
    return {
        "invariance": "ok",
        "shapes": len(inv_counts),
        "count": next(iter(inv_counts.values())),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scaling")
    p.add_argument("mb_per_device", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    mb_per_device = args.mb_per_device

    machine = ac.build([(n, i) for i, n in enumerate(NEEDLES)])

    def devices_for(n):
        return shard_devices(args.device, n)

    print(json.dumps(invariance(machine, devices_for)), flush=True)

    base_bps = None
    for n_dev in SIZES:
        corpus = synth_corpus(
            NEEDLES, mb_per_device * n_dev * 1024 * 1024, hit_fraction=0.01, seed=3
        )
        data = np.frombuffer(corpus, dtype=np.uint8)
        devices = devices_for(n_dev)
        mesh = make_mesh(devices, data=n_dev, seq=1)
        eng = DistributedAcEngine(machine, mesh, inner="pallas")
        expected = None
        best = float("inf")
        for i in range(4):
            t0 = time.perf_counter()
            got = eng.count(data)
            dt = time.perf_counter() - t0
            if i == 0:
                expected = got  # first call includes the tables' build and staging set-up
            else:
                assert got == expected
                best = min(best, dt)
        bps = len(data) / best
        if base_bps is None:
            base_bps = bps
        # Shards that share a device run one after another on it, so
        # weak-scaling efficiency CANNOT show there — time grows ~linearly
        # by construction.  Flag the rows so the numbers are not mistaken
        # for a hardware scaling result.
        virtual = len(set(devices)) < n_dev
        row = {
            "devices": n_dev,
            "distinct_devices": len(set(devices)),
            "device": str(devices[0].type),
            "corpus_mb": mb_per_device * n_dev,
            "count": expected,
            "seconds": round(best, 4),
            "bytes_per_sec": round(bps, 1),
            "weak_scaling_efficiency": round(bps / (base_bps * n_dev), 4),
        }
        if virtual:
            row["virtual_mesh"] = True
            row["aggregate_throughput_ratio"] = round(bps / base_bps, 4)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
