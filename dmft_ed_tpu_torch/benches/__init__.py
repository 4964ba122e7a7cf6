"""The port's benchmark entry points, one module per script of the JAX
package's repo root (``bench.py``, ``bench_e2e.py``, ``bench_scaling.py``,
``bench_trace.py``), under the same names:

    python -m dmft_ed_tpu_torch.benches.bench          # the headline
    python -m dmft_ed_tpu_torch.benches.bench_e2e      # DMFT loop seconds
    python -m dmft_ed_tpu_torch.benches.bench_scaling  # row-sharded H·v
    python -m dmft_ed_tpu_torch.benches.bench_trace    # device time split

Each runs on the card unless given ``--device cpu`` (and raises without a
card), prints the card's name and power limit as ``nvidia-smi`` gives them,
and prints its results as JSON lines. They import torch, numpy and scipy
and the port, never jax, the JAX package or the root scripts.
"""

from __future__ import annotations

import subprocess
import time

import torch

from ..device import resolve


def card_line(device) -> str:
    """The first card's line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` ("cpu" for the CPU)."""
    if resolve(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def device_name(device) -> str:
    """``torch.cuda.get_device_name`` of `device`, or "cpu"."""
    dev = resolve(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def sync(device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device):
    """(fn(), host seconds) with the card synchronised before and after."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def peak_gib(device):
    """Peak device memory since the last reset, GiB (None on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
