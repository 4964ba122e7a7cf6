"""Device selection for the port.

One explicit device per solver: ``"cuda"`` by default, ``"cpu"`` only when
the caller asks for it. There is no silent fallback — asking for cuda on a
machine without a card raises.
"""

from __future__ import annotations

import os

import torch


def resolve(device) -> torch.device:
    """torch.device for a user-facing ``device`` argument (str or
    torch.device); raises when a cuda device is requested but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def ragged_batching(device) -> bool:
    """Whether the batched Krylov engines (the whole-sweep lockstep diag
    and the wide-concat GF chains, sweep_plain.py) run: on an accelerator,
    where per-sector launches dominate, yes; on the host, where lockstep
    makes fast members wait for the slowest, no — the JAX reference makes
    the same call for an accelerator backend. Override with
    DMFT_ED_RAGGED=1|0 (the CPU tests force the sweep engines with it)."""
    choice = os.environ.get("DMFT_ED_RAGGED", "auto").lower()
    if choice in ("1", "on", "always"):
        return True
    if choice in ("0", "off", "never"):
        return False
    return torch.device(device).type == "cuda"


def ozaki_fused() -> bool:
    """Whether make_matvec_op encodes a block whose two spin parts are both
    dense-Ozaki as ONE fused two-orientation product
    (ozaki.fused_two_sided, kind "ozf") instead of two pre-sliced ones.
    Off by default, as in the reference (its TPU measurements found the
    fusion slower: both operands are re-sliced every call); opt in with
    DMFT_ED_OZAKI_FUSED=1."""
    return os.environ.get("DMFT_ED_OZAKI_FUSED", "0").lower() \
        in ("1", "on", "always")
