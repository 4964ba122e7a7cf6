"""Hand-written Hopper kernels of the port and their plain versions.

One module per kernel; each wrapper launches its CUDA kernel on a CUDA
tensor (or raises), takes the plain PyTorch version on a CPU tensor, and
counts its launches in ``<wrapper>.launches``.
"""

from .digit_matmul import digit_matmul, digit_matmul_plain
from .digit_split import digit_split, digit_split_plain
from .mix_gather import mix_gather, mix_gather_plain

KERNELS = {"digit_matmul": digit_matmul, "digit_split": digit_split,
           "mix_gather": mix_gather}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def add_launches(counts: dict) -> None:
    """Adds `counts` ({name: launches}) to the kernels' counters: a CUDA
    graph's replay launches what its capture recorded."""
    for name, n in counts.items():
        KERNELS[name].launches += n


__all__ = ["digit_matmul", "digit_matmul_plain", "digit_split",
           "digit_split_plain", "mix_gather", "mix_gather_plain", "KERNELS",
           "add_launches", "launch_counts", "reset_launches"]
