"""Hand-written Hopper kernels of the port and their plain versions.

One module per kernel; each wrapper launches its CUDA kernel on a CUDA
tensor (or raises), takes the plain PyTorch version on a CPU tensor, and
counts its launches in ``<wrapper>.launches``.
"""

from .digit_matmul import digit_matmul, digit_matmul_plain
from .digit_split import digit_split, digit_split_plain

KERNELS = {"digit_matmul": digit_matmul, "digit_split": digit_split}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["digit_matmul", "digit_matmul_plain", "digit_split",
           "digit_split_plain", "KERNELS", "reset_launches"]
