"""dmft_ed_tpu_torch — the PyTorch/CUDA port of the Lanczos exact-
diagonalization DMFT impurity solver.

A second package beside ``dmft_ed_tpu`` (the JAX reference). It imports
``torch``, numpy and scipy, never ``jax`` and nothing of ``dmft_ed_tpu``:
the numpy-only host modules are carried over as copies.

Every tensor lives on one explicit ``device`` (default ``"cuda"``), threaded
from ``EDSolver(cfg, hloc, device=...)`` and ``models.hm_bethe.run(...,
device=...)`` down to the Krylov vectors; ``device="cpu"`` is the only way
onto the CPU, and asking for cuda on a machine without one raises. Work is
in float64 / complex128, or float32 / complex64 with ``dtype="float32"``.
With a ``(sites, rows)`` mesh on torch.distributed (``parallel/``), every
rank runs the same code and large sectors solve row-sharded.

The Ozaki int8 digit matmul (``matmul_precision="ozaki*"``) runs on a
hand-written CUDA kernel (``csrc/digit_matmul.cu`` via
``kernels.digit_matmul``); on CPU tensors the wrapper takes its plain
PyTorch version.
"""

from .version import __version__
from .config import EDConfig, read_input
from .bath import Bath, get_bath_dimension
from .solver import EDSolver

__all__ = [
    "__version__",
    "EDConfig",
    "read_input",
    "Bath",
    "get_bath_dimension",
    "EDSolver",
]
