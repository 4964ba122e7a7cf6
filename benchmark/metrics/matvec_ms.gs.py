"""matvec_ms.gs: device ms per sector matvec in the traced solve: the
device time of the program's ``hamiltonian.apply_op`` spans (CUDA events
around each H·v, lanczos._op_matvec) over its counter
``lanczos.matvecs``."""

from benchmark.program_spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "hamiltonian.apply_op", "lanczos.matvecs")
