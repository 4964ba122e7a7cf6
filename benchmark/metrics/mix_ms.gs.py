"""mix_ms.gs: device ms per sector matvec spent in the mix terms (spin
exchange and pair hopping) in the traced solve: the device time of the
program's ``hamiltonian.mix`` spans over its counter ``lanczos.matvecs``
(None for an operator without mix terms, or a program without the
span)."""

from benchmark.program_spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "hamiltonian.mix", "lanczos.matvecs")
