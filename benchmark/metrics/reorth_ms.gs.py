"""reorth_ms.gs: device ms per thick-restart step outside the matvec in
the traced solve: the device time of the program's ``lanczos.reorth``
spans (both Gram-Schmidt passes over the basis, the norm, the writes of
the next vector and of T) over their number."""

from benchmark.program_spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "lanczos.reorth", "lanczos.reorth")
