"""ozaki_split_ms.gs: device ms per sector matvec spent extracting the
digits of the vector operand in the traced solve: the device time of the
program's ``ozaki.split`` spans over its counter ``lanczos.matvecs`` (None
without Ozaki products). The spans' events hold the card's waits inside
the extraction too (its blocking upload of the 2^bits scalar)."""

from benchmark.program_spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "ozaki.split", "lanczos.matvecs")
