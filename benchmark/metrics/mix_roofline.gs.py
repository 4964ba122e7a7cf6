"""mix_roofline.gs: the mix terms' least time over their device time in
the traced solve, %. The least time of one application is its least bytes
(``roofline_mix.mix_bytes``: the distinct entries of V that any term reads
and of Y that any term writes, once each, in float64; the cell's records
carry the count) at the card's memory bandwidth; the device time is that
of the program's ``hamiltonian.mix`` spans, one per matvec. A true lower
bound for any way of applying the terms, so no implementation reads above
100%. None without the spans, the count or a known card."""

from benchmark.program_spans import solves
from benchmark.roofline import PEAKS
from benchmark.roofline_mix import mix_bound_s


def read(ctx):
    nbytes = ctx.records.get("mix_bytes")
    got = solves(ctx)
    if not nbytes or got is None or ctx.device_kind not in PEAKS:
        return None
    mix = got[0].get("hamiltonian.mix", {})
    if not mix.get("spans") or not mix.get("device_s"):
        return None
    least = mix_bound_s(nbytes, ctx.device_kind)
    return 100.0 * mix["spans"] * least / mix["device_s"]
