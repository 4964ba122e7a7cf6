"""restart_idle_ms.gs: ms per solve in which the card idles while the
host runs the thick restart's Rayleigh-Ritz (its reads of T and the
betas, the host eigh) or the restart (the uploads of the Ritz
coefficients and of the new T): the traced window's idle gaps whose
middle falls in a ``lanczos.rayleigh_ritz`` or ``lanczos.restart`` span
(innermost span wins, as ``Trace.idle_gaps`` rules), over the traced
solves."""

from benchmark.program_spans import idle_by_span

SPANS = ("lanczos.rayleigh_ritz", "lanczos.restart")


def read(ctx):
    got = idle_by_span(ctx)
    if got is None:
        return None
    idle, solves = got
    return 1e3 * sum(idle.get(s, 0.0) for s in SPANS) / solves
