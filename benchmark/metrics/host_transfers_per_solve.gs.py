"""host_transfers_per_solve.gs: the thick restart's blocking host-device
transfers per solve in the traced solve (the program's counter
``lanczos.host_transfers``: the reads of T and the betas, the uploads of
the Ritz coefficients and of the new T). It counts the restart's
transfers only: the sector matvec's own (the Ozaki split's upload of its
2^bits scalar) are not in it."""

from benchmark.program_spans import solves


def read(ctx):
    got = solves(ctx)
    if got is None:
        return None
    tot, n = got
    return tot.get("lanczos.host_transfers", {}).get("count", 0) / n
