"""mix_gather_terms.gs: the mix terms applied as signed gathers per sector
matvec in the traced solve (the program's counter
``hamiltonian.mix_gather_terms`` over its counter ``lanczos.matvecs``).
It reads 4 where the Hund operator's four Kanamori terms run in the gather
kernel, and nothing where the program lacks the counter or the operator
has no such terms."""

from benchmark.program_spans import solves


def read(ctx):
    got = solves(ctx)
    if got is None:
        return None
    tot, _ = got
    n = tot.get("hamiltonian.mix_gather_terms", {}).get("count")
    mv = tot.get("lanczos.matvecs", {}).get("count", 0)
    return None if not n or not mv else n / mv
