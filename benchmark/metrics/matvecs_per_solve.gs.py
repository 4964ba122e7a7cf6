"""matvecs_per_solve.gs: the thick restart's own matvec count
(eigs_lanczos_op's third result), averaged over the window's solves."""


def read(ctx):
    mv = ctx.records.get("matvecs")
    return sum(mv) / len(mv) if mv else None
