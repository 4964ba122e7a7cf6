"""gs_solve_s: the whole window over all ground-state solves completed in
it (host clock; the window ends when the solve running at --seconds ends)."""


def read(ctx):
    if ctx.unit_kind != "solve" or ctx.units == 0:
        return None
    return ctx.window_s / ctx.units
