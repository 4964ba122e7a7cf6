"""iter_s: the whole window over all DMFT iterations completed in it
(host clock; the window ends when the episode running at --seconds ends)."""


def read(ctx):
    if ctx.unit_kind != "iteration" or ctx.units == 0:
        return None
    return ctx.window_s / ctx.units
