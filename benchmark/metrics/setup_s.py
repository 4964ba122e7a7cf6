"""setup_s: seconds from the process's start to the first timed unit
(imports, building the problem, the warm-up unit; host clock)."""


def read(ctx):
    return ctx.setup_s
