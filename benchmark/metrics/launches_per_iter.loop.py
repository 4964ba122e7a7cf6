"""launches_per_iter.loop: device kernels in the traced episode's
profiler trace over its DMFT iterations (copies and memsets left out)."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    return ctx.trace.kernel_count() / ctx.traced_units
