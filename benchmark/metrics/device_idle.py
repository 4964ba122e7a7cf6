"""device_idle.<cells>: share of the traced units' wall time in which no
kernel, copy or memset ran on the card (torch.profiler), %. One reader
for each split name (``device_idle.loop`` moves ``iter_s``,
``device_idle.gs`` moves ``gs_solve_s``)."""

from benchmark.trace import idle_pct


def read(ctx):
    return idle_pct(ctx.trace)
