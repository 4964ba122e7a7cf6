"""The program's own spans and counters (``dmft_ed_tpu_torch.timer``),
which it records while the traced units run under torch.profiler, for the
per-layer readers: what lies under the roots of the traced solves
(``lanczos.eigs_lanczos`` spans that start and end inside the traced
window), read through the recorder's by-name helpers ``totals`` and
``intervals``. Everything here returns None where the run has no card, no
trace or no recorded solve, and where the program has no recorder."""

from __future__ import annotations

import copy

ROOT = "lanczos.eigs_lanczos"


def _recorder():
    from dmft_ed_tpu_torch import timer
    return timer if hasattr(timer, "intervals") else None


def solves(ctx):
    """(the recorder's totals by name under the traced solves' roots, the
    number of those solves), or None."""
    timer, tr = _recorder(), ctx.trace
    if timer is None or tr is None or ctx.device_kind == "cpu":
        return None
    tot = timer.totals(ROOT, tr.t0_ns, tr.t1_ns)
    n = tot.get(ROOT, {}).get("spans", 0)
    return (tot, n) if n else None


def device_ms_per(ctx, name: str, per: str):
    """Device ms in the `name` spans of the traced solves over `per`'s
    number (a counter's count, or a span name's number of spans), or None
    where either has none."""
    got = solves(ctx)
    if got is None:
        return None
    tot, _ = got
    dev = tot.get(name, {}).get("device_s")
    n = tot.get(per, {})
    n = n.get("count", n.get("spans", 0))
    return None if dev is None or n == 0 else 1e3 * dev / n


def idle_by_span(ctx):
    """({program span name: the traced window's device idle seconds whose
    gaps fall in it}, solves), by ``Trace.idle_gaps``' innermost-span rule
    over the program's host spans under the traced solves' roots, or
    None."""
    got = solves(ctx)
    if got is None:
        return None
    tr = ctx.trace
    mine = copy.copy(tr)
    mine.spans = _recorder().intervals(ROOT, tr.t0_ns, tr.t1_ns)
    return dict(mine.idle_gaps(top=None)), got[1]
