"""solve_mfu.gs: the whole solve's share of the card's peak, %: the
window's matvecs times the least time one H·v of the sector takes at the
cell's precision (roofline.matvec_bound_s: the f64 tensor-core peak for
native, the int8 peak over the Ozaki digit products for ozaki<P>x<B>),
over the window's wall time. The solve's other work (the restart's
reorthogonalization and vector updates) is in the wall time and adds no
operations, so the share bounds every kernel's roofline under it: a change
that takes a kernel off the path can gain only as far as this share
moves. The card's power limit is printed beside it."""

from benchmark.roofline import PEAKS, matvec_bound_s


def read(ctx):
    rec = ctx.records
    if not rec.get("matvecs") or ctx.device_kind not in PEAKS:
        return None
    ddw, dup = rec["shape"]
    least = matvec_bound_s(ddw, dup, rec["precision"], ctx.device_kind)
    return 100.0 * sum(rec["matvecs"]) * least / ctx.window_s
