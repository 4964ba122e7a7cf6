"""bath_fit_s.loop: seconds per DMFT iteration in the solver's
"bath_fit" stage (solver.timers around fit.chi2_fitgf), over the window."""


def read(ctx):
    rec = ctx.records
    if not rec.get("iterations") or "bath_fit" not in rec["stage_s"]:
        return None
    return rec["stage_s"]["bath_fit"] / rec["iterations"]
