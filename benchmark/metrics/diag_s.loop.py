"""diag_s.loop: seconds per DMFT iteration in the solver's
"diagonalize" stage (solver.timers, host clock around diag.diagonalize,
which hands its spectrum back to the host), over the window."""


def read(ctx):
    rec = ctx.records
    if not rec.get("iterations") or "diagonalize" not in rec["stage_s"]:
        return None
    return rec["stage_s"]["diagonalize"] / rec["iterations"]
