"""End-to-end DMFT wall-clock benchmark of the port — the counterpart of
the repo root's ``bench_e2e.py``: the Bethe-lattice DMFT loop
(``models.hm_bethe.run``) as a whole, not a kernel.

- ``canonical``: ed_hm_bethe, Norb=1, Nbath=6, Nspin=1, beta=1000,
  Lmats=Lreal=5000, dmft_error=1e-5, the package defaults (thick restart,
  native products): seconds for the loop (``--nloop``, 60 by default).
- ``large``: the same loop at Nbath=11 (Ns=12, sectors up to 853,776),
  plain Lanczos, Krylov products in ``ozaki5x7`` on the card (the
  kernel ``csrc/digit_matmul.cu``), a fixed number of iterations
  (``--nloop``, 3 by default): seconds per iteration, per-iteration
  marks and the solver's stage seconds (``solver.timers``).

``--device cpu`` (or ``--cpu``, the root script's flag) runs the loop on
the CPU with ``native`` products and writes its line into
``bench_out/bench_e2e_<workload>_cpu.json`` (gitignored); a card run of
the same checkout then reports ``vs_baseline`` against that file where
it exists, and null otherwise (the root script's CPU seconds are the JAX
package's, from another machine).

    python -m dmft_ed_tpu_torch.benches.bench_e2e [--workload both]

prints the card line, then one JSON line per workload.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from . import card_line, device_name, sync
from ..config import EDConfig
from ..device import resolve
from ..kernels import KERNELS, reset_launches
from ..models import hm_bethe
from ..solver import EDSolver

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CPU_ART = os.path.join(_REPO, "bench_out", "bench_e2e_{}_cpu.json")


def canonical_config(nloop: int) -> EDConfig:
    return EDConfig(norb=1, nbath=6, nspin=1, uloc=(2.0,), beta=1000.0,
                    lmats=5000, lreal=5000, dmft_error=1e-5, nloop=nloop,
                    ed_verbose=0).validate()


def large_config(nloop: int, precision: str) -> EDConfig:
    return EDConfig(norb=1, nbath=11, nspin=1, uloc=(2.0,), beta=100.0,
                    lmats=1024, lreal=256, dmft_error=1e-12, nloop=nloop,
                    lanc_niter=256, lanc_ngfiter=200, lanc_method="lanczos",
                    matmul_precision=precision, ed_verbose=0).validate()


def run_canonical(nloop: int, device="cuda"):
    """(result, seconds, cfg) of the canonical loop."""
    dev = resolve(device)
    cfg = canonical_config(nloop)
    sync(dev)
    t0 = time.time()
    r = hm_bethe.run(cfg, le=500, wmixing=0.5, device=dev)
    sync(dev)
    return r, time.time() - t0, cfg


def run_large(nloop: int, device="cuda"):
    """(result, seconds, cfg, steady seconds per iteration, per-iteration
    seconds, per-iteration stage seconds, kernel launches) of the large
    loop. The marks come from the loop's header log lines, so the
    first iteration (the kernel's build and the first graph captures)
    stands apart from the steady ones."""
    dev = resolve(device)
    # ozaki5x7 on the card, exact f64 products on the CPU
    cfg = large_config(nloop, "native" if dev.type == "cpu" else "ozaki5x7")
    hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    solver = EDSolver(cfg, hloc, device=dev)
    marks, stage_snaps = [], []

    def mark():
        sync(dev)
        marks.append(time.time())
        stage_snaps.append(solver.timers.snapshot())

    def log(msg):
        if msg.startswith("--- DMFT loop"):
            mark()

    reset_launches()
    t0 = time.time()
    r = hm_bethe.run(cfg, le=300, wmixing=0.5, log=log, solver=solver)
    mark()
    dt = marks[-1] - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    iter_s = [marks[i + 1] - marks[i] for i in range(len(marks) - 1)]
    stages = []
    for a, b, s in zip(stage_snaps, stage_snaps[1:], iter_s):
        d = {k: b[k] - a.get(k, 0.0) for k in b
             if b[k] - a.get(k, 0.0) > 0.005}
        # "diag.*" sub-stages nest inside "diagonalize": top level only
        d["other"] = s - sum(v for k, v in d.items()
                             if not k.startswith("diag."))
        stages.append(d)
    steady = sum(iter_s[1:]) / len(iter_s[1:]) if len(iter_s) >= 2 else None
    return r, dt, cfg, steady, iter_s, stages, launches


def _baseline(workload: str, key: str, value):
    """The port's own CPU line for `workload` over `value`, or None."""
    path = CPU_ART.format(workload)
    if value is None or not os.path.exists(path):
        return None
    with open(path) as fh:
        base = json.load(fh).get(key)
    return base / value if base else None


def _write_cpu(workload: str, line: dict) -> None:
    path = CPU_ART.format(workload)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(line, fh, indent=1)


def workload_line(workload: str, nloop: int, device) -> dict:
    dev = resolve(device)
    where = "cpu" if dev.type == "cpu" else device_name(dev)
    if workload == "canonical":
        r, dt, cfg = run_canonical(nloop, dev)
        return {
            "metric": f"ed_hm_bethe DMFT loop wall-clock ({where})",
            "value": dt, "unit": "s",
            "vs_baseline": (None if dev.type == "cpu"
                            else _baseline(workload, "value", dt)),
            "converged": bool(r.converged),
            "error": float(r.error),
            "iterations": int(r.iterations),
            "s_per_iteration": dt / r.iterations,
            "docc": float(r.docc[0]),
            "dens": float(r.dens[0]),
            "ekin": float(r.ekin),
        }
    r, dt, cfg, steady, iter_s, stages, launches = run_large(nloop, dev)
    per_it = dt / r.iterations
    cpu = dev.type == "cpu"
    return {
        "metric": f"large-sector (dim 853k) DMFT iteration ({where}, "
                  f"{cfg.matmul_precision})",
        "value": per_it, "unit": "s/iter",
        "vs_baseline": None if cpu else _baseline(
            workload, "s_per_iteration", per_it),
        "iterations": int(r.iterations),
        "total_s": dt,
        "docc": float(r.docc[0]),
        "dens": float(r.dens[0]),
        "s_per_iteration": per_it,
        "steady_s_per_iteration": steady,
        "steady_vs_baseline": None if cpu else _baseline(
            workload, "steady_s_per_iteration", steady),
        "iter_s": iter_s,
        "stages_per_iter": stages,
        "launches": launches,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dmft_ed_tpu_torch.benches."
                                 "bench_e2e", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="canonical",
                    choices=["canonical", "large", "both"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true",
                    help="--device cpu (native products; the baseline run)")
    ap.add_argument("--nloop", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve("cpu" if args.cpu else args.device)
    print(card_line(dev), flush=True)
    workloads = ["canonical", "large"] if args.workload == "both" \
        else [args.workload]
    cwd = os.getcwd()
    for wl in workloads:
        nloop = args.nloop or (60 if wl == "canonical" else 3)
        with tempfile.TemporaryDirectory() as d:
            os.chdir(d)            # the loop writes .ed files into the cwd
            try:
                line = workload_line(wl, nloop, dev)
            finally:
                os.chdir(cwd)
        if dev.type == "cpu":
            _write_cpu(wl, line)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
