#!/usr/bin/env python3
"""The JAX package's CPU values that ``chip_smoke.py`` holds phases 6, 8
and 9 to.

* ``--case bethe``: the canonical Hubbard loop of phase 6
  (``dmft_ed_tpu.models.hm_bethe.run`` with the package defaults: Norb=1,
  Nbath=6, U=2, beta=1000, Lmats=Lreal=5000, Le=500, wmixing=0.5) for
  ``--nloop`` iterations: dens and docc of every iteration.
* ``--case ahm``: the canonical attractive-Hubbard loop
  (``dmft_ed_tpu.models.ahm_bethe.run`` with the package defaults: Norb=1,
  Nbath=6, U=-2, beta=1000, Lmats=Lreal=5000, dmft_error=1e-5, nloop=40,
  Le=500, wmixing=0.5), run to convergence: iterations, error, dens, docc,
  phi and the wall time (phase 8).
* ``--case nbath9``: one fixed-bath ``EDSolver.solve`` of the superc
  Nbath=9 config (Norb=1, U=-2, beta=100, Lmats=1024, Lreal=256,
  lanc_niter=256) on its initial bath, with ``native`` products and the
  given ``--method`` (phase 9).

Run from the root of a checkout, on the CPU: ``python3 chip_reference.py
--case ahm`` (a few minutes). Each case runs in a temporary directory of
its own (the solver writes ``.ed`` files into the cwd) and prints one JSON
object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
os.environ["JAX_PLATFORMS"] = "cpu"

BETHE_CFG = dict(norb=1, nbath=6, nspin=1, uloc=(2.0,), beta=1000.0,
                 lmats=5000, lreal=5000, dmft_error=1e-12, ed_verbose=0)
BETHE_RUN = dict(le=500, wmixing=0.5)
AHM_CFG = dict(norb=1, nbath=6, nspin=1, ed_mode="superc", uloc=(-2.0,),
               beta=1000.0, lmats=5000, lreal=5000, dmft_error=1e-5,
               nloop=40, ed_verbose=0)
AHM_RUN = dict(le=500, wmixing=0.5)
NBATH9_CFG = dict(norb=1, nbath=9, nspin=1, ed_mode="superc", uloc=(-2.0,),
                  beta=100.0, lmats=1024, lreal=256, lanc_niter=256,
                  ed_verbose=0)


def run_bethe(nloop: int) -> dict:
    import numpy as np
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.models import hm_bethe
    from dmft_ed_tpu.solver import EDSolver
    cfg = EDConfig(**dict(BETHE_CFG, nloop=nloop)).validate()
    solver = EDSolver(cfg, np.zeros((1, 1, 1, 1)), log=lambda m: None)
    obs = []

    def log(msg, *a, **k):
        if msg.startswith("--- DMFT loop") and solver.result is not None:
            o = solver.result.observables
            obs.append((float(o.dens[0]), float(o.docc[0])))

    t0 = time.time()
    r = hm_bethe.run(cfg, log=log, solver=solver, **BETHE_RUN)
    obs.append((float(r.dens[0]), float(r.docc[0])))
    return dict(case="bethe", iterations=int(r.iterations),
                dens=[d for d, _ in obs], docc=[d for _, d in obs],
                seconds=time.time() - t0)


def run_ahm() -> dict:
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.models import ahm_bethe
    cfg = EDConfig(**AHM_CFG).validate()
    t0 = time.time()
    r = ahm_bethe.run(cfg, log=lambda *a, **k: None, **AHM_RUN)
    return dict(case="ahm", converged=bool(r.converged),
                iterations=int(r.iterations), error=float(r.error),
                dens=float(r.dens[0]), docc=float(r.docc[0]),
                phi=float(r.phisc[0]), egs=float(r.egs), ekin=float(r.ekin),
                seconds=time.time() - t0)


def run_nbath9(method: str) -> dict:
    import numpy as np
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.solver import EDSolver
    cfg = EDConfig(**dict(NBATH9_CFG, lanc_method=method)).validate()
    solver = EDSolver(cfg, np.zeros((1, 1, 1, 1)), log=lambda m: None)
    bath = solver.init_solver()
    t0 = time.time()
    res = solver.solve(bath)
    o = res.observables
    return dict(case="nbath9", method=method, egs=float(res.egs),
                docc=float(o.docc[0]), phi=float(o.phisc[0]),
                dens=float(o.dens[0]), seconds=time.time() - t0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=("bethe", "ahm", "nbath9"),
                    required=True)
    ap.add_argument("--method", default="arpack")
    ap.add_argument("--nloop", type=int, default=5)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        out = (run_bethe(args.nloop) if args.case == "bethe"
               else run_ahm() if args.case == "ahm"
               else run_nbath9(args.method))
        os.chdir(REPO)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
