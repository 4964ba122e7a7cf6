"""Antiferromagnetic Hubbard model on the bipartite Bethe lattice
(drivers/ed_hm_bethe_afm.f90), PyTorch port of
dmft_ed_tpu/models/hm_bethe_afm.py.

Bipartite trick: sublattice B is sublattice A with spins exchanged, so one
impurity with Nspin=2 suffices and the self-consistency closes with the
spin-swapped local GF:

    Δ_σ^A(iω) = t² G_{σ̄}^A(iω)   (t = W/2)

The AFM solution is seeded by `sb_field` via break_symmetry_bath and shows
staggered magnetization m = n_↑ - n_↓ ≠ 0 beyond the Néel coupling.

Run: ``python -m dmft_ed_tpu_torch.models.hm_bethe_afm [input] [KEY=value
...]`` (``DEVICE=cpu`` runs on the CPU; the default is cuda).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from . import split_device
from ..solver import EDSolver
from ..bath import break_symmetry_bath
from ..lattice import ConvergenceMonitor
from .. import grids


@dataclass
class AfmResult:
    converged: bool
    iterations: int
    bath: np.ndarray
    smats: np.ndarray
    gmats: np.ndarray
    dens: np.ndarray
    magz: np.ndarray
    error: float


def run(cfg: EDConfig | None = None, wband: float = 1.0,
        wmixing: float = 0.5, log=None, device="cuda") -> AfmResult:
    if cfg is None:
        cfg = EDConfig(nspin=2, uloc=(2.0,))
    cfg = cfg.validate()
    if cfg.nspin != 2:
        raise ValueError("AFM requires Nspin=2")
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    hloc = np.zeros((2, 2, cfg.norb, cfg.norb))
    solver = EDSolver(cfg, hloc, device=device)
    bath = solver.init_solver()
    bath = break_symmetry_bath(cfg, bath, cfg.sb_field, 1.0, solver.mask)
    bath_prev = bath.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    res = weiss = None
    t2 = (wband / 2.0) ** 2
    zm = grids.z_mats(cfg)
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- DMFT loop {iloop}/{cfg.nloop} (AFM Bethe) ---")
        res = solver.solve(bath)
        # spin-swapped Bethe self-consistency
        weiss = np.zeros_like(res.gmats)
        for s in range(2):
            for a in range(cfg.norb):
                delta = t2 * res.gmats[1 - s, 1 - s, a, a]
                if cfg.cg_scheme == "delta":
                    weiss[s, s, a, a] = delta
                else:
                    weiss[s, s, a, a] = 1.0 / (zm + cfg.xmu
                                               - hloc[s, s, a, a] - delta)
        bath = solver.chi2_fitgf(weiss, bath)
        if iloop > 1:
            bath = wmixing * bath + (1 - wmixing) * bath_prev
        bath_prev = bath.copy()
        converged = monitor.check(
            np.stack([weiss[0, 0, 0, 0], weiss[1, 1, 0, 0]]), log=_log)
    return AfmResult(converged=converged, iterations=iloop, bath=bath,
                     smats=res.smats, gmats=res.gmats,
                     dens=res.observables.dens, magz=res.observables.magz,
                     error=monitor.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv, nspin=2)
    r = run(cfg, device=device)
    print(f"converged={r.converged} iters={r.iterations} "
          f"dens={r.dens} magz={r.magz}")
    return r


if __name__ == "__main__":
    main()
