"""Attractive-U Haldane model — superconducting DMFT on the honeycomb
lattice (drivers/ed_haldane_sc.f90): the two sublattices are inequivalent
superc impurities (Nlat=2) closed through the k-summed Nambu Gloc of the
2x2 Haldane Bloch Hamiltonian. PyTorch port of
dmft_ed_tpu/models/haldane_sc.py: the two sites' sweeps stack in one
site-batched solve and the Nambu k-sum (gloc_hk_lattice_superc) runs on the
device.

Run: ``python -m dmft_ed_tpu_torch.models.haldane_sc [input] ULOC=-2.0
NK=12 TS=1.0 TSP=0.1 PHI=1.0 MH=0.0`` (``DEVICE=cpu`` runs on the CPU; the
default is cuda).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from ..lattice_solver import LatticeEDSolver
from ..lattice import (gloc_hk_lattice_superc, self_consistency_superc,
                       ConvergenceMonitor)
from . import driver_args, split_device
from .kspace import hk_haldane


@dataclass
class HaldaneScResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    dens: np.ndarray
    docc: np.ndarray
    phisc: np.ndarray
    error: float


def run(cfg: EDConfig, nk: int = 12, t1: float = 1.0, t2: float = 0.0,
        phi: float = 0.0, mass: float = 0.0, wmixing: float = 0.5,
        log=None, device="cuda") -> HaldaneScResult:
    cfg = cfg.validate()
    if cfg.ed_mode != "superc" or cfg.norb != 1 or cfg.nspin != 1:
        raise ValueError("haldane_sc requires ed_mode=superc, Norb=1, "
                         "Nspin=1")
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    hk = hk_haldane(nk, t1, t2, phi, mass)
    nlat = 2
    hloc_so = hk.mean(axis=-1)
    hloc_ineq = np.zeros((nlat, 1, 1, 1, 1))
    for i in range(nlat):
        hloc_ineq[i, 0, 0, 0, 0] = hloc_so[i, i].real
    lsolver = LatticeEDSolver(cfg, hloc_ineq, log=_log, device=device)
    baths = lsolver.init_solvers()
    baths_prev = baths.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- Haldane-SC DMFT loop {iloop}/{cfg.nloop} ---")
        lsolver.solve(baths)
        smats = lsolver.get_sigma_matsubara()
        samats = np.stack([r.smats_an for r in lsolver.results])
        with lsolver.timers("gloc"):
            gm, fm = gloc_hk_lattice_superc(cfg, hk, smats, samats, "mats",
                                            device=lsolver.device)
        wn = np.zeros_like(gm)
        wa = np.zeros_like(fm)
        for i in range(nlat):
            wn[i], wa[i] = self_consistency_superc(
                cfg, gm[i], fm[i], smats[i], samats[i], hloc_ineq[i])
        baths = lsolver.chi2_fitgf(wn, baths, ispin=0, fg_an_ineq=wa)
        if iloop > 1:
            baths = wmixing * baths + (1 - wmixing) * baths_prev
        baths_prev = baths.copy()
        converged = monitor.check(wn[0, 0, 0, 0, 0], log=_log)
    phisc = np.stack([r.observables.phisc for r in lsolver.results])
    return HaldaneScResult(converged=converged, iterations=iloop,
                           baths=baths, dens=lsolver.get_dens()[:, 0],
                           docc=lsolver.get_docc()[:, 0],
                           phisc=phisc[:, 0], error=monitor.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    path = argv[0] if argv and "=" not in argv[0] else "inputHALDANE.conf"
    cfg = read_input(path, argv, ed_mode="superc")
    kw = driver_args(argv, {"NK": ("nk", int), "TS": ("t1", float),
                            "TSP": ("t2", float), "PHI": ("phi", float),
                            "MH": ("mass", float)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iters={r.iterations} dens={r.dens} "
          f"phi={r.phisc}")
    return r


if __name__ == "__main__":
    main()
