"""Attractive Hubbard model with site disorder — superconducting real-space
DMFT (drivers/ed_ahm_disorder.f90): every site of a finite cluster is an
inequivalent superc impurity; the lattice closes through the Nambu
real-space GF (gloc_realspace_superc). PyTorch port of
dmft_ed_tpu/models/ahm_disorder.py: the sites' sweeps stack in one
site-batched solve and the Nambu inversion runs on the device. The module
has no command line, as the JAX package's has none: the caller gives the
cluster and its disorder."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import EDConfig
from ..lattice_solver import LatticeEDSolver
from ..lattice import (gloc_realspace_superc, self_consistency_superc,
                       ConvergenceMonitor)
from ..aux import lso2nnn


@dataclass
class AhmDisorderResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    dens: np.ndarray
    docc: np.ndarray
    phisc: np.ndarray
    error: float


def run(cfg: EDConfig, hij: np.ndarray, eps_disorder: np.ndarray,
        wmixing: float = 0.5, log=None,
        device="cuda") -> AhmDisorderResult:
    """hij: [Nlat, Nlat] (1 band, Nspin=1); eps_disorder: per-site onsite
    energies (every site inequivalent)."""
    cfg = cfg.validate()
    if cfg.ed_mode != "superc" or cfg.norb != 1 or cfg.nspin != 1:
        raise ValueError("ahm_disorder requires ed_mode=superc, Norb=1, "
                         "Nspin=1")
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    nlat = hij.shape[0]
    hij = hij + np.diag(eps_disorder)
    hloc_ineq = lso2nnn(hij, nlat, 1, 1)
    lsolver = LatticeEDSolver(cfg, hloc_ineq, log=_log, device=device)
    baths = lsolver.init_solvers()
    baths_prev = baths.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- disorder-SC DMFT loop {iloop}/{cfg.nloop} "
             f"({nlat} sites) ---")
        lsolver.solve(baths)
        smats = lsolver.get_sigma_matsubara()
        samats = np.stack([r.smats_an for r in lsolver.results])
        with lsolver.timers("gloc"):
            gm, fm = gloc_realspace_superc(cfg, hij, smats, samats, "mats",
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
    return AhmDisorderResult(converged=converged, iterations=iloop,
                             baths=baths, dens=lsolver.get_dens()[:, 0],
                             docc=lsolver.get_docc()[:, 0],
                             phisc=phisc[:, 0], error=monitor.error)
