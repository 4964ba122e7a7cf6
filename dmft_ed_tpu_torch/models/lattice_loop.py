"""Shared inequivalent-site k-space DMFT loop — PyTorch port of
dmft_ed_tpu/models/lattice_loop.py.

The reference duplicates this loop in every multi-site driver
(ed_BLG_AA.f90:118-150, ed_wsm_slab.f90:140-230, ed_bhz_2d_afm*.f90 ...):
solve the Nineq impurities -> site-resolved k-sum Gloc -> per-site Weiss
-> joint bath fit -> mix -> converge. Here it is one function over any
site-major Bloch Hamiltonian [Nlat*Nso, Nlat*Nso, Nk], with an optional
lat->ineq symmetry reduction and Néel seeding, on one `device`."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import EDConfig
from ..lattice_solver import LatticeEDSolver
from ..lattice import gloc_hk_lattice, self_consistency, ConvergenceMonitor
from ..aux import so2nn


@dataclass
class SitesResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    smats_ineq: np.ndarray
    gmats_ineq: np.ndarray
    weiss_ineq: np.ndarray
    dens: np.ndarray
    docc: np.ndarray
    magz: np.ndarray
    error: float
    solver: LatticeEDSolver = None


def run_sites(cfg: EDConfig, hks: np.ndarray, lat2ineq=None, sb_signs=None,
              wmixing: float = 0.5, fit_ispin=None, log=None,
              device="cuda") -> SitesResult:
    """hks: [Nlat*Nso, Nlat*Nso, Nk] site-major Bloch Hamiltonian."""
    cfg = cfg.validate()
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    nso = cfg.nspin * cfg.norb
    nlat = hks.shape[0] // nso
    lat2ineq = np.arange(nlat) if lat2ineq is None \
        else np.asarray(lat2ineq, dtype=int)
    nineq = int(lat2ineq.max()) + 1
    ineq2lat = np.array([np.nonzero(lat2ineq == i)[0][0]
                         for i in range(nineq)])
    hloc_lat = hks.mean(axis=-1)
    hloc_lat[np.abs(hloc_lat) < 1e-10] = 0.0
    hloc_ineq = np.stack([
        so2nn(hloc_lat[ineq2lat[i] * nso:(ineq2lat[i] + 1) * nso,
                       ineq2lat[i] * nso:(ineq2lat[i] + 1) * nso],
              cfg.nspin, cfg.norb) for i in range(nineq)])
    lsolver = LatticeEDSolver(cfg, hloc_ineq, log=_log, device=device)
    baths = lsolver.init_solvers(sb_field_sign=sb_signs)
    baths_prev = baths.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    weiss_ineq = gm_ineq = None
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- lattice DMFT loop {iloop}/{cfg.nloop} "
             f"({nineq} ineq of {nlat} sites) ---")
        lsolver.solve(baths)
        smats_ineq = lsolver.get_sigma_matsubara()
        with lsolver.timers("gloc"):
            gm_lat = gloc_hk_lattice(cfg, hks, smats_ineq[lat2ineq], "mats",
                                     device=lsolver.device)
        gm_ineq = gm_lat[ineq2lat]
        weiss_ineq = np.stack([
            self_consistency(cfg, gm_ineq[i], smats_ineq[i], hloc_ineq[i])
            for i in range(nineq)])
        baths = lsolver.chi2_fitgf(weiss_ineq, baths, ispin=fit_ispin)
        if iloop > 1:
            baths = wmixing * baths + (1 - wmixing) * baths_prev
        baths_prev = baths.copy()
        gtest = weiss_ineq[0, 0, 0, 0, 0] if cfg.nspin == 1 else \
            np.stack([weiss_ineq[0, 0, 0, 0, 0], weiss_ineq[0, 1, 1, 0, 0]])
        converged = monitor.check(gtest, log=_log)
    return SitesResult(converged=converged, iterations=iloop, baths=baths,
                       smats_ineq=lsolver.get_sigma_matsubara(),
                       gmats_ineq=gm_ineq, weiss_ineq=weiss_ineq,
                       dens=lsolver.get_dens(), docc=lsolver.get_docc(),
                       magz=lsolver.get_mag(), error=monitor.error,
                       solver=lsolver)
