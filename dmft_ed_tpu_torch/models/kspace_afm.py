"""Two-sublattice antiferromagnetic DMFT over a Bloch Hamiltonian
(drivers/ed_graphene_afm.f90, ed_hm_square_afm2.f90, ed_bhz_2d_afm2.f90
class): the magnetic unit cell holds 2 inequivalent Nspin=2 impurities
seeded with opposite symmetry-breaking fields (sb_field ±), closed through
the site-resolved k-sum Gloc (gloc_hk_lattice). PyTorch port of
dmft_ed_tpu/models/kspace_afm.py: the two sites' sweeps stack in one
site-batched solve and the k-sum runs on the device.

Run: ``python -m dmft_ed_tpu_torch.models.kspace_afm [input] ULOC=3.0
LATTICE=graphene|square NK=12 TS=1.0`` (``DEVICE=cpu`` runs on the CPU; the
default is cuda).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from ..lattice_solver import LatticeEDSolver
from ..lattice import gloc_hk_lattice, self_consistency, ConvergenceMonitor
from . import driver_args, split_device
from .kspace import hk_graphene
from .ahm_stripe import stripe_hk


def expand_spin(hk: np.ndarray, nspin: int) -> np.ndarray:
    """[Nlat, Nlat, Nk] spinless Bloch matrix -> [Nlat*nspin, ...] with the
    site-major (site, spin) ordering gloc_hk_lattice expects."""
    nlat, _, nkk = hk.shape
    out = np.zeros((nlat * nspin, nlat * nspin, nkk), dtype=complex)
    for s in range(nspin):
        out[s::nspin, s::nspin] = hk
    return out


@dataclass
class KspaceAfmResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    smats_ineq: np.ndarray
    dens: np.ndarray
    magz: np.ndarray     # [Nlat=2, Norb]
    error: float


def run(cfg: EDConfig, hk2: np.ndarray, wmixing: float = 0.5,
        log=None, device="cuda") -> KspaceAfmResult:
    """hk2: spinless 2-sublattice Bloch Hamiltonian [2, 2, Nk]."""
    cfg = cfg.validate()
    if cfg.nspin != 2 or cfg.norb != 1:
        raise ValueError("AFM k-space: Nspin=2, Norb=1")
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    nlat = 2
    hks = expand_spin(hk2, 2)
    hloc_so = hk2.mean(axis=-1)
    hloc_ineq = np.zeros((nlat, 2, 2, 1, 1), dtype=complex)
    for i in range(nlat):
        for s in range(2):
            hloc_ineq[i, s, s, 0, 0] = hloc_so[i, i].real
    lsolver = LatticeEDSolver(cfg, hloc_ineq, log=_log, device=device)
    # Néel seed: opposite sb_field on the two sublattices
    baths = lsolver.init_solvers(sb_field_sign=[+1, -1])
    baths_prev = baths.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- AFM k-space DMFT loop {iloop}/{cfg.nloop} ---")
        lsolver.solve(baths)
        smats_ineq = lsolver.get_sigma_matsubara()
        with lsolver.timers("gloc"):
            gm_ineq = gloc_hk_lattice(cfg, hks, smats_ineq, "mats",
                                      device=lsolver.device)
        weiss_ineq = np.stack([
            self_consistency(cfg, gm_ineq[i], smats_ineq[i], hloc_ineq[i])
            for i in range(nlat)])
        baths = lsolver.chi2_fitgf(weiss_ineq, baths)
        if iloop > 1:
            baths = wmixing * baths + (1 - wmixing) * baths_prev
        baths_prev = baths.copy()
        converged = monitor.check(
            np.stack([weiss_ineq[0, 0, 0, 0, 0],
                      weiss_ineq[0, 1, 1, 0, 0]]), log=_log)
    return KspaceAfmResult(converged=converged, iterations=iloop,
                           baths=baths,
                           smats_ineq=lsolver.get_sigma_matsubara(),
                           dens=lsolver.get_dens()[:, 0],
                           magz=lsolver.get_mag(), error=monitor.error)


def run_graphene(cfg: EDConfig, nk: int = 12, t: float = 1.0,
                 **kw) -> KspaceAfmResult:
    """ed_graphene_afm.f90: honeycomb bipartite Néel order."""
    return run(cfg, hk_graphene(nk, t), **kw)


def run_square_afm2(cfg: EDConfig, nk: int = 12, t: float = 0.25,
                    **kw) -> KspaceAfmResult:
    """ed_hm_square_afm2.f90: square lattice, 2-site magnetic supercell."""
    return run(cfg, stripe_hk(2, 1, nk, t), **kw)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    cfg = read_input(path, argv, nspin=2)
    kw = dict(dict(lattice="graphene", nk=12, t=1.0), **driver_args(argv, {
        "LATTICE": ("lattice", str.lower), "NK": ("nk", int),
        "TS": ("t", float)}))
    fn = run_graphene if kw.pop("lattice") == "graphene" else run_square_afm2
    r = fn(cfg, device=device, **kw)
    print(f"converged={r.converged} iters={r.iterations} dens={r.dens} "
          f"magz={r.magz[:, 0]}")
    return r


if __name__ == "__main__":
    main()
