"""Hubbard slab: L layers of a square lattice with inter-layer hopping —
layer-resolved DMFT (drivers/ed_hm_slab.f90).

Mixed representation: in-plane momentum (k-sum) x real-space layers; each
inequivalent layer is one impurity, Σ is layer-block-diagonal
(gloc_hk_lattice). PyTorch port of dmft_ed_tpu/models/hm_slab.py: the
layers' sweeps stack in one site-batched solve and the k-sum runs on the
device.

Run: ``python -m dmft_ed_tpu_torch.models.hm_slab [input] ULOC=2.0
NLAYERS=4 NK=12`` (``DEVICE=cpu`` runs on the CPU; the default is cuda).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from ..lattice_solver import LatticeEDSolver
from ..lattice import gloc_hk_lattice, self_consistency, ConvergenceMonitor
from . import driver_args, split_device


def slab_hk(nlayers: int, nk: int = 16, t: float = 0.25,
            t_perp: float = 0.25) -> np.ndarray:
    """[Nlayers, Nlayers, Nk^2]: in-plane eps(k) on the diagonal + nearest
    inter-layer hopping."""
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    hks = []
    for kx in ks:
        for ky in ks:
            eps = -2 * t * (np.cos(kx) + np.cos(ky))
            h = eps * np.eye(nlayers)
            for l in range(nlayers - 1):
                h[l, l + 1] = -t_perp
                h[l + 1, l] = -t_perp
            hks.append(h)
    return np.stack(hks, axis=-1)


@dataclass
class SlabResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    smats_ineq: np.ndarray
    dens: np.ndarray     # per layer
    docc: np.ndarray
    error: float


def run(cfg: EDConfig, nlayers: int = 4, nk: int = 12, t: float = 0.25,
        t_perp: float = 0.25, wmixing: float = 0.5, log=None,
        device="cuda") -> SlabResult:
    cfg = cfg.validate()
    if cfg.norb != 1 or cfg.nspin != 1:
        raise ValueError("slab driver: 1-band per layer (Norb=1, Nspin=1)")
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    hk = slab_hk(nlayers, nk, t, t_perp)
    # mirror symmetry: layer l equivalent to nlayers-1-l
    lat2ineq = np.array([min(l, nlayers - 1 - l) for l in range(nlayers)])
    nineq = int(lat2ineq.max()) + 1
    ineq2lat = np.array([np.nonzero(lat2ineq == i)[0][0]
                         for i in range(nineq)])
    hloc_ineq = np.zeros((nineq, 1, 1, 1, 1))
    lsolver = LatticeEDSolver(cfg, hloc_ineq, log=_log, device=device)
    baths = lsolver.init_solvers()
    baths_prev = baths.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- slab DMFT loop {iloop}/{cfg.nloop} "
             f"({nineq} ineq of {nlayers} layers) ---")
        lsolver.solve(baths)
        smats_ineq = lsolver.get_sigma_matsubara()
        smats_lat = smats_ineq[lat2ineq]
        with lsolver.timers("gloc"):
            gm_lat = gloc_hk_lattice(cfg, hk, smats_lat, "mats",
                                     device=lsolver.device)
        gm_ineq = gm_lat[ineq2lat]
        weiss_ineq = np.stack([
            self_consistency(cfg, gm_ineq[i], smats_ineq[i], hloc_ineq[i])
            for i in range(nineq)])
        baths = lsolver.chi2_fitgf(weiss_ineq, baths, ispin=0)
        if iloop > 1:
            baths = wmixing * baths + (1 - wmixing) * baths_prev
        baths_prev = baths.copy()
        converged = monitor.check(weiss_ineq[0, 0, 0, 0, 0], log=_log)
    return SlabResult(converged=converged, iterations=iloop, baths=baths,
                      smats_ineq=lsolver.get_sigma_matsubara(),
                      dens=lsolver.get_dens()[lat2ineq][:, 0],
                      docc=lsolver.get_docc()[lat2ineq][:, 0],
                      error=monitor.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    cfg = read_input(path, argv)
    kw = driver_args(argv, {"NLAYERS": ("nlayers", int), "NK": ("nk", int)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iters={r.iterations} dens={r.dens}")
    return r


if __name__ == "__main__":
    main()
