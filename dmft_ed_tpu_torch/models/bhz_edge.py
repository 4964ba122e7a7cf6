"""BHZ strip with open edges — layer-resolved DMFT (drivers/
ed_bhz_2d_edge.f90): Ly layers periodic along x, open along y; each layer
is an Nspin=2/Norb=2 impurity and the lattice closes through the
layer-resolved k-sum Gloc (gloc_hk_lattice). The topological phase shows
gapless helical edge modes on the strip spectrum.

PyTorch port of dmft_ed_tpu/models/bhz_edge.py: the layers' sweeps stack
in one site-batched solve and the k-sum runs on the device.

Run: ``python -m dmft_ed_tpu_torch.models.bhz_edge [input] LY=4 NKX=12
MH=1.0 LAMBDA=0.3`` (``DEVICE=cpu`` runs on the CPU; the default is cuda).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from ..lattice_solver import LatticeEDSolver
from ..lattice import gloc_hk_lattice, self_consistency, ConvergenceMonitor
from ..aux import so2nn
from . import driver_args, split_device
from .bhz_2d import hk_bhz


def strip_hk_from_bulk(hk_fn, nkx: int, ly: int, nso: int,
                       nky_ft: int = 16) -> np.ndarray:
    """Generic bulk->strip builder: Fourier-transform the bulk Bloch
    Hamiltonian over ky to real-space layer hoppings A_d(kx) =
    (1/Nky) Σ_ky e^{-i ky d} H(kx, ky), then assemble the open-boundary
    strip H[l, l'] = A_{l-l'}. Exact for finite-range hoppings along y.
    Returns [Ly*nso, Ly*nso, Nkx]."""
    kxs = np.linspace(-np.pi, np.pi, nkx, endpoint=False)
    kys = np.linspace(-np.pi, np.pi, nky_ft, endpoint=False)
    out = np.zeros((ly * nso, ly * nso, nkx), dtype=complex)
    for ik, kx in enumerate(kxs):
        hks = np.stack([hk_fn(kx, ky) for ky in kys])    # [Nky, nso, nso]
        # hopping range along y is at most nky_ft//2 - 1
        ads = {d: np.tensordot(np.exp(-1j * kys * d), hks, axes=1) / nky_ft
               for d in range(-(ly - 1), ly)}
        H = np.zeros((ly * nso, ly * nso), dtype=complex)
        for l1 in range(ly):
            for l2 in range(ly):
                H[l1 * nso:(l1 + 1) * nso, l2 * nso:(l2 + 1) * nso] = \
                    ads[l1 - l2]
        out[:, :, ik] = H
    return out


def bhz_strip_hk(nkx: int = 16, ly: int = 6, mh: float = 1.0,
                 llambda: float = 0.3, rh: float = 0.0) -> np.ndarray:
    """[Ly*4, Ly*4, Nkx] BHZ strip (ed_bhz_2d_edge.f90 geometry)."""
    return strip_hk_from_bulk(
        lambda kx, ky: hk_bhz(kx, ky, mh, llambda, rh), nkx, ly, 4)


@dataclass
class BhzEdgeResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    smats_ineq: np.ndarray
    dens: np.ndarray     # [Nineq, Norb]
    error: float


def run(cfg: EDConfig, ly: int = 4, nkx: int = 12, mh: float = 1.0,
        llambda: float = 0.3, wmixing: float = 0.5, log=None,
        device="cuda") -> BhzEdgeResult:
    cfg = cfg.validate()
    if cfg.norb != 2 or cfg.nspin != 2:
        raise ValueError("BHZ edge: Nspin=Norb=2")
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    hk = bhz_strip_hk(nkx, ly, mh, llambda)
    # mirror symmetry: layer l equivalent to ly-1-l
    lat2ineq = np.array([min(l, ly - 1 - l) for l in range(ly)])
    nineq = int(lat2ineq.max()) + 1
    ineq2lat = np.array([np.nonzero(lat2ineq == i)[0][0]
                         for i in range(nineq)])
    nso = 4
    hloc_lat = hk.mean(axis=-1)
    hloc_ineq = np.stack([
        so2nn(hloc_lat[ineq2lat[i] * nso:(ineq2lat[i] + 1) * nso,
                       ineq2lat[i] * nso:(ineq2lat[i] + 1) * nso],
              cfg.nspin, cfg.norb) for i in range(nineq)])
    lsolver = LatticeEDSolver(cfg, hloc_ineq, log=_log, device=device)
    baths = lsolver.init_solvers()
    baths_prev = baths.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- BHZ-edge DMFT loop {iloop}/{cfg.nloop} "
             f"({nineq} ineq of {ly} layers) ---")
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
    return BhzEdgeResult(converged=converged, iterations=iloop, baths=baths,
                         smats_ineq=lsolver.get_sigma_matsubara(),
                         dens=lsolver.get_dens(), error=monitor.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    cfg = read_input(path, argv, norb=2, nspin=2)
    kw = driver_args(argv, {"LY": ("ly", int), "NKX": ("nkx", int),
                            "MH": ("mh", float),
                            "LAMBDA": ("llambda", float)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iterations={r.iterations} dens={r.dens}")
    return r


if __name__ == "__main__":
    main()
