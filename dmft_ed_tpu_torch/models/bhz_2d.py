"""BHZ model (2D topological insulator) DMFT (drivers/ed_bhz_2d.f90),
PyTorch port of dmft_ed_tpu/models/bhz_2d.py.

4 spin-orbitals (Nspin=2, Norb=2) on a square-lattice k-grid:
    H(k) = [[h(k), R(k)], [0, conj(h(-k))]] + h.c. parts
    h(k) = (mh - cos kx - cos ky)·σz + λ(sin kx·σx - sin ky·σy)
(hk_bhz / hk_bhz2x2, ed_bhz_2d.f90:289-324). With rh=0 the model is
spin-block-diagonal and runs in ed_mode=normal (Nspin=2); rh≠0 mixes spins
and requires ed_mode=nonsu2.

Run: ``python -m dmft_ed_tpu_torch.models.bhz_2d [input_file] [KEY=value
...]`` (``DEVICE=cpu`` runs on the CPU; the default is cuda; NK, MH,
LAMBDA, RH and WMIXING set the driver's own parameters).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from . import driver_args, split_device
from ..solver import EDSolver
from ..bath import spin_symmetrize_bath
from ..lattice import gloc_hk, self_consistency, ConvergenceMonitor
from ..aux import so2nn, search_variable


def hk_bhz(kx, ky, mh=1.0, llambda=0.3, rh=0.0):
    """[4, 4] BHZ Bloch Hamiltonian, basis (orb1↑, orb2↑, orb1↓, orb2↓)."""
    epsik = np.cos(kx) + np.cos(ky)
    h2 = np.array([[mh - epsik, llambda * (np.sin(kx) - 1j * np.sin(ky))],
                   [llambda * (np.sin(kx) + 1j * np.sin(ky)), -(mh - epsik)]],
                  dtype=complex)
    hk = np.zeros((4, 4), dtype=complex)
    hk[:2, :2] = h2
    h2m = np.array([[mh - epsik, llambda * (np.sin(-kx) - 1j * np.sin(-ky))],
                    [llambda * (np.sin(-kx) + 1j * np.sin(-ky)),
                     -(mh - epsik)]], dtype=complex)
    hk[2:, 2:] = np.conj(h2m)
    if rh != 0.0:
        hk[0, 2] = 1j * rh * (np.sin(kx) - 1j * np.sin(ky))
        hk[2, 0] = -1j * rh * (np.sin(kx) + 1j * np.sin(ky))
    return hk


def build_hk_grid(nk=20, mh=1.0, llambda=0.3, rh=0.0):
    """Hk [4, 4, Nk*Nk] on the uniform BZ grid + local Hamiltonian."""
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    hks = np.stack([hk_bhz(kx, ky, mh, llambda, rh)
                    for kx in ks for ky in ks], axis=-1)
    hloc_so = hks.mean(axis=-1)
    hloc_so[np.abs(hloc_so) < 1e-10] = 0.0
    return hks, hloc_so


@dataclass
class BhzResult:
    converged: bool
    iterations: int
    bath: np.ndarray
    smats: np.ndarray
    gmats: np.ndarray
    weiss: np.ndarray
    dens: np.ndarray
    error: float


def run(cfg: EDConfig | None = None, nk: int = 20, mh: float = 1.0,
        llambda: float = 0.3, rh: float = 0.0, wmixing: float = 0.5,
        spinsym: bool = True, log=None, hk_hloc=None,
        solver: EDSolver | None = None, device="cuda") -> BhzResult:
    """hk_hloc: optional precomputed (Hk [4,4,Nk], Hloc_so [4,4]) — lets
    sibling drivers (ed_bhz_3d.f90) reuse this loop with their own Bloch
    builder. solver: an EDSolver built on this model's Hloc, to read its
    stage timers; device is then the solver's."""
    if cfg is None:
        cfg = EDConfig(norb=2, nspin=2, nbath=2, uloc=(1.0, 1.0))
    cfg = cfg.validate()
    assert cfg.norb == 2 and cfg.nspin == 2, "BHZ needs Nspin=Norb=2"
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    hk, hloc_so = hk_hloc if hk_hloc is not None \
        else build_hk_grid(nk, mh, llambda, rh)
    hloc = so2nn(hloc_so, cfg.nspin, cfg.norb)
    if solver is None:
        solver = EDSolver(cfg, hloc, device=device)
    bath = solver.init_solver()
    bath_prev = bath.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop,
                                 mesh=solver.mesh)
    converged, iloop = False, 0
    res = weiss = gm = None
    xmu = cfg.xmu
    sstate: dict = {}
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- DMFT loop {iloop}/{cfg.nloop} (BHZ) ---")
        res = solver.solve(bath)
        with solver.timers("gloc"):
            gm = gloc_hk(cfg, hk, res.smats, "mats", device=solver.device)
        with solver.timers("weiss"):
            weiss = self_consistency(cfg, gm, res.smats, hloc)
        if spinsym:
            bath = solver.chi2_fitgf(weiss, bath, ispin=0)
            bath = spin_symmetrize_bath(cfg, bath, solver.mask)
        else:
            bath = solver.chi2_fitgf(weiss, bath)
        if iloop > 1:
            bath = wmixing * bath + (1 - wmixing) * bath_prev
        bath_prev = bath.copy()
        converged = monitor.check(weiss[0, 0, 0, 0], log=_log)
        if cfg.nread != 0.0:
            xmu, conv2 = search_variable(cfg, xmu,
                                         float(res.observables.dens.sum()),
                                         sstate, _log, mesh=solver.mesh)
            converged = converged and conv2
            cfg = cfg.replace(xmu=xmu)
            solver.cfg = cfg
    return BhzResult(converged=converged, iterations=iloop, bath=bath,
                     smats=res.smats, gmats=gm, weiss=weiss,
                     dens=res.observables.dens, error=monitor.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv, norb=2, nspin=2)
    kw = driver_args(argv, {"NK": ("nk", int), "MH": ("mh", float),
                            "LAMBDA": ("llambda", float),
                            "RH": ("rh", float),
                            "WMIXING": ("wmixing", float)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iterations={r.iterations} dens={r.dens}")
    return r


if __name__ == "__main__":
    main()
