"""Attractive Hubbard model on the 2D square lattice: superconducting DMFT
with a k-sum Nambu Gloc (drivers/ed_ahm_square.f90), PyTorch port of
dmft_ed_tpu/models/ahm_square.py.

The loop of ahm_bethe, with Gloc from the Bloch Hamiltonian
eps(k) = -2t(cos kx + cos ky) through lattice.gloc_hk_superc instead of
the Bethe DOS integral.

Run: ``python -m dmft_ed_tpu_torch.models.ahm_square [input] ULOC=-2.0
NK=20 TS=0.25`` (``DEVICE=cpu`` runs on the CPU; the default is cuda).
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import EDConfig, read_input
from . import driver_args, split_device
from ..solver import EDSolver
from ..bath import ph_symmetrize_bath, enforce_normal_bath
from ..lattice import (gloc_hk_superc, self_consistency_superc,
                       ConvergenceMonitor)
from ..aux import search_variable
from .kspace import hk_square
from .ahm_bethe import AhmResult


def run(cfg: EDConfig | None = None, nk: int = 20, ts: float = 0.25,
        wmixing: float = 0.5, phsym: bool = False, normal_bath: bool = False,
        log=None, device="cuda") -> AhmResult:
    if cfg is None:
        cfg = EDConfig(ed_mode="superc", uloc=(-2.0,))
    cfg = cfg.validate()
    if cfg.ed_mode != "superc" or cfg.norb != 1 or cfg.nspin != 1:
        raise ValueError("ahm_square requires ed_mode=superc, Norb=1, "
                         "Nspin=1")
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    hk = hk_square(nk, ts, nso=1)
    hloc = np.zeros((1, 1, 1, 1))
    solver = EDSolver(cfg, hloc, device=device)
    bath = solver.init_solver()
    bath_prev = bath.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    res = gm = fm = None
    xmu = cfg.xmu
    sstate: dict = {}
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- DMFT loop {iloop}/{cfg.nloop} (superc, square) ---")
        res = solver.solve(bath)
        with solver.timers("gloc"):
            gm, fm = gloc_hk_superc(cfg, hk, res.smats, res.smats_an,
                                    device=solver.device)
        with solver.timers("weiss"):
            wn, wa = self_consistency_superc(cfg, gm, fm, res.smats,
                                             res.smats_an, hloc)
        bath = solver.chi2_fitgf(wn, bath, ispin=0, fg_an=wa)
        if phsym:
            bath = ph_symmetrize_bath(cfg, bath)
        if normal_bath:
            bath = enforce_normal_bath(cfg, bath)
        if iloop > 1:
            bath = wmixing * bath + (1 - wmixing) * bath_prev
        bath_prev = bath.copy()
        converged = monitor.check(wn[0, 0, 0, 0], log=_log)
        if cfg.nread != 0.0:
            xmu, conv2 = search_variable(cfg, xmu,
                                         float(res.observables.dens.sum()),
                                         sstate, _log)
            converged = converged and conv2
            cfg = cfg.replace(xmu=xmu)
            solver.cfg = cfg
    return AhmResult(converged=converged, iterations=iloop, bath=bath,
                     smats=res.smats, smats_an=res.smats_an, gmats=gm,
                     fmats=fm, dens=res.observables.dens,
                     docc=res.observables.docc, phisc=res.observables.phisc,
                     egs=res.egs, ekin=0.0, error=monitor.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv, ed_mode="superc")
    kw = driver_args(argv, {"NK": ("nk", int), "TS": ("ts", float)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iters={r.iterations} dens={r.dens} "
          f"phi={r.phisc}")
    return r


if __name__ == "__main__":
    main()
