"""Attractive Hubbard model on the Bethe lattice — superconducting DMFT
(drivers/ed_ahm_bethe.f90; BASELINE.json config 3: Nambu sectors,
anomalous GF), PyTorch port of dmft_ed_tpu/models/ahm_bethe.py.

Run: ``python -m dmft_ed_tpu_torch.models.ahm_bethe [input_file]
[KEY=value ...]`` (``DEVICE=cpu`` runs on the CPU; the default is cuda).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from . import split_device
from ..solver import EDSolver
from ..bath import ph_symmetrize_bath, enforce_normal_bath
from ..lattice import (bethe_bands, gloc_superc_dos, self_consistency_superc,
                       kinetic_energy_superc, ConvergenceMonitor)
from ..aux import search_variable


@dataclass
class AhmResult:
    converged: bool
    iterations: int
    bath: np.ndarray
    smats: np.ndarray
    smats_an: np.ndarray
    gmats: np.ndarray
    fmats: np.ndarray
    dens: np.ndarray
    docc: np.ndarray
    phisc: np.ndarray
    egs: float
    ekin: float
    error: float


def run(cfg: EDConfig | None = None, le: int = 500, wbethe=1.0,
        wmixing: float = 0.5, phsym: bool = False, normal_bath: bool = False,
        log=None, solver: EDSolver | None = None,
        device="cuda") -> AhmResult:
    """device: where every tensor of the solve lives (ignored when a
    `solver` is passed — it carries its own)."""
    if cfg is None:
        cfg = EDConfig(ed_mode="superc", uloc=(-2.0,))
    cfg = cfg.validate()
    if cfg.ed_mode != "superc":
        raise ValueError("ahm_bethe requires ed_mode='superc'")
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)

    eb, db, h0 = bethe_bands(cfg.norb, wbethe, le)
    hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))

    if solver is None:
        solver = EDSolver(cfg, hloc, device=device)
    bath = solver.init_solver()
    bath_prev = bath.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop,
                                 mesh=solver.mesh)
    converged = False
    iloop = 0
    res = None
    xmu = cfg.xmu
    sstate: dict = {}
    gm = fm = None
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- DMFT loop {iloop}/{cfg.nloop} (superc) ---")
        res = solver.solve(bath)
        with solver.timers("gloc"):
            gm, fm = gloc_superc_dos(cfg, eb, db, h0, res.smats,
                                     res.smats_an)
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
                                         sstate, _log, mesh=solver.mesh)
            converged = converged and conv2
            cfg = cfg.replace(xmu=xmu)
            solver.cfg = cfg
    ekin = kinetic_energy_superc(cfg, eb, db, h0, res.smats, res.smats_an)
    return AhmResult(converged=converged, iterations=iloop, bath=bath,
                     smats=res.smats, smats_an=res.smats_an, gmats=gm,
                     fmats=fm, dens=res.observables.dens,
                     docc=res.observables.docc, phisc=res.observables.phisc,
                     egs=res.egs, ekin=ekin, error=monitor.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv, ed_mode="superc")
    r = run(cfg, device=device)
    print(f"converged={r.converged} iters={r.iterations} dens={r.dens} "
          f"docc={r.docc} phi={r.phisc}")
    return r


if __name__ == "__main__":
    main()
