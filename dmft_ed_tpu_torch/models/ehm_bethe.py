"""Extended Hubbard model on the Bethe lattice (drivers/ed_ehm_bethe.f90),
PyTorch port of dmft_ed_tpu/models/ehm_bethe.py.

The nearest-neighbor interaction W0 enters at the Hartree level as a
density-dependent chemical-potential shift applied each DMFT iteration:
``xmu_eff = xmu0 - W0 * dens`` with ``xmu0 = xmu_input + W0``
(ed_ehm_bethe.f90:41,88), and the self-consistency uses the Bethe
shortcut Delta = (W^2/4) Gloc (:113). The shift replaces ``solver.cfg``
each iteration: the solver rebuilds every sector operator from its cfg
on each solve and keeps nothing built under an earlier xmu.

Run: ``python -m dmft_ed_tpu_torch.models.ehm_bethe [input] [KEY=value
...]`` (``DEVICE=cpu`` runs on the CPU; the default is cuda). Driver
extras: W0, WBAND, WMIXING, LE.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from . import driver_args, split_device
from ..solver import EDSolver
from ..lattice import (bethe_bands, gloc_dos, kinetic_energy,
                       ConvergenceMonitor)


@dataclass
class EhmResult:
    converged: bool
    iterations: int
    bath: np.ndarray
    smats: np.ndarray
    gmats: np.ndarray
    delta: np.ndarray
    dens: np.ndarray
    docc: np.ndarray
    xmu_eff: float
    egs: float
    ekin: float
    error: float


def run(cfg: EDConfig | None = None, w0: float = 0.0, wband: float = 1.0,
        le: int = 500, wmixing: float = 0.5, log=None,
        device="cuda") -> EhmResult:
    if cfg is None:
        cfg = EDConfig()
    # this driver feeds the hybridization Delta = (W^2/4) Gloc to the fit
    # (the reference runs it with CG_SCHEME=delta in the input file)
    cfg = cfg.replace(cg_scheme="delta").validate()
    if cfg.norb != 1 or cfg.nspin != 1:
        raise ValueError("ed_ehm_bethe requires Norb=1, Nspin=1 "
                         "(ed_ehm_bethe.f90:44-45)")
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    eb, db, h0 = bethe_bands(1, wband, le)
    hloc = np.zeros((1, 1, 1, 1))
    xmu0 = cfg.xmu + w0                       # ed_ehm_bethe.f90:41
    dens = 1.0                                # initial guess at half filling
    solver = EDSolver(cfg, hloc, device=device)
    bath = solver.init_solver()
    bath_prev = bath.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged = False
    iloop = 0
    res = None
    delta = None
    xmu_eff = xmu0 - w0 * dens
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- EHM DMFT loop {iloop}/{cfg.nloop} (W0={w0}) ---")
        # Hartree shift from the nn interaction (ed_ehm_bethe.f90:88)
        xmu_eff = xmu0 - w0 * dens
        solver.cfg = cfg = cfg.replace(xmu=xmu_eff)
        res = solver.solve(bath)
        dens = float(res.observables.dens.sum())
        gloc = gloc_dos(cfg, eb, db, h0, res.smats, "mats")
        # Bethe shortcut: Delta = (W^2/4) Gloc (ed_ehm_bethe.f90:113)
        delta = (wband ** 2 / 4.0) * gloc
        bath = solver.chi2_fitgf(delta, bath, ispin=0)
        if iloop > 1:
            bath = wmixing * bath + (1 - wmixing) * bath_prev
        bath_prev = bath.copy()
        converged = monitor.check(delta[0, 0, 0, 0], log=_log)
        _log(f"dens={dens:.9f} xmu_eff={xmu_eff:.9f}")
    ekin = kinetic_energy(cfg, eb, db, h0, res.smats)
    return EhmResult(converged=converged, iterations=iloop, bath=bath,
                     smats=res.smats, gmats=gloc_dos(cfg, eb, db, h0,
                                                     res.smats, "mats"),
                     delta=delta, dens=res.observables.dens,
                     docc=res.observables.docc, xmu_eff=xmu_eff,
                     egs=res.egs, ekin=ekin, error=monitor.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv)
    kw = driver_args(argv, {"W0": ("w0", float), "WBAND": ("wband", float),
                            "LE": ("le", int),
                            "WMIXING": ("wmixing", float)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iters={r.iterations} dens={r.dens} "
          f"docc={r.docc} xmu_eff={r.xmu_eff:.6f}")
    return r


if __name__ == "__main__":
    main()
