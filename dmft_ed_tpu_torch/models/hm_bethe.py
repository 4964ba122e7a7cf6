"""Single/multi-band Hubbard model on the Bethe lattice — the canonical DMFT
driver (drivers/ed_hm_bethe.f90), PyTorch port of
dmft_ed_tpu/models/hm_bethe.py.

Run: ``python -m dmft_ed_tpu_torch.models.hm_bethe [input_file] [KEY=value ...]``
(``DEVICE=cpu`` runs on the CPU; the default is cuda).
Driver-level extras mirror the reference: LE, WBETHE, DBETHE, WMIXING,
BETHESC, WGIMP, MIXG0, SYMORBS (drivers/ed_hm_bethe.f90:38-45).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from . import split_device
from ..solver import EDSolver
from ..bath import orb_equality_bath
from ..lattice import (bethe_bands, gloc_dos, self_consistency,
                       kinetic_energy, ConvergenceMonitor)
from ..aux import search_variable
from .. import io as edio


@dataclass
class BetheResult:
    converged: bool
    iterations: int
    bath: np.ndarray
    smats: np.ndarray
    sreal: np.ndarray
    gmats: np.ndarray
    greal: np.ndarray
    weiss: np.ndarray
    dens: np.ndarray
    docc: np.ndarray
    egs: float
    ekin: float
    error: float


def run(cfg: EDConfig | None = None, le: int = 500, wbethe=1.0, dbethe=0.0,
        wmixing: float = 0.5, bethe_sc: bool = False, wgimp: bool = False,
        mix_g0: bool = False, sym_orbs: bool = False, log=None,
        solver: EDSolver | None = None, bands=None,
        phsym: bool = False, device="cuda") -> BetheResult:
    """bands: optional (Ebands, Dbands, H0) triple overriding the Bethe
    DOS — the same loop then serves any DOS-integral driver
    (lattice.dos_bands; ed_hm_2bands_dos.f90 / ed_hm_square_dos.f90).
    phsym: enforce particle-hole symmetry of the fitted bath each
    iteration (ph_symmetrize_bath — the AHM drivers' optional flag).
    device: where every tensor of the solve lives (ignored when a
    `solver` is passed — it carries its own)."""
    if cfg is None:
        cfg = EDConfig()
    cfg = cfg.validate()
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)

    eb, db, h0 = bands if bands is not None else bethe_bands(
        cfg.norb, wbethe, le, np.broadcast_to(
            np.asarray(dbethe, dtype=float), (cfg.norb,)))
    wband = np.broadcast_to(np.asarray(wbethe, dtype=float), (cfg.norb,))
    hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    for a in range(cfg.norb):
        hloc[:, :, a, a] = np.eye(cfg.nspin) * h0[a]

    if solver is None:
        solver = EDSolver(cfg, hloc, device=device)
    bath = solver.init_solver()
    bath_prev = bath.copy()
    weiss_prev = None

    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged = False
    iloop = 0
    weiss = None
    res = None
    xmu = cfg.xmu
    search_state: dict = {}
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- DMFT loop {iloop}/{cfg.nloop} ---")
        res = solver.solve(bath)
        smats, sreal = res.smats, res.sreal
        with solver.timers("gloc"):
            gmats = gloc_dos(cfg, eb, db, h0, smats, "mats")
            greal = gloc_dos(cfg, eb, db, h0, sreal, "real")
        with solver.timers("weiss"):
            if bethe_sc:
                gm = res.gmats if wgimp else gmats
                weiss = self_consistency(cfg, gm, smats, hloc, wbands=wband)
            else:
                # gloc_dos is orbital-diagonal -> the Weiss update must be too
                weiss = self_consistency(cfg, gmats, smats, hloc,
                                         diag_only=True)
        if mix_g0 and weiss_prev is not None:
            weiss = wmixing * weiss + (1 - wmixing) * weiss_prev
        if mix_g0:
            weiss_prev = weiss.copy()
        # bath fit
        if sym_orbs:
            bath = solver.chi2_fitgf(weiss, bath, ispin=0, iorb=0)
            bath = orb_equality_bath(cfg, bath, 0)
        else:
            bath = solver.chi2_fitgf(weiss, bath, ispin=0)
        if phsym:
            from ..bath import ph_symmetrize_bath
            bath = ph_symmetrize_bath(cfg, bath)
        if not mix_g0 and iloop > 1:
            bath = wmixing * bath + (1 - wmixing) * bath_prev
        bath_prev = bath.copy()
        # convergence on the orbital-averaged Weiss field (driver :147-159)
        gtest = np.mean([weiss[0, 0, a, a] for a in range(cfg.norb)], axis=0)
        converged = monitor.check(gtest, log=_log)
        if cfg.nread != 0.0:
            xmu, conv2 = search_variable(cfg, xmu, float(res.observables.dens
                                                         .sum()),
                                         search_state, _log)
            converged = converged and conv2
            cfg = cfg.replace(xmu=xmu)
            solver.cfg = cfg
    ekin = kinetic_energy(cfg, eb, db, h0, res.smats)
    wm = np.pi / cfg.beta * (2 * np.arange(1, cfg.lmats + 1) - 1)
    edio.splot("Gloc_iw.ed", wm, gmats[0, 0, 0, 0])
    return BetheResult(converged=converged, iterations=iloop, bath=bath,
                       smats=res.smats, sreal=res.sreal, gmats=gmats,
                       greal=greal, weiss=weiss, dens=res.observables.dens,
                       docc=res.observables.docc, egs=res.egs, ekin=ekin,
                       error=monitor.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    extras = {"device": device}
    cfg = read_input(path, argv)
    for tok in argv:
        if "=" not in tok:
            continue
        k, _, v = tok.partition("=")
        k = k.strip().upper()
        if k == "LE":
            extras["le"] = int(v)
        elif k == "WBETHE":
            extras["wbethe"] = float(v.split(",")[0])
        elif k == "DBETHE":
            extras["dbethe"] = float(v.split(",")[0])
        elif k == "WMIXING":
            extras["wmixing"] = float(v)
        elif k == "BETHESC":
            extras["bethe_sc"] = v.lower() in ("t", "true", "1", ".true.")
        elif k == "WGIMP":
            extras["wgimp"] = v.lower() in ("t", "true", "1", ".true.")
        elif k == "MIXG0":
            extras["mix_g0"] = v.lower() in ("t", "true", "1", ".true.")
        elif k == "SYMORBS":
            extras["sym_orbs"] = v.lower() in ("t", "true", "1", ".true.")
    r = run(cfg, **extras)
    print(f"converged={r.converged} iterations={r.iterations} "
          f"dens={r.dens} docc={r.docc} ekin={r.ekin:.8f}")
    return r


if __name__ == "__main__":
    main()
