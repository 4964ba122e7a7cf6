"""t2g model with atomic spin-orbit coupling — nonSU2 + replica bath DMFT
(drivers/ed_SOC.f90), PyTorch port of dmft_ed_tpu/models/soc.py.

Three orbitals (t2g) on a cubic lattice, H(k) = ε(k)·1 + λ_soc·(L·S):
spin-mixing atomic SOC requires ed_mode=nonsu2; the bath replicates the
impHloc structure (bath_type=replica) and the χ² fit optimizes the masked
matrix elements.

Run: ``python -m dmft_ed_tpu_torch.models.soc [input_file] [KEY=value ...]``
(``DEVICE=cpu`` runs on the CPU; the default is cuda; NK, TS, SOC and
WMIXING set the driver's own parameters).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from . import driver_args, split_device
from ..solver import EDSolver
from ..lattice import gloc_hk, self_consistency, ConvergenceMonitor
from ..aux import atomic_soc, so2nn, nn2so


def build_hk_soc(nk: int = 8, t: float = 0.5, soc: float = 0.25):
    """Hk [6, 6, Nk^3] cubic t2g + atomic SOC; returns (Hk, Hloc_nn)."""
    ls = nn2so(atomic_soc(), 2, 3)
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    hks = []
    for kx in ks:
        for ky in ks:
            for kz in ks:
                eps = -2 * t * (np.cos(kx) + np.cos(ky) + np.cos(kz))
                hks.append(eps * np.eye(6) + soc * ls)
    hk = np.stack(hks, axis=-1)
    hloc_so = hk.mean(axis=-1)
    hloc_so[np.abs(hloc_so) < 1e-10] = 0.0
    return hk, so2nn(hloc_so, 2, 3)


@dataclass
class SocResult:
    converged: bool
    iterations: int
    bath: np.ndarray
    smats: np.ndarray
    gmats: np.ndarray
    dens: np.ndarray
    error: float


def run(cfg: EDConfig | None = None, nk: int = 8, t: float = 0.5,
        soc: float = 0.25, wmixing: float = 0.5, log=None,
        solver: EDSolver | None = None, device="cuda") -> SocResult:
    """solver: an EDSolver built on this model's Hloc (build_hk_soc), to
    read its stage timers; device is then the solver's."""
    if cfg is None:
        cfg = EDConfig(norb=3, nspin=2, nbath=1, uloc=(1.0, 1.0, 1.0),
                       ed_mode="nonsu2", bath_type="replica")
    cfg = cfg.validate()
    assert cfg.norb == 3 and cfg.nspin == 2 and cfg.ed_mode == "nonsu2"
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    hk, hloc = build_hk_soc(nk, t, soc)
    if solver is None:
        solver = EDSolver(cfg, hloc, device=device)
    bath = solver.init_solver()
    bath_prev = bath.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    res = gm = weiss = None
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- DMFT loop {iloop}/{cfg.nloop} (SOC/nonsu2/replica) ---")
        res = solver.solve(bath)
        with solver.timers("gloc"):
            gm = gloc_hk(cfg, hk, res.smats, "mats", device=solver.device)
        with solver.timers("weiss"):
            weiss = self_consistency(cfg, gm, res.smats, hloc)
        bath = solver.chi2_fitgf(weiss, bath)
        if iloop > 1:
            bath = wmixing * bath + (1 - wmixing) * bath_prev
        bath_prev = bath.copy()
        converged = monitor.check(weiss[0, 0, 0, 0], log=_log)
    return SocResult(converged=converged, iterations=iloop, bath=bath,
                     smats=res.smats, gmats=gm,
                     dens=res.observables.dens, error=monitor.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv, norb=3, nspin=2, ed_mode="nonsu2",
                     bath_type="replica")
    kw = driver_args(argv, {"NK": ("nk", int), "TS": ("t", float),
                            "SOC": ("soc", float),
                            "WMIXING": ("wmixing", float)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iterations={r.iterations} dens={r.dens}")
    return r


if __name__ == "__main__":
    main()
