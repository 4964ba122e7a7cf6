"""Weyl-semimetal slab — layer-resolved DMFT with open y boundaries
(drivers/ed_wsm_slab.f90).

4-band (Nspin=2, Norb=2) time-reversal-broken WSM:
  H0(kx,kz) = (Mh - e0(cos kx + cos kz)) s0.tz
            + lambda (sin kx s3.tx + sin kz s1.tx)
            + BIA s2.ty + bx s1.tz + bz s3.tz        (ed_wsm_slab.f90:73-81,
                                                      h0_rk_wsm :374-381)
  T_y      = -0.5 e0 s0.tz - 0.5i lambda s0.ty       (t0_rk_wsm :384-387)
assembled into a Ly-layer open slab; layers are inequivalent impurities
with optional left-right mirror reduction (lrsym, :394-400). The bz term
splits the Dirac point into Weyl nodes; Fermi-arc states live on the
surface layers.

PyTorch port of dmft_ed_tpu/models/wsm_slab.py: the layers' sweeps stack in
one site-batched solve and the k-sum runs on the device. Run:
``python -m dmft_ed_tpu_torch.models.wsm_slab [input] LY=4 NK=10 MH=2.0
LAMBDA=1.0 BX=0.0 BZ=0.1 BIA=0.0 WMIXING=0.5`` (``DEVICE=cpu`` runs on the
CPU; the default is cuda).
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

_S = [np.eye(2, dtype=complex),
      np.array([[0, 1], [1, 0]], dtype=complex),
      np.array([[0, -1j], [1j, 0]], dtype=complex),
      np.array([[1, 0], [0, -1]], dtype=complex)]


def _kron(i, j):
    return np.kron(_S[i], _S[j])


def wsm_slab_hk(nk: int, ly: int, e0: float = 1.0, mh: float = 2.0,
                llambda: float = 1.0, bx: float = 0.0, bz: float = 0.1,
                bia: float = 0.0) -> np.ndarray:
    """[Ly*4, Ly*4, Nk^2] slab Bloch Hamiltonian over the (kx, kz) BZ."""
    emat, soxm, soym, sozm = _kron(0, 3), _kron(3, 1), _kron(0, 2), \
        _kron(1, 1)
    bxm, bzm, biam = _kron(1, 3), _kron(3, 3), _kron(2, 2)
    T = -0.5 * e0 * emat - 0.5j * llambda * soym
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    out = np.zeros((ly * 4, ly * 4, nk * nk), dtype=complex)
    ik = 0
    for kx in ks:
        for kz in ks:
            h0 = ((mh - e0 * (np.cos(kx) + np.cos(kz))) * emat
                  + llambda * (np.sin(kx) * soxm + np.sin(kz) * sozm)
                  + bia * biam + bx * bxm + bz * bzm)
            H = np.zeros((ly * 4, ly * 4), dtype=complex)
            for l in range(ly):
                H[l * 4:(l + 1) * 4, l * 4:(l + 1) * 4] = h0
                if l + 1 < ly:
                    H[l * 4:(l + 1) * 4, (l + 1) * 4:(l + 2) * 4] = T
                    H[(l + 1) * 4:(l + 2) * 4, l * 4:(l + 1) * 4] = \
                        T.conj().T
            out[:, :, ik] = H
            ik += 1
    return out


@dataclass
class WsmSlabResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    smats_ineq: np.ndarray
    dens: np.ndarray     # [Nineq, Norb]
    magz: np.ndarray
    error: float


def run(cfg: EDConfig, ly: int = 4, nk: int = 10, e0: float = 1.0,
        mh: float = 2.0, llambda: float = 1.0, bx: float = 0.0,
        bz: float = 0.1, bia: float = 0.0, lrsym: bool = True,
        wmixing: float = 0.5, log=None, device="cuda") -> WsmSlabResult:
    cfg = cfg.validate()
    if cfg.norb != 2 or cfg.nspin != 2:
        raise ValueError("WSM slab: Nspin=Norb=2")
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    hk = wsm_slab_hk(nk, ly, e0, mh, llambda, bx, bz, bia)
    # left-right mirror symmetry (ilat2ineq, ed_wsm_slab.f90:394-400)
    if lrsym:
        lat2ineq = np.array([min(l, ly - 1 - l) for l in range(ly)])
    else:
        lat2ineq = np.arange(ly)
    nineq = int(lat2ineq.max()) + 1
    ineq2lat = np.array([np.nonzero(lat2ineq == i)[0][0]
                         for i in range(nineq)])
    nso = 4
    hloc_lat = hk.mean(axis=-1)
    hloc_lat[np.abs(hloc_lat) < 1e-10] = 0.0
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
        _log(f"--- WSM slab DMFT loop {iloop}/{cfg.nloop} "
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
        baths = lsolver.chi2_fitgf(weiss_ineq, baths)
        if iloop > 1:
            baths = wmixing * baths + (1 - wmixing) * baths_prev
        baths_prev = baths.copy()
        converged = monitor.check(weiss_ineq[0, 0, 0, 0, 0], log=_log)
    return WsmSlabResult(converged=converged, iterations=iloop, baths=baths,
                         smats_ineq=lsolver.get_sigma_matsubara(),
                         dens=lsolver.get_dens(), magz=lsolver.get_mag(),
                         error=monitor.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    cfg = read_input(path, argv, nspin=2, norb=2)
    extras = driver_args(argv, {
        "LY": ("ly", int), "NK": ("nk", int), "MH": ("mh", float),
        "LAMBDA": ("llambda", float), "BX": ("bx", float),
        "BZ": ("bz", float), "BIA": ("bia", float),
        "WMIXING": ("wmixing", float)})
    r = run(cfg, device=device, **extras)
    print(f"converged={r.converged} iters={r.iterations} "
          f"dens={r.dens[:, 0]}")
    return r


if __name__ == "__main__":
    main()
