"""Generic k-space DMFT loop + Bloch Hamiltonian builders for the 2D
lattice driver families of the reference (drivers/ed_hm_square*.f90,
ed_graphene*.f90, ed_haldane*.f90, ed_kane_mele.f90), PyTorch port of
dmft_ed_tpu/models/kspace.py.

Every driver is: build Hk on a BZ grid -> DMFT loop with k-sum Gloc ->
matrix Weiss update -> chi2 fit. The reference duplicates this per model;
here the loop is one function over any Hk. The builders are numpy, copied
from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import EDConfig
from ..solver import EDSolver
from ..bath import spin_symmetrize_bath
from ..lattice import gloc_hk, self_consistency, ConvergenceMonitor
from ..aux import so2nn, search_variable


@dataclass
class KspaceResult:
    converged: bool
    iterations: int
    bath: np.ndarray
    smats: np.ndarray
    gmats: np.ndarray
    weiss: np.ndarray
    dens: np.ndarray
    docc: np.ndarray
    error: float


def run_kspace(cfg: EDConfig, hk: np.ndarray, hloc=None,
               wmixing: float = 0.5, spinsym: bool = True, log=None,
               device="cuda") -> KspaceResult:
    """DMFT loop over a fixed Bloch Hamiltonian hk [Nso, Nso, Nk]."""
    cfg = cfg.validate()
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    if hloc is None:
        hloc_so = hk.mean(axis=-1)
        hloc_so[np.abs(hloc_so) < 1e-10] = 0.0
        hloc = so2nn(hloc_so, cfg.nspin, cfg.norb)
    solver = EDSolver(cfg, hloc, device=device)
    bath = solver.init_solver()
    bath_prev = bath.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    res = weiss = gm = None
    xmu = cfg.xmu
    sstate: dict = {}
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- DMFT loop {iloop}/{cfg.nloop} (k-space) ---")
        res = solver.solve(bath)
        with solver.timers("gloc"):
            gm = gloc_hk(cfg, hk, res.smats, "mats", device=solver.device)
        with solver.timers("weiss"):
            weiss = self_consistency(cfg, gm, res.smats, hloc)
        if spinsym and cfg.nspin > 1:
            bath = solver.chi2_fitgf(weiss, bath, ispin=0)
            bath = spin_symmetrize_bath(cfg, bath, solver.mask)
        else:
            bath = solver.chi2_fitgf(weiss, bath,
                                     ispin=0 if cfg.nspin == 1 else None)
        if iloop > 1:
            bath = wmixing * bath + (1 - wmixing) * bath_prev
        bath_prev = bath.copy()
        converged = monitor.check(weiss[0, 0, 0, 0], log=_log)
        if cfg.nread != 0.0:
            xmu, conv2 = search_variable(cfg, xmu,
                                         float(res.observables.dens.sum()),
                                         sstate, _log)
            converged = converged and conv2
            cfg = cfg.replace(xmu=xmu)
            solver.cfg = cfg
    return KspaceResult(converged=converged, iterations=iloop, bath=bath,
                        smats=res.smats, gmats=gm, weiss=weiss,
                        dens=res.observables.dens, docc=res.observables.docc,
                        error=monitor.error)


# ----------------------------------------------------------------------
# Bloch Hamiltonian builders
# ----------------------------------------------------------------------

def hk_square(nk: int = 32, t: float = 0.25, nso: int = 1) -> np.ndarray:
    """Square-lattice nearest-neighbor band (ed_hm_square.f90):
    eps(k) = -2t(cos kx + cos ky). Returns [nso, nso, Nk^2]."""
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    eps = np.array([-2 * t * (np.cos(kx) + np.cos(ky))
                    for kx in ks for ky in ks])
    return np.eye(nso)[:, :, None] * eps[None, None, :]


def hk_multiband_square(nk: int = 32, ts: float = 0.5, norb: int = 2,
                        shifts=None) -> np.ndarray:
    """Norb degenerate square-lattice bands with per-orbital crystal-field
    shifts: H_ab(k) = δ_ab [-2 ts (cos kx + cos ky) + shifts_a].
    shifts=[0,0]: drivers/ed_hm_2b_square.f90:128-147 (hk_model);
    shifts=[0,0,0.5*ts]: drivers/ed_hm_3b_square.f90:133-152 (the dxy
    orbital raised by dxy=0.5 ts). Returns [norb, norb, Nk^2]."""
    shifts = np.zeros(norb) if shifts is None else np.asarray(shifts, float)
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    eps = np.array([-2 * ts * (np.cos(kx) + np.cos(ky))
                    for kx in ks for ky in ks])
    return (np.eye(norb)[:, :, None] * eps[None, None, :]
            + np.diag(shifts)[:, :, None])


def hk_multiband_cubic(nk: int = 16, ts: float = 0.5, norb: int = 2,
                       shifts=None) -> np.ndarray:
    """Norb degenerate simple-cubic bands
    H_ab(k) = δ_ab [-2 ts (cos kx + cos ky + cos kz) + shifts_a]
    (drivers/ed_hm_2b_cubic.f90 — the 3d twin of ed_hm_2b_square.f90).
    Returns [norb, norb, Nk^3]."""
    shifts = np.zeros(norb) if shifts is None else np.asarray(shifts, float)
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    eps = np.array([-2 * ts * (np.cos(kx) + np.cos(ky) + np.cos(kz))
                    for kx in ks for ky in ks for kz in ks])
    return (np.eye(norb)[:, :, None] * eps[None, None, :]
            + np.diag(shifts)[:, :, None])


def hk_square_2nn(nk: int = 32, ts: float = 0.25, tsp: float = 0.0,
                  nso: int = 1) -> np.ndarray:
    """Square lattice with 2nd-neighbor hopping (ed_hm_square_2nn.f90
    hk_model): eps(k) = -2 ts (cos kx + cos ky) - 4 tsp cos kx cos ky."""
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    eps = np.array([-2 * ts * (np.cos(kx) + np.cos(ky))
                    - 4 * tsp * np.cos(kx) * np.cos(ky)
                    for kx in ks for ky in ks])
    return np.eye(nso)[:, :, None] * eps[None, None, :]


def hk_daghofer(nk: int = 24, alpha: float = 1.0, theta: float = 0.0,
                etanm: float = 0.0) -> np.ndarray:
    """Daghofer 3-band model for the pnictides (ed_hm_daghofer.f90
    hk_model: fixed t1..t8 set, dxy = 0.4 - theta crystal field,
    xmu_tb = 0.212 tight-binding shift, etanm nematic splitting).
    Returns [3, 3, Nk^2]."""
    t1, t2, t3, t4 = 0.02, 0.06, 0.03, -0.01
    t5, t6, t7 = 0.2 * alpha, 0.3 * alpha, -0.2 * alpha
    t8 = -t7 / 2.0
    dxy = 0.4 - theta
    xmu_tb = 0.212
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    hks = []
    for kx in ks:
        for ky in ks:
            h = np.zeros((3, 3), dtype=complex)
            h[0, 0] = (2 * t2 * np.cos(kx) + 2 * t1 * np.cos(ky)
                       + 4 * t3 * np.cos(kx) * np.cos(ky) - xmu_tb + etanm)
            h[1, 1] = (2 * t1 * np.cos(kx) + 2 * t2 * np.cos(ky)
                       + 4 * t3 * np.cos(kx) * np.cos(ky) - xmu_tb - etanm)
            h[2, 2] = (2 * t5 * (np.cos(kx) + np.cos(ky))
                       + 4 * t6 * np.cos(kx) * np.cos(ky) + dxy - xmu_tb)
            h[0, 1] = h[1, 0] = 4 * t4 * np.sin(kx) * np.sin(ky)
            h[0, 2] = (2j * t7 * np.sin(kx)
                       + 4j * t8 * np.sin(kx) * np.cos(ky))
            h[1, 2] = (2j * t7 * np.sin(ky)
                       + 4j * t8 * np.sin(ky) * np.cos(kx))
            h[2, 0] = np.conj(h[0, 2])
            h[2, 1] = np.conj(h[1, 2])
            hks.append(h)
    return np.stack(hks, axis=-1)


def hk_2bands_hyb_fcc3d(nk: int = 10, e0: float = 1.0, mh: float = 0.0,
                        lam: float = 0.5) -> np.ndarray:
    """Two bands with fcc-like interband hybridization
    (ed_hm_2bands_hyb_fcc3d.f90:3-4,401-402):
        H = [[ Mh - e0 Σcos,   λ(cos kx - cos ky) cos kz],
             [ h.c.,          -Mh - e0 Σcos            ]]."""
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    hks = []
    for kx in ks:
        for ky in ks:
            for kz in ks:
                eps = np.cos(kx) + np.cos(ky) + np.cos(kz)
                v = lam * (np.cos(kx) - np.cos(ky)) * np.cos(kz)
                hks.append(np.array([[mh - e0 * eps, v],
                                     [v, -mh - e0 * eps]], dtype=complex))
    return np.stack(hks, axis=-1)


def _honeycomb_fk(kx, ky, t):
    """Nearest-neighbor honeycomb structure factor (graphene convention:
    d1=(1,0), d2=(-1/2,√3/2), d3=(-1/2,-√3/2))."""
    return -t * (np.exp(1j * kx)
                 + np.exp(1j * (-kx / 2 + np.sqrt(3) / 2 * ky))
                 + np.exp(1j * (-kx / 2 - np.sqrt(3) / 2 * ky)))


def _honeycomb_grid(nk):
    """Uniform grid over the honeycomb BZ via the reciprocal basis."""
    b1 = 2 * np.pi * np.array([1 / 3, 1 / np.sqrt(3)])
    b2 = 2 * np.pi * np.array([1 / 3, -1 / np.sqrt(3)])
    fr = np.linspace(0, 1, nk, endpoint=False)
    return [f1 * b1 + f2 * b2 for f1 in fr for f2 in fr]


def hk_graphene(nk: int = 24, t: float = 1.0, mass: float = 0.0
                ) -> np.ndarray:
    """Honeycomb 2-sublattice band (ed_graphene.f90), optional Semenoff
    mass. [2, 2, Nk^2]."""
    hks = []
    for k in _honeycomb_grid(nk):
        f = _honeycomb_fk(k[0], k[1], t)
        hks.append(np.array([[mass, f], [np.conj(f), -mass]]))
    return np.stack(hks, axis=-1)


def hk_haldane(nk: int = 24, t1: float = 1.0, t2: float = 0.1,
               phi: float = np.pi / 2, mass: float = 0.0) -> np.ndarray:
    """Haldane model (ed_haldane.f90): honeycomb + complex NNN hopping.
    [2, 2, Nk^2]."""
    a1 = np.array([3 / 2, np.sqrt(3) / 2])
    a2 = np.array([3 / 2, -np.sqrt(3) / 2])
    nnn = [a1, a2, a2 - a1]
    hks = []
    for k in _honeycomb_grid(nk):
        f = _honeycomb_fk(k[0], k[1], t1)
        g = sum(np.cos(np.dot(k, v)) for v in nnn)
        h = sum(np.sin(np.dot(k, v)) for v in nnn)
        d0 = -2 * t2 * np.cos(phi) * g
        dz = mass - 2 * t2 * np.sin(phi) * h
        hks.append(np.array([[d0 + dz, f], [np.conj(f), d0 - dz]]))
    return np.stack(hks, axis=-1)


def hk_kane_mele(nk: int = 24, t: float = 1.0, soc: float = 0.1
                 ) -> np.ndarray:
    """Kane-Mele model (ed_kane_mele.f90): two spin copies of Haldane with
    opposite fluxes. Basis (A↑, B↑, A↓, B↓): [4, 4, Nk^2]."""
    up = hk_haldane(nk, t, soc, np.pi / 2, 0.0)
    dw = hk_haldane(nk, t, soc, -np.pi / 2, 0.0)
    nkk = up.shape[-1]
    hk = np.zeros((4, 4, nkk), dtype=complex)
    hk[:2, :2] = up
    hk[2:, 2:] = dw
    return hk


def hk_wsm_3d(nk: int = 12, t: float = 1.0, mh: float = 2.0,
              lam: float = 1.0) -> np.ndarray:
    """3D Weyl semimetal, 2 bands (ed_wsm_3d.f90 class):
    H(k) = λ(sin kx σx + sin ky σy) + [mh - t(cos kx+cos ky+cos kz)] σz.
    Hosts Weyl nodes for |mh| < 3t. Returns [2, 2, Nk^3]."""
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    sy = np.array([[0, -1j], [1j, 0]], dtype=complex)
    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    hks = []
    for kx in ks:
        for ky in ks:
            for kz in ks:
                m = mh - t * (np.cos(kx) + np.cos(ky) + np.cos(kz))
                hks.append(lam * (np.sin(kx) * sx + np.sin(ky) * sy)
                           + m * sz)
    return np.stack(hks, axis=-1)
