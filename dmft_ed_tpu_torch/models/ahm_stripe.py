"""Attractive Hubbard model with a periodic U(x) stripe modulation —
superconducting supercell DMFT (drivers/ed_ahm_stripe.f90), PyTorch port of
dmft_ed_tpu/models/ahm_stripe.py.

The stripe supercell (Xperiod x Yperiod sites of the square lattice)
repeats over a reduced BZ; every supercell site is an inequivalent superc
impurity with its OWN interaction strength U(x) (the reference builds a
Uij pattern and a supercell Hk_stripe, ed_ahm_stripe.f90:140-172). The
lattice closes through the k-summed Nambu Gloc of the supercell Bloch
Hamiltonian (gloc_hk_lattice_superc, on the device). `run_stack` is the
ed_ahm_stackU heterostructure over the same loop.

Run: ``python -m dmft_ed_tpu_torch.models.ahm_stripe [input] ULOC=-2.0
LX=2 LY=1 NK=8 TS=0.25`` (``DEVICE=cpu`` runs on the CPU; the default is
cuda).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from ..lattice_solver import LatticeEDSolver
from ..lattice import (gloc_hk_lattice_superc, self_consistency_superc,
                       ConvergenceMonitor)
from . import driver_args, split_device


def stripe_hk(lx: int, ly: int, nk: int = 8, t: float = 0.25) -> np.ndarray:
    """Supercell Bloch Hamiltonian of the square lattice: [Nlat, Nlat, Nk²]
    with Nlat = lx*ly, nearest-neighbor hopping; bonds wrapping the
    supercell pick up the Bloch phase over the reduced BZ
    (get_k_hamiltonian_stripe_fast, ed_ahm_stripe.f90:140)."""
    nlat = lx * ly
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)

    def site(x, y):
        return x * ly + y

    hks = []
    for kx in ks:
        for ky in ks:
            h = np.zeros((nlat, nlat), dtype=complex)
            for x in range(lx):
                for y in range(ly):
                    i = site(x, y)
                    # +x neighbor (phase over the supercell length)
                    xp, wrapx = (x + 1) % lx, (x + 1) // lx
                    h[i, site(xp, y)] += -t * np.exp(1j * kx * wrapx)
                    h[site(xp, y), i] += -t * np.exp(-1j * kx * wrapx)
                    # +y neighbor
                    yp, wrapy = (y + 1) % ly, (y + 1) // ly
                    h[i, site(x, yp)] += -t * np.exp(1j * ky * wrapy)
                    h[site(x, yp), i] += -t * np.exp(-1j * ky * wrapy)
            hks.append(h)
    return np.stack(hks, axis=-1)


def stripe_upattern(lx: int, ly: int, u0: float, u1: float) -> np.ndarray:
    """Per-site U: attractive stripes of strength u0 / u1 alternating along
    x (the 'periodic Hubbard modulation' of ed_ahm_stripe.f90)."""
    u = np.empty(lx * ly)
    for x in range(lx):
        u[x * ly:(x + 1) * ly] = u0 if x < (lx + 1) // 2 else u1
    return u


def stack_hk(nlayers: int, n_umin: int, nk: int = 6, nkz: int = 4,
             ts: float = 0.25, t_perp: float = 0.5,
             alpha_join: float = 1.0) -> np.ndarray:
    """U-stack superlattice Bloch Hamiltonian (drivers/ed_ahm_stackU.f90:
    212-245): a periodic stack of 2D layers — per-layer in-plane
    dispersion -2·ts·(cos kx + cos ky), interlayer bonds -t_slab(i)
    between layers i, i+1 and the Bloch-phased wrap bond along the stack
    axis. t_slab = t_perp everywhere except inside the U_min domain
    (layers 1..n_umin) and on the wrap bond, which are scaled by
    alpha_join (the junction-coupling knob). [Nlat, Nlat, nk²·nkz]."""
    t_slab = np.full(nlayers, t_perp)
    t_slab[:n_umin] = t_perp * alpha_join
    t_slab[nlayers - 1] = t_perp * alpha_join
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    kzs = np.linspace(-np.pi, np.pi, nkz, endpoint=False)
    hks = []
    for kx in ks:
        for ky in ks:
            eps = -2.0 * ts * (np.cos(kx) + np.cos(ky))
            for kz in kzs:
                h = np.diag(np.full(nlayers, eps + 0j))
                for i in range(nlayers - 1):
                    h[i, i + 1] += -t_slab[i]
                    h[i + 1, i] += -t_slab[i]
                h[0, nlayers - 1] += -t_slab[nlayers - 1] * np.exp(1j * kz)
                h[nlayers - 1, 0] += -t_slab[nlayers - 1] * np.exp(-1j * kz)
                hks.append(h)
    return np.stack(hks, axis=-1)


def stack_upattern(nlayers: int, n_umin: int, u_min: float,
                   u_max: float) -> np.ndarray:
    """Per-layer U of the stack: u_min on layers 1..n_umin, u_max on the
    rest (ed_ahm_stackU.f90:284-286)."""
    u = np.full(nlayers, u_max)
    u[:n_umin] = u_min
    return u


@dataclass
class AhmStripeResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    dens: np.ndarray
    docc: np.ndarray
    phisc: np.ndarray
    uloc_sites: np.ndarray
    error: float


def run(cfg: EDConfig, lx: int = 2, ly: int = 1, nk: int = 8,
        ts: float = 0.25, uloc_sites=None, wmixing: float = 0.5,
        log=None, hk=None, device="cuda") -> AhmStripeResult:
    """hk: optional prebuilt supercell Bloch Hamiltonian [Nlat, Nlat, Nk]
    replacing the stripe builder (used by run_stack for the stackU
    geometry). Every site is an inequivalent superc impurity with its own
    config (its U); the sites' sweeps stack in one site-batched solve."""
    cfg = cfg.validate()
    if cfg.ed_mode != "superc" or cfg.norb != 1 or cfg.nspin != 1:
        raise ValueError("ahm_stripe requires ed_mode=superc, Norb=1, "
                         "Nspin=1")
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    nlat = lx * ly if hk is None else hk.shape[0]
    if uloc_sites is None:
        uloc_sites = stripe_upattern(lx, ly, cfg.uloc[0], 0.5 * cfg.uloc[0])
    uloc_sites = np.asarray(uloc_sites, dtype=float)
    if hk is None:
        hk = stripe_hk(lx, ly, nk, ts)
    hloc_ineq = np.zeros((nlat, 1, 1, 1, 1))
    cfgs = [cfg.replace(uloc=(float(uloc_sites[i]),)) for i in range(nlat)]
    lsolver = LatticeEDSolver(cfg, hloc_ineq, log=_log, cfgs=cfgs,
                              device=device)
    baths = lsolver.init_solvers()
    baths_prev = baths.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- stripe-SC DMFT loop {iloop}/{cfg.nloop} "
             f"({lx}x{ly} supercell) ---")
        lsolver.solve(baths)
        smats = lsolver.get_sigma_matsubara()
        samats = np.stack([r.smats_an for r in lsolver.results])
        with lsolver.timers("gloc"):
            gm, fm = gloc_hk_lattice_superc(cfg, hk, smats, samats, "mats",
                                            device=lsolver.device)
        wn = np.zeros_like(gm)
        wa = np.zeros_like(fm)
        for i in range(nlat):
            wn[i], wa[i] = self_consistency_superc(
                cfg, gm[i], fm[i], smats[i], samats[i], hloc_ineq[i])
        baths = lsolver.chi2_fitgf(wn, baths, ispin=0, fg_an_ineq=wa)
        if iloop > 1:
            baths = wmixing * baths + (1 - wmixing) * baths_prev
        baths_prev = baths.copy()
        converged = monitor.check(wn[0, 0, 0, 0, 0], log=_log)
    phisc = np.stack([r.observables.phisc for r in lsolver.results])
    return AhmStripeResult(converged=converged, iterations=iloop,
                           baths=baths, dens=lsolver.get_dens()[:, 0],
                           docc=lsolver.get_docc()[:, 0],
                           phisc=phisc[:, 0], uloc_sites=uloc_sites,
                           error=monitor.error)


def run_stack(cfg: EDConfig, nlayers: int = 4, n_umin: int = 2,
              nk: int = 6, nkz: int = 4, ts: float = 0.25,
              t_perp: float = 0.5, alpha_join: float = 1.0,
              u_min: float = None, u_max: float = None,
              wmixing: float = 0.5, log=None,
              device="cuda") -> AhmStripeResult:
    """drivers/ed_ahm_stackU.f90: attractive-Hubbard heterostructure — a
    periodic stack of 2D layers with two U domains (u_min on layers
    1..n_umin, u_max on the rest) joined through alpha_join-scaled
    interlayer bonds; every layer is an inequivalent superc impurity."""
    if u_max is None:
        u_max = cfg.uloc[0]
    if u_min is None:
        u_min = 0.5 * cfg.uloc[0]
    hk = stack_hk(nlayers, n_umin, nk, nkz, ts, t_perp, alpha_join)
    uloc = stack_upattern(nlayers, n_umin, u_min, u_max)
    return run(cfg, uloc_sites=uloc, wmixing=wmixing, log=log, hk=hk,
               device=device)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    cfg = read_input(path, argv, ed_mode="superc")
    kw = driver_args(argv, {"LX": ("lx", int), "LY": ("ly", int),
                            "NK": ("nk", int), "TS": ("ts", float)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iters={r.iterations} dens={r.dens} "
          f"phi={r.phisc} U={r.uloc_sites}")
    return r


if __name__ == "__main__":
    main()
