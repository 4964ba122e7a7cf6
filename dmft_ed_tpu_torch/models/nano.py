"""Real-space DMFT for nanostructures (drivers/ed_nano.f90; BASELINE config 5
with hm_square_lattice), PyTorch port of dmft_ed_tpu/models/nano.py.

Given a finite tight-binding Hamiltonian ``Hij [Nlso, Nlso]`` and a
site-symmetry map ``lat2ineq [Nlat]`` (0-based inequivalent index per site),
runs the inequivalent-site DMFT loop: solve each inequivalent impurity
(site-batched, LatticeEDSolver), spread Σ to all sites, invert the
real-space lattice GF on the device, update per-site Weiss fields, fit
the baths jointly (ed_nano.f90:236-320).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import EDConfig
from ..lattice_solver import LatticeEDSolver
from ..lattice import (gloc_realspace, self_consistency,
                       kinetic_energy_realspace, ConvergenceMonitor)
from ..bath import ph_symmetrize_bath
from ..aux import lso2nnn, search_variable


@dataclass
class NanoResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    smats_ineq: np.ndarray
    gmats_lat: np.ndarray
    weiss_ineq: np.ndarray
    dens: np.ndarray      # per lattice site
    docc: np.ndarray
    ekin: float
    error: float
    mag_xy: np.ndarray = None   # [nineq, 3] (Sx, Sy, Sz), nonsu2 only
    solver: LatticeEDSolver = None


def mag_xy(cfg: EDConfig, gmats_ineq: np.ndarray) -> np.ndarray:
    """Per-site spin texture from the spin-resolved Matsubara occupation
    sums n_{ss'} = 2/β Σ_n G_{ss'}(iω_n) of orbital 1
    (drivers/ed_nano_xy.f90:145-156, the magXY.ed observable):

        Sx = ½(n↑↓ + n↓↑),  Sy = -i/2 (n↑↓ - n↓↑),  Sz = ½(n↑↑ - n↓↓)

    (real parts, as the reference's real(8) assignment takes). Returns
    [nineq, 3]."""
    n = 2.0 / cfg.beta * np.sum(gmats_ineq[:, :, :, 0, 0, :], axis=-1)
    sx = 0.5 * (n[:, 0, 1] + n[:, 1, 0])
    sy = -0.5j * (n[:, 0, 1] - n[:, 1, 0])
    sz = 0.5 * (n[:, 0, 0] - n[:, 1, 1])
    return np.stack([sx.real, sy.real, sz.real], axis=1)


def write_mag_xy(mag: np.ndarray, path: str = "magXY.ed") -> None:
    """magXY.ed: one line per inequivalent site — index Sx Sy Sz
    (ed_nano_xy.f90:145-156)."""
    with open(path, "w") as fh:
        for i, (sx, sy, sz) in enumerate(mag):
            fh.write(f"{i + 1} {sx:.12e} {sy:.12e} {sz:.12e}\n")


def square_flake_hij(lx: int, ly: int, t: float = 1.0,
                     pbc: bool = False):
    """Nearest-neighbor square-lattice flake: Hij [Nlat, Nlat] (Norb=Nspin=1
    blocks), plus the lat2ineq map by C4v/mirror symmetry classes
    (the ed_hm_square_lattice geometry)."""
    n = lx * ly

    def idx(x, y):
        return x + lx * y

    H = np.zeros((n, n))
    for y in range(ly):
        for x in range(lx):
            i = idx(x, y)
            if x + 1 < lx:
                H[i, idx(x + 1, y)] = -t
                H[idx(x + 1, y), i] = -t
            elif pbc and lx > 2:
                H[i, idx(0, y)] = -t
                H[idx(0, y), i] = -t
            if y + 1 < ly:
                H[i, idx(x, y + 1)] = -t
                H[idx(x, y + 1), i] = -t
            elif pbc and ly > 2:
                H[i, idx(x, 0)] = -t
                H[idx(x, 0), i] = -t
    # symmetry classes: distance multiset from the 4 flake corners
    classes = {}
    lat2ineq = np.zeros(n, dtype=int)
    for y in range(ly):
        for x in range(lx):
            key = tuple(sorted((min(x, lx - 1 - x), min(y, ly - 1 - y))))
            if key not in classes:
                classes[key] = len(classes)
            lat2ineq[idx(x, y)] = classes[key]
    return H, lat2ineq


def hexagon_isoc_hij(t: float = 1.0, lam: float = 0.1):
    """Hexagonal ring (6-site honeycomb flake) with intrinsic spin-orbit
    coupling on next-nearest-neighbor bonds — the ed_nano_isoc.f90 class:
    H_soc = i lam nu_ij sigma_z with nu = +1 counterclockwise (Kane-Mele).
    Spin-conserving, so it runs in ed_mode=normal with Nspin=2. Returns
    (hij [12, 12] complex, lat2ineq) with site-major (site, spin) layout.
    By ring symmetry every site is equivalent (one inequivalent class)."""
    n = 6
    H = np.zeros((2 * n, 2 * n), dtype=complex)
    for i in range(n):
        j = (i + 1) % n
        for s in range(2):
            H[2 * i + s, 2 * j + s] = -t
            H[2 * j + s, 2 * i + s] = -t
    for i in range(n):
        j = (i + 2) % n                      # counterclockwise NNN: nu=+1
        for s, sgn in ((0, 1.0), (1, -1.0)):
            H[2 * i + s, 2 * j + s] += 1j * lam * sgn
            H[2 * j + s, 2 * i + s] += -1j * lam * sgn
    return H, np.zeros(n, dtype=int)


def run_adiabatic(cfg: EDConfig, hij_of_t, times, lat2ineq,
                  wmixing: float = 0.5, log=None, device="cuda"):
    """Adiabatic non-equilibrium drive (ed_nano_adiabatic.f90 /
    ed_nano_a2ph.f90 set_drive flow): sweep the drive parameter (time),
    solving the EQUILIBRIUM real-space DMFT problem of the instantaneous
    Hamiltonian Hij(t) at every step, warm-starting each step from the
    previous converged bath. `hij_of_t(t)` returns the [Nlso, Nlso]
    Hamiltonian at drive time t. Returns the list of NanoResult per step."""
    results = []
    baths = None
    for t in times:
        r = run(cfg, np.asarray(hij_of_t(t)), lat2ineq, wmixing=wmixing,
                baths0=baths, log=log, device=device)
        baths = r.baths
        results.append(r)
    return results


def post_transport(cfg: EDConfig, hij: np.ndarray, sreal_lat: np.ndarray,
                   gamma_l=None, gamma_r=None, jeff: bool = False,
                   device="cuda"):
    """Transport post-processing from a converged (fixed) self-energy —
    the ed_nano_fix_trans / ed_nano_newtrans flow: the DMFT solution is
    read back (LSigma files / NanoResult.smats_ineq) and re-used to
    compute (a) the Landauer transmission T(w) = Tr[G_adv Γ_L G_ret Γ_R]
    (ed_get_conductance, ed_nano_fix_trans.f90:659-784) and (b) the
    effective non-local exchange J_ij (ed_get_jeff, :930-1010).

    Returns dict with keys 'transmission' (None unless leads given) and
    'jeff' (None unless jeff=True and Nspin=2)."""
    from ..lattice import (transmission, gloc_realspace_full,
                           effective_exchange)
    out = {"transmission": None, "jeff": None}
    if gamma_l is not None and gamma_r is not None:
        out["transmission"] = transmission(cfg, hij, sreal_lat, gamma_l,
                                           gamma_r, device=device)
    if jeff:
        lead = None
        if gamma_l is not None and gamma_r is not None:
            gl = np.asarray(gamma_l)
            gr = np.asarray(gamma_r)
            lead = -0.5j * (gl + gr)
        gret = gloc_realspace_full(cfg, hij, sreal_lat, "real", lead=lead,
                                   device=device)
        out["jeff"] = effective_exchange(cfg, gret, sreal_lat)
    return out


@dataclass
class NanoScResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    smats_ineq: np.ndarray
    smats_an_ineq: np.ndarray
    dens: np.ndarray
    docc: np.ndarray
    phisc: np.ndarray     # per lattice site
    error: float


def run_sc(cfg: EDConfig, hij: np.ndarray, lat2ineq: np.ndarray,
           wmixing: float = 0.5, phsym: bool = False,
           log=None, device="cuda") -> NanoScResult:
    """Superconducting real-space DMFT on a finite structure
    (drivers/ed_nano_sc.f90): per-site Nambu Gloc from the doubled
    real-space BdG inversion (gloc_realspace_superc), per-site (G, F)
    Weiss update, joint anomalous bath fit — with the nano driver's
    site-symmetry reduction (ilat2ineq)."""
    from ..lattice import gloc_realspace_superc, self_consistency_superc
    cfg = cfg.validate()
    assert cfg.ed_mode == "superc" and cfg.norb == 1 and cfg.nspin == 1
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    nlat = hij.shape[0]
    lat2ineq = np.asarray(lat2ineq)
    nineq = int(lat2ineq.max()) + 1
    ineq2lat = np.array([np.nonzero(lat2ineq == i)[0][0]
                         for i in range(nineq)])
    hloc_lat = lso2nnn(hij, nlat, 1, 1)
    hloc_ineq = hloc_lat[ineq2lat]
    lsolver = LatticeEDSolver(cfg, hloc_ineq, log=_log, device=device)
    baths = lsolver.init_solvers()
    baths_prev = baths.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- nano-SC DMFT loop {iloop}/{cfg.nloop} "
             f"({nineq} ineq of {nlat} sites) ---")
        lsolver.solve(baths)
        smats_ineq = lsolver.get_sigma_matsubara()
        samats_ineq = np.stack([r.smats_an for r in lsolver.results])
        with lsolver.timers("gloc"):
            gm, fm = gloc_realspace_superc(cfg, hij, smats_ineq[lat2ineq],
                                           samats_ineq[lat2ineq], "mats",
                                           device=lsolver.device)
        gm_i, fm_i = gm[ineq2lat], fm[ineq2lat]
        wn = np.zeros_like(gm_i)
        wa = np.zeros_like(fm_i)
        for i in range(nineq):
            wn[i], wa[i] = self_consistency_superc(
                cfg, gm_i[i], fm_i[i], smats_ineq[i], samats_ineq[i],
                hloc_ineq[i])
        baths = lsolver.chi2_fitgf(wn, baths, ispin=0, fg_an_ineq=wa)
        if phsym:
            for i in range(nineq):
                baths[i] = ph_symmetrize_bath(cfg, baths[i])
        if iloop > 1:
            baths = wmixing * baths + (1 - wmixing) * baths_prev
        baths_prev = baths.copy()
        converged = monitor.check(wn[0, 0, 0, 0, 0], log=_log)
    phisc = np.stack([r.observables.phisc for r in lsolver.results])
    return NanoScResult(converged=converged, iterations=iloop, baths=baths,
                        smats_ineq=lsolver.get_sigma_matsubara(),
                        smats_an_ineq=np.stack(
                            [r.smats_an for r in lsolver.results]),
                        dens=lsolver.get_dens()[lat2ineq][:, 0],
                        docc=lsolver.get_docc()[lat2ineq][:, 0],
                        phisc=phisc[lat2ineq][:, 0], error=monitor.error)


def run(cfg: EDConfig, hij: np.ndarray, lat2ineq: np.ndarray,
        wmixing: float = 0.5, phsym: bool = False, sb_field_sign=None,
        baths0=None, enforce_map=None, log=None,
        device="cuda") -> NanoResult:
    """enforce_map: optional list of ((i,iorb,ispin), (j,jorb,jspin))
    inequivalent-index tuples; after each solve,
    Sigma[j,jspin,jspin,jorb,jorb] := Sigma[i,ispin,ispin,iorb,iorb] —
    the enforce_symmetry.in mechanism of
    ed_nano_enforce_ineq_symm.f90:468-485 (e.g. pinning a magnetic
    pattern across symmetry-related atoms). baths0: warm-start bath stack
    (the adiabatic drive restarts, ed_nano_adiabatic.f90). The result's
    `solver` holds the LatticeEDSolver (its stage timers, its results)."""
    cfg = cfg.validate()
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    nso = cfg.nspin * cfg.norb
    nlat = hij.shape[0] // nso
    lat2ineq = np.asarray(lat2ineq)
    nineq = int(lat2ineq.max()) + 1
    ineq2lat = np.array([np.nonzero(lat2ineq == i)[0][0]
                         for i in range(nineq)])
    hloc_lat = lso2nnn(hij, nlat, cfg.nspin, cfg.norb)
    hloc_ineq = hloc_lat[ineq2lat]

    lsolver = LatticeEDSolver(cfg, hloc_ineq, log=_log, device=device)
    baths = lsolver.init_solvers(sb_field_sign) if baths0 is None \
        else np.array(baths0, dtype=float)
    baths_prev = baths.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    weiss_ineq = gm_lat = None
    xmu = cfg.xmu
    sstate: dict = {}
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- real-space DMFT loop {iloop}/{cfg.nloop} "
             f"({nineq} ineq of {nlat} sites) ---")
        lsolver.solve(baths)
        smats_ineq = lsolver.get_sigma_matsubara()
        if enforce_map:
            # enforce_ineq_symmetry (ed_nano_enforce_ineq_symm.f90:468-485)
            for (i, io, isp), (j, jo, jsp) in enforce_map:
                smats_ineq[j, jsp, jsp, jo, jo] = \
                    smats_ineq[i, isp, isp, io, io]
        smats_lat = smats_ineq[lat2ineq]
        with lsolver.timers("gloc"):
            gm_lat = gloc_realspace(cfg, hij, smats_lat, "mats",
                                    device=lsolver.device)
        gm_ineq = gm_lat[ineq2lat]
        weiss_ineq = np.stack([
            self_consistency(cfg, gm_ineq[i], smats_ineq[i], hloc_ineq[i])
            for i in range(nineq)])
        baths = lsolver.chi2_fitgf(weiss_ineq, baths, ispin=None)
        if phsym:
            for i in range(nineq):
                baths[i] = ph_symmetrize_bath(cfg, baths[i])
        if iloop > 1:
            baths = wmixing * baths + (1 - wmixing) * baths_prev
        baths_prev = baths.copy()
        converged = monitor.check(weiss_ineq[0, 0, 0, 0, 0], log=_log)
        if cfg.nread != 0.0:
            dens_mean = float(lsolver.get_dens()[lat2ineq].sum() / nlat)
            xmu, conv2 = search_variable(cfg, xmu, dens_mean, sstate, _log)
            converged = converged and conv2
            cfg = cfg.replace(xmu=xmu)
            for s in lsolver.solvers:
                s.cfg = cfg
    smats_ineq = lsolver.get_sigma_matsubara()
    if enforce_map:
        for (i, io, isp), (j, jo, jsp) in enforce_map:
            smats_ineq[j, jsp, jsp, jo, jo] = smats_ineq[i, isp, isp, io, io]
    with lsolver.timers("ekin"):
        ekin = kinetic_energy_realspace(cfg, hij, smats_ineq[lat2ineq])
    mxy = None
    if cfg.nspin == 2 and gm_lat is not None:
        # in-plane spin texture + magXY.ed (ed_nano_xy.f90:145-156)
        mxy = mag_xy(cfg, gm_lat[ineq2lat])
        write_mag_xy(mxy)
    return NanoResult(converged=converged, iterations=iloop, baths=baths,
                      smats_ineq=smats_ineq, gmats_lat=gm_lat,
                      weiss_ineq=weiss_ineq,
                      dens=lsolver.get_dens()[lat2ineq][:, 0],
                      docc=lsolver.get_docc()[lat2ineq][:, 0],
                      ekin=ekin, error=monitor.error, mag_xy=mxy,
                      solver=lsolver)
