"""Hartree (static mean-field) solver for nano clusters
(drivers/hartree_nano.f90), PyTorch port of
dmft_ed_tpu/models/hartree_nano.py.

The reference iterates Sigma_s,i = Uloc (n_{-s,i} - 1/2) with densities
extracted from the Matsubara lattice GF by FFT (hartree_nano.f90:225-290).
Since the Hartree self-energy is STATIC, the effective problem is
single-particle: here each iteration diagonalizes
H_eff = Hij + diag(Sigma) once (one torch.linalg.eigh on the device) and
reads the densities off the exact Fermi occupations of its spectrum —
mathematically the same fixed point, without frequency sums or tails. The
rest (fermi, the search_variable xmu search, phsym, the class averages,
the mixing) runs on the host in the JAX package's order of operations.

Options mirror the driver: wmixing (density mixing), phsym
(n_dw := 1 - n_up, :268-272), lat2ineq symmetry classes, xmu search
(nread).

Run: ``python -m dmft_ed_tpu_torch.models.hartree_nano [input] ULOC=2.0
LX=4 LY=4 WMIXING=0.5 PHSYM=F STAGGER=0.0`` (``DEVICE=cpu`` runs on the
CPU; the default is cuda).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..config import EDConfig, read_input
from ..aux import search_variable
from ..device import resolve
from . import driver_args, flag, split_device


def fermi(e, beta: float):
    x = np.clip(beta * e, -500, 500)
    return 1.0 / (1.0 + np.exp(x))


@dataclass
class HartreeResult:
    converged: bool
    iterations: int
    dens: np.ndarray     # [Nlat, 2] (n_up, n_dw)
    docc: np.ndarray     # [Nlat]   n_up * n_dw (uncorrelated)
    mag: np.ndarray      # [Nlat]
    sigma: np.ndarray    # [Nlat, 2] static Hartree shifts
    egs: float
    error: float


def run(cfg: EDConfig, hij: np.ndarray, lat2ineq=None,
        wmixing: float = 0.5, phsym: bool = False, seed_mag=None,
        log=None, device="cuda") -> HartreeResult:
    """hij: [2*Nlat, 2*Nlat] site-major (site, spin) cluster Hamiltonian
    (the nano layout; spin blocks may differ). seed_mag: optional [Nlat]
    initial staggered magnetization to break spin symmetry."""
    cfg = cfg.validate()
    if cfg.norb != 1:
        raise ValueError("hartree_nano: Norb=1 (hartree_nano.f90)")
    device = resolve(device)
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    u = float(cfg.uloc_arr[0])
    nlat = hij.shape[0] // 2
    lat2ineq = np.zeros(nlat, dtype=int) if lat2ineq is None \
        else np.asarray(lat2ineq)
    iu = 2 * np.arange(nlat)
    idw = iu + 1
    n = np.full((nlat, 2), 0.5)
    if seed_mag is not None:
        m = np.asarray(seed_mag, dtype=float)
        n[:, 0] += m / 2.0
        n[:, 1] -= m / 2.0
    xmu = cfg.xmu
    sstate: dict = {}
    converged, iloop, err = False, 0, np.inf
    egs = 0.0
    while not converged and iloop < max(cfg.nloop, 1):
        iloop += 1
        n_prev = n.copy()
        # H_eff = Hij + Hartree shifts (hartree_nano.f90:274-279)
        heff = np.array(hij, dtype=complex)
        heff[iu, iu] += u * (n[:, 1] - 0.5)
        heff[idw, idw] += u * (n[:, 0] - 0.5)
        ev, evc = torch.linalg.eigh(torch.as_tensor(heff, device=device))
        evals, evecs = ev.cpu().numpy(), evc.cpu().numpy()
        occ = fermi(evals - xmu, cfg.beta)
        w2 = np.abs(evecs) ** 2                       # [2Nlat, nlev]
        n_new = np.stack([w2[iu] @ occ, w2[idw] @ occ], axis=1)
        if phsym:
            n_new[:, 1] = 1.0 - n_new[:, 0]
        # enforce inequivalent-site classes (spread the class average)
        for c in range(int(lat2ineq.max()) + 1):
            sel = lat2ineq == c
            n_new[sel] = n_new[sel].mean(axis=0)
        n = wmixing * n_new + (1 - wmixing) * n_prev
        err = float(np.abs(n - n_prev).max())
        egs = float(np.sum(evals * occ)
                    - u * np.sum((n[:, 0] - 0.5) * (n[:, 1] - 0.5)))
        converged = err < cfg.dmft_error
        _log(f"hartree iter {iloop}: err={err:.3e} "
             f"ntot={n.sum():.6f}")
        if cfg.nread != 0.0:
            xmu, conv2 = search_variable(cfg, xmu, float(n.sum()),
                                         sstate, _log)
            converged = converged and conv2
    sigma = np.stack([u * (n[:, 1] - 0.5), u * (n[:, 0] - 0.5)], axis=1)
    docc = n[:, 0] * n[:, 1]
    # observables files (observables_last_site####.hartree,
    # hartree_nano.f90:283-300)
    nineq = int(lat2ineq.max()) + 1
    for c in range(nineq):
        i = int(np.nonzero(lat2ineq == c)[0][0])
        try:
            with open(f"observables_last_site{c + 1:04d}.hartree",
                      "w") as fh:
                fh.write(f"{n[i, 0] + n[i, 1]:15.9f} {docc[i]:15.9f} "
                         f"{n[i, 0]:15.9f} {n[i, 1]:15.9f} "
                         f"{n[i, 0] - n[i, 1]:15.9f} "
                         f"{n[i, 0] + n[i, 1] - 2 * docc[i]:15.9f}\n")
        except OSError:
            pass
    return HartreeResult(converged=converged, iterations=iloop, dens=n,
                         docc=docc, mag=n[:, 0] - n[:, 1], sigma=sigma,
                         egs=egs, error=err)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    path = argv[0] if argv and "=" not in argv[0] else "inputED_NANO.conf"
    cfg = read_input(path, argv)
    from .nano import square_flake_hij
    kw = dict(dict(lx=4, ly=4, wmixing=0.5, phsym=False, stagger=0.0),
              **driver_args(argv, {
                  "LX": ("lx", int), "LY": ("ly", int),
                  "WMIXING": ("wmixing", float), "PHSYM": ("phsym", flag),
                  "STAGGER": ("stagger", float)}))
    lx, ly, stagger = kw["lx"], kw["ly"], kw["stagger"]
    H1, lat2ineq = square_flake_hij(lx, ly)
    nlat = H1.shape[0]
    hij = np.kron(H1, np.eye(2))
    seed = None
    if stagger:
        seed = np.array([stagger * (-1) ** ((i % lx) + (i // lx))
                         for i in range(nlat)])
        lat2ineq = np.arange(nlat)    # staggered order: no class averaging
    r = run(cfg, hij, lat2ineq, wmixing=kw["wmixing"], phsym=kw["phsym"],
            seed_mag=seed, device=device)
    print(f"converged={r.converged} iters={r.iterations} "
          f"ntot={r.dens.sum():.6f} |m|max={np.abs(r.mag).max():.6f}")
    return r


if __name__ == "__main__":
    main()
