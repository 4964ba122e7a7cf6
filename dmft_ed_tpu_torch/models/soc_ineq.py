"""t2g + atomic SOC with inequivalent sites (drivers/ed_SOC_ineq.f90),
PyTorch port of dmft_ed_tpu/models/soc_ineq.py.

Nlat inequivalent t2g impurities (Nspin=2, Norb=3, ed_mode=nonsu2) over a
supercell Bloch Hamiltonian whose site-diagonal blocks are the cubic-t2g
+ lambda L.S model (the reference builds Hk per site with TB_build_model,
ed_SOC_ineq.f90:450-462) with per-site crystal-field shifts (the
top/bottom/shift arrays, :152-154); sites are closed through the
site-resolved k-sum Gloc and solved with the shared lattice loop. The
quantum SOC operators <S>, <L>, <J>, <J^2>, <L.S> per site (:140-147)
come from LatticeEDSolver.get_quantum_soc_operators.

Run: ``python -m dmft_ed_tpu_torch.models.soc_ineq [input_file]
[KEY=value ...]`` (``DEVICE=cpu`` runs on the CPU; the default is cuda;
NLAT, NK, SOC, TPERP, SHIFTS=a,b,... and WMIXING set the driver's own
parameters).
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import EDConfig, read_input
from . import driver_args, split_device
from ..aux import atomic_soc, nn2so
from .lattice_loop import run_sites, SitesResult


def build_hk_soc_ineq(nlat: int, nk: int = 8, t: float = 0.5,
                      soc: float = 0.25, shifts=None,
                      tperp: float = 0.0) -> np.ndarray:
    """[Nlat*6, Nlat*6, Nk^3] supercell: per-site cubic t2g + SOC blocks
    with crystal-field shift[i] on the diagonal; optional inter-site
    orbital-diagonal hopping tperp chaining the sites (a layered
    perovskite stack)."""
    shifts = np.zeros(nlat) if shifts is None else np.asarray(shifts)
    ls = nn2so(atomic_soc(), 2, 3)
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    nlso = nlat * 6
    hks = []
    for kx in ks:
        for ky in ks:
            for kz in ks:
                eps = -2 * t * (np.cos(kx) + np.cos(ky) + np.cos(kz))
                H = np.zeros((nlso, nlso), dtype=complex)
                for i in range(nlat):
                    sl = slice(i * 6, (i + 1) * 6)
                    H[sl, sl] = (eps + shifts[i]) * np.eye(6) + soc * ls
                    if tperp and i + 1 < nlat:
                        s2 = slice((i + 1) * 6, (i + 2) * 6)
                        H[sl, s2] = -tperp * np.eye(6)
                        H[s2, sl] = -tperp * np.eye(6)
                hks.append(H)
    return np.stack(hks, axis=-1)


def run(cfg: EDConfig, nlat: int = 2, nk: int = 6, t: float = 0.5,
        soc: float = 0.25, shifts=None, tperp: float = 0.1,
        wmixing: float = 0.5, log=None, device="cuda") -> SitesResult:
    cfg = cfg.validate()
    assert cfg.norb == 3 and cfg.nspin == 2 and cfg.ed_mode == "nonsu2", \
        "ed_SOC_ineq: Norb=3, Nspin=2, nonsu2 (ed_SOC_ineq.f90 checks)"
    hks = build_hk_soc_ineq(nlat, nk, t, soc, shifts, tperp)
    return run_sites(cfg, hks, wmixing=wmixing, log=log, device=device)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv, norb=3, nspin=2, ed_mode="nonsu2")
    extras = driver_args(argv, {
        "NLAT": ("nlat", int), "NK": ("nk", int), "SOC": ("soc", float),
        "TPERP": ("tperp", float),
        "SHIFTS": ("shifts", lambda v: [float(x) for x in v.split(",")]),
        "WMIXING": ("wmixing", float)})
    r = run(cfg, device=device, **extras)
    ops = r.solver.get_quantum_soc_operators()
    for i, o in enumerate(ops):
        print(f"site {i}: J = {np.real(o['J'])}, L.S = {o['LS'].real:.6f}")
    print(f"converged={r.converged} iters={r.iterations} "
          f"dens={r.dens.sum(axis=1)}")
    return r


if __name__ == "__main__":
    main()
