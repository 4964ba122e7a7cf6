"""Bilayer graphene, AA and AB (Bernal) stackings — 4-sublattice DMFT
(drivers/ed_BLG_AA.f90, ed_BLG_AB.f90; the generic ed_BLG.f90 is the AA
driver with interlayer bias).

Each layer is a honeycomb lattice (hk0 with optional Haldane t' and mass,
hk_graphene_model, ed_BLG_AA.f90:170-207):
  h0 = 2 t' cos(phi) sum_a cos(k.a),  hz = 2 t' sin(phi) sum_a sin(k.a)+Mh
  hx = -t sum_d cos(k.d),             hy = -t sum_d sin(k.d)
with d1 = (1/2, sqrt3/2), d2 = (1/2, -sqrt3/2), d3 = (-1, 0)
(:68-76). Interlayer coupling t0 on the (A1-A2, B1-B2) pairs for AA
(:202-206) or (B1-A2) + skew t3 for AB (ed_BLG_AB.f90:202-207). The 4
sublattice sites are Nspin=1, Norb=1 impurities with optional interlayer
bias (delta) closed through the site-resolved k-sum (lattice_loop).

PyTorch port of dmft_ed_tpu/models/blg.py over the port's
lattice_loop.run_sites (site-batched sweep, the k-sum on the device). Run:
``python -m dmft_ed_tpu_torch.models.blg [input] STACKING=AA NK=15 TS=1.0
T0=0.142 T3=0.0 MH=0.0 BIAS=0.0 WMIXING=0.75`` (``DEVICE=cpu`` runs on the
CPU; the default is cuda).
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import EDConfig, read_input
from . import driver_args, split_device
from .lattice_loop import run_sites, SitesResult

_D = np.array([[0.5, np.sqrt(3) / 2], [0.5, -np.sqrt(3) / 2], [-1.0, 0.0]])
_A = np.array([_D[1] - _D[2], _D[2] - _D[0], _D[0] - _D[1]])


def _hk_layer(kx, ky, t, tsp=0.0, phi=0.0, mh=0.0):
    k = np.array([kx, ky])
    kd = _D @ k
    ka = _A @ k
    h0 = 2 * tsp * np.cos(phi) * np.sum(np.cos(ka))
    hx = -t * np.sum(np.cos(kd))
    hy = -t * np.sum(np.sin(kd))
    hz = 2 * tsp * np.sin(phi) * np.sum(np.sin(ka)) + mh
    return np.array([[h0 + hz, hx - 1j * hy],
                     [hx + 1j * hy, h0 - hz]], dtype=complex)


def blg_hk(nk: int, stacking: str = "AA", t: float = 1.0,
           t0: float = 0.142, t3: float = 0.0, tsp: float = 0.0,
           phi: float = 0.0, mh: float = 0.0,
           bias: float = 0.0) -> np.ndarray:
    """[4, 4, Nk^2] bilayer Bloch Hamiltonian, site order (A1,B1,A2,B2).
    `bias`: interlayer potential ±bias/2 (the ed_BLG.f90 delta)."""
    # honeycomb BZ: sample the reciprocal cell of the primitive vectors
    # a1 = d2 - d3, a2 = d1 - d2 (b_i . a_j = 2 pi delta_ij)
    b = 2 * np.pi * np.linalg.inv(np.stack([_A[0], _A[2]])).T
    fracs = np.linspace(0, 1, nk, endpoint=False)
    out = np.zeros((4, 4, nk * nk), dtype=complex)
    ik = 0
    for f1 in fracs:
        for f2 in fracs:
            kx, ky = f1 * b[0] + f2 * b[1]
            h0 = _hk_layer(kx, ky, t, tsp, phi, mh)
            hk = np.zeros((4, 4), dtype=complex)
            hk[:2, :2] = h0 + 0.5 * bias * np.eye(2)
            hk[2:, 2:] = h0 - 0.5 * bias * np.eye(2)
            if stacking.upper() == "AA":
                hk[0, 2] = hk[2, 0] = t0          # A1-A2
                hk[1, 3] = hk[3, 1] = t0          # B1-B2
            else:                                  # AB / Bernal
                hk[1, 2] = hk[2, 1] = t0          # B1-A2
                hk[0, 3] = t3 * h0[1, 0]          # skew (ed_BLG_AB:205-206)
                hk[3, 0] = t3 * h0[0, 1]
            out[:, :, ik] = hk
            ik += 1
    return out


def run(cfg: EDConfig, stacking: str = "AA", nk: int = 15, t: float = 1.0,
        t0: float = 0.142, t3: float = 0.0, mh: float = 0.0,
        bias: float = 0.0, wmixing: float = 0.75, log=None,
        device="cuda") -> SitesResult:
    cfg = cfg.validate()
    if cfg.norb != 1:
        raise ValueError("BLG drivers: Norb=1 per sublattice site")
    hks = blg_hk(nk, stacking, t, t0, t3, mh=mh, bias=bias)
    if cfg.nspin == 2:
        # expand to site-major (site, spin) blocks
        nlat = 4
        out = np.zeros((nlat * 2, nlat * 2, hks.shape[-1]), dtype=complex)
        for i in range(nlat):
            for j in range(nlat):
                for s in range(2):
                    out[i * 2 + s, j * 2 + s] = hks[i, j]
        hks = out
    # symmetry reduction: AA has all 4 sites equivalent at zero bias; AB
    # pairs (A1,B2) [uncoordinated] and (B1,A2) [dimer sites]
    if bias == 0.0:
        lat2ineq = [0, 0, 0, 0] if stacking.upper() == "AA" else [0, 1, 1, 0]
    else:
        lat2ineq = None
    return run_sites(cfg, hks, lat2ineq=lat2ineq, wmixing=wmixing,
                     fit_ispin=0 if cfg.nspin == 1 else None, log=log,
                     device=device)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    cfg = read_input(path, argv)
    extras = driver_args(argv, {
        "STACKING": ("stacking", str), "NK": ("nk", int),
        "TS": ("t", float), "T0": ("t0", float), "T3": ("t3", float),
        "MH": ("mh", float), "BIAS": ("bias", float),
        "WMIXING": ("wmixing", float)})
    r = run(cfg, device=device, **extras)
    print(f"converged={r.converged} iters={r.iterations} "
          f"dens={r.dens[:, 0]} docc={r.docc[:, 0]}")
    return r


if __name__ == "__main__":
    main()
