"""Microscopic commensurate twisted bilayer graphene
(drivers/ed_twistedBLG.f90).

Geometry: the (m0, r) commensurate moiré cell of Sboychakov et al.,
PRB 92, 075402 (2015) — cos(theta) = (3 m0^2 + 3 m0 r + r^2/2) /
(3 m0^2 + 3 m0 r + r^2), Nlat = 4 (3 m0^2 + 3 m0 r + r^2) carbon sites
(two layers x two sublattices), layer 2 rotated by theta and displaced by
dz = 3.345 (alat/2.46) along z (ed_twistedBLG.f90:64,74-95).

Hoppings: the exponential-decay Slater-Koster transfer integral of Nam &
Koshino, PRB 96, 075311 (2017) —
    t(d) = Vpi(d) [1 - (d.ez/|d|)^2] + Vsi(d) (d.ez/|d|)^2,
    Vpi = Vpi0 exp(-(|d|-a0)/r0),  Vsi = Vsi0 exp(-(|d|-dz)/r0),
distance-cutoff over neighboring supercells (adaptive image range)
(ed_twistedBLG.f90:191-264). DMFT treats the Nlat sites as inequivalent
single-orbital impurities over the moiré-BZ k-sum Gloc, i.e. the
LatticeEDSolver geometry with the cross-site batched sweep.

PyTorch port of dmft_ed_tpu/models/twisted_blg.py over the port's
lattice_loop.run_sites; the geometry and the Bloch builder are the JAX
package's numpy, copied. Run: ``python -m
dmft_ed_tpu_torch.models.twisted_blg [input] M0=1 R=1 NK=4 ALAT=2.46
HOPPING_CUTOFF=1.732 R0=0.184 VPI0=-2.7 VSI0=0.48 WMIXING=0.75``
(``DEVICE=cpu`` runs on the CPU; the default is cuda).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from . import driver_args, split_device


def twist_angle(m0: int, r: int):
    """(theta_radians, Nlat) of the (m0, r) commensurate cell
    (ed_twistedBLG.f90:64,74-75)."""
    den = 3 * m0 ** 2 + 3 * m0 * r + r ** 2
    cth = (3 * m0 ** 2 + 3 * m0 * r + r ** 2 / 2.0) / den
    return float(np.arccos(cth)), 4 * den


def _vectors(alat: float, m0: int, r: int):
    """Direct/rotated/superlattice/reciprocal vectors
    (ed_twistedBLG.f90:74-95)."""
    th, nlat = twist_angle(m0, r)
    a1 = alat * np.array([np.sqrt(3) / 2, -0.5])
    a2 = alat * np.array([np.sqrt(3) / 2, 0.5])
    c, s = np.cos(th), np.sin(th)
    a1z = a1 * (c - s / np.sqrt(3)) + a2 * (2 * s / np.sqrt(3))
    a2z = a2 * (c + s / np.sqrt(3)) - a1 * (2 * s / np.sqrt(3))
    disp = (a1 + a2) / 3.0
    disp2 = alat * np.array([c / np.sqrt(3), s / np.sqrt(3)])
    b1 = (2 * np.pi / alat) * np.array([1 / np.sqrt(3), -1.0])
    b2 = (2 * np.pi / alat) * np.array([1 / np.sqrt(3), 1.0])
    n = nlat // 4
    rr1 = m0 * a1 + (m0 + r) * a2
    rr2 = -(m0 + r) * a1 + (2 * m0 + r) * a2
    gg1 = ((2 * m0 + r) * b1 + (m0 + r) * b2) / n
    gg2 = (-(m0 + r) * b1 + m0 * b2) / n
    return dict(a1=a1, a2=a2, a1z=a1z, a2z=a2z, disp=disp, disp2=disp2,
                rr1=rr1, rr2=rr2, gg1=gg1, gg2=gg2, theta=th, nlat=nlat)


def build_unit_cell(alat: float = 2.46, m0: int = 1, r: int = 1):
    """[Nlat, 3] site positions of the moiré cell (build_uni_cell,
    ed_twistedBLG.f90:270-399): layer 1 at z=0 (sublattice B displaced by
    disp), layer 2 at z=dz on the rotated lattice (sublattice displaced by
    -disp2); a site belongs to the cell iff its (GG1, GG2) fractional
    coordinates lie in [0, 2 pi)."""
    v = _vectors(alat, m0, r)
    nlat = v["nlat"]
    dz = 3.345 * (alat / 2.46)
    eps = 1e-7
    sites = []
    rng_n = nlat
    ij = np.arange(-rng_n, rng_n + 1)
    for layer, (va, vb, dsp, sgn) in enumerate(
            [(v["a1"], v["a2"], v["disp"], 1.0),
             (v["a1z"], v["a2z"], v["disp2"], -1.0)]):
        for ab in (0, 1):
            # positions m*va + n*vb + sgn*ab*dsp, all (m, n)
            mm, nn = np.meshgrid(ij, ij, indexing="ij")
            pos = (mm[..., None] * va + nn[..., None] * vb
                   + sgn * ab * dsp)
            A = pos @ v["gg1"]
            B = pos @ v["gg2"]
            keep = ((A >= 0) & (A < 2 * np.pi - eps)
                    & (B >= 0) & (B < 2 * np.pi - eps))
            p = pos[keep]
            z = np.full((p.shape[0], 1), layer * dz)
            sites.append(np.concatenate([p, z], axis=1))
    ucell = np.concatenate(sites, axis=0)
    if ucell.shape[0] != nlat:
        raise RuntimeError(f"unit cell generation: got {ucell.shape[0]} "
                           f"sites, expected {nlat}")
    return ucell


def hk_twisted_blg(nk: int = 4, alat: float = 2.46, m0: int = 1, r: int = 1,
                   hopping_cutoff: float = np.sqrt(3.0), r0: float = 0.184,
                   vpi0: float = -2.7, vsi0: float = 0.48):
    """[Nlat, Nlat, nk^2] Bloch Hamiltonian over the moiré BZ
    (hk_twistedBLG_model, ed_twistedBLG.f90:191-264). hopping_cutoff and
    r0 in units of alat (rescaled internally as in the driver).

    DELIBERATE DEVIATIONS from the reference, both validated against the
    exact real-space torus spectrum (tests/test_twisted_blg.py):
    - the Bloch phase is e^{-i k.dist} with dist = U_i - U_j - R; the
      reference's extra e^{+i k.R} factor (ed_twistedBLG.f90:250) is NOT
      a gauge — it double-counts the supercell translation per image and
      shifts the spectrum at every k != 0.
    - same-site hops to neighboring images (i == j, R != 0) contribute to
      the Bloch diagonal when hopping_cutoff reaches |RR1|; the reference
      loops j = i+1.. only and silently drops them for any cutoff."""
    v = _vectors(alat, m0, r)
    ucell = build_unit_cell(alat, m0, r)
    nlat = v["nlat"]
    dz = 3.345 * (alat / 2.46)
    a0 = alat / np.sqrt(3.0)
    r00 = r0 * alat
    cut = hopping_cutoff * alat
    # supercell images: the reference fixes 3x3 (valid for its default
    # cutoff); here the range adapts so every hop with |d| < cut is
    # reachable — nimg such that nimg*Lmin > cut + cell diameter
    diam = np.max(np.linalg.norm(
        ucell[:, None, :2] - ucell[None, :, :2], axis=-1))
    lmin = min(np.linalg.norm(v["rr1"]), np.linalg.norm(v["rr2"]),
               np.linalg.norm(v["rr1"] + v["rr2"]),
               np.linalg.norm(v["rr1"] - v["rr2"]))
    nimg = max(1, int(np.ceil((cut + diam) / lmin)))
    rng_i = range(-nimg, nimg + 1)
    cells = np.array([[ii, jj] for ii in rng_i for jj in rng_i])
    ncells = len(cells)
    RR = cells[:, :1] * v["rr1"] + cells[:, 1:] * v["rr2"]   # [ncells, 2]
    RR3 = np.concatenate([RR, np.zeros((ncells, 1))], axis=1)
    # dist[c, i, j, :] = U_i - (U_j + R_c)
    dist = ucell[None, :, None, :] - (ucell[None, None, :, :]
                                      + RR3[:, None, None, :])
    dd = np.linalg.norm(dist, axis=-1)

    def slater_koster(d, ddn):
        cosz2 = (d[..., 2] / np.where(ddn > 0, ddn, 1.0)) ** 2
        vpi = vpi0 * np.exp(-(ddn - a0) / r00)
        vsi = vsi0 * np.exp(-(ddn - dz) / r00)
        return np.where((ddn < cut) & (ddn > 0),
                        vpi * (1 - cosz2) + vsi * cosz2, 0.0)

    iu, ju = np.triu_indices(nlat, k=1)            # i < j pairs
    d_ij = dist[:, iu, ju]                     # [ncells, npair, 3]
    t = slater_koster(d_ij, dd[:, iu, ju])
    # k grid over the moiré BZ
    fr = np.linspace(0.0, 1.0, nk, endpoint=False)
    kpts = np.array([f1 * v["gg1"] + f2 * v["gg2"]
                     for f1 in fr for f2 in fr])   # [Nk, 2]
    kd = kpts @ d_ij[..., :2].reshape(-1, 2).T  # [Nk, ncells*npair]
    npair = iu.size
    phase = np.exp(-1j * kd.reshape(len(kpts), ncells, npair))
    upper = np.einsum("cp,kcp->kp", t, phase)      # [Nk, npair]
    hk = np.zeros((nlat, nlat, len(kpts)), dtype=complex)
    hk[iu, ju] = upper.T
    hk[ju, iu] = upper.conj().T
    # diagonal: same-site hops to neighboring images (R != 0); the R and
    # -R images pair into a real cosine sum
    d_ii = -RR3                                     # U_i - U_i - R
    t_ii = slater_koster(d_ii, np.linalg.norm(d_ii, axis=-1))  # [ncells]
    if np.any(t_ii != 0.0):
        ph_ii = np.exp(-1j * (kpts @ d_ii[:, :2].T))       # [Nk, ncells]
        diag = ph_ii @ t_ii                                    # [Nk]
        hk[np.arange(nlat), np.arange(nlat)] += diag[None, :]
    return hk


@dataclass
class TwistedBLGResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    smats_ineq: np.ndarray
    gmats_ineq: np.ndarray
    dens: np.ndarray
    docc: np.ndarray
    error: float


def run(cfg: EDConfig, m0: int = 1, r: int = 1, nk: int = 4,
        alat: float = 2.46, hopping_cutoff: float = np.sqrt(3.0),
        r0: float = 0.184, vpi0: float = -2.7, vsi0: float = 0.48,
        wmixing: float = 0.75, log=None,
        device="cuda") -> TwistedBLGResult:
    """Real-space DMFT over the Nlat moiré carbon sites
    (ed_twistedBLG.f90:118-180: per-site bath, shared k-sum Gloc) —
    delegates to the shared inequivalent-site loop (lattice_loop.run_sites),
    which fits every spin component (the reference loops ispin=1..Nspin,
    ed_twistedBLG.f90:163-166)."""
    cfg = cfg.validate()
    if cfg.norb != 1:
        raise ValueError("twistedBLG: Norb=1 (ed_twistedBLG.f90:66)")
    from .lattice_loop import run_sites
    hk = hk_twisted_blg(nk, alat, m0, r, hopping_cutoff, r0, vpi0, vsi0)
    nlat = hk.shape[0]
    if cfg.nspin == 2:
        nkk = hk.shape[-1]
        hks = np.zeros((2 * nlat, 2 * nlat, nkk), dtype=complex)
        hks[0::2, 0::2] = hk
        hks[1::2, 1::2] = hk
        hk = hks
    r_ = run_sites(cfg, hk, wmixing=wmixing, log=log, device=device)
    return TwistedBLGResult(converged=r_.converged, iterations=r_.iterations,
                            baths=r_.baths, smats_ineq=r_.smats_ineq,
                            gmats_ineq=r_.gmats_ineq,
                            dens=r_.dens[:, 0], docc=r_.docc[:, 0],
                            error=r_.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    path = argv[0] if argv and "=" not in argv[0] else "inputGRAPHENE.conf"
    cfg = read_input(path, argv)
    kw = driver_args(argv, {
        "M0": ("m0", int), "R": ("r", int), "NK": ("nk", int),
        "ALAT": ("alat", float), "HOPPING_CUTOFF": ("hopping_cutoff", float),
        "R0": ("r0", float), "VPI0": ("vpi0", float),
        "VSI0": ("vsi0", float), "WMIXING": ("wmixing", float)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iters={r.iterations} "
          f"dens_mean={r.dens.mean():.6f}")
    return r


if __name__ == "__main__":
    main()
