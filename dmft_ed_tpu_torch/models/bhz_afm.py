"""BHZ antiferromagnetic supercells — 2-site / 4-site (2D) and 8-site (3D)
magnetic unit cells with Néel-seeded inequivalent-site DMFT
(drivers/ed_bhz_2d_afm2.f90, ed_bhz_2d_afm4.f90, ed_bhz_3d_afm8.f90).

The reference hand-writes each supercell Bloch matrix (e.g.
ed_bhz_2d_afm2.f90 hk_model: M=Mh*Gamma5 on-site, tx=-0.5*Gamma5
-0.5i*lambda*Gamma1 hops, collected with explicit phase factors); here one
generic `supercell_hk` folds any set of hopping matrices into an arbitrary
cell: H_{ab}(K) = onsite*delta_ab + sum_hops T e^{iK.R(a,d->b)} with the
image vector R solved from integer cell geometry — gauge-equivalent to the
reference matrices (site-resolved Gloc is gauge invariant).

Néel order: sb_field seeds of alternating sign by site parity; each
inequivalent site is a full Nspin=2, Norb=2 impurity; the k-sum Gloc is
site-resolved (gloc_hk_lattice).

PyTorch port of dmft_ed_tpu/models/bhz_afm.py: the sites' sweeps stack in
one site-batched solve and the k-sum runs on the device. Run:
``python -m dmft_ed_tpu_torch.models.bhz_afm [input] CELL=afm2 NK=10 MH=1.0
LAMBDA=0.3 EZ=1.0 WMIXING=0.5`` (``DEVICE=cpu`` runs on the CPU; the default
is cuda).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from itertools import product

import numpy as np

from ..config import EDConfig, read_input
from ..lattice_solver import LatticeEDSolver
from ..lattice import gloc_hk_lattice, self_consistency, ConvergenceMonitor
from ..aux import so2nn
from . import driver_args, split_device


# --- BHZ building blocks in the repo basis (orb fast, spin slow):
# Gamma5 = s0 x tz, Gamma1 = sz x tx, Gamma2 = s0 x ty (models/bhz_2d.py
# hk_bhz; ed_bhz_2d_afm2.f90:256-265)
_S0 = np.eye(2)
_SZ = np.diag([1.0, -1.0])
_TX = np.array([[0, 1], [1, 0]], dtype=complex)
_TY = np.array([[0, -1j], [1j, 0]], dtype=complex)
_TZ = np.diag([1.0, -1.0]).astype(complex)
G5 = np.kron(_S0, _TZ)
G1 = np.kron(_SZ, _TX)
G2 = np.kron(_S0, _TY)
# 3D: kz hops couple the spin blocks with lambda*sin(kz)*tx (bhz_3d.py)
G3 = np.kron(_TX, _TX)   # sx x tx


def bhz_hops_2d(mh: float, llambda: float):
    """(onsite M, hops {displacement: T}) reproducing
    H(k) = (mh - cos kx - cos ky) G5 + l sin kx G1 + l sin ky G2."""
    M = mh * G5
    Tx = -0.5 * G5 - 0.5j * llambda * G1
    Ty = -0.5 * G5 - 0.5j * llambda * G2
    return M, {(1, 0): Tx, (0, 1): Ty}


def bhz_hops_3d(mh: float, llambda: float, ez: float = 1.0):
    M = mh * G5
    Tx = -0.5 * G5 - 0.5j * llambda * G1
    Ty = -0.5 * G5 - 0.5j * llambda * G2
    Tz = -0.5 * ez * G5 - 0.5j * llambda * G3
    return M, {(1, 0, 0): Tx, (0, 1, 0): Ty, (0, 0, 1): Tz}


def supercell_hk(onsite: np.ndarray, hops: dict, positions, cellvecs,
                 nk: int) -> np.ndarray:
    """Fold single-site hoppings into a supercell Bloch Hamiltonian.

    positions: [Nlat, dims] integer site positions inside the cell;
    cellvecs: [dims, dims] integer cell vectors (rows). For every site a
    and hop (d, T), the target p = pos[a] + d is decomposed p = pos[b] +
    n·cellvecs; contributes T e^{iK·(n·cellvecs)} to H_{ab}(K) (+ h.c.).
    Returns [Nlat*Nso, Nlat*Nso, Nk^dims] on the reduced-BZ grid."""
    positions = np.asarray(positions, dtype=int)
    A = np.asarray(cellvecs, dtype=int)
    dims = A.shape[0]
    nlat, nso = len(positions), onsite.shape[0]
    Ainv = np.linalg.inv(A.T)
    terms = []   # (a, b, image_vec, T)
    for a, pos in enumerate(positions):
        for d, T in hops.items():
            p = pos + np.asarray(d, dtype=int)
            # find b, n with p = positions[b] + n @ A
            for b, pb in enumerate(positions):
                n = Ainv @ (p - pb)
                ni = np.rint(n)
                if np.allclose(n, ni, atol=1e-9):
                    terms.append((a, b, ni @ A, T))
                    break
            else:
                raise ValueError(f"hop {d} from site {a} leaves the tiling")
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    kgrid = np.stack([np.array(kv) for kv in product(ks, repeat=dims)])
    nkk = kgrid.shape[0]
    H = np.zeros((nlat * nso, nlat * nso, nkk), dtype=complex)
    for a in range(nlat):
        H[a * nso:(a + 1) * nso, a * nso:(a + 1) * nso, :] = \
            onsite[:, :, None]
    for a, b, R, T in terms:
        phase = np.exp(1j * kgrid @ np.asarray(R, dtype=float))
        blk = T[:, :, None] * phase[None, None, :]
        H[a * nso:(a + 1) * nso, b * nso:(b + 1) * nso, :] += blk
        H[b * nso:(b + 1) * nso, a * nso:(a + 1) * nso, :] += \
            np.conj(np.transpose(blk, (1, 0, 2)))
    return H


_CELLS = {
    "afm2": (np.array([[0, 0], [1, 0]]), np.array([[1, 1], [1, -1]])),
    "afm4": (np.array([[0, 0], [1, 0], [0, 1], [1, 1]]),
             np.array([[2, 0], [0, 2]])),
    "afm8": (np.array(list(product((0, 1), repeat=3))),
             2 * np.eye(3, dtype=int)),
}


@dataclass
class BhzAfmResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    smats_ineq: np.ndarray
    dens: np.ndarray
    magz: np.ndarray     # [Nlat, Norb]
    error: float


def run(cfg: EDConfig, cell: str = "afm2", nk: int = 10, mh: float = 1.0,
        llambda: float = 0.3, ez: float = 1.0, wmixing: float = 0.5,
        log=None, device="cuda") -> BhzAfmResult:
    cfg = cfg.validate()
    if cfg.nspin != 2 or cfg.norb != 2:
        raise ValueError("BHZ AFM: Nspin=Norb=2")
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    positions, cellvecs = _CELLS[cell]
    if cell == "afm8":
        M, hops = bhz_hops_3d(mh, llambda, ez)
    else:
        M, hops = bhz_hops_2d(mh, llambda)
    hks = supercell_hk(M, hops, positions, cellvecs, nk)
    nlat, nso = len(positions), 4
    sb_signs = [(-1) ** int(np.sum(p)) for p in positions]
    hloc_lat = hks.mean(axis=-1)
    hloc_lat[np.abs(hloc_lat) < 1e-10] = 0.0
    hloc_ineq = np.stack([
        so2nn(hloc_lat[i * nso:(i + 1) * nso, i * nso:(i + 1) * nso],
              cfg.nspin, cfg.norb) for i in range(nlat)])
    lsolver = LatticeEDSolver(cfg, hloc_ineq, log=_log, device=device)
    baths = lsolver.init_solvers(sb_field_sign=sb_signs)
    baths_prev = baths.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- BHZ {cell} DMFT loop {iloop}/{cfg.nloop} "
             f"({nlat} sites) ---")
        lsolver.solve(baths)
        smats_ineq = lsolver.get_sigma_matsubara()
        with lsolver.timers("gloc"):
            gm_ineq = gloc_hk_lattice(cfg, hks, smats_ineq, "mats",
                                      device=lsolver.device)
        weiss_ineq = np.stack([
            self_consistency(cfg, gm_ineq[i], smats_ineq[i], hloc_ineq[i])
            for i in range(nlat)])
        baths = lsolver.chi2_fitgf(weiss_ineq, baths)
        if iloop > 1:
            baths = wmixing * baths + (1 - wmixing) * baths_prev
        baths_prev = baths.copy()
        converged = monitor.check(
            np.stack([weiss_ineq[0, 0, 0, 0, 0],
                      weiss_ineq[0, 1, 1, 0, 0]]), log=_log)
    return BhzAfmResult(converged=converged, iterations=iloop, baths=baths,
                        smats_ineq=lsolver.get_sigma_matsubara(),
                        dens=lsolver.get_dens(), magz=lsolver.get_mag(),
                        error=monitor.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    cfg = read_input(path, argv, nspin=2, norb=2)
    extras = driver_args(argv, {
        "CELL": ("cell", str.lower), "NK": ("nk", int), "MH": ("mh", float),
        "LAMBDA": ("llambda", float), "EZ": ("ez", float),
        "WMIXING": ("wmixing", float)})
    r = run(cfg, device=device, **extras)
    print(f"converged={r.converged} iters={r.iterations} "
          f"dens={r.dens[:, 0]} magz={r.magz[:, 0]}")
    return r


if __name__ == "__main__":
    main()
