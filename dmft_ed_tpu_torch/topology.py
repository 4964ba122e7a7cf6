"""Topological diagnostics for the k-space and real-space driver families,
a copy of dmft_ed_tpu/topology.py (numpy only, on the host).

The reference computes (a) the spectrum of the interacting "topological
Hamiltonian" H(k) + ReΣ(ω=0) (solve_hk_topological,
drivers/ed_bhz_2d.f90:246-281) and (b) the real-space local Chern marker
from Hij and Σ (drivers/chern_marker3_NF.f90:get_local_chern). Here:

- chern_number: Fukui-Hatsugai-Suzuki plaquette invariant on the uniform
  BZ grid the Bloch builders produce (gauge-invariant, exactly integer
  for gapped fillings on any grid).
- topological_hamiltonian: H(k) + ReΣ(ω→0), the interacting invariant's
  input per the topological-Hamiltonian construction.
- local_chern_marker: Bianco-Resta marker C(r) = -4π Im⟨r|PXPYP|r⟩ per
  unit-cell area from a finite-cluster Hamiltonian (+ local self-energy),
  the quantity chern_marker3_NF.f90 assembles.
"""

from __future__ import annotations

import numpy as np


def chern_number(hk: np.ndarray, nk: int, nocc: int) -> float:
    """FHS lattice Chern number of the lowest `nocc` bands.

    hk: [n, n, nk*nk] on a uniform grid over the two reciprocal basis
    directions, flattened row-major (first direction outer) — the layout
    of every builder in models/kspace.py."""
    n = hk.shape[0]
    H = hk.transpose(2, 0, 1).reshape(nk, nk, n, n)
    _, evecs = np.linalg.eigh(H)
    U = evecs[..., :nocc]                               # [nk, nk, n, nocc]

    def link(Ua, Ub):
        return np.linalg.det(np.einsum("...ij,...ik->...jk",
                                       np.conj(Ua), Ub))

    Ux = link(U, np.roll(U, -1, axis=0))                # along dir 1
    Uy = link(U, np.roll(U, -1, axis=1))                # along dir 2
    F = np.angle(Ux * np.roll(Uy, -1, axis=0)
                 * np.conj(np.roll(Ux, -1, axis=1)) * np.conj(Uy))
    return float(np.sum(F) / (2 * np.pi))


def topological_hamiltonian(hk: np.ndarray, sigma: np.ndarray
                            ) -> np.ndarray:
    """H_top(k) = H(k) + ReΣ(ω→0): sigma is the zero-frequency self-energy
    [n, n] (or the first-Matsubara Σ(iω₁) as used by
    solve_hk_topological, ed_bhz_2d.f90:248-281)."""
    return hk + np.real(sigma)[:, :, None]


def local_chern_marker(hij: np.ndarray, positions: np.ndarray,
                       nso: int = 1, sigma0: np.ndarray | None = None,
                       fermi: float = 0.0) -> np.ndarray:
    """Bianco-Resta local Chern marker of a finite cluster.

    hij: [Nlat*nso, Nlat*nso] cluster Hamiltonian (site-major blocks);
    positions: [Nlat, 2] site coordinates (unit-cell units);
    sigma0: optional per-site [Nlat, nso, nso] ReΣ(0) added block-diagonally
    (the interacting marker of chern_marker3_NF.f90:get_local_chern).
    Returns C(r) [Nlat]."""
    nlat = positions.shape[0]
    H = np.array(hij, dtype=complex)
    if sigma0 is not None:
        for i in range(nlat):
            sl = slice(i * nso, (i + 1) * nso)
            H[sl, sl] += np.real(sigma0[i])
    evals, evecs = np.linalg.eigh(H)
    occ = evecs[:, evals < fermi]
    P = occ @ occ.conj().T
    x = np.repeat(positions[:, 0], nso)
    y = np.repeat(positions[:, 1], nso)
    M = P @ (x[:, None] * P) @ (y[:, None] * P)
    c = -4 * np.pi * np.imag(np.diag(M))
    return c.reshape(nlat, nso).sum(axis=1)


def qwz_flake(lx: int, ly: int, m: float, t: float = 1.0):
    """Qi-Wu-Zhang 2-band Chern insulator on an open square flake
    (|C| = 1 for 0 < |m| < 2): H = m σz on-site, hop_x = t(σz + iσx)/2,
    hop_y = t(σz + iσy)/2. Returns (hij [2*Nlat, 2*Nlat], positions).
    A standard validation lattice for the local marker."""
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    sy = np.array([[0, -1j], [1j, 0]], dtype=complex)
    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    nlat = lx * ly
    H = np.zeros((2 * nlat, 2 * nlat), dtype=complex)
    pos = np.zeros((nlat, 2))

    def site(xx, yy):
        return xx * ly + yy

    for xx in range(lx):
        for yy in range(ly):
            i = site(xx, yy)
            pos[i] = (xx, yy)
            H[2 * i:2 * i + 2, 2 * i:2 * i + 2] = m * sz
            if xx + 1 < lx:
                j = site(xx + 1, yy)
                hop = t * (sz + 1j * sx) / 2
                H[2 * j:2 * j + 2, 2 * i:2 * i + 2] = hop
                H[2 * i:2 * i + 2, 2 * j:2 * j + 2] = hop.conj().T
            if yy + 1 < ly:
                j = site(xx, yy + 1)
                hop = t * (sz + 1j * sy) / 2
                H[2 * j:2 * j + 2, 2 * i:2 * i + 2] = hop
                H[2 * i:2 * i + 2, 2 * j:2 * j + 2] = hop.conj().T
    return H, pos
