"""Plain reference of one sector of the Norb-orbital Hund-Kanamori impurity
with a hybrid bath (dmft-ed ``bath_type=hybrid``): its own Fock basis, the
sector's operator written term by term from the model's definition, its
lowest eigenvalue by the plain three-term Lanczos recurrence
(``impurity_nb13.SectorOperator.lowest_eigenvalue``) and the residual of a
given eigenpair. It imports neither jax nor either solver package.

The basis is upstream's (ED_SETUP.f90), as ``fock.py`` documents it:
``Ns = Norb + Nbath`` levels per spin, levels ``0..Norb-1`` the impurity
orbitals and ``Norb..Ns-1`` the bath (a hybrid bath level couples to every
orbital); each spin's configurations ascending; a sector vector is
``V[i_dw, i_up]`` with the up index fastest; the full word holds the up
bits at ``0..Ns-1`` below the down bits at ``Ns..2Ns-1``, and an operator
on word bit ``q`` carries ``(-1)^{set bits below q}``.

The Hamiltonian, with ``n = c^+ c`` and a, b the impurity orbitals::

    H = sum_{k,s} e_k n_{ks} - xmu sum_{a,s} n_{as}
      + sum_{a,k,s} V_{ak} (c^+_{as} c_{ks} + h.c.)
      + sum_a U_a (n_{a,up} - 1/2)(n_{a,dw} - 1/2)
      + U' sum_{a != b} (n_{a,up} - 1/2)(n_{b,dw} - 1/2)
      + (U' - J_H) sum_{a < b, s} (n_{as} - 1/2)(n_{bs} - 1/2)
      + J_x sum_{a != b} c^+_{a,up} c^+_{b,dw} c_{a,dw} c_{b,up}
      + J_p sum_{a != b} c^+_{a,up} c^+_{a,dw} c_{b,dw} c_{b,up}
      - (2 U' - J_H) / 4 * Norb (Norb - 1) / 2

the Kanamori interaction (Georges, de' Medici & Mravlje, Annu. Rev.
Condens. Matter Phys. 4, 137 (2013)) in the Hartree form that dmft-ed's
``hfmode`` selects. The one-body parts are dense per-spin matrices
(``fock.hopping_matrix``); the density terms form the diagonal; the two
four-fermion terms are applied as operators, right to left, to the
sector's full words, and kept as signed index gathers (source index,
destination index, coefficient times sign).

The constant. Completing every (n - 1/2)(n - 1/2) product above gives
``(2 U' - J_H) / 2`` per orbital pair (U'/4 for each of the two ordered
opposite-spin pairs, (U' - J_H)/4 for each spin's same-spin pair).
Upstream's ``hfmode`` adds half of that: its Hint.f90 adds
``-0.5 U' (n_a + n_b) + 0.25 U'`` and ``-0.5 (U' - J_H) (n_a + n_b)
+ 0.25 (U' - J_H)`` per pair a < b (n_a = n_{a,up} + n_{a,dw}), as the
repository's literal transcription of it (``tests/reference_ed.py``,
``build_full_H``) has it. The linear terms agree; the constant differs by
``(2 U' - J_H) / 4`` per pair, and the last line above takes that half
back, so that egs is upstream's.
"""

from __future__ import annotations

import numpy as np
import torch

from .fock import hopping_matrix, occupation, spin_basis
from .impurity_nb13 import SectorOperator as _SingleBand

_POP16 = np.array([bin(i).count("1") for i in range(1 << 16)],
                  dtype=np.int64)


def popcount(x: np.ndarray) -> np.ndarray:
    """Set bits of each non-negative int64 in x."""
    out = np.zeros(x.shape, dtype=np.int64)
    x = x.copy()
    while np.any(x):
        out += _POP16[x & 0xFFFF]
        x >>= 16
    return out


def one_body(e, v, xmu: float = 0.0) -> np.ndarray:
    """The (Ns, Ns) one-body matrix of one spin: the Norb impurity
    orbitals at -xmu, the bath levels e at Norb.., V[a, k] between orbital
    a and bath level k."""
    e, v = np.asarray(e, float), np.asarray(v, float)
    norb, nbath = v.shape
    ns = norb + nbath
    t = np.zeros((ns, ns))
    t[np.arange(norb), np.arange(norb)] = -xmu
    t[np.arange(norb, ns), np.arange(norb, ns)] = e
    t[:norb, norb:] = v
    t[norb:, :norb] = v.T
    return t


def apply_word_ops(ops, words: np.ndarray):
    """A product of creation and annihilation operators, given right to
    left as [("c" or "cdg", word bit)], applied to each full word:
    (indices of the words it does not annihilate, their images, signs)."""
    keep = np.arange(words.size)
    w = words.copy()
    sign = np.ones(words.size, dtype=np.int64)
    for kind, q in ops:
        bit = (w >> q) & 1
        ok = bit == (1 if kind == "c" else 0)
        keep, w, sign = keep[ok], w[ok], sign[ok]
        sign *= 1 - 2 * (popcount(w & ((1 << q) - 1)) & 1)
        w ^= 1 << q
    return keep, w, sign


def four_fermion_terms(norb: int, jx: float, jp: float):
    """[(coefficient, ops right to left as (kind, level, spin))] of the
    spin exchange and the pair hopping over the ordered orbital pairs."""
    out = []
    for a in range(norb):
        for b in range(norb):
            if a == b:
                continue
            if jx != 0.0:        # c+_{a,up} c+_{b,dw} c_{a,dw} c_{b,up}
                out.append((jx, [("c", b, 0), ("c", a, 1), ("cdg", b, 1),
                                 ("cdg", a, 0)]))
            if jp != 0.0:        # c+_{a,up} c+_{a,dw} c_{b,dw} c_{b,up}
                out.append((jp, [("c", b, 0), ("c", b, 1), ("cdg", a, 1),
                                 ("cdg", a, 0)]))
    return out


def mix_gathers(norb: int, ns: int, nup: int, ndw: int, jx: float,
                jp: float):
    """The four-fermion terms of sector (nup, ndw) as signed index
    gathers: [(src, dst, weight)] per term, flat sector indices (up index
    fastest), weight = coefficient x sign; host numpy."""
    up, dw = spin_basis(ns, nup), spin_basis(ns, ndw)
    words = (dw[:, None] << ns | up[None, :]).ravel()
    pos_up = np.full(1 << ns, -1, dtype=np.int64)
    pos_dw = np.full(1 << ns, -1, dtype=np.int64)
    pos_up[up] = np.arange(up.size)
    pos_dw[dw] = np.arange(dw.size)
    out = []
    for coeff, ops in four_fermion_terms(norb, jx, jp):
        src, img, sign = apply_word_ops(
            [(kind, lvl + ns * s) for kind, lvl, s in ops], words)
        dst = pos_dw[img >> ns] * up.size + pos_up[img & ((1 << ns) - 1)]
        assert np.all(dst >= 0), "a term left the sector"
        out.append((src, dst, coeff * sign.astype(np.float64)))
    return out


def density_diagonal(e, v, uloc, ust, jh, nup, ndw,
                     xmu=0.0) -> np.ndarray:
    """The [ddw, dup] diagonal: level energies and the density-density
    interaction in the Hartree form (module docstring)."""
    t = one_body(e, v, xmu)
    norb, ns = np.asarray(v).shape[0], t.shape[0]
    up, dw = spin_basis(ns, nup), spin_basis(ns, ndw)
    eps = np.diag(t)
    d = (sum(eps[p] * occupation(dw, p) for p in range(ns))[:, None]
         + sum(eps[p] * occupation(up, p) for p in range(ns))[None, :])
    hu = [occupation(up, a)[None, :] - 0.5 for a in range(norb)]
    hd = [occupation(dw, a)[:, None] - 0.5 for a in range(norb)]
    for a in range(norb):
        d = d + uloc[a] * hd[a] * hu[a]
        for b in range(norb):
            if b != a:
                d = d + ust * hu[a] * hd[b]
        for b in range(a + 1, norb):
            d = d + (ust - jh) * (hu[a] * hu[b] + hd[a] * hd[b])
    return d - 0.25 * (2 * ust - jh) * (norb * (norb - 1) // 2)


class SectorOperator(_SingleBand):
    """The operator of sector (nup, ndw):
    ``H V = D * V + H_dw @ V + V @ H_up^T + sum_terms w * V[src] -> [dst]``
    on ``V[i_dw, i_up]``; float64, on `device` (the dense products are
    plain ``torch.matmul``, the terms one gather and one ``index_add_``)."""

    def __init__(self, e, v, uloc, ust, jh, jx, jp, nup: int, ndw: int,
                 device, xmu: float = 0.0):
        v = np.asarray(v, float)
        t = one_body(e, v, xmu)
        norb, ns = v.shape[0], t.shape[0]
        self.h_up = hopping_matrix(ns, nup, t)
        self.h_dw = hopping_matrix(ns, ndw, t)
        self.d = density_diagonal(e, v, uloc, ust, jh, nup, ndw, xmu)
        self.gathers = mix_gathers(norb, ns, nup, ndw, jx, jp)
        self.shape = self.d.shape
        self.dim = self.d.size
        self.device = torch.device(device)
        f64 = dict(dtype=torch.float64, device=self.device)
        self.h_up_t = torch.as_tensor(self.h_up.T.copy(), **f64)
        self.h_dw_dev = torch.as_tensor(self.h_dw, **f64)
        self.diag = torch.as_tensor(self.d, **f64)
        idx = dict(dtype=torch.int64, device=self.device)
        cat = [np.concatenate([g[i] for g in self.gathers])
               if self.gathers else np.zeros(0) for i in range(3)]
        self.src = torch.as_tensor(cat[0], **idx)
        self.dst = torch.as_tensor(cat[1], **idx)
        self.w = torch.as_tensor(cat[2], **f64)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        X = x.reshape(self.shape)
        y = (self.diag * X + self.h_dw_dev @ X + X @ self.h_up_t).reshape(-1)
        return y.index_add_(0, self.dst, self.w * x.reshape(-1)[self.src])

    def dense(self) -> np.ndarray:
        """The sector's full (dim, dim) matrix on the host, up index
        fastest (small sectors only)."""
        ddw, dup = self.shape
        h = (np.kron(np.eye(ddw), self.h_up) + np.kron(self.h_dw, np.eye(dup))
             + np.diag(self.d.ravel()))
        for src, dst, w in self.gathers:
            np.add.at(h, (dst, src), w)
        return h
