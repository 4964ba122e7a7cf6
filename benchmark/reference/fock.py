"""Plain Fock-space construction of the single-band Anderson impurity.

Written from the model's definition, independent of the solver under
test. Conventions are those of the upstream dmft-ed code
(ED_SETUP.f90), so that a vector the solver returns can be judged in
this basis:

- ``Ns`` levels per spin: level 0 is the impurity orbital, levels
  ``1..Nbath`` the bath.
- A spin configuration is an integer whose bit ``p`` is the occupation of
  level ``p``; the configurations with ``n`` particles are taken in
  ascending numeric order.
- A sector ``(n_up, n_dw)`` vector is the matrix ``V[i_dw, i_up]``
  flattened with the up index fastest.
- Jordan-Wigner signs are counted over the full word, up bits below down
  bits: ``c_{p,up}`` carries ``(-1)^{#up bits below p}``, ``c_{p,dw}``
  carries ``(-1)^{n_up + #dw bits below p}``.

The Hamiltonian is
``H = sum_{s,i} e_i n_{i,s} + sum_{s,k} V_k (c+_{0,s} c_{k,s} + h.c.)
+ U (n_{0,up} - 1/2)(n_{0,dw} - 1/2) - mu sum_s n_{0,s}``.
Every function here is numpy on the host; the callers move what they
need to a device.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np


def spin_basis(ns: int, n: int) -> np.ndarray:
    """The ns-bit configurations with n set bits, ascending."""
    out = [sum(1 << p for p in c) for c in combinations(range(ns), n)]
    return np.sort(np.asarray(out, dtype=np.int64))


def occupation(basis: np.ndarray, level: int) -> np.ndarray:
    """0/1 occupation of `level` in each configuration."""
    return ((basis >> level) & 1).astype(np.float64)


def _bits_between(x: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Number of set bits of x strictly between bit lo and bit hi."""
    cnt = np.zeros(x.shape, dtype=np.int64)
    for p in range(lo + 1, hi):
        cnt += (x >> p) & 1
    return cnt


def hopping_matrix(ns: int, n: int, t: np.ndarray) -> np.ndarray:
    """Dense sum_{i != j} t[i, j] c+_i c_j on the n-particle basis of one
    spin (the diagonal of t is left to the caller)."""
    basis = spin_basis(ns, n)
    pos = {int(s): k for k, s in enumerate(basis)}
    h = np.zeros((basis.size, basis.size))
    for i in range(ns):
        for j in range(ns):
            if i == j or t[i, j] == 0.0:
                continue
            has = ((basis >> j) & 1 == 1) & ((basis >> i) & 1 == 0)
            src = basis[has]
            dst = src ^ (1 << j) ^ (1 << i)
            sign = 1 - 2 * (_bits_between(src, min(i, j), max(i, j)) & 1)
            rows = np.fromiter((pos[int(s)] for s in dst), np.int64,
                               dst.size)
            cols = np.nonzero(has)[0]
            h[rows, cols] += sign * t[i, j]
    return h


def single_particle(e: np.ndarray, v: np.ndarray, mu: float = 0.0):
    """The (Ns, Ns) one-body matrix of one spin: impurity at 0, bath
    levels e at 1.., hybridizations v between them."""
    ns = e.size + 1
    t = np.zeros((ns, ns))
    t[0, 0] = -mu
    t[np.arange(1, ns), np.arange(1, ns)] = e
    t[0, 1:] = v
    t[1:, 0] = v
    return t


class Sector:
    """The operator of one (n_up, n_dw) sector in factored form:
    ``H V = D * V + H_dw @ V + V @ H_up^T`` on ``V[i_dw, i_up]``."""

    def __init__(self, e: np.ndarray, v: np.ndarray, u: float,
                 nup: int, ndw: int, mu: float = 0.0):
        t = single_particle(np.asarray(e, float), np.asarray(v, float), mu)
        ns = t.shape[0]
        self.ns, self.nup, self.ndw = ns, nup, ndw
        self.up = spin_basis(ns, nup)
        self.dw = spin_basis(ns, ndw)
        self.h_up = hopping_matrix(ns, nup, t)
        self.h_dw = hopping_matrix(ns, ndw, t)
        eps = np.diag(t)
        e_up = sum(eps[p] * occupation(self.up, p) for p in range(ns))
        e_dw = sum(eps[p] * occupation(self.dw, p) for p in range(ns))
        n0u = occupation(self.up, 0)
        n0d = occupation(self.dw, 0)
        self.diag = (e_dw[:, None] + e_up[None, :]
                     + u * (n0d[:, None] - 0.5) * (n0u[None, :] - 0.5))
        self.n0_up, self.n0_dw = n0u, n0d

    @property
    def shape(self):
        return self.dw.size, self.up.size

    @property
    def dim(self) -> int:
        return self.dw.size * self.up.size

    def dense(self) -> np.ndarray:
        """The sector's full (dim, dim) matrix, up index fastest."""
        ddw, dup = self.shape
        return (np.kron(np.eye(ddw), self.h_up)
                + np.kron(self.h_dw, np.eye(dup))
                + np.diag(self.diag.ravel()))


def add_up_impurity(src: Sector, dst: Sector, vec: np.ndarray) -> np.ndarray:
    """c+_{0,up} applied to a (flat) vector of `src`, in `dst`'s basis
    (dst.nup = src.nup + 1, same n_dw); the sign is +1 (no up bit lies
    below level 0)."""
    ddw, dup = src.shape
    V = vec.reshape(ddw, dup)
    pos = {int(s): k for k, s in enumerate(dst.up)}
    out = np.zeros(dst.shape, dtype=V.dtype)
    for k, s in enumerate(src.up):
        if s & 1:
            continue
        out[:, pos[int(s | 1)]] += V[:, k]
    return out.ravel()


def remove_up_impurity(src: Sector, dst: Sector,
                       vec: np.ndarray) -> np.ndarray:
    """c_{0,up} applied to a (flat) vector of `src`, in `dst`'s basis
    (dst.nup = src.nup - 1); the sign is +1."""
    ddw, dup = src.shape
    V = vec.reshape(ddw, dup)
    pos = {int(s): k for k, s in enumerate(dst.up)}
    out = np.zeros(dst.shape, dtype=V.dtype)
    for k, s in enumerate(src.up):
        if not s & 1:
            continue
        out[:, pos[int(s & ~1)]] += V[:, k]
    return out.ravel()
