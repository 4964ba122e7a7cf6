"""Susceptibilities χ_spin, χ_dens, χ_pair in τ, iν and ω domains —
PyTorch port of dmft_ed_tpu/chi.py.

Replaces ED_GF_CHISPIN.f90 / ED_GF_CHIDENS.f90 / ED_GF_CHIPAIR.f90: apply the
(Hermitian) probe operator to each kept state, one Lanczos tridiagonalization
in the same (or pair-shifted) sector, then the bosonic spectral accumulation
— both isign=±1 reductions from the single tridiagonalization, with the
β·peso zero-frequency limit (add_to_lanczos_spinChi, :254-323).

The probe vectors are built on the host (excitations.py); every Krylov
chain runs on the solver's device through gf_common.ResolventBatch, as the
Green's functions do. The density channels (n_a ∓ i n_b) are complex
vectors against a real operator: under ``ozaki*`` they go through the
Ozaki products as their real and imaginary parts (hamiltonian._linear)
— the JAX package's digits drop the imaginary part there. The probe
channels of several inequivalent sites can share one batch (``site=``,
lattice_solver._batched_chi).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .config import EDConfig
from .sectors import sector_table
from .bath import Bath
from .eigenspace import StateList
from .excitations import apply_diag_op, apply_spin_op
from .gf_common import HamCache, ResolventBatch, state_iter
from . import grids


class _BoseAccum:
    """Accumulation grids + the per-channel reduction."""

    def __init__(self, cfg: EDConfig, nrow: int):
        self.cfg = cfg
        self.tau = grids.imaginary_time(cfg)
        self.vm = grids.matsubara_bosonic(cfg)
        self.wr = grids.real_axis(cfg)
        self.chi_tau = np.zeros((nrow, len(self.tau)), dtype=complex)
        self.chi_iv = np.zeros((nrow, len(self.vm)), dtype=complex)
        self.chi_w = np.zeros((nrow, len(self.wr)), dtype=complex)

    def add_poles(self, row, weights, poles, isigns=(1, -1)):
        """isign=±1 bosonic reductions of one resolvent's (weights, dE)
        pole set (add_to_lanczos_spinChi, ED_GF_CHISPIN.f90:254-323); the
        dens off-diagonal channels use a single isign with complex weight
        (ED_GF_CHIDENS.f90:131-178). weights carry the full Boltzmann/Z
        prefactor (gf_common.ResolventBatch convention); poles are
        dE_j = E_j - E_i. Vectorized over (poles x grid)."""
        cfg = self.cfg
        if weights.size == 0:
            return
        beta = cfg.beta
        peso = np.asarray(weights)                    # may be complex
        dE = np.asarray(poles)
        ebde = np.where(beta * dE < 200.0,
                        np.exp(-np.clip(beta * dE, -700.0, 200.0)), 0.0)
        iv = 1j * self.vm[1:]
        zw = self.wr + 1j * cfg.eps
        iv0 = np.where(beta * dE < 1e-1, peso * beta,
                       peso * (1 - ebde) / np.where(np.abs(dE) > 0, dE, 1.0))
        if 1 in isigns:
            self.chi_iv[row, 0] += iv0.sum()
            self.chi_iv[row, 1:] += np.sum(
                (peso * (ebde - 1.0))[:, None] / (iv[None, :] - dE[:, None]),
                axis=0)
            self.chi_tau[row] += np.sum(
                peso[:, None] * np.exp(np.clip(-self.tau[None, :]
                                               * dE[:, None], -200, 200)),
                axis=0)
            self.chi_w[row] += np.sum(
                (peso * (ebde - 1.0))[:, None] / (zw[None, :] - dE[:, None]),
                axis=0)
        if -1 in isigns:
            self.chi_iv[row, 0] += iv0.sum()
            self.chi_iv[row, 1:] += np.sum(
                (peso * (1.0 - ebde))[:, None] / (iv[None, :] + dE[:, None]),
                axis=0)
            self.chi_tau[row] += np.sum(
                peso[:, None] * np.exp(np.clip(
                    -(beta - self.tau[None, :]) * dE[:, None], -200, 200)),
                axis=0)
            self.chi_w[row] += np.sum(
                (peso * (1.0 - ebde))[:, None] / (zw[None, :] + dE[:, None]),
                axis=0)


def chi_rows_plan(cfg: EDConfig, slist: StateList, rows, batch,
                  site: int = 0, kind: str = ""):
    """Add probe channels of one site to a (possibly cross-site)
    ResolventBatch and return a finalizer.
    rows: list of (row_index, builder) where builder(sector, vec) returns
    None or (target_sector, vector[, cnorm_multiplier[, isigns]]).

    All probe channels run through gf_common.ResolventBatch — the same
    device batching (the wide-concat sweep, the ragged merge, channels per
    sector on a batch axis) as the GF pass; the reference runs each chi
    channel through a serial Lanczos (ED_GF_CHI*.f90)."""
    nrow = max(r for r, _ in rows) + 1
    for row, build in rows:
        for sector, e_i, vec in state_iter(slist):
            r = build(sector, vec)
            if r is None:
                continue
            jsec, vv = r[0], r[1]
            cnorm = r[2] if len(r) > 2 else 1.0
            isigns = r[3] if len(r) > 3 else (1, -1)
            batch.add(jsec, vv, e_i,
                      {"row": row, "isigns": isigns, "cnorm2": cnorm,
                       "site": site, "chi": kind}, site=site)

    def finalize(results):
        acc = _BoseAccum(cfg, nrow)
        for meta, w, p in results:
            acc.add_poles(meta["row"], w, p, meta["isigns"])
        return acc.chi_tau, acc.chi_iv, acc.chi_w
    return finalize


def _chi_generic(cfg: EDConfig, slist: StateList, zeta: float, bath: Bath,
                 hloc, finite_t: bool, rows, log=None, device="cuda",
                 mesh=None):
    """Single-impurity susceptibility over chi_rows_plan (row-sharded
    above cfg.shard_dim_threshold with a `mesh`)."""
    cache = HamCache(cfg, bath, hloc, device, mesh)
    batch = ResolventBatch(cfg, cache, slist.emin, zeta, finite_t)
    fin = chi_rows_plan(cfg, slist, rows, batch)
    return fin(list(batch.run()))


def _rows_spin(cfg: EDConfig):
    """χ^z_aa = <Sz_a(τ) Sz_a(0)> per orbital + total (build_chi_spin)."""
    ns = cfg.ns

    def sz_op(a):
        def build(sector, vec):
            up = np.zeros(ns)
            dw = np.zeros(ns)
            up[a], dw[a] = 0.5, -0.5
            return sector, apply_diag_op(cfg, sector, vec, up, dw)
        return build

    def sz_tot(sector, vec):
        up = np.zeros(ns)
        dw = np.zeros(ns)
        up[:cfg.norb], dw[:cfg.norb] = 0.5, -0.5
        return sector, apply_diag_op(cfg, sector, vec, up, dw)

    rows = [(a, sz_op(a)) for a in range(cfg.norb)]
    if cfg.norb > 1:
        rows.append((cfg.norb, sz_tot))
    return rows, lambda tau_, iv_, w_: _to_matrix(cfg, tau_, iv_, w_)


def build_chi_spin(cfg: EDConfig, slist, zeta, bath, hloc, finite_t,
                   log=None, device="cuda", mesh=None):
    """Returns arrays [Norb(+1 tot), Norb broadcast, L] shaped [N, N, L]-like:
    here (rows = orbitals + total) mapped to [Norb+t, Norb+t] diag layout."""
    if log:
        log("Get impurity spin Chi:")
    rows, post = _rows_spin(cfg)
    return post(*_chi_generic(cfg, slist, zeta, bath, hloc, finite_t,
                              rows, log, device, mesh))


def _rows_dens(cfg: EDConfig):
    """χ_nn: orbital-diagonal, off-diagonal (via (n_a+n_b) and (n_a∓i n_b)
    combinations with the (1+i) reconstruction on χ(ω),
    ED_GF_CHIDENS.f90:18-66, :280-470) and total-density channels."""
    ns = cfg.ns
    norb = cfg.norb

    def n_comb(coeffs):
        def build(sector, vec, _c=coeffs):
            up = np.zeros(ns)
            dw = np.zeros(ns)
            for orb, cf in _c.items():
                up[orb] = dw[orb] = cf
            return sector, apply_diag_op(cfg, sector, vec, up, dw)
        return build

    rows = [(a, n_comb({a: 1.0})) for a in range(norb)]
    pair_rows = {}
    nrow = norb
    tot_row = None
    if norb > 1:
        for a in range(norb):
            for b in range(a + 1, norb):
                pair_rows[(a, b)] = nrow
                row = nrow
                rows.append((row, n_comb({a: 1.0, b: 1.0})))
                # single-isign complex channels (ED_GF_CHIDENS.f90:96-178)
                rows.append((row, lambda sec, v, a=a, b=b: (
                    sec, apply_diag_op(cfg, sec, v.astype(complex),
                                       *_nvec(ns, {a: 1.0, b: -1j})),
                    1j, (1,))))
                rows.append((row, lambda sec, v, a=a, b=b: (
                    sec, apply_diag_op(cfg, sec, v.astype(complex),
                                       *_nvec(ns, {a: 1.0, b: 1j})),
                    1j, (-1,))))
                nrow += 1
        rows.append((nrow, n_comb({a: 1.0 for a in range(norb)})))
        tot_row = nrow
        nrow += 1

    def post(tau_, iv_, w_):
        n = norb + (1 if norb > 1 else 0)
        out_tau = np.zeros((n, n, tau_.shape[-1]), dtype=complex)
        out_iv = np.zeros((n, n, iv_.shape[-1]), dtype=complex)
        out_w = np.zeros((n, n, w_.shape[-1]), dtype=complex)
        for a in range(norb):
            out_tau[a, a], out_iv[a, a], out_w[a, a] = tau_[a], iv_[a], w_[a]
        if norb > 1:
            out_tau[norb, norb] = tau_[tot_row]
            out_iv[norb, norb] = iv_[tot_row]
            out_w[norb, norb] = w_[tot_row]
            for (a, b), row in pair_rows.items():
                out_tau[a, b] = out_tau[b, a] = tau_[row]
                out_iv[a, b] = out_iv[b, a] = iv_[row]
                # (1+i) reconstruction applied to χ(ω) as in the reference
                w_ab = 0.5 * (w_[row] - (1 + 1j) * w_[a] - (1 + 1j) * w_[b])
                out_w[a, b] = out_w[b, a] = w_ab
        return out_tau, out_iv, out_w
    return rows, post


def build_chi_dens(cfg: EDConfig, slist, zeta, bath, hloc, finite_t,
                   log=None, device="cuda", mesh=None):
    if log:
        log("Get impurity dens Chi:")
    rows, post = _rows_dens(cfg)
    return post(*_chi_generic(cfg, slist, zeta, bath, hloc, finite_t,
                              rows, log, device, mesh))


def _nvec(ns, coeffs):
    up = np.zeros(ns, dtype=complex)
    dw = np.zeros(ns, dtype=complex)
    for orb, cf in coeffs.items():
        up[orb] = dw[orb] = cf
    return up, dw


def _rows_dens_mix(cfg: EDConfig):
    """χ_mix^{ab}: orbital-mixing density response over ALL pairs (a, b),
    diagonal included — the reference's separate densChi_mix_* arrays
    (ED_GF_CHIDENS.f90:490-673, add_to_lanczos_densChi_mix). Per spin
    species σ (the reference loops ispin=1..Nspin, so Nspin=1 probes the
    up channel only — mirrored here), two independent Krylov chains:

        isign=+1 with v = c†_{b,σ} c_{a,σ} |ψ⟩
        isign=-1 with v = c†_{a,σ} c_{b,σ} |ψ⟩

    both number-conserving, so the resolvent runs in the state's own
    sector. Post shape: (tau, iv, w) arrays [norb, norb, L]."""
    from .excitations import apply_hop_op
    table = sector_table(cfg)
    norb = cfg.norb

    def hop(spin, src, dst, isign):
        def build(sector, vec, _s=spin, _a=src, _b=dst, _i=isign):
            w = apply_hop_op(cfg, table, sector, vec, _s, _a, _b)
            if w is None:
                return None
            return sector, w, 1.0, (_i,)
        return build

    rows = []
    for a in range(norb):
        for b in range(norb):
            row = a * norb + b
            for s in range(cfg.nspin):
                rows.append((row, hop(s, a, b, 1)))
                rows.append((row, hop(s, b, a, -1)))

    def post(tau_, iv_, w_):
        shape = (norb, norb)
        return (tau_.reshape(shape + tau_.shape[-1:]),
                iv_.reshape(shape + iv_.shape[-1:]),
                w_.reshape(shape + w_.shape[-1:]))
    return rows, post


def build_chi_dens_mix(cfg: EDConfig, slist, zeta, bath, hloc, finite_t,
                       log=None, device="cuda", mesh=None):
    if log:
        log("Get impurity dens Chi (mix):")
    rows, post = _rows_dens_mix(cfg)
    return post(*_chi_generic(cfg, slist, zeta, bath, hloc, finite_t,
                              rows, log, device, mesh))


def _rows_pair(cfg: EDConfig):
    """χ_pair_aa with the pair operator Δ_a = c_{a,dw} c_{a,up}
    (build_chi_pair; ED_GF_CHIPAIR.f90:60-130)."""
    table = sector_table(cfg)

    def pair_op(a):
        def build(sector, vec):
            r1 = apply_spin_op(cfg, table, sector, vec, 0, a, False)  # c_up
            if r1 is None:
                return None
            j1, w1 = r1
            r2 = apply_spin_op(cfg, table, j1, w1, 1, a, False)       # c_dw
            if r2 is None:
                return None
            return r2
        return build

    rows = [(a, pair_op(a)) for a in range(cfg.norb)]
    return rows, lambda tau_, iv_, w_: _to_matrix(cfg, tau_, iv_, w_)


def build_chi_pair(cfg: EDConfig, slist, zeta, bath, hloc, finite_t,
                   log=None, device="cuda", mesh=None):
    if log:
        log("Get impurity pair Chi:")
    rows, post = _rows_pair(cfg)
    return post(*_chi_generic(cfg, slist, zeta, bath, hloc, finite_t,
                              rows, log, device, mesh))


_CHI_KINDS = {"spin": _rows_spin, "dens": _rows_dens,
              "dens_mix": _rows_dens_mix, "pair": _rows_pair}


def chi_plan(cfg: EDConfig, kind: str, slist, batch, site: int = 0):
    """Add one chi kind's probe channels for one site to a (possibly
    cross-site) ResolventBatch (lattice_solver._batched_chi) and return
    the finalizer mapping that site's (meta, w, p) results to the chi
    tuple — the χ analogue of gf_normal_plan (kinds 'spin', 'dens',
    'dens_mix', 'pair')."""
    rows, post = _CHI_KINDS[kind](cfg)
    fin = chi_rows_plan(cfg, slist, rows, batch, site=site, kind=kind)
    return lambda results: post(*fin(results))


def _to_matrix(cfg, tau_, iv_, w_):
    """rows -> [N, N, L] diagonal matrices for the io layer (row Norb = tot
    stored at the (Norb-1, Norb-1)+... kept as extra diagonal entry)."""
    n = tau_.shape[0]
    out = []
    for arr in (tau_, iv_, w_):
        m = np.zeros((n, n) + arr.shape[1:], dtype=arr.dtype)
        for i in range(n):
            m[i, i] = arr[i]
        out.append(m)
    return tuple(out)
