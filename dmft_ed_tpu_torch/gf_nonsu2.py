"""Green's functions with broken SU(2) (ed_mode = nonsu2) — PyTorch port of
dmft_ed_tpu/gf_nonsu2.py.

Replaces ED_GF_NONSU2.f90: spin-diagonal components via c†/c, spin- and
orbital-off-diagonal components via (c†_{a,s} + c†_{b,s'}) and
(c†_{a,s} + i c†_{b,s'}) combinations with the symmetry reconstruction
(:18-342; workers :343-902; replica components gated by the bath mask), and
the full (Nspin·Norb)² matrix Dyson equation (:977+).

Convention: G[s, s', a, b](z) = <<c_{a,s}; c†_{b,s'}>>, the one of G0 and of
the lattice Gloc, so that Σ = G0^-1 - G^-1 vanishes at U = 0. The JAX
package's reconstruction, (1+i) with the i-combination's weight +i, returns
the transpose <<c_{b,s'}; c†_{a,s}>>, which differs from it wherever the
Hamiltonian is complex (spin-orbit coupling, complex replica baths); the
port takes the i-combination with weight -i and reconstructs with (1-i),
as gf_normal does for its orbital off-diagonals. The excitation vectors
are built on the host (excitations.py); the Krylov chains run on the
solver's device through gf_common.ResolventBatch, and the Dyson inversions
are one batched torch.linalg.inv per axis.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import EDConfig
from .sectors import sector_table
from .bath import Bath
from .bath_fns import bath_params, invg0, g0and
from .eigenspace import StateList
from .excitations import apply_op_combo
from .gf_common import HamCache, ResolventBatch, accumulate_poles, state_iter
from . import grids


def _components(cfg: EDConfig, bath: Bath):
    """(s, s2, a, b) off-diagonal combos to compute, per bath topology."""
    out = []
    ns_, no = cfg.nspin, cfg.norb
    for s in range(ns_):
        for s2 in range(ns_):
            for a in range(no):
                for b in range(no):
                    if s == s2 and a == b:
                        continue
                    if cfg.bath_type == "normal":
                        ok = (s != s2) and (a == b)
                    elif cfg.bath_type == "hybrid":
                        ok = True
                    else:  # replica: gate by fit mask (ED_GF_NONSU2.f90:54)
                        m = bath.mask
                        ok = m is not None and (m[s, s2, a, b, 0]
                                                or m[s, s2, a, b, 1])
                    if ok:
                        out.append((s, s2, a, b))
    return out


def gf_nonsu2_plan(cfg: EDConfig, slist: StateList, bath: Bath,
                   batch, site: int = 0, log=None):
    """Enqueue every nonsu2 GF channel of one impurity into `batch` and
    return finalize(results) -> (Gmats, Greal). Each channel's meta carries
    `site`, the impurity it belongs to, so that one batch can serve several
    inequivalent sites."""
    table = sector_table(cfg)
    zm, zr = grids.z_mats(cfg), grids.z_real(cfg)
    Gm = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb, cfg.lmats),
                  dtype=complex)
    Gr = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb, cfg.lreal),
                  dtype=complex)

    def enqueue(sector, vec, e_i, terms, isign, target, cnorm2=1.0):
        r = apply_op_combo(cfg, table, sector, vec, terms)
        if r is None:
            return
        jsec, vv = r
        batch.add(jsec, vv, e_i,
                  {"isign": isign, "target": target, "cnorm2": cnorm2,
                   "site": site}, site=site)

    # spin-diagonal, orbital-diagonal channels
    for s in range(cfg.nspin):
        for a in range(cfg.norb):
            if log:
                log(f"Get G_l{a + 1}{a + 1}_s{s + 1}{s + 1}")
            for sector, e_i, vec in state_iter(slist):
                enqueue(sector, vec, e_i, [(1.0, s, a, True)], 1,
                        (s, s, a, a))
                enqueue(sector, vec, e_i, [(1.0, s, a, False)], -1,
                        (s, s, a, a))

    comps = _components(cfg, bath)
    for (s, s2, a, b) in comps:
        if log:
            log(f"Get G_l{a + 1}{b + 1}_s{s + 1}{s2 + 1}")
        for sector, e_i, vec in state_iter(slist):
            tgt = (s, s2, a, b)
            enqueue(sector, vec, e_i,
                    [(1.0, s, a, True), (1.0, s2, b, True)], 1, tgt)
            enqueue(sector, vec, e_i,
                    [(1.0, s, a, False), (1.0, s2, b, False)], -1, tgt)
            enqueue(sector, vec, e_i,
                    [(1.0, s, a, True), (1j, s2, b, True)], 1, tgt, -1j)
            enqueue(sector, vec, e_i,
                    [(1.0, s, a, False), (-1j, s2, b, False)], -1, tgt, -1j)

    def finalize(results):
        for meta, w, p in results:
            s, s2, a, b = meta["target"]
            isign = meta["isign"]
            Gm[s, s2, a, b] += accumulate_poles(zm, w, p, isign)
            Gr[s, s2, a, b] += accumulate_poles(zr, w, p, isign)
        # off-diagonal reconstruction: with S = G_{O+} - G_aa - G_bb and
        # D = G_{Oi} - G_aa - G_bb, the target holds G_{O+} - i G_{Oi} and
        # G_ab = (S - i D) / 2
        for (s, s2, a, b) in comps:
            for G in (Gm, Gr):
                G[s, s2, a, b] = 0.5 * (G[s, s2, a, b]
                                        - (1 - 1j) * G[s, s, a, a]
                                        - (1 - 1j) * G[s2, s2, b, b])
        return Gm, Gr

    return finalize


def build_gf_nonsu2(cfg: EDConfig, slist: StateList, zeta: float,
                    bath: Bath, hloc: np.ndarray, finite_t: bool, log=None,
                    device="cuda", mesh=None):
    """Returns (Gmats, Greal) [Nspin,Nspin,Norb,Norb,L]; row-sharded above
    cfg.shard_dim_threshold with a `mesh`."""
    cache = HamCache(cfg, bath, hloc, device, mesh)
    batch = ResolventBatch(cfg, cache, slist.emin, zeta, finite_t)
    finalize = gf_nonsu2_plan(cfg, slist, bath, batch, log=log)
    return finalize(batch.run())


def _so_matrix(F, L, nspin, norb):
    """[Nspin,Nspin,Norb,Norb,L] -> [L, Nso, Nso] (spin-major index)."""
    return F.permute(4, 0, 2, 1, 3).reshape(L, nspin * norb, nspin * norb)


def build_sigma_nonsu2(cfg: EDConfig, bath: Bath, hloc: np.ndarray, Gm, Gr,
                       device="cuda"):
    """Full (Nspin·Norb)^2 matrix Dyson Σ = G0^{-1} - G^{-1}
    (build_sigma_nonsu2); also returns G0 on both axes."""
    p = bath_params(bath, device)
    ns_, no = cfg.nspin, cfg.norb
    out = []
    for G, axis, z in ((Gm, "mats", grids.z_mats(cfg)),
                       (Gr, "real", grids.z_real(cfg))):
        zt = torch.as_tensor(z, device=device)
        L = zt.shape[0]
        i0 = _so_matrix(invg0(cfg, zt, p, hloc, axis), L, ns_, no)
        ig = torch.linalg.inv(_so_matrix(torch.as_tensor(G, device=device),
                                         L, ns_, no))
        S = (i0 - ig).reshape(L, ns_, no, ns_, no).permute(1, 3, 2, 4, 0)
        out.append(S.cpu().numpy())
    zm = torch.as_tensor(grids.z_mats(cfg), device=device)
    zr = torch.as_tensor(grids.z_real(cfg), device=device)
    g0m = g0and(cfg, zm, p, hloc, "mats").cpu().numpy()
    g0r = g0and(cfg, zr, p, hloc, "real").cpu().numpy()
    return out[0], out[1], g0m, g0r
