"""Impurity Green's functions and self-energy, ed_mode = normal — port of
dmft_ed_tpu/gf_normal.py.

Diagonal G via c†/c excitations, orbital off-diagonals via (c†_i+c†_j) and
(c†_i+i c†_j) combinations with symmetry reconstruction
(ED_GF_NORMAL.f90:18-116, :279-553), pole accumulation (:580-632) and the
Dyson self-energy (:656-731). The excitation vectors are built on the host
(excitations.py); the Krylov chains run on the solver's device through
gf_common.ResolventBatch.
"""

from __future__ import annotations

from typing import Tuple

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


def _gf_shape(cfg, L):
    return np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb, L),
                    dtype=complex)


def build_gf_normal(cfg: EDConfig, slist: StateList, zeta: float,
                    bath: Bath, hloc: np.ndarray, finite_t: bool,
                    log=None, device="cuda",
                    mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (Gmats, Greal) [Nspin,Nspin,Norb,Norb,L]. `mesh`: sectors
    above cfg.shard_dim_threshold run their chains row-sharded."""
    cache = HamCache(cfg, bath, hloc, device, mesh)
    batch = ResolventBatch(cfg, cache, slist.emin, zeta, finite_t)
    finalize = gf_normal_plan(cfg, slist, bath, batch, log=log)
    return finalize(batch.run())


def gf_normal_plan(cfg: EDConfig, slist: StateList, bath: Bath,
                   batch, site: int = 0, log=None):
    """Enqueue every normal-mode GF channel of one impurity into `batch`
    (tagged with `site`, so that one batch serves several inequivalent
    sites) and return finalize(results) -> (Gmats, Greal), where results
    iterates this site's (meta, weights, poles)."""
    table = sector_table(cfg)
    zm, zr = grids.z_mats(cfg), grids.z_real(cfg)
    Gm, Gr = _gf_shape(cfg, cfg.lmats), _gf_shape(cfg, cfg.lreal)

    def enqueue(sector, vec, e_i, terms, isign, target, cnorm2=1.0):
        r = apply_op_combo(cfg, table, sector, vec, terms)
        if r is None:
            return
        jsec, vv = r
        batch.add(jsec, vv, e_i,
                  {"isign": isign, "target": target, "cnorm2": cnorm2,
                   "site": site}, site=site)

    # --- diagonal G_aa channels (lanc_build_gf_normal_c)
    for ispin in range(cfg.nspin):
        for iorb in range(cfg.norb):
            if log:
                log(f"Get G_l{iorb + 1}_s{ispin + 1}")
            for sector, e_i, vec in state_iter(slist):
                enqueue(sector, vec, e_i, [(1.0, ispin, iorb, True)], 1,
                        (ispin, ispin, iorb, iorb))
                enqueue(sector, vec, e_i, [(1.0, ispin, iorb, False)], -1,
                        (ispin, ispin, iorb, iorb))

    # --- orbital off-diagonal channels (lanc_build_gf_normal_mix_c):
    # O+ = c_a + c_b and Oi = c_a - i c_b give both off-diagonals
    #   Gab = (S - i D)/2,  Gba = (S + i D)/2,
    #   S = G_{O+} - Gaa - Gbb,  D = G_{Oi} - Gaa - Gbb.
    offdiag = (cfg.bath_type != "normal") or cfg.ed_solve_offdiag_gf
    mask = _offdiag_mask(cfg, bath) if (offdiag and cfg.norb > 1) else None
    Gm_i = np.zeros_like(Gm)
    Gr_i = np.zeros_like(Gr)
    if mask is not None:
        for ispin in range(cfg.nspin):
            for iorb in range(cfg.norb):
                for jorb in range(iorb + 1, cfg.norb):
                    if not mask[ispin, iorb, jorb]:
                        continue
                    if log:
                        log(f"Get G_l{iorb + 1}_m{jorb + 1}_s{ispin + 1}")
                    for sector, e_i, vec in state_iter(slist):
                        tgt = (ispin, ispin, iorb, jorb)
                        enqueue(sector, vec, e_i,
                                [(1.0, ispin, iorb, True),
                                 (1.0, ispin, jorb, True)], 1, tgt)
                        enqueue(sector, vec, e_i,
                                [(1.0, ispin, iorb, False),
                                 (1.0, ispin, jorb, False)], -1, tgt)
                        enqueue(sector, vec, e_i,
                                [(1.0, ispin, iorb, True),
                                 (1j, ispin, jorb, True)], 1,
                                tgt + ("i",))
                        enqueue(sector, vec, e_i,
                                [(1.0, ispin, iorb, False),
                                 (-1j, ispin, jorb, False)], -1,
                                tgt + ("i",))

    def finalize(results):
        for meta, w, p in results:
            tgt = meta["target"]
            isign = meta["isign"]
            if len(tgt) == 5:                      # the Oi combo channel
                s1, s2, a, b, _ = tgt
                Gm_i[s1, s2, a, b] += accumulate_poles(zm, w, p, isign)
                Gr_i[s1, s2, a, b] += accumulate_poles(zr, w, p, isign)
            else:
                s1, s2, a, b = tgt
                Gm[s1, s2, a, b] += accumulate_poles(zm, w, p, isign)
                Gr[s1, s2, a, b] += accumulate_poles(zr, w, p, isign)
        if mask is not None:
            for ispin in range(cfg.nspin):
                for iorb in range(cfg.norb):
                    for jorb in range(iorb + 1, cfg.norb):
                        if not mask[ispin, iorb, jorb]:
                            continue
                        for G, Gi in ((Gm, Gm_i), (Gr, Gr_i)):
                            dd = (G[ispin, ispin, iorb, iorb]
                                  + G[ispin, ispin, jorb, jorb])
                            S = G[ispin, ispin, iorb, jorb] - dd
                            D = Gi[ispin, ispin, iorb, jorb] - dd
                            G[ispin, ispin, iorb, jorb] = \
                                0.5 * (S - 1j * D)
                            G[ispin, ispin, jorb, iorb] = \
                                0.5 * (S + 1j * D)
        return Gm, Gr

    return finalize


def _offdiag_mask(cfg: EDConfig, bath: Bath) -> np.ndarray:
    """Which (spin, iorb, jorb) off-diagonal components to compute:
    all for hybrid, replica gated by the bath mask (ED_GF_NORMAL.f90:38-42)."""
    m = np.ones((cfg.nspin, cfg.norb, cfg.norb), dtype=bool)
    if cfg.bath_type == "replica" and bath.mask is not None:
        for s in range(cfg.nspin):
            m[s] = bath.mask[s, s, :, :, 0] | bath.mask[s, s, :, :, 1]
    return m


def build_sigma_normal(cfg: EDConfig, bath: Bath, hloc: np.ndarray,
                       Gmats: np.ndarray, Greal: np.ndarray, device="cuda"):
    """Σ = G0^{-1} - G^{-1}; scalar per (spin,orb) for bath normal,
    orbital-matrix Dyson for hybrid/replica (build_sigma_normal,
    ED_GF_NORMAL.f90:656-731). Also returns G0 on both axes."""
    p = bath_params(bath, device)
    zm = torch.as_tensor(grids.z_mats(cfg), device=device)
    zr = torch.as_tensor(grids.z_real(cfg), device=device)
    ig0m = invg0(cfg, zm, p, hloc, "mats").cpu().numpy()
    ig0r = invg0(cfg, zr, p, hloc, "real").cpu().numpy()
    Sm = np.zeros_like(Gmats)
    Sr = np.zeros_like(Greal)
    if cfg.bath_type == "normal":
        for s in range(cfg.nspin):
            for a in range(cfg.norb):
                Sm[s, s, a, a] = ig0m[s, s, a, a] - 1.0 / Gmats[s, s, a, a]
                Sr[s, s, a, a] = ig0r[s, s, a, a] - 1.0 / Greal[s, s, a, a]
    else:
        for s in range(cfg.nspin):
            igm = np.linalg.inv(Gmats[s, s].transpose(2, 0, 1)
                                ).transpose(1, 2, 0)
            igr = np.linalg.inv(Greal[s, s].transpose(2, 0, 1)
                                ).transpose(1, 2, 0)
            Sm[s, s] = ig0m[s, s] - igm
            Sr[s, s] = ig0r[s, s] - igr
    g0m = g0and(cfg, zm, p, hloc, "mats").cpu().numpy()
    g0r = g0and(cfg, zr, p, hloc, "real").cpu().numpy()
    return Sm, Sr, g0m, g0r
