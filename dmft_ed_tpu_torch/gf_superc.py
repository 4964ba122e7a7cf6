"""Superconducting Green's functions (ed_mode = superc) — port of
dmft_ed_tpu/gf_superc.py.

Replaces ED_GF_SUPERC.f90: per orbital, three auxiliary Krylov channels
  1. c†_↑ / c_↑                         -> G
  2. c_↓ (isign +1) / c†_↓ (isign -1)   -> Ḡ  (hole propagator)
  3. (c†_↑ + c_↓) / (c_↑ + c†_↓)        -> A, with F = ½(A − G − Ḡ)
(:18-77, channel ops :119-450); hybrid-bath mixed orbital channels (:455-750);
Σ and Σᴬ from Nambu inversion (:826-930). Nspin=2 is forbidden in this mode.

The excitation vectors are built on the host (excitations.py); the Krylov
chains run on the solver's device through gf_common.ResolventBatch. A superc
target sector is multi-block with pairing mix terms, so its channels take
the stacked route, one chain per channel.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import EDConfig
from .sectors import sector_table
from .bath import Bath
from .bath_fns import bath_params, invg0, g0and, f0and, fdelta
from .eigenspace import StateList
from .excitations import apply_op_combo
from .gf_common import HamCache, ResolventBatch, accumulate_poles, state_iter
from . import grids


def build_gf_superc(cfg: EDConfig, slist: StateList, zeta: float,
                    bath: Bath, hloc: np.ndarray, finite_t: bool, log=None,
                    device="cuda", mesh=None):
    """Returns (Gmats, Greal, Fmats, Freal); all channels batched per
    target sector (gf_common.ResolventBatch), row-sharded above
    cfg.shard_dim_threshold with a `mesh`."""
    cache = HamCache(cfg, bath, hloc, device, mesh)
    batch = ResolventBatch(cfg, cache, slist.emin, zeta, finite_t)
    finalize = gf_superc_plan(cfg, slist, batch, log=log)
    return finalize(batch.run())


def gf_superc_plan(cfg: EDConfig, slist: StateList, batch, site: int = 0,
                   log=None):
    """Enqueue the 3-auxiliary-channel superc GF build of one impurity
    into `batch` (tagged with `site`) and return finalize(results) ->
    (Gmats, Greal, Fmats, Freal)."""
    table = sector_table(cfg)
    zm, zr = grids.z_mats(cfg), grids.z_real(cfg)
    shape_m = (cfg.nspin, cfg.nspin, cfg.norb, cfg.norb, cfg.lmats)
    shape_r = (cfg.nspin, cfg.nspin, cfg.norb, cfg.norb, cfg.lreal)
    Gm = np.zeros(shape_m, dtype=complex)
    Gr = np.zeros(shape_r, dtype=complex)
    Fm = np.zeros(shape_m, dtype=complex)
    Fr = np.zeros(shape_r, dtype=complex)
    auxm = np.zeros((3, cfg.norb, cfg.lmats), dtype=complex)
    auxr = np.zeros((3, cfg.norb, cfg.lreal), dtype=complex)
    mixm = np.zeros((cfg.norb, cfg.norb, cfg.lmats), dtype=complex)
    mixr = np.zeros((cfg.norb, cfg.norb, cfg.lreal), dtype=complex)
    hybrid = cfg.bath_type == "hybrid" and cfg.norb > 1

    def enqueue(sector, vec, e_i, terms, isign, target, cnorm2=1.0):
        r = apply_op_combo(cfg, table, sector, vec, terms)
        if r is None:
            return
        jsec, vv = r
        batch.add(jsec, vv, e_i,
                  {"isign": isign, "target": target, "cnorm2": cnorm2,
                   "site": site}, site=site)

    for a in range(cfg.norb):
        if log:
            log(f"Get G&F_l{a + 1}_s1")
        for sector, e_i, vec in state_iter(slist):
            # channel 1: G
            enqueue(sector, vec, e_i, [(1.0, 0, a, True)], 1, ("aux", 0, a))
            enqueue(sector, vec, e_i, [(1.0, 0, a, False)], -1, ("aux", 0, a))
            # channel 2: barG (hole propagator: inverted isign)
            enqueue(sector, vec, e_i, [(1.0, 1, a, False)], 1, ("aux", 1, a))
            enqueue(sector, vec, e_i, [(1.0, 1, a, True)], -1, ("aux", 1, a))
            # channel 3: A = (c†_up + c_dw)
            enqueue(sector, vec, e_i,
                    [(1.0, 0, a, True), (1.0, 1, a, False)], 1, ("aux", 2, a))
            enqueue(sector, vec, e_i,
                    [(1.0, 0, a, False), (1.0, 1, a, True)], -1,
                    ("aux", 2, a))

    if hybrid:
        for a in range(cfg.norb):
            for b in range(a + 1, cfg.norb):
                if log:
                    log(f"Get G_l{a + 1}_m{b + 1}_s1")
                for sector, e_i, vec in state_iter(slist):
                    tgt = ("mix", a, b)
                    enqueue(sector, vec, e_i,
                            [(1.0, 0, a, True), (1.0, 1, b, False)], 1, tgt)
                    enqueue(sector, vec, e_i,
                            [(1.0, 0, a, False), (1.0, 1, b, True)], -1, tgt)
                    enqueue(sector, vec, e_i,
                            [(1.0, 0, a, True), (1j, 1, b, False)], 1, tgt,
                            -1j)
                    enqueue(sector, vec, e_i,
                            [(1.0, 0, a, False), (-1j, 1, b, True)], -1, tgt,
                            -1j)

    def finalize(results):
        for meta, w, p in results:
            isign = meta["isign"]
            if meta["target"][0] == "aux":
                _, ch, a = meta["target"]
                auxm[ch, a] += accumulate_poles(zm, w, p, isign)
                auxr[ch, a] += accumulate_poles(zr, w, p, isign)
            else:
                _, a, b = meta["target"]
                mixm[a, b] += accumulate_poles(zm, w, p, isign)
                mixr[a, b] += accumulate_poles(zr, w, p, isign)

        for a in range(cfg.norb):
            Gm[0, 0, a, a] = auxm[0, a]
            Gr[0, 0, a, a] = auxr[0, a]
            Fm[0, 0, a, a] = 0.5 * (auxm[2, a] - auxm[0, a] - auxm[1, a])
            Fr[0, 0, a, a] = 0.5 * (auxr[2, a] - auxr[0, a] - auxr[1, a])
        if hybrid:
            for a in range(cfg.norb):
                for b in range(a + 1, cfg.norb):
                    Gm[0, 0, a, b] = mixm[a, b]
                    Gr[0, 0, a, b] = mixr[a, b]
                    Fm[0, 0, a, b] = 0.5 * (mixm[a, b]
                                            - (1 - 1j) * Gm[0, 0, a, a]
                                            - (1 - 1j) * auxm[1, b])
                    Fr[0, 0, a, b] = 0.5 * (mixr[a, b]
                                            - (1 - 1j) * Gr[0, 0, a, a]
                                            - (1 - 1j) * auxr[1, b])
        return Gm, Gr, Fm, Fr

    return finalize


def build_sigma_superc(cfg: EDConfig, bath: Bath, hloc: np.ndarray,
                       Gm, Gr, Fm, Fr, device="cuda"):
    """Nambu Dyson: Σ = G0^{-1} - G^{-1}, Σᴬ = F0^{-1} - F^{-1}
    (build_sigma_superc, ED_GF_SUPERC.f90:826-930). The real-axis Nambu
    matrix pairs G(w) with conj(G(-w)): the reversed grid, index
    lreal-1-i. Also returns G0 and F0 on both axes."""
    p = bath_params(bath, device)
    zm = torch.as_tensor(grids.z_mats(cfg), device=device)
    zr = torch.as_tensor(grids.z_real(cfg), device=device)
    ig0m = invg0(cfg, zm, p, hloc, "mats").cpu().numpy()
    ig0r = invg0(cfg, zr, p, hloc, "real").cpu().numpy()
    if0m = -fdelta(cfg, zm, p, "mats").cpu().numpy()
    if0r = -fdelta(cfg, zr, p, "real").cpu().numpy()
    Sm = np.zeros_like(Gm)
    Sr = np.zeros_like(Gr)
    SAm = np.zeros_like(Fm)
    SAr = np.zeros_like(Fr)
    no = cfg.norb
    if cfg.bath_type == "normal":
        for a in range(no):
            g, f = Gm[0, 0, a, a], Fm[0, 0, a, a]
            det = np.abs(g) ** 2 + f ** 2
            Sm[0, 0, a, a] = ig0m[0, 0, a, a] - np.conj(g) / det
            SAm[0, 0, a, a] = if0m[0, 0, a, a] - f / det
            gr, fr = Gr[0, 0, a, a], Fr[0, 0, a, a]
            det_r = -gr * np.conj(gr[::-1]) - fr ** 2
            Sr[0, 0, a, a] = ig0r[0, 0, a, a] + np.conj(gr[::-1]) / det_r
            SAr[0, 0, a, a] = if0r[0, 0, a, a] + fr / det_r
    else:
        for G, F, ig0, if0, S, SA, rev in (
                (Gm, Fm, ig0m, if0m, Sm, SAm, False),
                (Gr, Fr, ig0r, if0r, Sr, SAr, True)):
            g = G[0, 0].transpose(2, 0, 1)                 # [L, no, no]
            f = F[0, 0].transpose(2, 0, 1)
            gbar = -np.conj(g[::-1] if rev else g)
            Minv = np.linalg.inv(np.block([[g, f], [f, gbar]]))
            S[0, 0] = ig0[0, 0] - Minv[:, :no, :no].transpose(1, 2, 0)
            SA[0, 0] = if0[0, 0] - Minv[:, :no, no:].transpose(1, 2, 0)
    g0m = g0and(cfg, zm, p, hloc, "mats").cpu().numpy()
    g0r = g0and(cfg, zr, p, hloc, "real").cpu().numpy()
    f0m = f0and(cfg, zm, p, hloc, "mats").cpu().numpy()
    f0r = f0and(cfg, zr, p, hloc, "real").cpu().numpy()
    return Sm, Sr, SAm, SAr, g0m, g0r, f0m, f0r
