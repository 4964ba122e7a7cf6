"""Inequivalent-site (real-space DMFT) solver layer — PyTorch port of
dmft_ed_tpu/lattice_solver.py.

Replaces ED_MAIN.f90's lattice variants (:344-681): a stack of impurity
solvers, one per inequivalent site, each with its own ``_ineq####`` file
suffix. The reference distributes sites round-robin over MPI ranks
(ED_MAIN.f90:576-678); here the sites are one batch: the sector sweep runs
site-batched (diag.diagonalize_sites), the Green's function and
susceptibility chains of every site share one gf_common.ResolventBatch,
and the bath fit is one joint L-BFGS-B over all sites
(fit.chi2_fitgf_sites). With a ``(sites, rows)`` mesh the eigh batches,
the stacked restarts and the fit's objective split over the sites group
and large sectors row-shard over the rows group.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .config import EDConfig
from .solver import EDSolver, SolveResult
from .bath import break_symmetry_bath


class LatticeEDSolver:
    """N_ineq impurity solvers sharing one config and one device.

    hloc_ineq: [Nineq, Nspin, Nspin, Norb, Norb].
    """

    def __init__(self, cfg: EDConfig, hloc_ineq: np.ndarray, log=None,
                 cfgs=None, mesh=None, device="cuda"):
        """cfgs: optional per-site configs (same sector structure as cfg,
        different interaction/level values — ed_ahm_stripe.f90's periodic
        U modulation). mesh: optional (sites, rows) parallel.Mesh — the
        site-batched sweep and the joint fit split over 'sites', sectors
        above cfg.shard_dim_threshold row-shard over 'rows'; every rank
        gets every site's result."""
        self.cfg = cfg
        self.mesh = mesh
        self.nineq = hloc_ineq.shape[0]
        self.cfgs = list(cfgs) if cfgs is not None else [cfg] * self.nineq
        self.solvers: List[EDSolver] = [
            EDSolver(self.cfgs[i], hloc_ineq[i], suffix=f"_ineq{i + 1:04d}",
                     log=log, device=device, mesh=mesh)
            for i in range(self.nineq)]
        self.device = self.solvers[0].device
        self.results: Optional[List[SolveResult]] = None
        from .timer import Timers
        self.timers = Timers(self.solvers[0].log if cfg.ed_verbose >= 4
                             else None)

    def init_solvers(self, sb_field_sign: Optional[Sequence[int]] = None
                     ) -> np.ndarray:
        """[Nineq, Nb] initial bath stack (ed_init_solver lattice)."""
        baths = np.stack([s.init_solver() for s in self.solvers])
        if sb_field_sign is not None and self.cfg.nspin > 1:
            for i, sgn in enumerate(sb_field_sign):
                baths[i] = break_symmetry_bath(
                    self.cfg, baths[i], self.cfg.sb_field, float(sgn),
                    self.solvers[i].mask)
        return baths

    def solve(self, baths: np.ndarray,
              batched: bool = True) -> List[SolveResult]:
        """Solve all inequivalent impurities. With `batched`, the sector
        sweep runs site-batched (diag.diagonalize_sites) and the GF and chi
        chains of all sites share one batch; without, each site runs its
        own EDSolver.solve."""
        if not batched:
            self.results = [s.solve(baths[i])
                            for i, s in enumerate(self.solvers)]
            return self.results
        from .bath import unpack_bath
        from .diag import diagonalize_sites
        cfg = self.cfg
        ubaths = [unpack_bath(cfg, baths[i], self.solvers[i].mask)
                  for i in range(self.nineq)]
        hlocs = [s.hloc for s in self.solvers]
        with self.timers("diagonalize_sites"):
            slists, zetas, states = diagonalize_sites(
                cfg, ubaths, hlocs, [s.diag_state for s in self.solvers],
                log=self.solvers[0].log, cfgs=self.cfgs,
                suffixes=[s.suffix for s in self.solvers],
                timers=self.timers, device=self.device, mesh=self.mesh)
        for i, s in enumerate(self.solvers):
            s.diag_state = states[i]
        with self.timers("gf_resolvents"):
            gfs = self._batched_gf(ubaths, slists, zetas)
        with self.timers("chi_resolvents"):
            chis = self._batched_chi(ubaths, slists, zetas)
        self.results = []
        for i, s in enumerate(self.solvers):
            self.results.append(
                s.solve_from_spectrum(ubaths[i], slists[i], zetas[i],
                                      gf=gfs[i], chi=chis[i]))
        return self.results

    def _add_sites(self, batch, ubaths, slists, zetas):
        """Register every site's operator cache, ground energy, Z and
        temperature regime with a shared ResolventBatch."""
        from .gf_common import HamCache
        for i, s in enumerate(self.solvers):
            finite_t = self.cfg.finite_t or \
                s.diag_state.lanc_nstates_total > 1
            finite_t = finite_t and len(slists[i]) > 1
            cache = HamCache(self.cfgs[i], ubaths[i], s.hloc, self.device,
                             self.mesh)
            batch.add_site(i, cache, slists[i].emin, zetas[i], finite_t)

    def _batched_gf(self, ubaths, slists, zetas):
        """Cross-site batched GF pass (all three ed_modes): every site's
        Krylov resolvents run through one gf_common.ResolventBatch, whose
        routes stack the same sector of different sites — the reference's
        round-robin site distribution (ED_MAIN.f90:576-678) as a batch
        axis."""
        from .gf_common import ResolventBatch
        from .gf_normal import gf_normal_plan
        from .gf_superc import gf_superc_plan
        from .gf_nonsu2 import gf_nonsu2_plan
        cfg = self.cfg
        batch = ResolventBatch(cfg)
        self._add_sites(batch, ubaths, slists, zetas)
        finalizers = []
        for i, s in enumerate(self.solvers):
            if cfg.ed_mode == "superc":
                finalizers.append(gf_superc_plan(cfg, slists[i], batch,
                                                 site=i, log=s.log))
            elif cfg.ed_mode == "nonsu2":
                finalizers.append(gf_nonsu2_plan(cfg, slists[i], ubaths[i],
                                                 batch, site=i, log=s.log))
            else:
                finalizers.append(gf_normal_plan(cfg, slists[i], ubaths[i],
                                                 batch, site=i, log=s.log))
        per_site = [[] for _ in range(self.nineq)]
        for meta, w, p in batch.run():
            per_site[meta["site"]].append((meta, w, p))
        return [fin(per_site[i]) for i, fin in enumerate(finalizers)]

    def _batched_chi(self, ubaths, slists, zetas):
        """Cross-site batched susceptibility pass: every enabled chi kind's
        probe channels of ALL sites feed one ResolventBatch (site-tagged
        metas route results back) — the chi analogue of _batched_gf.
        Returns one {kind: chi tuple} dict per site (None entries when no
        flags)."""
        cfg = self.cfg
        kinds = []
        if cfg.chispin_flag:
            kinds.append("spin")
        if cfg.chidens_flag:
            kinds.append("dens")
            if cfg.norb > 1:
                kinds.append("dens_mix")
        if cfg.chipair_flag:
            kinds.append("pair")
        if not kinds:
            return [None] * self.nineq
        from .gf_common import ResolventBatch
        from .chi import chi_plan
        batch = ResolventBatch(cfg)
        self._add_sites(batch, ubaths, slists, zetas)
        finalizers = {}
        for i in range(self.nineq):
            for kind in kinds:
                finalizers[(i, kind)] = chi_plan(self.cfgs[i], kind,
                                                 slists[i], batch, site=i)
        per_key = {k: [] for k in finalizers}
        for meta, w, p in batch.run():
            per_key[(meta["site"], meta["chi"])].append((meta, w, p))
        return [{kind: finalizers[(i, kind)](per_key[(i, kind)])
                 for kind in kinds} for i in range(self.nineq)]

    # stacked getters (ed_get_*_lattice, ED_IO)
    def get_sigma_matsubara(self) -> np.ndarray:
        return np.stack([r.smats for r in self.results])

    def get_sigma_realaxis(self) -> np.ndarray:
        return np.stack([r.sreal for r in self.results])

    def get_gimp_matsubara(self) -> np.ndarray:
        return np.stack([r.gmats for r in self.results])

    def get_dens(self) -> np.ndarray:
        return np.stack([r.observables.dens for r in self.results])

    def get_docc(self) -> np.ndarray:
        return np.stack([r.observables.docc for r in self.results])

    def get_mag(self) -> np.ndarray:
        return np.stack([r.observables.magz for r in self.results])

    def get_greal(self) -> np.ndarray:
        return np.stack([r.greal for r in self.results])

    def get_eimp(self) -> np.ndarray:
        return np.stack([s.get_eimp() for s in self.solvers])

    def get_doubles(self) -> np.ndarray:
        return np.stack([s.get_doubles() for s in self.solvers])

    def get_phisc(self) -> np.ndarray:
        return np.stack([r.observables.phisc for r in self.results])

    def get_density_matrix(self) -> np.ndarray:
        """[Nineq, Nso, Nso] (ed_get_density_matrix lattice variant)."""
        return np.stack([r.observables.imp_density_matrix
                         for r in self.results])

    def get_neigen_total(self) -> np.ndarray:
        """Per-site lanc_nstates_total after the finite-T feedback
        (ed_get_neigen_total, ED_IO/get_lanc_info.f90)."""
        return np.array([s.get_neigen_total() for s in self.solvers])

    def get_quantum_soc_operators(self):
        """Per-site <S>,<L>,<J>,<J^2>,<L.S>
        (ed_get_quantum_SOC_operators_lattice, ED_IO/get_imp_SOC_op.f90:115)."""
        return [s.get_quantum_soc_operators() for s in self.solvers]

    def chi2_fitgf(self, weiss_ineq: np.ndarray, baths: np.ndarray,
                   ispin=None, fg_an_ineq=None) -> np.ndarray:
        """Joint block-separable fit over sites (fit.chi2_fitgf_sites):
        one L-BFGS-B whose objective evaluates every site in one pass."""
        from .fit import chi2_fitgf_sites
        first = not getattr(self, "_fit_ran", False)
        self._fit_ran = True
        with self.timers("bath_fit"):
            return chi2_fitgf_sites(
                self.cfg, weiss_ineq, baths, [s.hloc for s in self.solvers],
                ispin=ispin, fgs_an=fg_an_ineq,
                masks=[s.mask for s in self.solvers], cfgs=self.cfgs,
                suffixes=[s.suffix for s in self.solvers],
                log=self.solvers[0].log if self.cfg.ed_verbose > 0 else None,
                precondition=first, device=self.device, mesh=self.mesh)
