"""Solver orchestration: init + the fixed solve pipeline — PyTorch port of
dmft_ed_tpu/solver.py (ed_mode "normal", "superc" and "nonsu2"; with a
``mesh``, the row-sharded solve of large sectors on every rank).

Replaces ED_MAIN.f90: ``ed_init_solver`` (bath allocation/init/pack,
:61-152) and ``ed_solve`` (set bath -> diagonalize -> Green's functions ->
observables -> local energy, :253-327). Every tensor lives on the solver's
``device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .config import EDConfig
from .bath import (init_bath, pack_bath, unpack_bath, replica_mask,
                   get_bath_dimension)
from .device import resolve
from .diag import DiagState, diagonalize, write_state_list
from .parallel.mesh import from_rank0, writes_files
from .observables import (compute_observables, local_energy,
                          quasiparticle_weight, Observables, EnergyObs)
from . import io as edio


@dataclass
class SolveResult:
    smats: np.ndarray = None
    sreal: np.ndarray = None
    gmats: np.ndarray = None
    greal: np.ndarray = None
    g0mats: np.ndarray = None
    g0real: np.ndarray = None
    # superc anomalous components
    fmats: np.ndarray = None
    freal: np.ndarray = None
    f0mats: np.ndarray = None
    f0real: np.ndarray = None
    smats_an: np.ndarray = None
    sreal_an: np.ndarray = None
    observables: Observables = None
    energy: EnergyObs = None
    egs: float = 0.0
    zeta: float = 1.0
    nstates: int = 0
    chi_spin: tuple = None
    chi_dens: tuple = None
    chi_dens_mix: tuple = None
    chi_pair: tuple = None
    bath_dm: np.ndarray = None    # replica-bath density matrix


def _default_log(msg):
    print(msg, flush=True)


class EDSolver:
    """One impurity problem. Usage mirrors the reference driver flow:

        cfg = read_input("inputED.in")
        solver = EDSolver(cfg, hloc, device="cuda")
        bath = solver.init_solver()          # flat user bath vector
        ...
        res = solver.solve(bath)             # -> SolveResult
        bath = solver.chi2_fitgf(weiss, bath)
    """

    def __init__(self, cfg: EDConfig, hloc: Optional[np.ndarray] = None,
                 suffix: str = "", log=None, device="cuda", mesh=None):
        """mesh: optional parallel.Mesh (parallel.make_mesh) with a 'rows'
        axis — sectors of dim >= cfg.shard_dim_threshold then diagonalize
        and build their GF and chi chains row-sharded over its ranks (the
        reference's MPI solver, ED_MAIN.f90:103-152, 284-327). Every rank
        runs this solver on the same inputs and gets the whole result; the
        mesh's device replaces `device`. On a mesh only global rank 0
        writes the output files (parallel.mesh.writes_files) and every rank
        reads them back through it (parallel.mesh.from_rank0), so the
        ranks may share one working directory, as under ``torchrun``."""
        cfg.validate()
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve(device)
        self.suffix = suffix
        self.log = log if log is not None else (
            _default_log if cfg.ed_verbose > 0 else lambda m: None)
        if hloc is None:
            hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
        self.hloc = np.asarray(hloc)
        self.mask = replica_mask(cfg, self.hloc) \
            if cfg.bath_type == "replica" else None
        self.diag_state = DiagState(
            lanc_nstates_total=cfg.lanc_nstates_total)
        self.result: Optional[SolveResult] = None
        self._fit_ran = False
        from .timer import Timers
        self.timers = Timers(self.log if cfg.ed_verbose >= 4 else None)

    # ------------------------------------------------------------------
    @property
    def bath_dimension(self) -> int:
        return get_bath_dimension(self.cfg, self.hloc)

    def init_solver(self) -> np.ndarray:
        """ed_init_solver: build + pack the initial bath (on a mesh, rank
        0 reads the bath restart file it wrote and sends every rank the
        bath)."""
        b = from_rank0(self.mesh,
                       lambda: init_bath(self.cfg, self.hloc, self.suffix))
        if self.mask is not None:
            b.mask = self.mask
        return pack_bath(b)

    # ------------------------------------------------------------------
    def solve(self, bath_flat: np.ndarray) -> SolveResult:
        cfg = self.cfg
        bath = unpack_bath(cfg, bath_flat, self.mask)
        with self.timers("diagonalize"):
            slist, zeta, self.diag_state = diagonalize(
                cfg, bath, self.hloc, self.diag_state, self.suffix, self.log,
                timers=self.timers, device=self.device, mesh=self.mesh)
        return self.solve_from_spectrum(bath, slist, zeta)

    def solve_from_spectrum(self, bath, slist, zeta, gf=None,
                            chi=None) -> SolveResult:
        """GF/observables/files pipeline given a computed spectrum (the
        site-batched lattice path hands its spectra here). `gf`: optional
        precomputed (Gmats, Greal) — (Gmats, Greal, Fmats, Freal) in
        superc — from a cross-site batched GF pass (LatticeEDSolver),
        skipping the per-site Krylov build. `chi`: optional dict {kind: chi
        tuple} from the cross-site batched chi pass (kinds 'spin', 'dens',
        'dens_mix', 'pair'), skipping the per-site chi builds."""
        cfg = self.cfg
        res = SolveResult()
        finite_t = cfg.finite_t or self.diag_state.lanc_nstates_total > 1
        finite_t = finite_t and len(slist) > 1
        res.egs, res.zeta, res.nstates = slist.emin, zeta, len(slist)
        write_state_list(cfg, slist, zeta, self.suffix, self.mesh)
        timers = self.timers
        if cfg.ed_mode == "superc":
            from .gf_superc import build_gf_superc, build_sigma_superc
            with timers("gf_resolvents"):
                res.gmats, res.greal, res.fmats, res.freal = \
                    gf if gf is not None else build_gf_superc(
                        cfg, slist, zeta, bath, self.hloc, finite_t,
                        self.log, device=self.device, mesh=self.mesh)
            with timers("sigma_dyson"):
                (res.smats, res.sreal, res.smats_an, res.sreal_an,
                 res.g0mats, res.g0real, res.f0mats, res.f0real) = \
                    build_sigma_superc(cfg, bath, self.hloc, res.gmats,
                                       res.greal, res.fmats, res.freal,
                                       device=self.device)
        else:
            if cfg.ed_mode == "nonsu2":
                from .gf_nonsu2 import (build_gf_nonsu2 as build_gf,
                                        build_sigma_nonsu2 as build_sigma)
            else:
                from .gf_normal import (build_gf_normal as build_gf,
                                        build_sigma_normal as build_sigma)
            with timers("gf_resolvents"):
                res.gmats, res.greal = gf if gf is not None else build_gf(
                    cfg, slist, zeta, bath, self.hloc, finite_t, self.log,
                    device=self.device, mesh=self.mesh)
            with timers("sigma_dyson"):
                res.smats, res.sreal, res.g0mats, res.g0real = build_sigma(
                    cfg, bath, self.hloc, res.gmats, res.greal,
                    device=self.device)
        if cfg.chispin_flag or cfg.chidens_flag or cfg.chipair_flag:
            self._solve_chi(res, bath, slist, zeta, finite_t, chi or {})
        with self.timers("observables"):
            res.observables = compute_observables(cfg, slist, zeta, bath,
                                                  self.hloc, finite_t)
            res.energy = local_energy(cfg, slist, zeta, bath, self.hloc,
                                      finite_t)
        simp, zimp = quasiparticle_weight(cfg, res.smats)
        so = cfg.ed_mode == "nonsu2"    # spin-offdiag components in files
        writes = writes_files(self.mesh)
        if writes:
            self._write_files(res, simp, zimp, so)
        if cfg.bath_type == "replica":
            # bath density matrix, replica baths only
            # (ED_OBSERVABLES.f90:591-658 computes bth_density_matrix under
            # the same gate); one (s,s',a,b) row per bath copy
            from .observables import bath_density_matrix
            with self.timers("bath_dm"):
                res.bath_dm = bath_density_matrix(cfg, slist, zeta, finite_t)
            if writes:
                _write_bath_dm(cfg, res.bath_dm, self.suffix)
        if cfg.ed_verbose >= 2 and self.log:
            self.log(self.timers.report())
        if self.log:
            o = res.observables
            self.log("dens=" + " ".join(f"{x:.9f}" for x in o.dens)
                     + "  docc=" + " ".join(f"{x:.9f}" for x in o.docc)
                     + f"  egs={res.egs:.9f}")
        self.result = res
        return res

    def _write_files(self, res, simp, zimp, so) -> None:
        """The solve's Sigma/G/G0 (as the print flags ask), observables,
        energy and impurity density matrix files."""
        cfg = self.cfg
        if cfg.ed_print_sigma:
            edio.print_function(cfg, "Sigma", res.smats, res.sreal,
                                self.suffix, spin_offdiag=so)
            if res.smats_an is not None:
                edio.print_function(cfg, "Self", res.smats_an, res.sreal_an,
                                    self.suffix)
        if cfg.ed_print_g:
            edio.print_function(cfg, "G", res.gmats, res.greal, self.suffix,
                                spin_offdiag=so)
            if res.fmats is not None:
                edio.print_function(cfg, "F", res.fmats, res.freal,
                                    self.suffix)
        if cfg.ed_print_g0:
            edio.print_function(cfg, "G0", res.g0mats, res.g0real,
                                self.suffix, spin_offdiag=so)
            if res.f0mats is not None:
                edio.print_function(cfg, "F0", res.f0mats, res.f0real,
                                    self.suffix)
        edio.write_observables(cfg, res.observables, res.egs, simp, zimp,
                               self.suffix)
        edio.write_energy(cfg, res.energy, self.suffix)
        rho = res.observables.imp_density_matrix
        if rho is not None:
            np.savetxt(f"imp_density_matrix{self.suffix}.ed",
                       np.column_stack([rho.real, rho.imag]), fmt="%18.12f")

    def _solve_chi(self, res, bath, slist, zeta, finite_t, pre) -> None:
        """The susceptibilities the flags ask for, each written with
        io.write_chi (ED_MAIN.f90's buildchi calls); a kind found in `pre`
        (the cross-site pass's results) is taken from there."""
        from . import chi as chi_mod
        cfg = self.cfg
        args = (cfg, slist, zeta, bath, self.hloc, finite_t, self.log)
        kinds = []
        if cfg.chispin_flag:
            kinds.append(("spin", "spinChi", chi_mod.build_chi_spin))
        if cfg.chidens_flag:
            kinds.append(("dens", "densChi", chi_mod.build_chi_dens))
            if cfg.norb > 1:
                kinds.append(("dens_mix", "densChi_mix",
                              chi_mod.build_chi_dens_mix))
        if cfg.chipair_flag:
            kinds.append(("pair", "pairChi", chi_mod.build_chi_pair))
        for kind, name, build in kinds:
            field_ = "chi_" + kind
            out = pre.get(kind)
            if out is None:
                with self.timers("chi_resolvents"):
                    out = build(*args, device=self.device, mesh=self.mesh)
            setattr(res, field_, out)
            if writes_files(self.mesh):
                edio.write_chi(cfg, name, *out, self.suffix)

    # ------------------------------------------------------------------
    def chi2_fitgf(self, fg, bath_flat: np.ndarray, ispin=None,
                   iorb=None, fg_an=None) -> np.ndarray:
        from .fit import chi2_fitgf
        # Δ-target pre-conditioning on the COLD start only, and never in
        # superc (see fit.chi2_fitgf)
        first = not self._fit_ran
        self._fit_ran = True
        with self.timers("bath_fit"):
            return chi2_fitgf(self.cfg, fg, bath_flat, self.hloc, ispin=ispin,
                              iorb=iorb, fg_an=fg_an, mask=self.mask,
                              suffix=self.suffix,
                              log=self.log, precondition=first,
                              device=self.device, mesh=self.mesh)

    # ------------------------------------------------------------------
    def read_sigma(self):
        """Re-ingest printed impSigma files (ed_read_impSigma restart path,
        ED_IO/read_impSigma.f90). Returns (Smats, Sreal); nonsu2 restores
        the spin-offdiagonal components too (:117-216). On a mesh, rank 0
        reads the files it wrote and sends every rank their contents."""
        return from_rank0(self.mesh, lambda: edio.read_function(
            self.cfg, "Sigma", self.suffix,
            spin_offdiag=self.cfg.ed_mode == "nonsu2"))

    # ------------------------------------------------------------------
    # ed_get_* accessors (ED_IO.f90:274-327)
    def get_sigma_matsubara(self):
        return self.result.smats

    def get_sigma_realaxis(self):
        return self.result.sreal

    def get_self_matsubara(self):
        return self.result.smats_an

    def get_gimp_matsubara(self):
        return self.result.gmats

    def get_gimp_realaxis(self):
        return self.result.greal

    def get_dens(self):
        return self.result.observables.dens

    def get_docc(self):
        return self.result.observables.docc

    def get_mag(self):
        return self.result.observables.magz

    def get_phisc(self):
        return self.result.observables.phisc

    def get_eimp(self):
        E = self.result.energy
        return np.array([E.epot, E.eknot, E.ehartree, E.epot - E.ehartree])

    def get_doubles(self):
        E = self.result.energy
        return np.array([E.dust, E.dund, E.dse, E.dph])

    def get_density_matrix(self):
        """[Nso, Nso] impurity single-particle density matrix
        (ed_get_density_matrix, ED_IO)."""
        return self.result.observables.imp_density_matrix

    def get_neigen_total(self) -> int:
        """Current lanc_nstates_total after the finite-T auto-tuning
        feedback (ed_get_neigen_total, ED_IO/get_lanc_info.f90)."""
        return int(self.diag_state.lanc_nstates_total)

    def get_bath_density_matrix(self):
        """[Nspin, Nspin, Norb, Norb, Nbath] replica-bath density matrix
        (bth_density_matrix, ED_OBSERVABLES.f90:591-658); None unless
        bath_type='replica'."""
        return self.result.bath_dm

    def get_quantum_soc_operators(self):
        """<S>, <L>, <J>, <J^2>, <L.S> of the t2g impurity shell from the
        density matrix, rotated to the {t2g, Sz} frame
        (ed_get_quantum_SOC_operators, ED_IO/get_imp_SOC_op.f90); written to
        J_imp<suffix>.ed."""
        from .aux import quantum_soc_operators
        ops = quantum_soc_operators(self.cfg,
                                    self.result.observables.imp_density_matrix)
        if not writes_files(self.mesh):
            return ops
        with open(f"J_imp{self.suffix}.ed", "w") as fh:
            fh.write("# Jx Jy Jz Jx^2 Jy^2 Jz^2 L.S\n")
            fh.write(" ".join(f"{v.real:18.12f}" for v in ops["J"])
                     + " " + " ".join(f"{v.real:18.12f}" for v in ops["Jsq"])
                     + f" {ops['LS'].real:18.12f}\n")
        return ops


def _write_bath_dm(cfg: EDConfig, bdm: np.ndarray, suffix: str) -> None:
    """bath_density_matrix<suffix>.ed: one (ibath, s, s', a, b) row per
    element, Re and Im."""
    with open(f"bath_density_matrix{suffix}.ed", "w") as fh:
        fh.write("# ibath ispin jspin iorb jorb Re Im\n")
        for k in range(cfg.nbath):
            for s in range(cfg.nspin):
                for s2 in range(cfg.nspin):
                    for a in range(cfg.norb):
                        for b2 in range(cfg.norb):
                            v = bdm[s, s2, a, b2, k]
                            fh.write(f"{k + 1:4d} {s + 1:2d} {s2 + 1:2d} "
                                     f"{a + 1:2d} {b2 + 1:2d} "
                                     f"{v.real:18.12f} {v.imag:18.12f}\n")
