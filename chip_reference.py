#!/usr/bin/env python3
"""The JAX package's CPU values that ``chip_smoke.py`` holds phases 6, 8,
9, 10, 11, 12, 13, 14, 15, 16 and 17 to.

* ``--case bethe``: the canonical Hubbard loop of phase 6
  (``dmft_ed_tpu.models.hm_bethe.run`` with the package defaults: Norb=1,
  Nbath=6, U=2, beta=1000, Lmats=Lreal=5000, Le=500, wmixing=0.5) for
  ``--nloop`` iterations: dens and docc of every iteration.
* ``--case ahm``: the canonical attractive-Hubbard loop
  (``dmft_ed_tpu.models.ahm_bethe.run`` with the package defaults: Norb=1,
  Nbath=6, U=-2, beta=1000, Lmats=Lreal=5000, dmft_error=1e-5, nloop=40,
  Le=500, wmixing=0.5), run to convergence: iterations, error, dens, docc,
  phi and the wall time (phase 8).
* ``--case nbath9``: one fixed-bath ``EDSolver.solve`` of the superc
  Nbath=9 config (Norb=1, U=-2, beta=100, Lmats=1024, Lreal=256,
  lanc_niter=256) on its initial bath, with ``native`` products and the
  given ``--method`` (phase 9).
* ``--case soc``: ``dmft_ed_tpu.models.soc.run`` with the driver defaults
  (Norb=3, Nbath=1, nonsu2, replica bath, nk=8, the package defaults)
  for ``--nloop`` iterations: dens per orbital, |Σ_{↑↓}(iω)| (the
  Frobenius norm of smats[0, 1]) and the DMFT error (phase 10; 3
  iterations take about 3 minutes).
* ``--case bhz``: ``dmft_ed_tpu.models.bhz_2d.run`` with the driver
  defaults (Norb=2, Nbath=2, nk=20) in nonsu2 with rh = 0.2, for
  ``--nloop`` iterations, the same values (phase 11; about 3 minutes).
* ``--case jz2``: one fixed-bath ``EDSolver.solve`` of phase 12's
  spin-orbit impurity at Nbath=2 (Norb=3, t2g + atomic SOC in the
  Jz-conserving form, a replica bath, U, U', Jh) in plain N sectors:
  egs, dens, docc, G_{aa}^{ss}(iω_0) and Σ(iω_0) (about 3 minutes). The
  same solve in the Jz basis does not run here: its ~190 sector compiles
  exhaust XLA:CPU's JIT memory (MemoryError); chip_smoke holds the
  port's Jz and plain solves both to these values, as
  tests/test_jz_basis.py holds the Jz basis to plain N.
* ``--case flake``: ``dmft_ed_tpu.models.hm_square_lattice.run`` at the
  driver's default geometry (a 4x4 flake, ts=0.25: 16 sites in 3
  inequivalent classes) with Norb=1, Nbath=6, U=2, beta=100, Lmats=1024,
  Lreal=256 and the package defaults, for ``--nloop`` iterations: dens,
  docc and Σ(iω_0) per class, the DMFT error and ekin (phase 13(a);
  about 5 minutes).
* ``--case soc_ineq``: ``dmft_ed_tpu.models.soc_ineq.run`` with the
  driver's defaults (nlat=2, nk=6; Norb=3, Nbath=1, nonsu2, a replica
  bath, U=1) for ``--nloop`` iterations: dens per site and orbital,
  |Σ_{↑↓}(iω)| per site and the DMFT error (phase 13(d)).
* ``--case drivers``: each of the ten single-site drivers of phase 14(a)
  (the cases of ``chip_smoke.DRIVER_CASES``, run through the JAX
  package's modules), each in a directory of its own: the
  first solve's egs, dens and docc, the last solve's dens and docc, the
  iterations and the seconds (about 5 minutes in all).
* ``--case lattice_drivers``: each of the fifteen lattice-driver cases of
  phase 15(a) (``chip_smoke.LATTICE_CASES`` and the arrays
  ``chip_smoke.lattice_case_args`` builds from its seed, run through the
  JAX package's modules), each in a directory of its own: the values
  ``chip_smoke.lattice_values`` reads (the first solve's egs per site,
  each site's chi^2 after the first fit, the last solve's dens, docc and
  phi; hartree_nano's dens and mag; nano_isoc_sq's chi0(q) and Chern
  marker) and the seconds (about 3 minutes in all).
* ``--case stack``: ``dmft_ed_tpu.models.ahm_stripe.run_stack`` on
  ``chip_smoke.STACK_CFG`` (four superc layers, Nbath=9, one iteration;
  phase 15(b)): the first solve's egs, dens, docc and phi per layer
  (about 13 minutes and 4 GiB).
* ``--case f32``: the thick-restart sweep of phase 16(c)'s config
  (``chip_smoke.ARPACK_CFG``: Norb=1, Nbath=11, arpack) on its initial
  bath, restricted by ``ed_sectors`` to the half-filled (6,6) sector of
  853,776 states, in ``dtype="float32"`` and in float64: the ground-state
  energies and the seconds.
* ``--case bench13``: the root ``bench.py``'s problem at ``--nbath``
  (default 13: the half-filled (7,7) sector of Ns=14, 11,778,624 states
  in one 3432x3432 block; phase 17): the 30 alphas and betas of
  ``bench.lanczos_loop`` from ``bench.run``'s start vector, native
  products; and the sector's ground-state energy by the JAX package's
  thick restart (``lanczos.eigs_lanczos_op``, one eigenpair, the basis,
  step limit and tolerance of ``diag``'s rule for the bench's config) from
  the same start vector, with its matvecs and the seconds (a few minutes
  and a few GiB at Nbath=13).

The JAX package's nonsu2 G holds <<c_{b,s'}; c†_{a,s}>> at [s, s', a, b],
the transpose of G0's convention (ROADMAP.md §3), which the port mends.
The nonsu2 cases here transpose the JAX package's G back before its Dyson
(``_mend_nonsu2_g``), so the JAX loops solve the port's equations; the
package itself is untouched.

Run from the root of a checkout, on the CPU: ``python3 chip_reference.py
--case ahm`` (a few minutes). Each case runs in a temporary directory of
its own (the solver writes ``.ed`` files into the cwd) and prints one JSON
object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
os.environ["JAX_PLATFORMS"] = "cpu"

BETHE_CFG = dict(norb=1, nbath=6, nspin=1, uloc=(2.0,), beta=1000.0,
                 lmats=5000, lreal=5000, dmft_error=1e-12, ed_verbose=0)
BETHE_RUN = dict(le=500, wmixing=0.5)
AHM_CFG = dict(norb=1, nbath=6, nspin=1, ed_mode="superc", uloc=(-2.0,),
               beta=1000.0, lmats=5000, lreal=5000, dmft_error=1e-5,
               nloop=40, ed_verbose=0)
AHM_RUN = dict(le=500, wmixing=0.5)
FLAKE_CFG = dict(norb=1, nbath=6, nspin=1, uloc=(2.0,), beta=100.0,
                 lmats=1024, lreal=256, dmft_error=1e-12, ed_verbose=0)
FLAKE_RUN = dict(lx=4, ly=4, ts=0.25)
FLAKE_NLOOP = 3
SOC_INEQ_CFG = dict(norb=3, nspin=2, nbath=1, uloc=(1.0, 1.0, 1.0),
                    ed_mode="nonsu2", bath_type="replica", dmft_error=1e-12,
                    ed_verbose=0)
SOC_INEQ_NLOOP = 2
NBATH9_CFG = dict(norb=1, nbath=9, nspin=1, ed_mode="superc", uloc=(-2.0,),
                  beta=100.0, lmats=1024, lreal=256, lanc_niter=256,
                  ed_verbose=0)


def run_bethe(nloop: int) -> dict:
    import numpy as np
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.models import hm_bethe
    from dmft_ed_tpu.solver import EDSolver
    cfg = EDConfig(**dict(BETHE_CFG, nloop=nloop)).validate()
    solver = EDSolver(cfg, np.zeros((1, 1, 1, 1)), log=lambda m: None)
    obs = []

    def log(msg, *a, **k):
        if msg.startswith("--- DMFT loop") and solver.result is not None:
            o = solver.result.observables
            obs.append((float(o.dens[0]), float(o.docc[0])))

    t0 = time.time()
    r = hm_bethe.run(cfg, log=log, solver=solver, **BETHE_RUN)
    obs.append((float(r.dens[0]), float(r.docc[0])))
    return dict(case="bethe", iterations=int(r.iterations),
                dens=[d for d, _ in obs], docc=[d for _, d in obs],
                seconds=time.time() - t0)


def run_ahm() -> dict:
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.models import ahm_bethe
    cfg = EDConfig(**AHM_CFG).validate()
    t0 = time.time()
    r = ahm_bethe.run(cfg, log=lambda *a, **k: None, **AHM_RUN)
    return dict(case="ahm", converged=bool(r.converged),
                iterations=int(r.iterations), error=float(r.error),
                dens=float(r.dens[0]), docc=float(r.docc[0]),
                phi=float(r.phisc[0]), egs=float(r.egs), ekin=float(r.ekin),
                seconds=time.time() - t0)


def run_nbath9(method: str) -> dict:
    import numpy as np
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.solver import EDSolver
    cfg = EDConfig(**dict(NBATH9_CFG, lanc_method=method)).validate()
    solver = EDSolver(cfg, np.zeros((1, 1, 1, 1)), log=lambda m: None)
    bath = solver.init_solver()
    t0 = time.time()
    res = solver.solve(bath)
    o = res.observables
    return dict(case="nbath9", method=method, egs=float(res.egs),
                docc=float(o.docc[0]), phi=float(o.phisc[0]),
                dens=float(o.dens[0]), seconds=time.time() - t0)


SOC_NLOOP = 3
BHZ_NLOOP = 3
BHZ_RUN = dict(rh=0.2)
# phase 12's spin-orbit impurity: t2g + atomic SOC in the Jz-conserving
# form (tests/test_jz_basis.py), a replica bath of Nbath copies
JZ_CFG = dict(norb=3, nspin=2, uloc=(2.0, 2.0, 2.0), ust=1.2, jh=0.4,
              ed_mode="nonsu2", bath_type="replica", beta=100.0, lmats=1024,
              lreal=256, lanc_nstates_sector=2, ed_verbose=0)
JZ_LAMBDA = 0.3


def jz_problem(bath_mod, cfg):
    """(hloc, bath) of phase 12 for a config of either package: hloc =
    λ·atomic_soc_jz(), bath copy k = 0.7λ·atomic_soc_jz() + eps_k with
    eps_k evenly on [-1, 1], vr = 0.6; the mask of Hloc plus the
    diagonal."""
    import numpy as np
    from dmft_ed_tpu_torch.aux import atomic_soc_jz
    ls = atomic_soc_jz()
    hloc = JZ_LAMBDA * ls
    b = bath_mod.Bath(cfg)
    b.mask = bath_mod.replica_mask(cfg, hloc + 1e-3 * np.einsum(
        "st,ab->stab", np.eye(2), np.eye(3)))
    for k, eps in enumerate(np.linspace(-1.0, 1.0, cfg.nbath)):
        b.h[..., k] = 0.7 * JZ_LAMBDA * ls + eps * np.einsum(
            "st,ab->stab", np.eye(2), np.eye(3))
    b.vr[:] = 0.6
    return hloc, b


def _mend_nonsu2_g():
    """Transpose the JAX package's nonsu2 G back to G0's convention, on
    the single-site path (build_gf_nonsu2) and on the lattice solver's
    cross-site path (gf_nonsu2_plan's finalizer)."""
    import numpy as np
    from dmft_ed_tpu import gf_nonsu2
    orig = gf_nonsu2.build_gf_nonsu2
    orig_plan = gf_nonsu2.gf_nonsu2_plan

    def mended(*a, **k):
        return tuple(np.ascontiguousarray(G.transpose(1, 0, 3, 2, 4))
                     for G in orig(*a, **k))

    def mended_plan(*a, **k):
        fin = orig_plan(*a, **k)
        return lambda results: tuple(
            np.ascontiguousarray(G.transpose(1, 0, 3, 2, 4))
            for G in fin(results))
    gf_nonsu2.build_gf_nonsu2 = mended
    gf_nonsu2.gf_nonsu2_plan = mended_plan


def _loop_values(r) -> dict:
    import numpy as np
    return dict(iterations=int(r.iterations), dens=r.dens.tolist(),
                smats_ud=float(np.linalg.norm(r.smats[0, 1])),
                error=float(r.error))


def run_soc(nloop: int) -> dict:
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.models import soc
    _mend_nonsu2_g()
    cfg = EDConfig(norb=3, nspin=2, nbath=1, uloc=(1.0, 1.0, 1.0),
                   ed_mode="nonsu2", bath_type="replica", nloop=nloop,
                   dmft_error=1e-12, ed_verbose=0).validate()
    t0 = time.time()
    r = soc.run(cfg, log=lambda *a, **k: None)
    return dict(case="soc", seconds=time.time() - t0, **_loop_values(r))


def run_bhz(nloop: int) -> dict:
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.models import bhz_2d
    _mend_nonsu2_g()
    cfg = EDConfig(norb=2, nspin=2, nbath=2, uloc=(1.0, 1.0),
                   ed_mode="nonsu2", nloop=nloop, dmft_error=1e-12,
                   ed_verbose=0).validate()
    t0 = time.time()
    r = bhz_2d.run(cfg, log=lambda *a, **k: None, **BHZ_RUN)
    return dict(case="bhz", seconds=time.time() - t0, **_loop_values(r))


def flake_values(r, lat2ineq) -> dict:
    """Per-class values of a nano.run result (either package): dens and
    docc of each class's first site, Σ(iω_0) of each class."""
    import numpy as np
    first = [int(np.nonzero(np.asarray(lat2ineq) == i)[0][0])
             for i in range(len(r.smats_ineq))]
    s0 = r.smats_ineq[:, 0, 0, 0, 0, 0]
    return dict(iterations=int(r.iterations), error=float(r.error),
                ekin=float(r.ekin), dens_lat=r.dens.tolist(),
                dens=[float(r.dens[i]) for i in first],
                docc=[float(r.docc[i]) for i in first],
                sigma0_re=s0.real.tolist(), sigma0_im=s0.imag.tolist())


def run_flake(nloop: int) -> dict:
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.models import hm_square_lattice
    from dmft_ed_tpu.models.nano import square_flake_hij
    lat2ineq = square_flake_hij(FLAKE_RUN["lx"], FLAKE_RUN["ly"])[1]
    cfg = EDConfig(**dict(FLAKE_CFG, nloop=nloop)).validate()
    t0 = time.time()
    r = hm_square_lattice.run(cfg, log=lambda *a, **k: None, **FLAKE_RUN)
    return dict(case="flake", seconds=time.time() - t0,
                **flake_values(r, lat2ineq))


def run_soc_ineq(nloop: int) -> dict:
    import numpy as np
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.models import soc_ineq
    _mend_nonsu2_g()
    cfg = EDConfig(**dict(SOC_INEQ_CFG, nloop=nloop)).validate()
    t0 = time.time()
    r = soc_ineq.run(cfg, log=lambda *a, **k: None)
    return dict(case="soc_ineq", seconds=time.time() - t0,
                iterations=int(r.iterations), error=float(r.error),
                dens=r.dens.tolist(),
                smats_ud=[float(np.linalg.norm(r.smats_ineq[i, 0, 1]))
                          for i in range(len(r.smats_ineq))])


def run_drivers() -> dict:
    import importlib
    import numpy as np
    from chip_smoke import DRIVER_CASES
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.models import kspace
    from dmft_ed_tpu.solver import EDSolver
    seen, solve = [], EDSolver.solve

    def recorded(self, bath):
        r = solve(self, bath)
        o = r.observables
        seen.append((float(r.egs), o.dens.tolist(), o.docc.tolist()))
        return r
    EDSolver.solve = recorded
    out = {}
    for name, (entry, cfg_kw, run_kw, hk) in DRIVER_CASES.items():
        os.mkdir(name)
        os.chdir(name)
        t0 = time.time()
        seen.clear()
        mod = importlib.import_module(f"dmft_ed_tpu.models.{name}")
        args = ()
        if hk is not None:
            H = getattr(kspace, hk[0])(**hk[1])
            args = (H,)
            if name == "material":
                mod.write_hk_w90("hk.in", H, np.zeros((H.shape[-1], 3)))
                args = ("hk.in",)
        r = getattr(mod, entry)(EDConfig(**cfg_kw).validate(), *args,
                                log=lambda *a, **k: None, **run_kw)
        os.chdir("..")
        out[name] = dict(iterations=int(r.iterations), first_egs=seen[0][0],
                         first_dens=seen[0][1], first_docc=seen[0][2],
                         dens=seen[-1][1], docc=seen[-1][2],
                         seconds=time.time() - t0)
    return dict(case="drivers", drivers=out)


def run_f32() -> dict:
    import numpy as np
    from chip_smoke import ARPACK_CFG
    from dmft_ed_tpu.bath import init_bath
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.diag import diagonalize
    out = dict(case="f32")
    for dt in ("float32", "float64"):
        cfg = EDConfig(**dict(ARPACK_CFG, dtype=dt, ed_sectors=True,
                              ed_sectors_shift=0, ed_verbose=0)).validate()
        with open("sectors_list.restart", "w") as fh:
            fh.write(f"{cfg.ns // 2} {cfg.ns // 2}\n")
        hloc = np.zeros((1, 1, 1, 1))
        t0 = time.time()
        slist, _, _ = diagonalize(cfg, init_bath(cfg, hloc), hloc)
        out[dt] = dict(egs=float(slist.emin), seconds=time.time() - t0)
    return out


def run_bench13(nbath: int) -> dict:
    import numpy as np
    import jax
    import jax.numpy as jnp
    import bench
    from dmft_ed_tpu.hamiltonian import make_matvec_op
    from dmft_ed_tpu.lanczos import eigs_lanczos_op
    cfg, sec, ham, matvec, template = bench.build_problem(nbath, "float64")
    blk = sec.blocks[0]
    v0 = np.random.default_rng(1).normal(size=(blk.ddw, blk.dup))
    v0 = jnp.asarray(v0 / np.linalg.norm(v0))
    t0 = time.time()
    loop = jax.jit(bench.lanczos_loop, static_argnums=(0, 2))
    _, al, be = loop(matvec, v0, 30)
    out = dict(case="bench13", nbath=nbath, dim=int(sec.dim),
               nnz=int(ham.nnz_estimate()), alphas=np.asarray(al).tolist(),
               betas=np.asarray(be).tolist(), loop_seconds=time.time() - t0)
    spec, arrays, blocks = make_matvec_op(ham, cfg)
    ncv = min(sec.dim, cfg.lanc_ncv_factor * cfg.lanc_nstates_sector
              + cfg.lanc_ncv_add)
    t0 = time.time()
    evals, _, niter = eigs_lanczos_op(
        spec, blocks, arrays, v0.reshape(-1), 1, ncv,
        maxiter=min(sec.dim, cfg.lanc_niter), tol=cfg.lanc_tolerance)
    out.update(egs=float(evals[0]), ncv=int(ncv), matvecs=int(niter),
               gs_seconds=time.time() - t0)
    return out


def run_lattice_drivers() -> dict:
    import importlib
    import dmft_ed_tpu.models as models
    from chip_smoke import (LATTICE_CASES, lattice_case_args, lattice_values,
                            record_site_solves)
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.lattice_solver import LatticeEDSolver
    out = {}
    for name, (modname, entry, cfg_kw, run_kw, _) in LATTICE_CASES.items():
        os.mkdir(name)
        os.chdir(name)
        mod = importlib.import_module(f"dmft_ed_tpu.models.{modname}")
        args, extra = lattice_case_args(name, models)
        t0 = time.time()
        with record_site_solves(LatticeEDSolver) as seen:
            r = getattr(mod, entry)(EDConfig(**cfg_kw).validate(), *args,
                                    log=lambda *a, **k: None, **run_kw,
                                    **extra)
        out[name] = dict(lattice_values(name, r, seen),
                         seconds=time.time() - t0)
        os.chdir("..")
        print(name, json.dumps(out[name]), file=sys.stderr, flush=True)
    return dict(case="lattice_drivers", drivers=out)


def run_stack() -> dict:
    from chip_smoke import STACK_CFG, record_site_solves
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.lattice_solver import LatticeEDSolver
    from dmft_ed_tpu.models import ahm_stripe
    cfg = EDConfig(**STACK_CFG).validate()
    t0 = time.time()
    with record_site_solves(LatticeEDSolver) as seen:
        r = ahm_stripe.run_stack(cfg, log=lambda *a, **k: None)
    return dict(case="stack", iterations=int(r.iterations),
                uloc_sites=r.uloc_sites.tolist(), seconds=time.time() - t0,
                **seen[0][1])


def run_jz2() -> dict:
    import numpy as np
    from dmft_ed_tpu import bath
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.solver import EDSolver
    _mend_nonsu2_g()
    cfg = EDConfig(**dict(JZ_CFG, nbath=2)).validate()
    hloc, b = jz_problem(bath, cfg)
    t0 = time.time()
    r = EDSolver(cfg, hloc, log=lambda m: None).solve(bath.pack_bath(b))
    o = r.observables
    return dict(case="jz2", egs=float(r.egs), dens=o.dens.tolist(),
                docc=o.docc.tolist(),
                g0=[[float(r.gmats[s, s, a, a, 0].real),
                     float(r.gmats[s, s, a, a, 0].imag)]
                    for s in range(2) for a in range(3)],
                sigma0_re=r.smats[..., 0].real.ravel().tolist(),
                sigma0_im=r.smats[..., 0].imag.ravel().tolist(),
                seconds=time.time() - t0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=("bethe", "ahm", "nbath9", "soc", "bhz",
                                       "jz2", "flake", "soc_ineq",
                                       "drivers", "lattice_drivers",
                                       "stack", "f32", "bench13"),
                    required=True)
    ap.add_argument("--method", default="arpack")
    ap.add_argument("--nbath", type=int, default=13,
                    help="bench13's Nbath (13: the (7,7) sector of Ns=14)")
    ap.add_argument("--nloop", type=int, default=None,
                    help="iterations (bethe 5, soc 3, bhz 3, flake 3, "
                    "soc_ineq 2)")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        out = {"bethe": lambda: run_bethe(args.nloop or 5),
               "ahm": run_ahm,
               "nbath9": lambda: run_nbath9(args.method),
               "soc": lambda: run_soc(args.nloop or SOC_NLOOP),
               "bhz": lambda: run_bhz(args.nloop or BHZ_NLOOP),
               "jz2": run_jz2,
               "flake": lambda: run_flake(args.nloop or FLAKE_NLOOP),
               "soc_ineq": lambda: run_soc_ineq(
                   args.nloop or SOC_INEQ_NLOOP),
               "drivers": run_drivers,
               "lattice_drivers": run_lattice_drivers,
               "stack": run_stack, "f32": run_f32,
               "bench13": lambda: run_bench13(args.nbath)}[args.case]()
        os.chdir(REPO)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
