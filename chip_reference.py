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
* ``--case backend_parity``: tests/test_torch_backend_parity.py's loop
  (``hm_bethe.run``, Nbath=6, beta=100, plain Lanczos, to
  dmft_error=1e-7 in at most 80 iterations, ``native``) on the JAX
  package's default CPU route: the fixed point's docc, dens, egs, Z and
  error, which tests/test_torch_slow_bethe.py holds the card's native
  loop to (a few minutes).

The cases below tell a fault of the port from a property that the JAX
package shares, for the slow physics tests (ROADMAP.md §3). They run
either package (``--package jax|torch``, on the CPU with one torch and one
BLAS thread; ``--device cuda`` runs the port on a card, where the JAX
package is not needed):

* ``--case loop --package P --seed S``: the backend-parity loop
  (PARITY_CFG, native) on the batched route (``DMFT_ED_RAGGED=1``) with
  ``cfg.seed = S``: the error of every iteration (the loop's
  ``error.err``), the fixed point, the seconds (~2.5 min). ``--out DIR``
  also writes ``DIR/<package>_s<S>.json``.
* ``--case pool --out DIR``: pools the ``loop`` files of DIR per package
  over iterations 40-80: the median error, the share above 5e-6, the
  finals above 5e-6 and a Mann-Whitney test of the per-run medians.
* ``--case split --seed S``: along the port's batched-route trajectory,
  both packages solve the same bath and fit the same Weiss field from the
  same bath every iteration: the largest differences of G, Σ, egs and
  docc and of the fitted baths, and the chi^2 of both fits (~5 min).
* ``--case nudge_multiband --package P --n N --step X [--route 0|1]
  [--device cpu|cuda]``: tests/test_multiband_dos.py:102's loop with its
  initial bath scaled by (1 + k X), k = 0..N-1 (k = 0 is the test's own
  input): |dens0 - dens1| per run against the test's 1e-6. ``--route``
  sets ``DMFT_ED_RAGGED``; ``--device cuda`` (port only) runs it on the
  card's route.
* ``--case nudge_blg ...``: tests/test_new_drivers.py:185's AB loop the
  same way: max |dens - 1| against the test's 3e-4.
* ``--case soc_mended [--raw]``: tests/test_soc.py:23's loop in the JAX
  package with its nonsu2 G mended (``_mend_nonsu2_g``; ``--raw``:
  unmended): the orbital densities and their spread against the test's
  0.05.
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
import contextlib
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
# tests/test_torch_backend_parity.py's CFG and RUN
PARITY_CFG = dict(norb=1, nbath=6, nspin=1, uloc=(2.0,), beta=100.0,
                  lmats=512, lreal=64, lfit=512, nloop=80, dmft_error=1e-7,
                  ed_verbose=0, lanc_method="lanczos", lanc_niter=256,
                  lanc_ngfiter=200, lanc_dim_threshold=32)
PARITY_RUN = dict(le=300, wmixing=0.5)
# tests/test_multiband_dos.py:102, tests/test_new_drivers.py:185 and
# tests/test_soc.py:23's configs
MULTIBAND_CFG = dict(norb=2, nbath=2, nspin=1, uloc=(1.5, 1.5),
                     bath_type="hybrid", beta=50.0, lmats=120, lreal=30,
                     lfit=120, nloop=15, dmft_error=1e-3, ed_verbose=0,
                     lanc_dim_threshold=2048)
BLG_CFG = dict(norb=1, nbath=3, nspin=1, uloc=(2.0,), beta=20.0, lmats=96,
               lreal=32, nloop=4, dmft_error=1e-15, ed_verbose=0)
SOC_PROBE_CFG = dict(norb=3, nspin=2, nbath=1, uloc=(1.0, 1.0, 1.0),
                     ust=0.5, ed_mode="nonsu2", bath_type="replica",
                     beta=50.0, lmats=100, lreal=30, lfit=100, nloop=5,
                     dmft_error=1e-3, ed_verbose=0, lanc_dim_threshold=400,
                     lanc_nstates_sector=2, cg_niter=200)
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


def run_backend_parity() -> dict:
    import numpy as np
    from dmft_ed_tpu.config import EDConfig
    from dmft_ed_tpu.models import hm_bethe
    cfg = EDConfig(**PARITY_CFG, matmul_precision="native").validate()
    t0 = time.time()
    r = hm_bethe.run(cfg, log=lambda *a, **k: None, **PARITY_RUN)
    z = 1.0 / (1.0 - r.smats[0, 0, 0, 0, 0].imag / (np.pi / cfg.beta))
    return dict(case="backend_parity", iterations=int(r.iterations),
                docc=float(r.docc[0]), dens=float(r.dens[0]),
                egs=float(r.egs), z=float(z), error=float(r.error),
                seconds=time.time() - t0)


def _pkg(name):
    """(config, models, solver, lattice_solver, kwargs) of a package."""
    if name == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import dmft_ed_tpu.config as config
        import dmft_ed_tpu.models as models
        import dmft_ed_tpu.solver as solver
        import dmft_ed_tpu.lattice_solver as lattice_solver
        return config, models, solver, lattice_solver, {}
    import torch
    torch.set_num_threads(1)
    import dmft_ed_tpu_torch.config as config
    import dmft_ed_tpu_torch.models as models
    import dmft_ed_tpu_torch.solver as solver
    import dmft_ed_tpu_torch.lattice_solver as lattice_solver
    return config, models, solver, lattice_solver, {"device": "cpu"}


def threadpool_limits(limits=1):
    """threadpoolctl's BLAS limit where the package is installed."""
    try:
        from threadpoolctl import threadpool_limits as limit
    except ImportError:
        return contextlib.nullcontext()
    return limit(limits=limits)


def _fresh_dir():
    os.chdir(tempfile.mkdtemp())


def run_loop(package: str, seed: int, out: str | None) -> dict:
    import numpy as np
    os.environ["DMFT_ED_RAGGED"] = "1"
    config, _, _, _, kw = _pkg(package)
    from importlib import import_module
    hm_bethe = import_module(("dmft_ed_tpu" if package == "jax"
                              else "dmft_ed_tpu_torch") + ".models.hm_bethe")
    cfg = config.EDConfig(**PARITY_CFG, matmul_precision="native",
                            seed=seed).validate()
    _fresh_dir()
    t0 = time.time()
    r = hm_bethe.run(cfg, log=lambda *a, **k: None, **PARITY_RUN, **kw)
    errors = [float(ln.split()[1]) for ln in open("error.err")]
    z = 1.0 / (1.0 - r.smats[0, 0, 0, 0, 0].imag / (np.pi / cfg.beta))
    res = dict(case="loop", package=package, seed=seed, errors=errors,
               final=float(r.error), docc=float(r.docc[0]),
               dens=float(r.dens[0]), egs=float(r.egs), z=float(z),
               seconds=time.time() - t0)
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"{package}_s{seed}.json"), "w") as fh:
            json.dump(res, fh)
    return res


def run_pool(out: str) -> dict:
    import glob
    import numpy as np
    from scipy.stats import mannwhitneyu
    res = {}
    medians = {}
    for package in ("jax", "torch"):
        runs = [json.load(open(f)) for f in sorted(
            glob.glob(os.path.join(out, f"{package}_s*.json")))]
        # error.err starts at iteration 2 (the first check has no error)
        tails = [np.array(r["errors"][38:79]) for r in runs]
        pooled = np.concatenate(tails)
        medians[package] = [float(np.median(t)) for t in tails]
        res[package] = dict(
            runs=len(runs), median=float(np.median(pooled)),
            share_above_5e6=float(np.mean(pooled > 5e-6)),
            finals_above_5e6=sum(r["final"] > 5e-6 for r in runs),
            finals=[r["final"] for r in runs], run_medians=medians[package])
    res["mannwhitney_p"] = float(mannwhitneyu(medians["jax"],
                                              medians["torch"]).pvalue)
    return dict(case="pool", **res)


def run_split(seed: int) -> dict:
    import numpy as np
    os.environ["DMFT_ED_RAGGED"] = "1"
    jconfig, _, jsolver, _, _ = _pkg("jax")
    tconfig, _, tsolver, _, _ = _pkg("torch")
    from dmft_ed_tpu_torch.lattice import (bethe_bands, gloc_dos,
                                           self_consistency)
    jc = jconfig.EDConfig(**PARITY_CFG, matmul_precision="native",
                            seed=seed).validate()
    tc = tconfig.EDConfig(**PARITY_CFG, matmul_precision="native",
                            seed=seed).validate()
    hloc = np.zeros((1, 1, 1, 1))
    base = tempfile.mkdtemp()
    dirs = {k: os.path.join(base, k) for k in ("j", "t")}
    for d in dirs.values():
        os.makedirs(d)
    js = jsolver.EDSolver(jc, hloc, log=lambda m: None)
    ts = tsolver.EDSolver(tc, hloc, log=lambda m: None, device="cpu")
    eb, db, h0 = bethe_bands(1, 1.0, PARITY_RUN["le"], np.zeros(1))

    def chi2(k):
        with open(os.path.join(dirs[k], "chi2fit_results.ed")) as fh:
            return float(fh.read().split("\n")[-2].split()[0])

    rows = []
    with threadpool_limits(limits=1):
        os.chdir(dirs["t"])
        bath = ts.init_solver()
        prev = bath.copy()
        for it in range(1, PARITY_CFG["nloop"] + 1):
            os.chdir(dirs["t"])
            rt = ts.solve(bath)
            os.chdir(dirs["j"])
            rj = js.solve(bath)
            gm = gloc_dos(tc, eb, db, h0, rt.smats, "mats")
            weiss = self_consistency(tc, gm, rt.smats, hloc, diag_only=True)
            os.chdir(dirs["t"])
            ft = ts.chi2_fitgf(weiss, bath, ispin=0)
            os.chdir(dirs["j"])
            fj = js.chi2_fitgf(weiss, bath, ispin=0)
            rows.append(dict(
                dG=float(np.max(np.abs(rt.gmats - rj.gmats))),
                dSigma=float(np.max(np.abs(rt.smats - rj.smats))),
                degs=float(abs(rt.egs - rj.egs)),
                ddocc=float(abs(rt.observables.docc[0]
                                - rj.observables.docc[0])),
                dfit=float(np.max(np.abs(ft - fj))),
                chi2=(chi2("t"), chi2("j"))))
            bath = ft if it == 1 else (PARITY_RUN["wmixing"] * ft
                                       + (1 - PARITY_RUN["wmixing"]) * prev)
            prev = bath.copy()
    worst = {k: max(r[k] for r in rows)
             for k in ("dG", "dSigma", "degs", "ddocc")}
    return dict(case="split", seed=seed, iterations=len(rows), **worst,
                dfit_first=rows[0]["dfit"],
                dfit_later=max(r["dfit"] for r in rows[1:]),
                chi2_first=rows[0]["chi2"])


def _nudged(package, n, step, cls_name, run_one):
    """run_one() n times, with the initial bath of the class's
    initializer scaled by (1 + k step)."""
    import numpy as np
    _, _, solver, lattice_solver, _ = _pkg(package)
    cls = getattr(solver, "EDSolver") if cls_name == "EDSolver" \
        else getattr(lattice_solver, "LatticeEDSolver")
    meth = "init_solver" if cls_name == "EDSolver" else "init_solvers"
    orig = getattr(cls, meth)
    out = []
    try:
        for k in range(n):
            def init(self, *a, k=k, **kw):
                return orig(self, *a, **kw) * (1.0 + k * step)
            setattr(cls, meth, init)
            _fresh_dir()
            with threadpool_limits(limits=1):
                out.append(float(run_one()))
            print(json.dumps(dict(k=k, value=out[-1])), flush=True)
    finally:
        setattr(cls, meth, orig)
    return np.array(out)


def run_nudge_multiband(package, n, step, route, device) -> dict:
    import numpy as np
    if route is not None:
        os.environ["DMFT_ED_RAGGED"] = route
    config, models, _, _, kw = _pkg(package)
    if device != "cpu":
        kw = {"device": device}
    from importlib import import_module
    kspace = import_module(models.__name__ + ".kspace")
    cfg = config.EDConfig(**MULTIBAND_CFG).validate()
    hk = kspace.hk_multiband_square(nk=10, ts=0.5, norb=2)

    def one():
        r = kspace.run_kspace(cfg, hk, log=lambda m: None, **kw)
        return abs(r.dens[0] - r.dens[1])
    v = _nudged(package, n, step, "EDSolver", one)
    return dict(case="nudge_multiband", package=package, route=route,
                device=device, n=n, step=step,
                above_1e6=int(np.sum(v > 1e-6)), median=float(np.median(v)),
                values=v.tolist())


def run_nudge_blg(package, n, step, route, device) -> dict:
    import numpy as np
    if route is not None:
        os.environ["DMFT_ED_RAGGED"] = route
    config, models, _, _, kw = _pkg(package)
    if device != "cpu":
        kw = {"device": device}
    from importlib import import_module
    blg = import_module(models.__name__ + ".blg")

    def one():
        r = blg.run(config.EDConfig(**BLG_CFG).validate(), stacking="AB",
                    nk=8, t0=0.3, **kw)
        return np.max(np.abs(r.dens[:, 0] - 1.0))
    v = _nudged(package, n, step, "LatticeEDSolver", one)
    return dict(case="nudge_blg", package=package, route=route,
                device=device, n=n, step=step,
                above_3e4=int(np.sum(v > 3e-4)), median=float(np.median(v)),
                max=float(v.max()), values=v.tolist())


def run_soc_mended(raw: bool) -> dict:
    import numpy as np
    config, _, _, _, _ = _pkg("jax")
    from dmft_ed_tpu.models import soc
    if not raw:
        _mend_nonsu2_g()
    cfg = config.EDConfig(**SOC_PROBE_CFG).validate()
    _fresh_dir()
    with threadpool_limits(limits=1):
        r = soc.run(cfg, nk=4, t=0.5, soc=0.25, wmixing=0.5,
                    log=lambda m: None)
    return dict(case="soc_mended", raw=raw, dens=r.dens.tolist(),
                ptp=float(np.ptp(r.dens)), error=float(r.error),
                max_sigma_updn=float(np.max(np.abs(r.smats[0, 1]))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=("bethe", "ahm", "nbath9", "soc", "bhz",
                                       "jz2", "flake", "soc_ineq",
                                       "drivers", "lattice_drivers",
                                       "stack", "f32", "bench13",
                                       "backend_parity", "loop", "pool",
                                       "split", "nudge_multiband",
                                       "nudge_blg", "soc_mended"),
                    required=True)
    ap.add_argument("--method", default="arpack")
    ap.add_argument("--nbath", type=int, default=13,
                    help="bench13's Nbath (13: the (7,7) sector of Ns=14)")
    ap.add_argument("--nloop", type=int, default=None,
                    help="iterations (bethe 5, soc 3, bhz 3, flake 3, "
                    "soc_ineq 2)")
    ap.add_argument("--package", choices=("jax", "torch"), default="torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--step", type=float, default=1e-13)
    ap.add_argument("--route", choices=("0", "1"), default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--raw", action="store_true")
    args = ap.parse_args()
    if args.out:
        args.out = os.path.abspath(args.out)
    probes = {"loop": lambda: run_loop(args.package, args.seed, args.out),
              "pool": lambda: run_pool(args.out),
              "split": lambda: run_split(args.seed),
              "nudge_multiband": lambda: run_nudge_multiband(
                  args.package, args.n, args.step, args.route, args.device),
              "nudge_blg": lambda: run_nudge_blg(
                  args.package, args.n, args.step, args.route, args.device),
              "soc_mended": lambda: run_soc_mended(args.raw)}
    if args.case in probes:
        import scipy.linalg  # noqa: F401  (the OpenBLAS threadpoolctl limits)
        with threadpool_limits(limits=1):
            out = probes[args.case]()
        os.chdir(REPO)
        print(json.dumps(out))
        return 0
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
               "bench13": lambda: run_bench13(args.nbath),
               "backend_parity": run_backend_parity}[args.case]()
        os.chdir(REPO)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
