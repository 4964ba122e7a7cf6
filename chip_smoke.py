#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dmft_ed_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``, and exits non-zero without a result
when any is missing or any phase fails. Phases:

1. the card's name and power limit; build every kernel of the port from
   ``dmft_ed_tpu_torch/csrc/`` (one ``nvcc`` per source, all in parallel),
   with each ptxas report and the count of tensor-core instructions
   (``IGMMA``/``IMMA``) in the library's SASS, which must not be 0;
2. each kernel against its plain PyTorch version on the card, at every
   shape class the main paths give it (the seven per-spin dimensions
   C(12, n) x the dw and up families at 5x7, the 924 class at 6x6; the
   thick restart's zero-embedded operands, H of a 792-dim spin sector in
   924x924, both sides; ``ozaki.fused_two_sided``'s K = 1848 product),
   plus a ragged shape (once more with nonzero pad columns, which must
   not enter) and the pairwise schedule forced with chunks of 8 and 39:
   bitwise against the plain version, 1e-9 against the f64 product; times
   of the kernel, the plain version and the library call, the host's
   cost of one wrapper call, achieved TOPS and the share of the bound;
3. the first slice's path: the Nbath=11 Bethe DMFT loop
   (``models.hm_bethe.run``) with ``lanc_method="lanczos"`` and
   ``matmul_precision="ozaki5x7"``, one iteration (cut from two to keep
   the script near half its time limit);
4. precision: one fixed-bath solve on the final bath with ``native`` and
   with ``ozaki5x7``;
6. the canonical loop: ``hm_bethe.run`` with the package defaults
   (``lanc_method="arpack"``, ``native``) at Norb=1, Nbath=6, beta=1000,
   Lmats=Lreal=5000 (``bench_e2e.py``), cut to 5 iterations and held to
   the JAX package's docc after the same count;
7. the thick restart at full width: one ``EDSolver.solve`` of the Nbath=11
   config with ``lanc_method="arpack"`` and ``chispin_flag`` on phase 3's
   final bath, with ``native`` and with ``ozaki5x7`` (over the native
   solve's ground-state sector and its neighbours, ``ed_sectors``, in a
   directory of its own; its p2 bucket runs the stacked restart over
   zero-embedded operators), held to phase 4's plain-Lanczos egs and to
   each other;
8. the canonical attractive-Hubbard loop: ``models.ahm_bethe.run`` with the
   package defaults (``arpack``, ``native``) at Norb=1, Nbath=6, U=-2,
   beta=1000, Lmats=Lreal=5000, dmft_error=1e-5, to convergence, held to
   the JAX package's CPU runs of the same config;
9. superc at Nbath=9 (Sz=0 sector of dim 184,756 in 11 blocks): (a) one
   fixed-bath ``EDSolver.solve`` on the initial bath with ``arpack`` and
   with ``lanczos``, held to each other and to the JAX package's egs;
   (b) the Sz=0 operator, whose pairing mix terms are rectangular Ozaki
   products C(10, n-+1) x C(10, n), under ``native`` and ``ozaki5x7``:
   applied to 4 seeded vectors and run 40 Lanczos steps, held to each
   other, with the kernel's launches and a sample of its calls held
   bitwise against the plain version;
10. the SOC loop: ``models.soc.run`` with the driver defaults (Norb=3,
    Nbath=1, ``ed_mode="nonsu2"``, a replica bath, nk=8, the package
    defaults), cut to SOC_NLOOP iterations and held to the JAX package's
    CPU values after the same count (dens per orbital, |Σ_{↑↓}(iω)|, the
    DMFT error);
11. the BHZ loop: ``models.bhz_2d.run`` with the driver defaults (Norb=2,
    Nbath=2, nk=20) in nonsu2 with rh = 0.2, held the same way;
12. the spin-orbit impurity where the card works: Norb=3, Nbath=3 (24
    spin-orbitals), t2g + atomic SOC in the Jz-conserving form with a
    replica bath and U, U', Jh: the sweeps and the observables of the
    ground state's N and its neighbours (N = 11 .. 13, half filling) (a)
    in the Jz basis (up to 440,528 states in 49 blocks) and (b) in plain
    N sectors (up to 2,704,156 in 13 blocks), held to each other; (c)
    one whole
    ``EDSolver.solve`` (G, Σ) at Nbath=2 in the Jz basis and in plain N,
    held to each other and to the JAX package's CPU values. Nonsu2
    operators are complex, so phases 10-12 launch no digit matmul (no
    Ozaki digits for complex operators, in either package);
13. inequivalent-site real-space DMFT on the driver's default flake
    (``models.hm_square_lattice.run``: 4x4 sites, ts=0.25, 3 symmetry
    classes -> ``nano.run`` -> ``LatticeEDSolver.solve`` with the
    site-batched sweep, the cross-site GF and the joint fit), each part in
    a directory of its own: (a) Norb=1, Nbath=6, U=2, beta=100,
    Lmats=1024, Lreal=256, the package defaults, 3 iterations, held to
    the JAX package's CPU run (``chip_reference.py --case flake``) and to
    the flake's symmetry classes; (b) the same flake at full width,
    Nbath=11 (sectors of 853,776 in 3-site stacks), one iteration, held to
    half filling, with the seconds per stage, the matvecs and torch calls
    of the largest sector and the peak memory; (c) one fixed-bath
    ``LatticeEDSolver.solve`` of the Nbath=8 flake, batched against
    per-site (native) and ozaki5x7 (over the sectors of each site's
    native ground state, ``ed_sectors``) against native, the kernel launched
    under ozaki5x7 (a sample of its calls held bitwise against the plain
    version) and not under native; (d) ``models.soc_ineq.run`` with the
    driver's defaults (2 sites, nonsu2, a replica bath), 2 iterations,
    held to ``chip_reference.py --case soc_ineq``;
14. the single-site drivers (ROADMAP.md §1 item 2), each part in a
    directory of its own: (a) each of ``hm_bethe_nbands``,
    ``hm_2bands_bethe``, ``hm_dos``, ``ehm_bethe``, ``hm_bethe_afm``,
    ``ahm_2bands``, ``kspace.run_kspace``, ``hm_multiband``, ``material``
    (an H(k) file it writes) and ``ahm_square`` at small depth (Nbath
    2-4, Lmats=200, one iteration), held to ``chip_reference.py --case
    drivers``, with its seconds; (b) BASELINE.json's 2-band Hund config at
    full width (``hm_bethe_nbands``: Norb=2, a hybrid bath of 10 levels,
    U'=U-2J, Jx=Jp=J; the (6,6) sector has 853,776 states), one
    iteration with the package defaults: half filling before the fit,
    the stage seconds, the largest sector's matvecs and torch calls per
    matvec (eager and graphed), the peak memory, and the ground state's
    sectors again with plain Lanczos (egs 1e-9); (c) that sector's
    operator, spin exchange and pair hopping as four mix terms, under
    native and ozaki5x7: H v, 40 Lanczos steps, the kernel's launches and
    a sample of its calls held bitwise against the plain version; then
    the thick restart under ozaki5x7 of the (6,6) sector (``ed_sectors``):
    the mix terms keep it on the serial restart, with the kernel in every
    matvec; egs held to (b)'s native egs;
15. the lattice drivers (ROADMAP.md §1 item 3), each part in a directory
    of its own: (a) each of ``ahm_stripe.run`` and ``run_stack``,
    ``haldane_sc``, ``ahm_disorder`` (a 3x3 flake with a seeded
    disorder), ``kspace_afm.run_graphene``, ``hm_slab``, ``bhz_afm``
    (afm2), ``bhz_edge``, ``bhz_edge_afm``, ``wsm_slab``, ``hartree_nano``,
    ``nano_isoc_sq`` (with chi0(q) and the local Chern marker), ``blg``
    (AA), ``tblg`` (synthetic hoppings) and ``twisted_blg`` at small depth
    (Nbath 1-3, Lmats=200, one iteration), held to ``chip_reference.py
    --case lattice_drivers``, with its seconds; (b) the ed_ahm_stackU
    heterostructure at full width (``ahm_stripe.run_stack``: four
    superconducting layers in two U domains, Nbath=9, Sz=0 of 184,756
    states in 11 blocks, 144 k-points), one iteration with the package
    defaults: the first solve per layer held to ``chip_reference.py
    --case stack``, each layer's ground-state sectors solved again per
    site, the stage seconds, the member matvecs at Sz=0, the torch calls
    of one matvec (eager and graphed) and the peak memory; the superc
    and lattice paths run ``native``, so phase 15 launches no digit
    matmul;
16. the meshes (ROADMAP.md §1 item 4) and float32 (item 5), in a
    directory of its own. The card machine has one GPU, so
    ``chip_smoke.py`` starts two rank processes that share cuda:0 in a
    gloo group (``parallel.spawn.run_ranks``, joined with a timeout;
    their times are not multi-GPU times): (a) ``EDSolver(mesh=rows 2)``
    solves phase 7's config and bath, native and ozaki5x7, over the
    ground state's sector and its neighbours (every one above the
    default ``shard_dim_threshold``, so row-sharded: 462 of the (6,6)
    sector's 924 rows per rank), held to phase 7's single-process solves
    (egs 1e-10, G 1e-8, Σ 1e-6, dens and docc 1e-9), with the kernel's
    launches on the sharded ozaki5x7 route, a sample of its calls held
    bitwise, one sharded (6,6) matvec of each precision against the
    unsharded one (bitwise under ozaki5x7, 1e-12 relative native), the
    all-gathers per matvec, ms per sharded matvec beside its all-gather
    alone and the unsharded matvec, and the peak memory per rank; the two
    ranks run in one shared directory, where only rank 0 writes, and
    each solve's files (one subdirectory per precision) must carry the
    names and line counts of phase 7's single-process ozaki5x7 solve over
    the same sectors; (b) ``LatticeEDSolver(mesh=sites 2)`` on phase
    13(a)'s flake (three classes on two site ranks), held to the
    single-process batched solve (egs 1e-9, G 1e-7, dens and docc 1e-8);
    (c) phase 7's native solve in ``dtype="float32"``: egs within 1e-5
    relative of the float64 egs, seconds and peak memory beside phase
    7's;
17. the port's benchmark entry points (``dmft_ed_tpu_torch.benches``) at
    the ed_nano scale, ``bench.py``'s half-filled (7,7) sector of Ns=14
    (Nbath=13: 11,778,624 states in one 3432x3432 block): (a)
    ``benches.bench.run``, 30 Lanczos steps, under native, ozaki5x7 and
    float32, the native alphas and betas held to the JAX package's CPU
    values (``chip_reference.py --case bench13``), ozaki5x7 and float32
    to native, with the seconds per step, the Lanczos iterations and
    effective nnz per second, the kernel's launches (a sample of its
    calls held bitwise) and the peak memory; (c) the sector's ground
    state by the thick restart (``benches.bench.ground_state``), native
    and ozaki5x7, held to the JAX package's egs and to each other; (d)
    ``benches.bench_scaling`` on one rank and on two ranks sharing the
    card (gloo), native: the sharded alphas and betas against one rank's,
    ms per step, per sharded matvec and of its 94 MB all-gather alone (not
    multi-GPU times). ``bench_e2e``'s two workloads are phases 3 and 6;
5. printed last, after phases 6 to 17: a ``{"kernels": [...]}`` line, the
   card line, and as the last line ``{"ok": true, "device": {...}}``.

Phases 10-12 print their seconds, the solver's stage timers, the matvecs
of their largest sector, the torch calls of one matvec there, and the
peak device memory.

Phase 2 also holds the kernel at phase 17's classes, the Nbath=13 sector's
3432x3432 operators against a 3432x3432 panel on both sides (K padded to
3440, M not a multiple of the 128-row tile) and a rank's 1716-row slices
of them (``bench_scaling``'s ozaki5x7 route on two ranks); at phase
16's row-sharded class, 462x924 · 924x924 on both sides; at phase 9's
classes: the 252 block class on both sides and the largest pairing
classes, 252 -> 210 and 210 -> 252, on both sides; and at phase 14's
mix-term classes, a 924x924 hop operator
c+_a c_b against a 924x4096 panel and against the 924x924 panel of one
Krylov vector of the (6,6) sector (the shape of every product phase
14(c)'s Lanczos steps make), on both sides. At the 924 class, the superc
252 / 210 classes and the 3432 class it holds the digit-extraction
kernel too (``kernels.digit_split``): both operands of each case split
as left (per-row scales) and right (per-column scales), bitwise against
the plain version, with the kernel's ms beside its byte bound and the
plain version's ms; phase 17(c) checks its launches, two per matvec and
two for the operator's constant blocks under ozaki5x7, none under native.

Phase 18: the mix terms' signed-gather kernel (``kernels.mix_gather``,
``csrc/mix_gather.cu``) on the Hund cell's operator
(``benchmark/configs/hund2_nb12.json``: the (7,7) sector, one 3432x3432
block, four Kanamori terms in one "pmix" entry), float64 and float32:
bitwise against its plain version on the same tables and apply_op against
the dense "bmix" encoding of the same operator; the kernel's ms beside its
byte bound (the distinct entries of V read and of Y written, 8 bytes
each), the plain version's ms and the dense batched products' with
their add into Y (the "bmix" entry's ``Bmix.add``, the library
yardstick); then the
benchmark cell's thick restart from one start vector in float64, one
launch per matvec, which gives the kernels line its ``launches``. Its
``launches_per_path`` holds every path's count (a CUDA graph's replays
count the launches their capture recorded); every path of ``MIX_PATHS``
launches the kernel, and no ozaki5x7 or Nbath=13 path does.

Every path runs with the launch counts reset just before it and read just
after it. ``--phases 10,12`` (for development; any of 10-18) runs phase
1 and the listed phases only, and prints no result line (``--phases 17``
also runs phase 2's phase-17 classes).

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Published dense peaks of one H100 SXM (NVIDIA data sheet), for bound_ms.
INT8_OPS_PER_S = 1.979e15
HBM_BYTES_PER_S = 3.35e12
# the kernels every ozaki5x7 path launches (mix_gather runs only where an
# operator has mix terms of real vectors outside the Ozaki route)
OZAKI_KERNELS = ("digit_matmul", "digit_split")
# the native paths whose operators have real mix terms (the superc pairing,
# the Hund exchange and pair hopping), each of which launches mix_gather
MIX_PATHS = ("ahm_loop_native", "nbands_nbath10_native",
             "stack_nbath9_native", "hund_gs_nbath12_native")

# Phase-2 tolerances: kernel vs plain bitwise (same schedule and epilogue;
# the int32 sums are exact in any order), and vs the f64 product the
# ozaki5x7 / ozaki6 truncation class (tests/test_ozaki.py).
TOL_EXACT_REL = 1e-9

# Phase-4 bounds on |native - ozaki5x7| for one fixed-bath solve at
# Nbath=11. Plain Lanczos amplifies the ~1e-10 relative digit truncation of
# each matvec; measured on an H100 (see PERF.md) well below these.
TOL_EGS = 1e-8
TOL_DOCC = 1e-7

MAIN_CFG = dict(norb=1, nbath=11, nspin=1, uloc=(2.0,), beta=100.0,
                lmats=1024, lreal=256, dmft_error=1e-12, nloop=1,
                lanc_niter=256, lanc_ngfiter=200, lanc_method="lanczos",
                matmul_precision="ozaki5x7", ed_verbose=0)
MAIN_RUN = dict(le=300, wmixing=0.5)
# the phase-2 case whose numbers the kernels line reports
MAIN_CASE = "dw K=924"

# Phase 6: the canonical workload (BASELINE.md, bench_e2e.py run_canonical)
# with the package defaults: lanc_method="arpack", matmul_precision="native".
# Depth cut to a fixed CANON_NLOOP iterations (it converges in 18) to keep
# the script inside its time limit.
CANON_NLOOP = 5
CANON_CFG = dict(norb=1, nbath=6, nspin=1, uloc=(2.0,), beta=1000.0,
                 lmats=5000, lreal=5000, dmft_error=1e-5, nloop=CANON_NLOOP,
                 ed_verbose=0)
CANON_RUN = dict(le=500, wmixing=0.5)
# docc after CANON_NLOOP iterations: the JAX package's CPU run of the same
# config and count (python3 chip_reference.py --case bethe --nloop 5),
# held within the 2e-3 backend-parity contract (PERF_NOTES.md)
CANON_JAX_DOCC = 0.09552425414171856
TOL_CANON = 2e-3

# Phase 7: the Nbath=11 config on the thick restart, with chi_spin.
ARPACK_CFG = dict(MAIN_CFG, lanc_method="arpack", chispin_flag=True)
# The whole ozaki5x7 sweep took 112.3 s on an H100 (host bound, PERF.md),
# so the ozaki5x7 solve sweeps the native solve's ground-state sector and
# its neighbours N +- 1 of each spin (ed_sectors over the
# sectors_list.restart the native solve wrote): (7,6) and (6,7), 792 x
# 924, still stack with (6,6) in the 2^20 bucket, zero-embedded
ARPACK_OZAKI_SECTORS = dict(ed_sectors=True, ed_sectors_shift=1)
# |egs(arpack) - egs(plain Lanczos)| on one bath, both native f64
TOL_EGS_METHODS = 1e-9
# max|native - ozaki5x7| of chi_spin(iv) relative to max|chi_spin(iv)|
TOL_CHI_REL = 1e-6

# Phase 8: the canonical attractive-Hubbard loop (BASELINE.md, ed_ahm_bethe)
# with the package defaults: lanc_method="arpack", matmul_precision="native".
AHM_CFG = dict(norb=1, nbath=6, nspin=1, ed_mode="superc", uloc=(-2.0,),
               beta=1000.0, lmats=5000, lreal=5000, dmft_error=1e-5,
               nloop=40, ed_verbose=0)
AHM_RUN = dict(le=500, wmixing=0.5)
# At convergence the loop does not pin the density: the fit does not
# impose particle-hole symmetry, and the converged dens lands anywhere in
# ~1e-2 of 1 (the JAX package's two converged CPU runs of AHM_CFG end at
# 1.0008 and 1.0103, with docc 0.4400 and 0.4450). What the runs share is
# phi and the local moment m2 = dens - 2 docc (the singly occupied weight:
# extra density goes into doubly occupied sites). Held: phi and m2 inside
# the two JAX runs' values (artifacts/canonical_ahm.json: 22 iterations;
# python3 chip_reference.py --case ahm: 17 iterations), each widened by
# the 2e-3 backend-parity contract (PERF_NOTES.md), and |dens - 1| <=
# TOL_AHM_DENS.
AHM_JAX_RUNS = (dict(docc=0.44002586627666485, phi=0.4217019491971091,
                     dens=1.0007705066918862),
                dict(docc=0.4449765765564796, phi=0.4220461123640124,
                     dens=1.0102959209531506))
TOL_AHM = 2e-3
TOL_AHM_DENS = 2e-2


def ahm_held(docc, phi, dens):
    """The values phase 8 holds: phi and m2 = dens - 2 docc."""
    return dict(phi=phi, m2=dens - 2.0 * docc)


AHM_WINDOWS = {k: (min(ahm_held(**r)[k] for r in AHM_JAX_RUNS) - TOL_AHM,
                   max(ahm_held(**r)[k] for r in AHM_JAX_RUNS) + TOL_AHM)
               for k in ("phi", "m2")}

# Phase 9: superc at Nbath=9 on its initial bath.
SUPERC_CFG = dict(norb=1, nbath=9, nspin=1, ed_mode="superc", uloc=(-2.0,),
                  beta=100.0, lmats=1024, lreal=256, lanc_niter=256,
                  ed_verbose=0)
# egs of the JAX package's CPU solve of SUPERC_CFG with lanc_method
# "arpack" and native products (python3 chip_reference.py --case nbath9)
SUPERC_EGS_JAX = -11.344307499556198
# |phi|, |docc| between the arpack and the lanczos solve
TOL_OBS_METHODS = 1e-7
# phase 9b: leading Lanczos coefficients, native against ozaki5x7
TOL_KRYLOV = 1e-8


# Phases 10-11: the nonsu2 k-space loops with their drivers' defaults, cut
# to a fixed count of iterations and held to the JAX package's CPU values
# after the same count (python3 chip_reference.py --case soc | bhz; the
# JAX package's nonsu2 G transposed back to G0's convention there, as the
# port computes it, ROADMAP.md §3).
SOC_NLOOP = 3
SOC_CFG = dict(norb=3, nspin=2, nbath=1, uloc=(1.0, 1.0, 1.0),
               ed_mode="nonsu2", bath_type="replica", nloop=SOC_NLOOP,
               dmft_error=1e-12, ed_verbose=0)
SOC_RUN = dict(nk=8)
SOC_JAX = dict(dens=[1.0513259368616312, 1.0513259368616361,
                    1.051325936861641],
               smats_ud=0.005907781142193307, error=0.005584614994940914)
BHZ_NLOOP = 3
BHZ_CFG = dict(norb=2, nspin=2, nbath=2, uloc=(1.0, 1.0), ed_mode="nonsu2",
               nloop=BHZ_NLOOP, dmft_error=1e-12, ed_verbose=0)
BHZ_RUN = dict(rh=0.2)
BHZ_JAX = dict(dens=[0.5163924938396428, 1.4832745081209329],
               smats_ud=0.03993600548790096, error=2.7476490394275097e-05)
# dens per orbital and the DMFT error (absolute); |Σ_{↑↓}(iω)| relative.
# On an H100 the SOC loop lands within 5.0e-8, 7.8e-9 and 1.7e-6 of the
# JAX package's values, the BHZ loop within 3.9e-7, 6.6e-9 and 8.9e-5
# (PERF.md): the fit's flat valley parts the trajectories of two
# backends from the second fit on (tests/test_torch_soc.py), and the
# BHZ loop's |Σ_{↑↓}| (0.040) is small against its spread.
TOL_LOOP_DENS = 1e-5
TOL_LOOP_SIGMA_REL = 1e-3
TOL_LOOP_ERROR = 1e-6

# Phase 12: t2g + atomic SOC, Jz-conserving (tests/test_jz_basis.py's
# problem), at the width of t2g ED-DMFT studies: Nbath=3 replica copies.
JZ_CFG = dict(norb=3, nspin=2, uloc=(2.0, 2.0, 2.0), ust=1.2, jh=0.4,
              ed_mode="nonsu2", bath_type="replica", beta=100.0, lmats=1024,
              lreal=256, lanc_nstates_sector=2, ed_verbose=0)
JZ_LAMBDA = 0.3
# the ground state's N at Nbath=3: half filling (12 of 24 spin-orbitals);
# the full Jz sweep of all 329 sectors finds it at (N, 2Jz) = (12, 0) in
# 222 s on an H100 (PERF.md), so the script sweeps N = 11 .. 13 only
JZ_NGS = 12
# the JAX package's Nbath=2 plain-N solve (python3 chip_reference.py
# --case jz2); the port's Jz and plain solves are both held to it
JZ2_JAX = dict(
    egs=-10.649701857954273,
    dens=[0.9921419554631008, 0.9921419554630929, 1.0158523372834276],
    docc=[0.07758459635440795, 0.07758459635440115, 0.09987654215876188],
    g0=[[0.16564232336407958, -0.05705886015407734],
        [-0.41062781959759076, -0.11761742208744869],
        [0.07606313803703657, -0.057148476335497925],
        [-0.41062781959753825, -0.11761742208743614],
        [0.16564232336407791, -0.057058860154078156],
        [0.07606313803704512, -0.057148476335497925]],
    sigma0_re=[0.14364971365327428, 0.0, 0.0,
               0.0, 2.476854520932114, 0.0,
               0.0, 0.0, 0.8232433709445867,
               0.0, 0.0, 1.9728461946802072,
               0.0, 0.0, 0.0,
               0.0, -1.972846194680419, 0.0,
               0.0, 0.0, 0.0,
               0.0, 0.0, -1.9728461946804252,
               1.9728461946802045, 0.0, 0.0,
               2.476854520932394, -3.355671475613607e-18, 0.0,
               0.0, 0.14364971365328627, 0.0,
               0.0, 0.0, 0.8232433709444532],
    sigma0_im=[-0.24519126304594027, 0.0, 0.0,
               0.0, -0.5898863106880187, 0.0,
               0.0, 0.0, -0.2614353422679748,
               0.0, 0.0, -0.11744123038256098,
               0.0, 0.0, 0.0,
               0.0, 0.11744123038268459, 0.0,
               0.0, 0.0, 0.0,
               0.0, 0.0, 0.1174412303826509,
               -0.11744123038258693, 0.0, 0.0,
               -0.5898863106881125, 0.0, 0.0,
               0.0, -0.24519126304601935, 0.0,
               0.0, 0.0, -0.26143534226786086])
# Jz against plain N: egs, then dens and docc
TOL_JZ_EGS = 1e-9
TOL_JZ_OBS = 1e-7
# Nbath=2 against the JAX package: G_{aa}^{ss}(iω_0) and Σ(iω_0)
TOL_JZ_GF = 1e-7

# Phase 13: inequivalent-site real-space DMFT on the driver's default flake
# (hm_square_lattice.run: a 4x4 square flake, ts=0.25, 16 sites in 3
# symmetry classes, corners, edges and centre).
FLAKE_RUN = dict(lx=4, ly=4, ts=0.25)
# (a) the flake loop with the package defaults (arpack, native), cut to
# FLAKE_NLOOP iterations and held to the JAX package's CPU run of the same
# config and count (python3 chip_reference.py --case flake)
FLAKE_NLOOP = 3
FLAKE_CFG = dict(norb=1, nbath=6, nspin=1, uloc=(2.0,), beta=100.0,
                 lmats=1024, lreal=256, dmft_error=1e-12, nloop=FLAKE_NLOOP,
                 ed_verbose=0)
FLAKE_JAX = dict(
    error=0.009285346594791714, ekin=-0.1604497162192402,
    dens=[0.999998239032014, 1.0000028975304627, 0.9999995206145957],
    docc=[0.03994999570611506, 0.06073862438607683, 0.06971090292099488],
    sigma0_re=[0.00039980842429277033, 6.2054782705631535e-06,
               3.806888486381148e-05],
    sigma0_im=[-0.8780550501801385, -0.3918592580422794,
               -0.5502486487297837])
# After the first joint fit the two packages' baths part in the fit's flat
# valley (tests/test_torch_sites.py): the port's CPU run of this config
# ends 6.6e-6 (dens), 1.4e-4 (docc), 1.1e-4 (ekin), 1.7e-3 (|Σ(iω_0)|,
# relative) and 3.4e-7 (the DMFT error, which is about 9.3e-3) off the
# JAX package's, its run on an H100 4.9e-6, 2.7e-4, 2.3e-4, 2.9e-3 and
# 9.6e-5 (PERF.md). Held: dens 1e-3 and docc 2e-3 (the backend-parity
# contract, PERF_NOTES.md), ekin 2e-3, Σ(iω_0) 1e-2 relative per class,
# the error 1e-3.
TOL_FLAKE_DENS = 1e-3
TOL_FLAKE_DOCC = 2e-3
TOL_FLAKE_EKIN = 2e-3
TOL_FLAKE_SIGMA_REL = 1e-2
TOL_FLAKE_ERROR = 1e-3
# (b) full width: Nbath=11 (sectors of 853,776; 3-site stacks), the package
# defaults (arpack, native), cut to one iteration. The first solve sees the
# particle-hole symmetric initial bath: held to half filling per site and
# 0 < docc < 1/4.
FLAKE11_CFG = dict(FLAKE_CFG, nbath=11, lanc_ngfiter=200, nloop=1)
TOL_FLAKE11_DENS = 1e-6
# (c) one fixed-bath LatticeEDSolver.solve of the Nbath=8 flake on the
# initial baths perturbed from a seed: batched against per-site (native)
# and ozaki5x7 against native (phase 4's bounds, TOL_EGS and TOL_DOCC).
# The whole ozaki5x7 sweep takes 287 s on an H100 (173,960 launches, host
# bound, PERF.md), so the ozaki5x7 solve sweeps only the sectors of each
# site's native ground state: ed_sectors reads the
# sectors_list_ineq####.restart files the native solves wrote (the
# reference's restart mechanism, per site)
FLAKE8_CFG = dict(FLAKE_CFG, nbath=8, nloop=1)
TOL_SITES_EGS = 1e-9
TOL_SITES_G = 1e-8
# (d) soc_ineq with the driver's defaults (nlat=2, nk=6; Norb=3, Nbath=1,
# nonsu2, a replica bath), cut to SOC_INEQ_NLOOP iterations and held to
# the JAX package's CPU values (python3 chip_reference.py --case
# soc_ineq, its nonsu2 G transposed back) with phases 10-11's bounds
SOC_INEQ_NLOOP = 2
SOC_INEQ_CFG = dict(norb=3, nspin=2, nbath=1, uloc=(1.0, 1.0, 1.0),
                    ed_mode="nonsu2", bath_type="replica",
                    nloop=SOC_INEQ_NLOOP, dmft_error=1e-12, ed_verbose=0)
SOC_INEQ_JAX = dict(
    error=0.03312446839411293,
    dens=[[1.0357931448649873, 1.035793144864996, 1.0357931448649929],
          [1.0357931448649844, 1.035793144864995, 1.0357931448649798]],
    smats_ud=[0.003435920565267747, 0.003435920565412501])

# Phase 14: the single-site drivers (ROADMAP.md §1 item 2).
# (a) each new driver's run() on the card at small depth (Nbath 2-4,
# Lmats=200, nk <= 8, one iteration, the fit to a tight stop), held to the
# JAX package's CPU run of the same case (python3 chip_reference.py --case
# drivers): the first solve's egs, dens and docc by the backend-parity
# contract (PERF_NOTES.md). Depth cut from two iterations to one (116 s
# on an H100 at two) to make room for phase 16; the values are the
# reference's at one iteration. Two bands of one width would leave the
# hybrid fit an orbital rotation free (tests/test_torch_drivers_bethe.py),
# so hm_bethe_nbands takes two.
DRIVER_BASE = dict(beta=50.0, lmats=200, lreal=64, lfit=200, nloop=1,
                   dmft_error=1e-12, ed_verbose=0, cg_ftol=1e-12,
                   cg_niter=1000)
HUND_SMALL = dict(DRIVER_BASE, norb=2, nbath=4, bath_type="hybrid",
                  uloc=(2.0, 2.0), ust=1.5, jh=0.25, jx=0.25, jp=0.25)
TWO_BANDS = dict(DRIVER_BASE, norb=2, nbath=3, uloc=(2.0, 2.0), ust=1.0,
                 jh=0.5)
# name: (entry point, config, run() keywords, Bloch builder or None)
DRIVER_CASES = {
    "hm_bethe_nbands": ("run", HUND_SMALL,
                        dict(wbethe=[1.0, 1.3], dbethe=[0.0, 0.1]), None),
    "hm_2bands_bethe": ("run", TWO_BANDS,
                        dict(wratio=2.0, delta=0.3, sc_method=2), None),
    "hm_dos": ("run", dict(TWO_BANDS, jh=0.0),
               dict(dos_model="flat", wband=[1.0, 1.5], delta=0.2, le=300),
               None),
    "ehm_bethe": ("run", dict(DRIVER_BASE, norb=1, nbath=4, uloc=(2.0,),
                              xmu=0.1), dict(w0=0.4, le=300), None),
    "hm_bethe_afm": ("run", dict(DRIVER_BASE, norb=1, nbath=4, nspin=2,
                                 uloc=(3.0,)), {}, None),
    "ahm_2bands": ("run", dict(DRIVER_BASE, norb=2, nbath=3,
                               ed_mode="superc", uloc=(-2.0, -2.0)),
                   dict(alpha=0.6, le=300, wmixing=0.5), None),
    "kspace": ("run_kspace", dict(DRIVER_BASE, norb=2, nbath=3,
                                  uloc=(2.0, 2.0)), {},
               ("hk_haldane", dict(nk=8, t1=0.5, t2=0.1, mass=0.1))),
    "hm_multiband": ("run", dict(TWO_BANDS, norb=3, nbath=2,
                                 uloc=(2.0, 2.0, 2.0)),
                     dict(model="3b_square", nk=8), None),
    "material": ("run", dict(TWO_BANDS, jh=0.0), {},
                 ("hk_2bands_hyb_fcc3d", dict(nk=6, mh=0.1, lam=0.4))),
    "ahm_square": ("run", dict(DRIVER_BASE, norb=1, nbath=4,
                               ed_mode="superc", uloc=(-2.0,)),
                   dict(nk=8), None),
}
# the JAX package's CPU run of each case (python3 chip_reference.py --case
# drivers): the iterations, the first solve's egs, the last dens and docc
DRIVERS_JAX = {
    'hm_bethe_nbands': dict(
        iterations=1,
        first_egs=-7.479328353833771,
        dens=[1.0174145386279414, 0.9688131697875572],
        docc=[0.15731267307282243, 0.13365548091775797]),
    'hm_2bands_bethe': dict(
        iterations=1,
        first_egs=-11.402055880756208,
        dens=[1.06831858951836, 0.93168141048163],
        docc=[0.2048836757380409, 0.13656508621967572]),
    'hm_dos': dict(
        iterations=1,
        first_egs=-11.520337355029145,
        dens=[1.053579952768755, 0.9464200472312305],
        docc=[0.20351719339556895, 0.1499372406268067]),
    'ehm_bethe': dict(
        iterations=1,
        first_egs=-5.773593608589926,
        dens=[1.032858510471641],
        docc=[0.19263478799766268]),
    'hm_bethe_afm': dict(
        iterations=1,
        first_egs=-5.87006484669077,
        dens=[0.9999999999999998],
        docc=[0.142337885330382]),
    'ahm_2bands': dict(
        iterations=1,
        first_egs=-10.988217965289993,
        dens=[1.0000000000000036, 1.0000000000000044],
        docc=[0.33392038965516524, 0.33392038965516574]),
    'kspace': dict(
        iterations=1,
        first_egs=-11.002302094016802,
        dens=[0.965701006835791, 1.0342989931641973],
        docc=[0.15060706352191444, 0.18490605668611784]),
    'hm_multiband': dict(
        iterations=1,
        first_egs=-15.9979033937913,
        dens=[1.0003867299690496, 1.0003867299690496, 0.9890011978484208],
        docc=[0.039627280663532286, 0.03962728066353227, 0.03443900153663476]),
    'material': dict(
        iterations=1,
        first_egs=-11.520337355029135,
        dens=[0.9464200472312281, 1.0535799527687528],
        docc=[0.14993724062680636, 0.20351719339556856]),
    'ahm_square': dict(
        iterations=1,
        first_egs=-5.6924496640936075,
        dens=[0.999999999999999],
        docc=[0.32444562776136393])}
TOL_DRIVER_EGS = 1e-8
TOL_DRIVER_DENS = 1e-3
TOL_DRIVER_DOCC = 2e-3
# (b) full width: BASELINE.json's 2-band Hund config, hybrid bath, at
# Nbath=10 (Ns=12: the (6,6) sector has 924^2 = 853,776 states), U'=U-2J,
# Jx=Jp=J, package defaults (arpack, native), cut to one iteration. The
# first solve sees the particle-hole symmetric initial bath at xmu=0:
# half filling per orbital. Its ground-state sectors are solved again
# with plain Lanczos (ed_sectors over the sectors_list.restart the
# thick restart wrote): egs to TOL_EGS_METHODS.
NBANDS_CFG = dict(norb=2, nbath=10, bath_type="hybrid", uloc=(2.0, 2.0),
                  ust=1.5, jh=0.25, jx=0.25, jp=0.25, hfmode=True, xmu=0.0,
                  beta=100.0, lmats=1024, lreal=256, nloop=1,
                  dmft_error=1e-12, ed_verbose=0)
TOL_NBANDS_DENS = 1e-6
# (c) the (6,6) sector's operator, its spin exchange and pair hopping as
# four mix terms (two more Ozaki products each), native against ozaki5x7
# on the initial bath: H v to TOL_EXACT_REL, the leading HUND_KRYLOV
# Lanczos coefficients to TOL_KRYLOV; and the ozaki5x7 thick restart of
# that sector, which phase 7's sector cut left as the only ozaki5x7 run
# of the serial restart: egs to TOL_EGS
HUND_KRYLOV = 40


# Phase 15: the lattice drivers (ROADMAP.md §1 item 3).
# (a) each new driver on the card at small depth (Nbath 1-3, beta=50,
# Lmats=200, nk <= 8, one iteration, the fits to a tight stop), held to
# the JAX package's CPU run of the same case (python3 chip_reference.py
# --case lattice_drivers): the first solve's egs (per site, before any
# fit), each site's chi^2 after the first fit; the solve's dens and docc
# by the backend-parity contract (PERF_NOTES.md), phi for the superc
# drivers; hartree_nano (one-body) dens and mag; nano_isoc_sq's chi0(q)
# and local Chern marker after its loop's first iteration. Depth cut:
# every case runs one iteration (ahm_disorder's two took 94.5 s of phase
# 15's 200.3 s on an H100; the others were cut to make room for phase
# 16), so dens, docc and phi are the first solve's.
LATTICE_BASE = dict(DRIVER_BASE, nloop=1)
LATTICE_SC = dict(LATTICE_BASE, norb=1, nspin=1, ed_mode="superc",
                  uloc=(-2.0,))
LATTICE_SPIN = dict(LATTICE_BASE, norb=1, nspin=2, uloc=(3.0,))
LATTICE_BHZ = dict(LATTICE_BASE, norb=2, nspin=2, nbath=1, uloc=(2.0, 2.0),
                   ust=1.0, jh=0.5)
# name: (module, entry point, config, run() keywords, geometry); geometry
# names the arrays the case builds from its seed (lattice_case_args).
# nano_isoc_sq runs the 3x3 torus: the 4x4 torus has zero modes at
# k = (0, pi), (pi, 0) on the Fermi level, where the marker's occupied
# projector is not defined (the two packages' markers part by 5.7e-7
# there on the CPU).
LATTICE_CASES = {
    "ahm_stripe": ("ahm_stripe", "run", dict(LATTICE_SC, nbath=3),
                   dict(lx=2, ly=2, nk=6), None),
    "ahm_stack": ("ahm_stripe", "run_stack",
                  dict(LATTICE_SC, nbath=2, uloc=(-3.0,)),
                  dict(nlayers=4, n_umin=2, nk=4, nkz=4), None),
    "haldane_sc": ("haldane_sc", "run", dict(LATTICE_SC, nbath=3,
                                             uloc=(-3.0,)),
                   dict(nk=8, t1=0.5, t2=0.1, phi=1.5707963267948966,
                        mass=0.2), None),
    "ahm_disorder": ("ahm_disorder", "run",
                     dict(LATTICE_SC, nbath=2, nloop=1), {},
                     "disordered_flake"),
    "kspace_afm": ("kspace_afm", "run_graphene",
                   dict(LATTICE_SPIN, nbath=2), dict(nk=8, t=0.5), None),
    "hm_slab": ("hm_slab", "run", dict(LATTICE_BASE, norb=1, nbath=3,
                                       uloc=(2.0,)),
                dict(nlayers=4, nk=8), None),
    "bhz_afm": ("bhz_afm", "run", LATTICE_BHZ, dict(cell="afm2", nk=6),
                None),
    "bhz_edge": ("bhz_edge", "run", LATTICE_BHZ, dict(ly=4, nkx=8), None),
    "bhz_edge_afm": ("bhz_edge_afm", "run", LATTICE_BHZ,
                     dict(ly=3, nkx=8), None),
    "wsm_slab": ("wsm_slab", "run", LATTICE_BHZ, dict(ly=4, nk=6), None),
    "hartree_nano": ("hartree_nano", "run",
                     dict(LATTICE_BASE, norb=1, nspin=2, uloc=(3.0,),
                          nloop=200, dmft_error=1e-12),
                     dict(wmixing=0.5), "staggered_flake"),
    "nano_isoc_sq": ("nano_isoc_sq", "run",
                     dict(LATTICE_SPIN, nbath=2, nloop=1),
                     dict(nx=3, t=1.0, lam=0.2, chern=True), None),
    "blg": ("blg", "run", dict(LATTICE_BASE, norb=1, nbath=3, uloc=(2.0,)),
            dict(stacking="AA", nk=8, bias=0.2), None),
    "tblg": ("tblg", "run", dict(LATTICE_BASE, norb=1, nbath=2,
                                 uloc=(2.0,)),
             dict(nk=6), "synthetic_hopping"),
    "twisted_blg": ("twisted_blg", "run",
                    dict(LATTICE_BASE, norb=1, nbath=1, uloc=(2.0,)),
                    dict(nk=2), None),
}
LATTICE_SEED = 17
# the JAX package's CPU run of each case (python3 chip_reference.py --case
# lattice_drivers, about 3 minutes on the CPU): the iterations, the first
# solve's egs per site, each site's chi^2 after the first fit, the last
# solve's dens, docc and phi per site; hartree_nano's dens and mag;
# nano_isoc_sq's chi0(q) and Chern marker
LATTICE_JAX = {
    'ahm_stripe': dict(
        iterations=1,
        first_egs=[-5.494108982644975, -5.494108982644975, -5.429764016495174,
                   -5.429764016495174],
        chi2=[2.283425691e-05, 2.283425696e-05, 1.914021208e-05,
              1.914021173e-05],
        dens=[[1.0000000000000024], [1.0000000000000024], [0.9999999999999997],
              [0.9999999999999997]],
        docc=[[0.33392038965516513], [0.33392038965516513],
              [0.2938877244380446], [0.2938877244380446]],
        phi=[[0.01751118285488007], [0.01751118285488007],
             [0.0127137823762411], [0.0127137823762411]]),
    'ahm_stack': dict(
        iterations=1,
        first_egs=[-4.741883201432243, -4.741883201432243, -5.0448585401003685,
                   -5.0448585401003685],
        chi2=[2.988500054e-06, 2.988500054e-06, 7.720789326e-06,
              7.720789516e-06],
        dens=[[1.0000000000000278], [1.0000000000000278], [1.0000000000000924],
              [1.0000000000000924]],
        docc=[[0.44171692516832894], [0.44171692516832894],
              [0.4606167690080734], [0.4606167690080734]],
        phi=[[0.4349143401556704], [0.4349143401556704], [0.4558980110711124],
             [0.4558980110711124]]),
    'haldane_sc': dict(
        iterations=1,
        first_egs=[-5.434513154373611, -5.834513154373613],
        chi2=[8.680201852e-07, 8.680203687e-07],
        dens=[[0.628673578592975], [1.371326421407023]],
        docc=[[0.19162479865606202], [0.5629512200630858]],
        phi=[[0.020832901014086358], [0.020832901014085026]]),
    'ahm_disorder': dict(
        iterations=1,
        first_egs=[-4.801757949332179, -5.480358782677736, -4.830252111057587,
                   -5.086192534957441, -5.377393567136395, -5.052552898900522,
                   -4.972384048420136, -4.824498282089912, -4.811907972042965],
        chi2=[4.413302449e-05, 2.547800256e-05, 4.440574212e-05,
              7.275781119e-06, 1.51162898e-05, 3.198849859e-05,
              6.288564294e-06, 4.506207474e-05, 4.178855692e-05],
        dens=[[0.09028056443335664], [1.9093853331118302],
              [0.11005446156741414], [1.8964732739445165],
              [1.9063127739405556], [1.8951582156485955], [1.8915423596097976],
              [0.1050585758440714], [0.09661057530076106]],
        docc=[[0.0036412474388853523], [0.9130567971699535],
              [0.006210537930551547], [0.9014859849504986],
              [0.9102697981447552], [0.9003474711116318], [0.8973591811720407],
              [0.005220151839850799], [0.0042431389907088566]],
        phi=[[0.004080177206316704], [0.004159834981731947],
             [0.026413354327893268], [0.011329853796492095],
             [0.005021512802987349], [0.013156817933558052],
             [0.021157719255405882], [0.013502388504273433],
             [0.006138283615887752]]),
    'kspace_afm': dict(
        iterations=1,
        first_egs=[-5.050943369848078, -5.05094336984808],
        chi2=[1.269711804e-06, 1.269711803e-06],
        dens=[[1.0000000000000002], [1.0000000000000007]],
        docc=[[0.04129058800019338], [0.04129058800019343]],
        phi=[[0.0], [0.0]]),
    'hm_slab': dict(
        iterations=1,
        first_egs=[-5.493486219854924, -5.493486219854924],
        chi2=[2.426885117e-05, 3.1158319e-05],
        dens=[[0.9999999999999998], [0.9999999999999998]],
        docc=[[0.1661927875676822], [0.1661927875676822]],
        phi=[[0.0], [0.0]]),
    'bhz_afm': dict(
        iterations=1,
        first_egs=[-4.901772470890918, -4.901772470890913],
        chi2=[0.01975180142, 0.01975180142],
        dens=[[0.6323539987360551, 1.3676460012639444],
              [0.6323539987360554, 1.3676460012639455]],
        docc=[[0.06273003068291151, 0.43037603194685603],
              [0.06273003068291164, 0.43037603194685653]],
        phi=[[0.0, 0.0], [0.0, 0.0]]),
    'bhz_edge': dict(
        iterations=1,
        first_egs=[-4.895288797254227, -4.895288797254227],
        chi2=[0.003793426123, 0.001539659409],
        dens=[[0.6300563410644497, 1.369943658935552],
              [0.6300563410644497, 1.369943658935552]],
        docc=[[0.06276121078872583, 0.43270486972427713],
              [0.06276121078872583, 0.43270486972427713]],
        phi=[[0.0, 0.0], [0.0, 0.0]]),
    'bhz_edge_afm': dict(
        iterations=1,
        first_egs=[-4.901772470890916, -4.901772470890916],
        chi2=[0.005191295552, 0.01786132845],
        dens=[[0.6323539987360534, 1.3676460012639442],
              [0.6323539987360534, 1.3676460012639442]],
        docc=[[0.06273003068291118, 0.4303760319468562],
              [0.06273003068291118, 0.4303760319468562]],
        phi=[[0.0, 0.0], [0.0, 0.0]]),
    'wsm_slab': dict(
        iterations=1,
        first_egs=[-5.947100915285307, -5.947100915285307],
        chi2=[0.001030857032, 0.0002577177683],
        dens=[[0.34500192144933106, 1.6549980785506706],
              [0.34500192144933106, 1.6549980785506706]],
        docc=[[0.018039378865192728, 0.6730374574158623],
              [0.018039378865192728, 0.6730374574158623]],
        phi=[[0.0, 0.0], [0.0, 0.0]]),
    'hartree_nano': dict(
        iterations=55,
        dens=[[0.9507266027626806, 0.049273397237319355],
              [0.07011057271841786, 0.9298894272815825],
              [0.9298894272815821, 0.0701105727184179],
              [0.0492733972373193, 0.9507266027626806],
              [0.07011057271841784, 0.9298894272815824],
              [0.9147001272548039, 0.08529987274519593],
              [0.08529987274519593, 0.9147001272548045],
              [0.9298894272815826, 0.07011057271841792],
              [0.9298894272815819, 0.07011057271841795],
              [0.08529987274519596, 0.9147001272548041],
              [0.9147001272548045, 0.08529987274519592],
              [0.07011057271841796, 0.9298894272815824],
              [0.049273397237319334, 0.9507266027626805],
              [0.9298894272815825, 0.07011057271841792],
              [0.07011057271841797, 0.9298894272815822],
              [0.9507266027626797, 0.049273397237319334]],
        mag=[0.9014532055253612, -0.8597788545631646, 0.8597788545631642,
             -0.9014532055253613, -0.8597788545631646, 0.829400254509608,
             -0.8294002545096086, 0.8597788545631647, 0.8597788545631639,
             -0.8294002545096082, 0.8294002545096086, -0.8597788545631645,
             -0.9014532055253611, 0.8597788545631646, -0.8597788545631642,
             0.9014532055253603]),
    'nano_isoc_sq': dict(
        iterations=1,
        first_egs=[-5.0419084957603415],
        chi2=[0.0002850562479],
        dens=[[1.0000000000000002]],
        docc=[[0.03906806968154379]],
        phi=[[0.0]],
        chi0=[[0.11714630962796896, 0.13135685555843155, 0.13135685555843155,
               0.13265386277042726, 0.14855679581055561, 0.14855679581055561,
               0.13265386277042726, 0.14855679581055561, 0.14855679581055561],
              [0.11714630962796892, 0.13135685555843146, 0.13135685555843146,
               0.13265386277042718, 0.1485567958105555, 0.1485567958105555,
               0.13265386277042718, 0.1485567958105555, 0.1485567958105555]],
        chern=[2.5745126702253103e-16, -1.2724676473665479e-17,
               6.757320186813245e-16, 2.892385646963191e-15,
               -1.565373720662023e-16, 1.5706837820724027e-15,
               -1.2320903942538782e-15, 8.37430565264286e-16,
               -2.4803065003015244e-15]),
    'blg': dict(
        iterations=1,
        first_egs=[-5.395199462081389, -5.395199462081389, -5.595199462081387,
                   -5.595199462081387],
        chi2=[6.472276151e-06, 6.472276151e-06, 6.472276151e-06,
              6.472276151e-06],
        dens=[[0.9657225525827531], [0.9657225525827531], [1.0342774474172485],
              [1.0342774474172485]],
        docc=[[0.1497595593071828], [0.1497595593071828],
              [0.18403700672443163], [0.18403700672443163]],
        phi=[[0.0], [0.0], [0.0], [0.0]]),
    'tblg': dict(
        iterations=1,
        first_egs=[-4.344318836531884, -5.344318836531886, -4.344318836531884,
                   -5.344318836531886],
        chi2=[0.0002999889498, 0.0001972009823, 0.0002999889498,
              0.0001972009823],
        dens=[[0.9675694995656597], [1.032430500434341], [0.9675694995656597],
              [1.032430500434341]],
        docc=[[0.03752943926757378], [0.06995993970191404],
              [0.03752943926757378], [0.06995993970191404]],
        phi=[[0.0], [0.0], [0.0], [0.0]]),
    'twisted_blg': dict(
        iterations=1,
        first_egs=[-2.0615528128088307, -2.0615528128088307,
                   -2.0615528128088307, -2.0615528128088307,
                   -2.0615528128088307, -2.0615528128088307,
                   -2.0615528128088307, -2.0615528128088307,
                   -2.0615528128088307, -2.0615528128088307,
                   -2.0615528128088307, -2.0615528128088307,
                   -2.0615528128088307, -2.0615528128088307,
                   -2.0615528128088307, -2.0615528128088307,
                   -2.0615528128088307, -2.0615528128088307,
                   -2.0615528128088307, -2.0615528128088307,
                   -2.0615528128088307, -2.0615528128088307,
                   -2.0615528128088307, -2.0615528128088307,
                   -2.0615528128088307, -2.0615528128088307,
                   -2.0615528128088307, -2.0615528128088307],
        chi2=[0.0003716653329, 0.000306051502, 0.0003054598039,
              0.0003587584265, 0.0003707592152, 0.0003731509587,
              0.0003064973982, 0.0003052240327, 0.0003711740947,
              0.0003723075333, 0.0003549406912, 0.0003061536476,
              0.000372273453, 0.0003061444737, 0.0003536409595,
              0.0003711478974, 0.0003713235073, 0.000304544839,
              0.0003715750829, 0.000304946163, 0.0003057252059,
              0.0003723270411, 0.000304761242, 0.0003700531726,
              0.0003700619628, 0.0003565614825, 0.0003064836744,
              0.0003053156284],
        dens=[[0.9999999999999997], [0.9999999999999997], [0.9999999999999997],
              [0.9999999999999997], [0.9999999999999997], [0.9999999999999997],
              [0.9999999999999997], [0.9999999999999997], [0.9999999999999997],
              [0.9999999999999997], [0.9999999999999997], [0.9999999999999997],
              [0.9999999999999997], [0.9999999999999997], [0.9999999999999997],
              [0.9999999999999997], [0.9999999999999997], [0.9999999999999997],
              [0.9999999999999997], [0.9999999999999997], [0.9999999999999997],
              [0.9999999999999997], [0.9999999999999997], [0.9999999999999997],
              [0.9999999999999997], [0.9999999999999997], [0.9999999999999997],
              [0.9999999999999997]],
        docc=[[0.18936609374091673], [0.18936609374091673],
              [0.18936609374091673], [0.18936609374091673],
              [0.18936609374091673], [0.18936609374091673],
              [0.18936609374091673], [0.18936609374091673],
              [0.18936609374091673], [0.18936609374091673],
              [0.18936609374091673], [0.18936609374091673],
              [0.18936609374091673], [0.18936609374091673],
              [0.18936609374091673], [0.18936609374091673],
              [0.18936609374091673], [0.18936609374091673],
              [0.18936609374091673], [0.18936609374091673],
              [0.18936609374091673], [0.18936609374091673],
              [0.18936609374091673], [0.18936609374091673],
              [0.18936609374091673], [0.18936609374091673],
              [0.18936609374091673], [0.18936609374091673]],
        phi=[[0.0], [0.0], [0.0], [0.0], [0.0], [0.0], [0.0], [0.0], [0.0],
             [0.0], [0.0], [0.0], [0.0], [0.0], [0.0], [0.0], [0.0], [0.0],
             [0.0], [0.0], [0.0], [0.0], [0.0], [0.0], [0.0], [0.0], [0.0],
             [0.0]])}
TOL_LATTICE_PHI = 1e-4
# each site's chi^2 after the first joint fit, against the JAX package's,
# relative to the largest site's (the scale of the summed objective the
# fit minimises)
TOL_FIT_CHI2 = 5e-3
# The superc drivers' second solves follow their first joint anomalous
# fits, which walk a flat valley (tests/test_torch_drivers_superc_lattice.py)
# and here stop at the L-BFGS-B step limit (cg_niter=1000) with chi^2 up
# to 2.1e-1 apart relative to the largest site's (ahm_disorder; 7.6e-2
# ahm_stack; the port on the CPU): printed, not held. At two iterations
# ahm_disorder's nine sites ended 5.2e-3 (dens), 4.8e-3 (docc) and 2.2e-3
# (phi) off the JAX package's on an H100 (5.0e-3, 4.1e-3, 2.7e-3 for the
# port on the CPU), and ahm_stack 9.1e-4 in phi on the CPU, where the
# normal-mode drivers end within 1e-7. Held: the first solve as for every
# driver; dens, docc and phi 1e-2 after two iterations.
TOL_LATTICE_SC = 1e-2
TOL_HARTREE = 1e-10
TOL_CHI0 = 1e-8
# (b) full width: the ed_ahm_stackU heterostructure (ahm_stripe.run_stack)
# with the driver's stack defaults (4 layers, U_min = U/2 on the first 2,
# nk=6, nkz=4: 144 k-points) at phase 9's superc width, Nbath=9 (Sz=0:
# 184,756 states in 11 blocks), one iteration, the package defaults
# (arpack, native). Its first solve is held to the JAX package's CPU
# solve of the same config (python3 chip_reference.py --case stack), and
# each layer's ground-state sectors are solved again per site.
STACK_CFG = dict(norb=1, nspin=1, nbath=9, ed_mode="superc", uloc=(-3.0,),
                 deltasc=0.1, beta=100.0, lmats=1024, lreal=256, nloop=1,
                 dmft_error=1e-12, ed_verbose=0)
TOL_STACK_EGS = 1e-8
TOL_STACK_OBS = 1e-6
# the JAX package's CPU solve of STACK_CFG (python3 chip_reference.py
# --case stack; 805 s on the CPU): the first solve per layer
STACK_JAX = {'egs': [-11.372637028585594,
                     -11.372637028585567,
                     -11.527131126028321,
                     -11.527131126028237],
             'dens': [[1.0000000000000042],
                      [1.000000000000008],
                      [0.9999999999999771],
                      [0.9999999999999947]],
             'docc': [[0.32357712316034715],
                      [0.32357712316034853],
                      [0.3797120424903412],
                      [0.3797120424903512]],
             'phi': [[0.12493229958392171],
                     [0.12493229958392926],
                     [0.19204422585475894],
                     [0.19204422585475334]]}


# Phase 16: the meshes (ROADMAP.md §1 item 4) and dtype="float32" (item 5).
# The card machine has one GPU, so the row-sharded route runs as two rank
# processes sharing cuda:0 in a gloo group (gloo carries the collectives
# through host copies); their times are not multi-GPU times.
# (a) one fixed-bath EDSolver(mesh=rows 2).solve of phase 7's config and
# bath, native and ozaki5x7, over the ground state's sector and its N+-1
# neighbours (ed_sectors with phase 7's sectors_list.restart: at T=0 the
# result is the whole sweep's), every one of them above the default
# shard_dim_threshold, so all sharded (the (6,6) sector: 462 of its 924
# rows per rank); held to phase 7's single-process solves at the bounds
# of tests/test_parallel.py:145-155, and one sharded (6,6) matvec under
# ozaki5x7 bitwise to the unsharded one
P16_RANKS = 2
P16_TIMEOUT = 420.0
# phase 7's ozaki5x7 solve runs in this directory of its own: phase 16's
# ranks must leave the same file names and line counts
P7_OZAKI_DIR = "arpack_ozaki5x7"
TOL_P16_EGS = 1e-10
TOL_P16_G = 1e-8
TOL_P16_SIGMA = 1e-6
TOL_P16_OBS = 1e-9
P16_MATVECS = 20
# the native sharded matvec against the unsharded one (row slices of one
# f64 GEMM: the same sums, perhaps not the same blocking)
TOL_P16_MATVEC_REL = 1e-12
# (b) one LatticeEDSolver(mesh=sites 2).solve of phase 13(a)'s flake
# (Nbath=6, three classes on two site ranks: the sites axis pads) on the
# initial baths perturbed from a seed, held to the single-process batched
# solve at tests/test_parallel.py:264-270's bounds
TOL_P16_SITES_EGS = 1e-9
TOL_P16_SITES_G = 1e-7
TOL_P16_SITES_OBS = 1e-8
# (c) phase 7's native solve in dtype="float32": egs within the JAX
# package's float32 tolerance (diag.py:211) of the float64 egs; and the
# float32 thick restart of the (6,6) sector on the initial bath, held to
# the JAX package's float32 egs of the same sweep (python3
# chip_reference.py --case f32) at the same tolerance
TOL_F32_EGS_REL = 1e-5
# (its float64 egs there: -13.328425446921548; 14.0 s and 59.4 s on the
# CPU)
F32_JAX_EGS = -13.32846450805664


# Phase 17: the port's benchmark entry points (dmft_ed_tpu_torch.benches)
# at the ed_nano scale: bench.py's problem at Nbath=13, the half-filled
# (7,7) sector of Ns=14 (one 3432x3432 block, 11,778,624 states).
# (a) benches.bench.run, 30 steps, under native, ozaki5x7 and float32, one
# warm-up and P17_REPEATS timed runs each (the entry point's default is 3;
# cut to keep the script near half its limit); the native alphas and
# betas held to the JAX package's CPU values (python3 chip_reference.py
# --case bench13), ozaki5x7 and float32 to native. Differences are
# max_j |d alpha_j|, |d beta_j| over the largest |beta| (the recurrence's
# scale; a relative difference per alpha would divide by alphas near 0).
# Measured on an H100 (PERF.md): 7.8e-13, 8.4e-12 and 9.5e-8; the bounds
# are ten times those, tightened from 1e-10, 1e-8 and 1e-4.
P17_NBATH = 13
P17_NITER = 30
P17_REPEATS = 1
TOL_P17_NATIVE = 1e-11
TOL_P17_OZAKI = 1e-10
TOL_P17_F32 = 1e-6
# (c) the (7,7) ground state by the thick restart (benches.bench.
# ground_state: lanczos.eigs_lanczos_op, one eigenpair, diag's basis rule),
# native and ozaki5x7, held to the JAX package's egs of the same restart
# from the same start vector and to each other (absolute). Measured on an
# H100: native 1.1e-13, ozaki5x7 4.6e-11 (both within 1e-9, the bound
# first set); held at ten times those, the pair at the ozaki5x7 bound.
TOL_P17_EGS = 1e-12
TOL_P17_EGS_OZAKI = 5e-10
# (d) benches.bench_scaling on 1 and 2 ranks sharing the card (gloo,
# native): the sharded alphas and betas against the single process
# (measured 9.8e-17 on an H100; bound tightened from 1e-12)
P17_SCALING = dict(niter=6, repeats=1)
TOL_P17_SHARDED = 1e-15
# python3 chip_reference.py --case bench13 (the JAX package on the CPU:
# the loop 41.8 s, the restart 373.5 s on an 8-core host)
BENCH13_JAX = dict(
    alphas=[0.0007001217418281723, 0.0021269597548037615,
        0.0025660413311520388, 0.007772536464962845, 0.01252978597015141,
        0.024191654489132446, 0.04876477946340242, 0.07455707934222433,
        0.10102875952005548, 0.12060180388590945, 0.13655346359053425,
        0.14711870394260343, 0.16927782090601415, 0.19628723418008712,
        0.18937893843837034, 0.13407908902375812, 0.061034487118882895,
        0.017310464942785896, -0.0054013854273793115, -0.027013828282440495,
        -0.06019631900760259, -0.10651545580697983, -0.15950650426231938,
        -0.197380627294049, -0.16893931271358434, -0.08934907450756457,
        0.014424473302984098, 0.07627995481206591, 0.05836952677137259,
        0.003831818676243765],
    betas=[2.650204113256758, 3.4285615497069006, 3.948012350457089,
        4.289288668940658, 4.54587053801053, 4.741308462278421,
        4.889583697844653, 5.001600724377374, 5.076911780089969,
        5.126144270679571, 5.160087565331989, 5.176159653447503,
        5.188405650720739, 5.20720111274799, 5.211243935983311,
        5.198827787817805, 5.180728972512298, 5.176383096414613,
        5.175820472131988, 5.1753823747290815, 5.174489984168913,
        5.172845320842024, 5.173198468512063, 5.183269971225859,
        5.189999484322845, 5.18216976639449, 5.1735457078793505,
        5.162276103808036, 5.144753722457418, 5.121927978231394],
    egs=-10.34660117602844, matvecs=199, dim=11778624, nnz=176679360)


def build_kernels():
    """Compile every csrc/*.cu at once (one nvcc each, all started
    together); print each ptxas report and the tensor-core instructions in
    the built library's SASS. Returns {name: tensor-core instruction
    count}."""
    from dmft_ed_tpu_torch.kernels import KERNELS, _build
    t0 = time.time()

    def one(name):
        path = _build.build(name)
        return name, time.time() - t0, path

    with ThreadPoolExecutor(max_workers=len(KERNELS)) as ex:
        done = list(ex.map(one, KERNELS))
    counts = {}
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    for name, secs, path in done:
        print(f"built {name} in {secs:.1f} s -> {os.path.relpath(path, REPO)}")
        with open(path + ".log") as fh:
            print(fh.read().strip())
        sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        ops = {op: len(re.findall(rf"\b{re.escape(op)}\b", sass))
               for op in ("IGMMA", "IMMA", "IDP.4A")}
        print(f"{name} SASS: {json.dumps(ops)}")
        counts[name] = ops["IGMMA"] + ops["IMMA"]
    return counts


def time_ms(fn, reps: int) -> float:
    """Mean device ms per call over `reps` calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_us(fn, reps: int) -> float:
    """Mean host microseconds per call over `reps` calls, with the card
    synchronised before them and not between them: what one call costs
    the host until it returns (its launch cost, while the card keeps up
    or the launch queue has room)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def digit_matmul_ops(P, M, K, N):
    """int8 operations of the P(P+1)/2 digit-pair products (true K)."""
    return 2.0 * (P * (P + 1) // 2) * M * N * K


def digit_matmul_bound_ms(P, M, K, N):
    """(bound_ms, bound_by): the operations over the int8 peak, vs the
    digit stacks read once, the scales read once and the f64 output
    written once over the memory rate."""
    nbytes = P * M * K + P * K * N + 8 * (M + N) + 8 * M * N
    t_ops = digit_matmul_ops(P, M, K, N) / INT8_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def digit_matmul_cases(device, cases, reps: int = 10, timed: bool = True):
    """Kernel vs plain version (and vs the f64 product) for each
    (label, A, B, P, bits, kchunk, pad) case, kchunk None for the schedule
    that ozaki._schedule picks (the concatenated one at these K) or a
    forced pairwise chunk length, pad None or a nonzero digit written into
    both stacks' pad columns (which must not change the result). Returns
    one record per case; raises, after every case has run, if any
    disagreed."""
    import torch
    from dmft_ed_tpu_torch import ozaki
    from dmft_ed_tpu_torch.kernels import digit_matmul, digit_matmul_plain
    out, bad = [], []
    for label, A, Bm, P, B, forced, pad in cases:
        (M, K), N = A.shape, Bm.shape[1]
        ad, sa = ozaki._left_digits(A, P, B)
        bd, sb = ozaki._right_digits(Bm, P, B)
        if pad is not None:
            assert ad.shape[2] > K, (label, K)
            ad[:, :, K:] = pad
            bd[:, :, K:] = -pad
        rs, cs = sa.reshape(-1), sb.reshape(-1)
        pairwise, kchunk = ozaki._schedule(K, P, B)
        assert not pairwise, (label, K)
        if forced is not None:
            pairwise, kchunk = True, forced

        def kern():
            return digit_matmul(ad, bd, rs, cs, B, pairwise, kchunk, k=K)

        def plain():
            return digit_matmul_plain(ad, bd, rs, cs, B, pairwise, kchunk,
                                      k=K)

        got, ref = kern(), plain()
        exact = A @ Bm
        if device.type == "cuda":
            torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err_plain = float((got - ref).abs().max())
        rel_exact = float((got - exact).abs().max()) / max(
            float(exact.abs().max()), 1e-300)
        bitwise = bool(torch.equal(got, ref))
        rec = dict(label=label, shape=(M, K, N), Kp=int(ad.shape[2]), P=P,
                   B=B, pairwise=pairwise, kchunk=kchunk,
                   max_abs_err=err_plain, bitwise=bitwise,
                   rel_err_vs_f64=rel_exact)
        rec["bound_ms"], rec["bound_by"] = digit_matmul_bound_ms(P, M, K, N)
        if timed:
            rec["ms"] = time_ms(kern, reps)
            rec["host_us"] = host_us(kern, 5 * reps)
            rec["plain_ms"] = time_ms(plain, max(2, reps // 4))
            rec["library_ms"] = time_ms(lambda: A @ Bm, reps)
            rec["tops"] = digit_matmul_ops(P, M, K, N) / rec["ms"] / 1e9
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        print("digit_matmul", json.dumps(rec))
        if not bitwise:
            bad.append(f"{label}: kernel differs from plain by up to "
                       f"{err_plain:.3e} (max|out| {scale:.3e})")
        if not rel_exact <= TOL_EXACT_REL:
            bad.append(f"{label}: kernel vs f64 product relative "
                       f"{rel_exact:.3e} > {TOL_EXACT_REL:g}")
        out.append(rec)
    if bad:
        raise AssertionError("; ".join(bad))
    return out


# phase-2 cases whose operands phase 2 also splits with digit_split (both
# orientations): the 924 class, the superc 252 / 210 classes, the Nbath=13
# 3432 class
SPLIT_LABELS = ("dw K=924", "up K=924", "superc dw K=252", "superc up K=252",
                "superc pair c_up 252->210 (V @ C^T)",
                "superc pair cdg_up 210->252 (V @ C^T)",
                "bench dw K=3432", "bench up K=3432")


def digit_split_bound_ms(P, rows, k):
    """The f64 operand read once, the P int8 planes (Kp columns) and the
    f64 scales written once, over the memory rate."""
    from dmft_ed_tpu_torch.ozaki import kpad
    return 1e3 * (8 * rows * k + P * rows * kpad(k) + 8 * rows) \
        / HBM_BYTES_PER_S


def digit_split_cases(device, cases, reps: int = 20):
    """The split kernel against its plain version, bitwise (digits, pad and
    scales), for both operands of every phase-2 case in SPLIT_LABELS: the
    left operand A [m, k] scaled per row and the right operand B [k, n]
    scaled per column; the kernel's ms, the plain version's and the byte
    bound. Returns one record per split; raises, after every split has
    run, if any disagreed."""
    import torch
    from dmft_ed_tpu_torch.kernels import digit_split, digit_split_plain
    out, bad = [], []
    for label, A, Bm, P, B, _, _ in cases:
        if label not in SPLIT_LABELS:
            continue
        for side, X, right in (("left", A, False), ("right", Bm, True)):
            n0 = digit_split.launches
            got = digit_split(X, P, B, right)
            launched = digit_split.launches - n0
            ref = digit_split_plain(X, P, B, right)
            if device.type == "cuda":
                torch.cuda.synchronize()
            bitwise = bool(torch.equal(got[0], ref[0])
                           and torch.equal(got[1], ref[1]))
            rows, k = (X.shape[1], X.shape[0]) if right else X.shape
            rec = dict(label=f"{label} {side}", shape=tuple(X.shape), P=P,
                       B=B, bitwise=bitwise, launches=launched,
                       bound_ms=digit_split_bound_ms(P, rows, k))
            if device.type == "cuda":
                rec["ms"] = time_ms(lambda: digit_split(X, P, B, right), reps)
                rec["plain_ms"] = time_ms(
                    lambda: digit_split_plain(X, P, B, right), reps // 4)
                rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            print("digit_split", json.dumps(rec))
            if not bitwise:
                bad.append(f"{label} {side}: split differs from plain")
            if launched != (1 if device.type == "cuda" else 0):
                bad.append(f"{label} {side}: {launched} launches")
            out.append(rec)
    if bad:
        raise AssertionError("; ".join(bad))
    return out


def main_path_shapes(cfg_kwargs):
    """The digit-matmul shapes of one lockstep step of the main path:
    (cfg, dw_cols, up_rows), with dw_cols[n] the dw product's column
    count (every dup of the sectors sharing n_dw = n) and up_rows[n] the
    up product's row count (every ddw of the sectors sharing n_up = n),
    over the Krylov-class sectors (dim > lanc_dim_threshold)."""
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.sectors import sector_table
    cfg = EDConfig(**cfg_kwargs).validate()
    dw_cols, up_rows = {}, {}
    for sec in sector_table(cfg).sectors:
        if sec.dim <= cfg.lanc_dim_threshold:
            continue
        b = sec.blocks[0]
        dw_cols[b.ndw] = dw_cols.get(b.ndw, 0) + b.dup
        up_rows[b.nup] = up_rows.get(b.nup, 0) + b.ddw
    return cfg, dw_cols, up_rows


def kernel_cases(device, cfg_kwargs):
    """Phase-2 operands: for every per-spin dimension class K = C(Ns, n)
    of the main path (n = 0 .. Ns/2 of one spin species), its two product
    families at 5x7 -- H_dw(n) @ [V | ...] over the columns of every
    sector sharing n_dw, and [V; ...] @ H_up(n)^T over their rows -- with
    the main path's own per-spin operators on the initial bath; the 924
    class at 6x6; a ragged shape; and the pairwise schedule forced with
    chunks of 8 and 39; the ragged shape again with nonzero pad columns.
    Krylov-like V from a seed. The n = 0 operators are
    the 1x1 zero matrix, so that class takes a random 1x1 operator. Then
    the thick restart's zero-embedded operands and the fused product."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.bath import init_bath
    from dmft_ed_tpu_torch.hamiltonian import build_sector_hamiltonian
    from dmft_ed_tpu_torch.sectors import sector_table
    cfg, dw_cols, up_rows = main_path_shapes(cfg_kwargs)
    hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    bath = init_bath(cfg, hloc)
    tab = sector_table(cfg)
    g = torch.Generator().manual_seed(1234)

    def randn(*shape):
        return torch.randn(*shape, dtype=torch.float64, generator=g).to(
            device)

    def op(nup, ndw, spin):
        ham = build_sector_hamiltonian(cfg, tab.get(nup, ndw), bath, hloc)
        return torch.as_tensor((ham.hdw if spin == "dw" else ham.hup)[0]
                               .to_dense(), dtype=torch.float64,
                               device=device)

    out = []
    for n in range(cfg.ns // 2 + 1):
        H_dw, H_up = op(0, n, "dw"), op(n, 0, "up")
        if n == 0:
            H_dw, H_up = randn(1, 1), randn(1, 1)
        K = H_dw.shape[0]
        dw = (f"dw K={K}", H_dw, randn(K, dw_cols[n]), 5, 7, None, None)
        up = (f"up K={K}", randn(up_rows[n], K), H_up.T, 5, 7, None, None)
        out += [dw, up]
        if n == cfg.ns // 2:
            out += [(c[0] + " 6x6",) + c[1:3] + (6, 6, None, None)
                    for c in (dw, up)]
            # phase 16's row-sharded (6,6) products on two ranks: a rank's
            # Hdw rows against the gathered vector, its local rows of the
            # vector against Hup^T
            h, V = K // 2, randn(K, K) / K
            out += [(f"rows dw {h} of {K} (Hdw rows @ gathered V)",
                     H_dw[:h].contiguous(), V, 5, 7, None, None),
                    (f"rows up {h} of {K} (local V rows @ Hup^T)",
                     V[:h].contiguous(), H_up.T.contiguous(), 5, 7, None,
                     None)]
    Ar, Br = randn(300, 129), randn(129, 501)
    out += [("ragged 300x129x501", Ar, Br, 5, 7, None, None),
            ("ragged, nonzero pad", Ar, Br, 5, 7, None, 37),
            ("pairwise kchunk=8", Ar, Br, 5, 7, 8, None),
            ("pairwise kchunk=39", Ar, Br, 5, 7, 39, None),
            ("pairwise kchunk=39, nonzero pad", Ar, Br, 5, 7, 39, 37)]
    # the thick restart's stacked members at the 2^20 bucket: a 792-dim
    # spin operator zero-embedded in 924x924 against a 924x924 member
    # vector whose pad rows (dw) or columns (up) are zero
    from dmft_ed_tpu_torch import ozaki
    n_emb = cfg.ns // 2 - 1                        # C(12, 5) = 792
    K = op(0, cfg.ns // 2, "dw").shape[0]
    Hd, Hu = op(0, n_emb, "dw"), op(n_emb, 0, "up")
    e = Hd.shape[0]
    Hd_p = torch.zeros((K, K), dtype=torch.float64, device=device)
    Hd_p[:e, :e] = Hd
    Hu_p = torch.zeros_like(Hd_p)
    Hu_p[:e, :e] = Hu
    V = randn(K, K) / K
    V_dw, V_up = V.clone(), V.clone()
    V_dw[e:] = 0
    V_up[:, e:] = 0
    out += [(f"dw embedded {e} in {K}", Hd_p, V_dw, 5, 7, None, None),
            (f"up embedded {e} in {K}", V_up, Hu_p.T, 5, 7, None, None)]
    # fused_two_sided's product at the 924 class: [Hdw | lam V] @
    # [lam V ; HupT], K = 2 * 924
    H_dw, H_upT = op(0, cfg.ns // 2, "dw"), op(cfg.ns // 2, 0, "up").T
    lam = ozaki.fused_lambda(H_dw, H_upT, V)
    out.append((f"fused K={2 * K}", torch.cat([H_dw, lam * V], dim=1),
                torch.cat([lam * V, H_upT], dim=0), 5, 7, None, None))
    return out


def main_path(device, cfg_kwargs, run_kwargs, loop, hloc=None):
    """The port's DMFT loop ``loop.run`` (a module of ``models``) through
    its public entry points, with per-iteration seconds, stage splits and
    launches printed; `hloc` is the model's local Hamiltonian (zero by
    default). Returns (result, per-iteration (dens, docc, egs, phi),
    launches per kernel)."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.solver import EDSolver
    cfg = EDConfig(**cfg_kwargs).validate()
    if hloc is None:
        hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    solver = EDSolver(cfg, hloc, log=lambda m: None, device=device)
    marks, snaps, obs, counts = [], [], [], []

    def note():
        if device.type == "cuda":
            torch.cuda.synchronize()
        marks.append(time.time())
        snaps.append(solver.timers.snapshot())
        counts.append({name: fn.launches for name, fn in KERNELS.items()})
        if solver.result is not None:
            o = solver.result.observables
            obs.append((o.dens.copy(), o.docc.copy(), solver.result.egs,
                        None if o.phisc is None else o.phisc.copy()))

    def log(msg):
        if msg.startswith("--- DMFT loop"):
            note()

    reset_launches()
    t0 = time.time()
    r = loop.run(cfg, log=log, solver=solver, device=device, **run_kwargs)
    note()
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    iter_s = [marks[i + 1] - marks[i] for i in range(len(marks) - 1)]
    stages = [{k: snaps[i + 1][k] - snaps[i].get(k, 0.0)
               for k in snaps[i + 1]
               if snaps[i + 1][k] - snaps[i].get(k, 0.0) > 1e-3}
              for i in range(len(iter_s))]
    print(f"{loop.__name__}: {r.iterations} DMFT iterations in "
          f"{marks[-1] - t0:.3f} s")
    for i, (s, st, (dens, docc, egs, phi)) in enumerate(zip(iter_s, stages,
                                                            obs)):
        n_i = {k: counts[i + 1][k] - counts[i][k] for k in counts[i]}
        print(f"  iteration {i + 1}: {s:.3f} s dens={dens.tolist()} "
              f"docc={docc.tolist()} "
              + ("" if phi is None else f"phi={phi.tolist()} ")
              + f"egs={egs!r} launches={n_i}\n    stages "
              + json.dumps({k: round(v, 3) for k, v in sorted(st.items())}))
    print(f"  launches={launches}")
    return r, obs, launches


def check_main_path(r, obs, launches):
    """Finite results; half filling (dens = 1 within 1e-6) and
    0 < docc < 1/4 in every iteration; every kernel launched.

    The first bath is particle-hole symmetric. The chi^2 fit does not impose
    that symmetry, so later iterations fill only approximately: 3.7e-7 off
    after one fit at Nbath=11 on an H100 (PERF.md); the JAX package at
    Nbath=5 on the CPU ends 1.1e-4 off after one fit."""
    import numpy as np
    for name, arr in (("smats", r.smats), ("gmats", r.gmats),
                      ("bath", r.bath), ("dens", r.dens), ("docc", r.docc)):
        if not np.all(np.isfinite(arr)):
            raise AssertionError(f"main path: non-finite {name}")
    if not np.isfinite(r.egs):
        raise AssertionError("main path: non-finite egs")
    for i, (dens, docc, _, _) in enumerate(obs):
        if not np.all(np.abs(dens - 1.0) <= 1e-6):
            raise AssertionError(f"main path: iteration {i + 1} dens {dens} "
                                 "is not half filling within 1e-6")
        if not np.all((docc > 0.0) & (docc < 0.25)):
            raise AssertionError(f"main path: iteration {i + 1} docc {docc} "
                                 "outside (0, 0.25)")
    for name in OZAKI_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"main path never launched kernel {name}")


def precision_check(device, cfg_kwargs, bath):
    """One fixed-bath solve with native f64 and with ozaki5x7 products."""
    import numpy as np
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.solver import EDSolver
    res = {}
    for prec in ("native", "ozaki5x7"):
        cfg = EDConfig(**dict(cfg_kwargs, matmul_precision=prec)).validate()
        hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
        t0 = time.time()
        res[prec] = EDSolver(cfg, hloc, log=lambda m: None,
                             device=device).solve(bath)
        print(f"fixed-bath solve {prec}: {time.time() - t0:.3f} s "
              f"egs={res[prec].egs!r} "
              f"docc={res[prec].observables.docc.tolist()}")
    d_egs = abs(res["native"].egs - res["ozaki5x7"].egs)
    d_docc = float(np.max(np.abs(res["native"].observables.docc
                                 - res["ozaki5x7"].observables.docc)))
    d_g = float(np.max(np.abs(res["native"].gmats - res["ozaki5x7"].gmats)))
    print(f"native vs ozaki5x7: |d egs|={d_egs:.3e} (bound {TOL_EGS:g}) "
          f"|d docc|={d_docc:.3e} (bound {TOL_DOCC:g}) "
          f"max|d gmats|={d_g:.3e}")
    if not (d_egs <= TOL_EGS and d_docc <= TOL_DOCC):
        raise AssertionError("native and ozaki5x7 solves disagree")
    return res["native"].egs


def check_canonical(r):
    """Finite results, CANON_NLOOP iterations, the final dens within 1e-3
    of 1 (the loop starts off half filling: the port's second iteration
    sits at 1.0014 on an H100), and docc within TOL_CANON of the JAX
    package's after the same count."""
    import numpy as np
    for name, arr in (("smats", r.smats), ("gmats", r.gmats),
                      ("bath", r.bath), ("dens", r.dens), ("docc", r.docc)):
        if not np.all(np.isfinite(arr)):
            raise AssertionError(f"canonical loop: non-finite {name}")
    if r.iterations != CANON_NLOOP:
        raise AssertionError(f"canonical loop: {r.iterations} iterations, "
                             f"not {CANON_NLOOP}")
    if not np.all(np.abs(r.dens - 1.0) <= 1e-3):
        raise AssertionError(f"canonical loop: final dens {r.dens} is not 1 "
                             "within 1e-3")
    docc = float(r.docc[0])
    d = abs(docc - CANON_JAX_DOCC)
    print(f"canonical loop: {r.iterations} iterations, error {r.error:.3e}, "
          f"docc={docc!r} (JAX {CANON_JAX_DOCC!r}, |d| {d:.3e}, bound "
          f"{TOL_CANON:g})")
    if not d <= TOL_CANON:
        raise AssertionError(f"canonical loop: docc {docc} is {d:.3e} off "
                             "the JAX package's")


def arpack_solve(device, bath, egs_lanczos):
    """One fixed-bath EDSolver.solve of ARPACK_CFG with native and with
    ozaki5x7 products: wall time, diag stages, the thick restart's
    expansions and matvecs per p2 bucket and per serial sector, and the
    kernel's launches; egs against the plain-Lanczos native egs of the same
    bath, and native against ozaki5x7. Returns the ozaki solve's launches
    per kernel, and the results and (seconds, peak GiB) of both solves
    (phase 16 holds its sharded solves to them). The ozaki5x7 solve runs
    in ``arpack_ozaki5x7/`` with the native solve's sectors_list.restart,
    so that its files stand alone (phase 16 compares the ranks' files
    with them)."""
    import shutil
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.solver import EDSolver
    res, launches, seconds = {}, {}, {}
    for prec in ("native", "ozaki5x7"):
        cut = ARPACK_OZAKI_SECTORS if prec != "native" else {}
        cfg = EDConfig(**dict(ARPACK_CFG, matmul_precision=prec,
                              ed_verbose=3, **cut)).validate()
        hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
        lines = []
        solver = EDSolver(cfg, hloc, device=device, log=lambda m: lines.append(
            m) if m.startswith("thick restart") else None)
        here = os.getcwd()
        if prec != "native":
            os.mkdir(P7_OZAKI_DIR)
            shutil.copy("sectors_list.restart", P7_OZAKI_DIR)
            os.chdir(P7_OZAKI_DIR)
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res[prec] = solver.solve(bath)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.time() - t0
        os.chdir(here)
        launches[prec] = {name: fn.launches for name, fn in KERNELS.items()}
        seconds[prec] = (dt, _peak_gib())
        stages = {k: round(v, 3) for k, v in sorted(solver.timers.acc.items())}
        print(f"arpack solve {prec}: {dt:.3f} s egs={res[prec].egs!r} "
              f"docc={res[prec].observables.docc.tolist()} "
              f"launches={launches[prec]}\n  stages {json.dumps(stages)}")
        for ln in lines:
            if "bucket" in ln or "dim=" in ln and int(ln.split("dim=")[1]
                                                      .split()[0]) > 2 ** 17:
                print("  " + ln)
        print(f"  thick-restart solves: {len(lines)}")
    a, o = res["native"], res["ozaki5x7"]
    d_meth = abs(a.egs - egs_lanczos)
    d_egs = abs(a.egs - o.egs)
    d_docc = float(np.max(np.abs(a.observables.docc - o.observables.docc)))
    chi_a, chi_o = a.chi_spin[1], o.chi_spin[1]
    d_chi = float(np.max(np.abs(chi_a - chi_o))) / float(np.max(np.abs(chi_a)))
    print(f"arpack vs lanczos (native): |d egs|={d_meth:.3e} (bound "
          f"{TOL_EGS_METHODS:g}); native vs ozaki5x7: |d egs|={d_egs:.3e} "
          f"(bound {TOL_EGS:g}) |d docc|={d_docc:.3e} (bound {TOL_DOCC:g}) "
          f"max|d chi_spin(iv)|/max|chi_spin(iv)|={d_chi:.3e} (bound "
          f"{TOL_CHI_REL:g})")
    bad = []
    if not d_meth <= TOL_EGS_METHODS:
        bad.append("arpack and lanczos egs disagree")
    if not (d_egs <= TOL_EGS and d_docc <= TOL_DOCC and d_chi <= TOL_CHI_REL):
        bad.append("native and ozaki5x7 arpack solves disagree")
    if not all(np.all(np.isfinite(x)) for r in res.values()
               for x in r.chi_spin):
        bad.append("non-finite chi_spin")
    for name in OZAKI_KERNELS:
        if launches["ozaki5x7"][name] <= 0:
            bad.append(f"the ozaki5x7 arpack solve never launched {name}")
    if bad:
        raise AssertionError("; ".join(bad))
    return launches["ozaki5x7"], res, seconds


def superc_kernel_cases(device):
    """Phase-2 operands at phase 9's classes, from the Sz=0 sector of
    SUPERC_CFG on its initial bath (blocks (n, n), per-spin dims C(10, n)):
    the 252 block class on both sides (H_dw @ V, V @ H_up^T), and the
    largest pairing classes as the mix terms run them -- V @ C_up^T, then
    C_dw @ W, for the annihilating pair 252 -> 210 and the creating pair
    210 -> 252. Krylov-like V and W from a seed."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.bath import init_bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.hamiltonian import build_sector_hamiltonian
    from dmft_ed_tpu_torch.sectors import sector_table
    cfg = EDConfig(**SUPERC_CFG).validate()
    hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    sec = sector_table(cfg).get(0)
    ham = build_sector_hamiltonian(cfg, sec, init_bath(cfg, hloc), hloc)
    g = torch.Generator().manual_seed(4321)

    def randn(*shape):
        return (torch.randn(*shape, dtype=torch.float64, generator=g)
                / shape[0] ** 0.5).to(device)

    def dense(coo):
        return torch.as_tensor(coo.to_dense(), dtype=torch.float64,
                               device=device)

    half = cfg.ns // 2
    bi = next(i for i, b in enumerate(sec.blocks) if b.nup == half)
    K = sec.blocks[bi].dup
    out = [(f"superc dw K={K}", dense(ham.hdw[bi]), randn(K, K), 5, 7,
            None, None),
           (f"superc up K={K}", randn(K, K), dense(ham.hup[bi]).T, 5, 7,
            None, None)]
    for src, dst, what in ((half, half - 1, "c"), (half - 1, half, "cdg")):
        si = next(i for i, b in enumerate(sec.blocks) if b.nup == src)
        di = next(i for i, b in enumerate(sec.blocks) if b.nup == dst)
        t = next(t for t in ham.mix if t.src == si and t.dst == di)
        ku, kd = t.up.shape[1], t.up.shape[0]
        out += [(f"superc pair {what}_up {ku}->{kd} (V @ C^T)",
                 randn(ku, ku), dense(t.up).T, 5, 7, None, None),
                (f"superc pair {what}_dw {ku}->{kd} (C @ W)",
                 dense(t.dw), randn(ku, kd), 5, 7, None, None)]
    return out


def check_ahm(r):
    """Finite results; converged; phi and m2 inside AHM_WINDOWS; dens
    within TOL_AHM_DENS of 1."""
    import numpy as np
    for name, arr in (("smats", r.smats), ("smats_an", r.smats_an),
                      ("gmats", r.gmats), ("fmats", r.fmats),
                      ("bath", r.bath), ("dens", r.dens), ("docc", r.docc),
                      ("phisc", r.phisc)):
        if not np.all(np.isfinite(arr)):
            raise AssertionError(f"ahm loop: non-finite {name}")
    dens = float(r.dens[0])
    got = ahm_held(float(r.docc[0]), float(r.phisc[0]), dens)
    print(f"ahm loop: converged={r.converged} after {r.iterations} "
          f"iterations, error {r.error:.3e}, docc={float(r.docc[0])!r} "
          f"dens={dens!r} (bound |dens - 1| <= {TOL_AHM_DENS:g}) "
          + " ".join(f"{k}={got[k]!r} (window {AHM_WINDOWS[k]})"
                     for k in got))
    bad = [k for k in got
           if not AHM_WINDOWS[k][0] <= got[k] <= AHM_WINDOWS[k][1]]
    if not abs(dens - 1.0) <= TOL_AHM_DENS:
        bad.append("dens")
    if not r.converged:
        bad.append("not converged")
    if bad:
        raise AssertionError(f"ahm loop: {bad}")


def superc_solve(device):
    """Phase 9a: one fixed-bath EDSolver.solve of SUPERC_CFG on its initial
    bath with lanc_method arpack and lanczos (native): wall time and stage
    timers of each; egs, phi and docc held to each other and egs to the JAX
    package's."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.solver import EDSolver
    res = {}
    for method in ("arpack", "lanczos"):
        cfg = EDConfig(**dict(SUPERC_CFG, lanc_method=method)).validate()
        hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
        solver = EDSolver(cfg, hloc, device=device, log=lambda m: None)
        bath = solver.init_solver()
        reset_launches()
        t0 = time.time()
        r = solver.solve(bath)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.time() - t0
        res[method] = r
        o = r.observables
        stages = {k: round(v, 3) for k, v in sorted(solver.timers.acc.items())}
        print(f"superc solve {method}: {dt:.3f} s egs={r.egs!r} "
              f"phi={o.phisc.tolist()} docc={o.docc.tolist()} "
              f"dens={o.dens.tolist()} launches="
              f"{ {n: fn.launches for n, fn in KERNELS.items()} }\n"
              f"  stages {json.dumps(stages)}")
    a, b = res["arpack"], res["lanczos"]
    d_egs = abs(a.egs - b.egs)
    d_phi = float(np.max(np.abs(a.observables.phisc - b.observables.phisc)))
    d_docc = float(np.max(np.abs(a.observables.docc - b.observables.docc)))
    d_jax = abs(a.egs - SUPERC_EGS_JAX)
    print(f"superc arpack vs lanczos: |d egs|={d_egs:.3e} (bound "
          f"{TOL_EGS_METHODS:g}) |d phi|={d_phi:.3e} |d docc|={d_docc:.3e} "
          f"(bound {TOL_OBS_METHODS:g}); arpack vs the JAX package's egs: "
          f"|d egs|={d_jax:.3e} (bound {TOL_EGS_METHODS:g})")
    bad = []
    if not d_egs <= TOL_EGS_METHODS:
        bad.append("arpack and lanczos egs disagree")
    if not (d_phi <= TOL_OBS_METHODS and d_docc <= TOL_OBS_METHODS):
        bad.append("arpack and lanczos phi/docc disagree")
    if not d_jax <= TOL_EGS_METHODS:
        bad.append("egs disagrees with the JAX package's")
    for r in res.values():
        for f in ("gmats", "fmats", "smats", "smats_an", "greal", "freal"):
            if not np.all(np.isfinite(getattr(r, f))):
                bad.append(f"non-finite {f}")
    if bad:
        raise AssertionError("superc solve: " + "; ".join(bad))


def superc_operator(device):
    """Phase 9b: make_matvec_op of SUPERC_CFG's Sz=0 sector under native
    and ozaki5x7 (operator_native_vs_ozaki, 24 leading coefficients).
    Returns the ozaki5x7 operator's kernel launches."""
    import numpy as np
    from dmft_ed_tpu_torch.bath import init_bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.hamiltonian import build_sector_hamiltonian
    from dmft_ed_tpu_torch.sectors import sector_table
    cfg = EDConfig(**SUPERC_CFG).validate()
    hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    sec = sector_table(cfg).get(0)
    t0 = time.time()
    ham = build_sector_hamiltonian(cfg, sec, init_bath(cfg, hloc), hloc)
    print(f"superc Sz=0 sector: dim {sec.dim}, {len(sec.blocks)} blocks, "
          f"{len(ham.mix)} mix terms, host build {time.time() - t0:.3f} s")
    return operator_native_vs_ozaki(device, cfg, ham, "superc operator",
                                    24, seed=90)


def operator_native_vs_ozaki(device, cfg, ham, label, nkry, seed):
    """make_matvec_op of one sector Hamiltonian under native and ozaki5x7,
    applied to 4 seeded vectors (one batched call) and run 40 Lanczos
    steps from one seeded v0; the two agree within TOL_EXACT_REL (vectors)
    and TOL_KRYLOV (leading `nkry` alpha, beta); the ozaki5x7 run's first
    two kernel calls per operand shape held bitwise against the plain
    version (held_kernel). Returns the ozaki5x7 operator's kernel
    launches (counts reset before the ozaki5x7 encode, read after its
    Lanczos run)."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.hamiltonian import (make_matvec_op, apply_op,
                                               flatten_blocks,
                                               unflatten_blocks)
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.lanczos import lanczos_tridiag_op
    dim = ham.sector.dim
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.normal(size=(4, dim)), device=device)
    v0 = torch.as_tensor(rng.normal(size=dim), device=device)
    v0 = v0 / torch.linalg.vector_norm(v0)

    def stamp():
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.time()

    out, launches, samples = {}, {}, []
    for prec in ("native", "ozaki5x7"):
        c = cfg.replace(matmul_precision=prec)
        reset_launches()
        with held_kernel() if prec != "native" \
                else contextlib.nullcontext([]) as hk:
            t0 = stamp()
            spec, arrays, blocks = make_matvec_op(ham, c, device)
            t1 = stamp()
            Y = flatten_blocks(apply_op(spec, arrays,
                                        unflatten_blocks(X, blocks)))
            t2 = stamp()
            al, be, ns = lanczos_tridiag_op(spec, blocks, arrays, v0, 40)
            t3 = stamp()
        samples += hk
        launches[prec] = {n: fn.launches for n, fn in KERNELS.items()}
        out[prec] = (Y, al.cpu().numpy(), be.cpu().numpy(), int(ns))
        print(f"{label} {prec}: encode {t1 - t0:.3f} s, apply to 4 "
              f"vectors {t2 - t1:.3f} s, 40 Lanczos steps {t3 - t2:.3f} s, "
              f"launches={launches[prec]}")
    (Yn, an, bn, nn), (Yo, ao, bo, no) = out["native"], out["ozaki5x7"]
    rel = float((Yn - Yo).abs().max()) / float(Yn.abs().max())
    d_kry = float(max(np.max(np.abs(an[:nkry] - ao[:nkry])),
                      np.max(np.abs(bn[:nkry] - bo[:nkry]))))
    print(f"{label} native vs ozaki5x7: max|d Hv|/max|Hv|={rel:.3e} "
          f"(bound {TOL_EXACT_REL:g}); leading {nkry} alpha, beta "
          f"max|d|={d_kry:.3e} (bound {TOL_KRYLOV:g}); steps {nn}, {no}; "
          f"kernel calls held bitwise: {len(samples)} "
          f"{[k for k, _ in samples]}")
    bad = []
    if not rel <= TOL_EXACT_REL:
        bad.append("H v differs")
    if not d_kry <= TOL_KRYLOV or nn < nkry or no < nkry:
        bad.append("Lanczos coefficients differ")
    for name in OZAKI_KERNELS:
        if launches["ozaki5x7"][name] <= 0:
            bad.append(f"the ozaki5x7 operator never launched {name}")
    if not samples:
        bad.append("no kernel call was held against the plain version")
    if bad:
        raise AssertionError(f"{label}: " + "; ".join(bad))
    return launches["ozaki5x7"]


@contextlib.contextmanager
def count_matvecs():
    """Counts the serial and stacked Krylov engines' sector matvecs per
    sector dim while active (each call of a matvec that
    lanczos._op_matvec returns, graphed or eager; one per member and
    step in a stacked chain); yields the {dim: calls} dict."""
    from dmft_ed_tpu_torch import lanczos
    counts = {}
    orig = lanczos._op_matvec

    def counting(spec, blocks, arrays, mesh=None):
        mv = orig(spec, blocks, arrays, mesh)
        d = sum(a * b for a, b in blocks)

        def counted(x):
            counts[d] = counts.get(d, 0) + 1
            return mv(x)
        return counted
    lanczos._op_matvec = counting
    try:
        yield counts
    finally:
        lanczos._op_matvec = orig


def matvec_calls(cfg, sec, bath, hloc, device):
    """(torch calls of one apply_op of sector `sec`, its wall ms eager,
    its wall ms replayed from the Krylov engines' CUDA graph, its mix
    entries): a TorchFunctionMode counts every torch function, operator
    and tensor method the matvec reaches. The graph's result must equal
    the eager one bitwise."""
    import torch
    from torch.overrides import TorchFunctionMode
    from dmft_ed_tpu_torch import lanczos
    from dmft_ed_tpu_torch.hamiltonian import (build_sector_hamiltonian,
                                               make_matvec_op, apply_op,
                                               flatten_blocks, is_complex,
                                               mix_entries, unflatten_blocks)

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    ham = build_sector_hamiltonian(cfg, sec, bath, hloc)
    spec, arrays, blocks = make_matvec_op(ham, cfg, device)
    V = unflatten_blocks(torch.randn(
        sec.dim, dtype=torch.complex128 if is_complex(spec)
        else torch.float64, device=device), blocks)
    apply_op(spec, arrays, V)
    with Count():
        apply_op(spec, arrays, V)
    x = flatten_blocks(V)

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(5):
            y = fn(x)
        torch.cuda.synchronize()
        return (time.time() - t0) / 5 * 1e3, y
    ms, y = wall_ms(lambda v: flatten_blocks(apply_op(
        spec, arrays, unflatten_blocks(v, blocks))))
    graphed = lanczos._op_matvec(spec, blocks, arrays)
    graphed(x)
    ms_g, y_g = wall_ms(graphed)
    if not torch.equal(y, y_g):
        raise AssertionError(f"sector {sec.qn}: the graphed matvec differs "
                             "from the eager one")
    return Count.n, ms, ms_g, len(mix_entries(spec))


def _stages(timers) -> str:
    return json.dumps({k: round(v, 3) for k, v in sorted(timers.acc.items())})


def _peak_gib():
    import torch
    return torch.cuda.max_memory_allocated() / 2 ** 30


def nonsu2_loop(device, loop, cfg_kwargs, run_kwargs, hloc, ref):
    """Phases 10-11: ``loop.run`` through main_path, with the matvecs and
    the torch calls per matvec of the largest sector and the peak device
    memory; held to the JAX package's values `ref` after the same count
    of iterations. Returns the launches per kernel."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.bath import replica_mask, unpack_bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.sectors import sector_table
    name = loop.__name__.split(".")[-1]
    cfg = EDConfig(**cfg_kwargs).validate()
    torch.cuda.reset_peak_memory_stats()
    with count_matvecs() as mv:
        r, _, launches = main_path(device, cfg_kwargs, run_kwargs, loop,
                                   hloc=hloc)
    peak = _peak_gib()
    sec = max(sector_table(cfg).sectors, key=lambda x: x.dim)
    mask = replica_mask(cfg, hloc) if cfg.bath_type == "replica" else None
    calls, ms, ms_g, nmix = matvec_calls(
        cfg, sec, unpack_bath(cfg, r.bath, mask), hloc, device)
    sud = float(np.linalg.norm(r.smats[0, 1]))
    d_dens = float(np.max(np.abs(r.dens - np.asarray(ref["dens"]))))
    d_sud = abs(sud - ref["smats_ud"]) / ref["smats_ud"]
    d_err = abs(r.error - ref["error"])
    print(f"{name}: largest sector dim {sec.dim} ({len(sec.blocks)} blocks, "
          f"{nmix} mix entries): {mv.get(sec.dim, 0)} matvecs, "
          f"{calls} torch calls and {ms:.3f} ms per matvec ({ms_g:.3f} ms "
          f"from its CUDA graph); peak device "
          f"memory {peak:.3f} GiB\n  dens={r.dens.tolist()} "
          f"|S_ud|={sud!r} error={r.error!r}; against the JAX package's: "
          f"max|d dens|={d_dens:.3e} (bound {TOL_LOOP_DENS:g}) "
          f"|d S_ud|/|S_ud|={d_sud:.3e} (bound {TOL_LOOP_SIGMA_REL:g}) "
          f"|d error|={d_err:.3e} (bound {TOL_LOOP_ERROR:g})")
    bad = [f"non-finite {f}" for f in ("smats", "gmats", "bath", "dens")
           if not np.all(np.isfinite(getattr(r, f)))]
    if r.iterations != cfg.nloop:
        bad.append(f"{r.iterations} iterations, not {cfg.nloop}")
    if not (d_dens <= TOL_LOOP_DENS and d_sud <= TOL_LOOP_SIGMA_REL
            and d_err <= TOL_LOOP_ERROR):
        bad.append("disagrees with the JAX package")
    if bad:
        raise AssertionError(f"{name} loop: " + "; ".join(bad))
    return launches


def jz_problem(cfg):
    """(hloc, bath) of phase 12: hloc = λ·atomic_soc_jz(); bath copy k =
    0.7λ·atomic_soc_jz() + eps_k, eps_k evenly on [-1, 1]; vr = 0.6; the
    mask of Hloc plus the diagonal (chip_reference.py's jz_problem)."""
    import numpy as np
    from dmft_ed_tpu_torch.aux import atomic_soc_jz
    from dmft_ed_tpu_torch.bath import Bath, replica_mask
    ls = atomic_soc_jz()
    hloc = JZ_LAMBDA * ls
    one = np.einsum("st,ab->stab", np.eye(2), np.eye(3))
    b = Bath(cfg)
    b.mask = replica_mask(cfg, hloc + 1e-3 * one)
    for k, eps in enumerate(np.linspace(-1.0, 1.0, cfg.nbath)):
        b.h[..., k] = 0.7 * JZ_LAMBDA * ls + eps * one
    b.vr[:] = 0.6
    return hloc, b


def jz_sweep(device, cfg):
    """Phase 12 (a)/(b): the sector sweep and the observables of cfg, with
    the stage timers, the matvecs and torch calls per matvec of the
    largest swept sector and the peak device memory. Returns (egs, dens,
    docc, N of the ground state)."""
    import torch
    from dmft_ed_tpu_torch.diag import diagonalize, sectors_mask
    from dmft_ed_tpu_torch.observables import compute_observables
    from dmft_ed_tpu_torch.sectors import sector_table
    from dmft_ed_tpu_torch.timer import Timers
    hloc, bath = jz_problem(cfg)
    tab = sector_table(cfg)
    mask = sectors_mask(cfg, tab)
    swept = [sec for sec in tab.sectors if mask[sec.index]]
    big = max(swept, key=lambda x: x.dim)
    timers = Timers(None)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with count_matvecs() as mv:
        with timers("diagonalize"):
            slist, zeta, _ = diagonalize(cfg, bath, hloc, device=device,
                                         timers=timers)
        with timers("observables"):
            obs = compute_observables(cfg, slist, zeta, bath, hloc, False)
    torch.cuda.synchronize()
    dt = time.time() - t0
    peak = _peak_gib()
    calls, ms, ms_g, nmix = matvec_calls(cfg, big, bath, hloc, device)
    basis = "Jz" if cfg.jz_basis else "plain N"
    print(f"spin-orbit Nbath={cfg.nbath} {basis}: {len(swept)} sectors swept "
          f"in {dt:.3f} s, egs={slist.emin!r} ({len(slist)} states in "
          f"{sorted({s.sector.qn[1:] for s in slist})}) "
          f"dens={obs.dens.tolist()} docc={obs.docc.tolist()}\n  largest "
          f"sector dim {big.dim} ({len(big.blocks)} blocks, {nmix} mix "
          f"entries): {mv.get(big.dim, 0)} matvecs, {calls} torch calls and "
          f"{ms:.3f} ms per matvec ({ms_g:.3f} ms from its CUDA graph); "
          f"{sum(mv.values())} matvecs in all; peak "
          f"device memory {peak:.3f} GiB\n  stages "
          + _stages(timers))
    return slist.emin, obs.dens, obs.docc, next(iter(slist)).sector.qn[1]


def jz2_solve(device):
    """Phase 12 (c): one whole EDSolver.solve at Nbath=2 in the Jz basis
    and in plain N: egs, dens, docc, the diagonal G(iω_0) and Σ(iω_0)
    against each other and the JAX package's."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.bath import pack_bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.solver import EDSolver
    got, bad = {}, []
    for label, jz in (("jz", True), ("plain", False)):
        cfg = EDConfig(**dict(JZ_CFG, nbath=2, jz_basis=jz)).validate()
        hloc, bath = jz_problem(cfg)
        os.mkdir(f"jz2_{label}")
        os.chdir(f"jz2_{label}")
        solver = EDSolver(cfg, hloc, log=lambda m: None, device=device)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        r = solver.solve(pack_bath(bath))
        torch.cuda.synchronize()
        dt = time.time() - t0
        os.chdir("..")
        o = r.observables
        got[label] = (r.egs, o.dens, o.docc)
        ref = JZ2_JAX
        g0 = np.array([[r.gmats[s, s, a, a, 0].real,
                        r.gmats[s, s, a, a, 0].imag]
                       for s in range(2) for a in range(3)])
        s0 = r.smats[..., 0].ravel()
        d = dict(egs=abs(r.egs - ref["egs"]),
                 dens=float(np.max(np.abs(o.dens - ref["dens"]))),
                 docc=float(np.max(np.abs(o.docc - ref["docc"]))),
                 g0=float(np.max(np.abs(g0 - np.asarray(ref["g0"])))),
                 sigma0=float(np.max(np.abs(
                     s0 - (np.asarray(ref["sigma0_re"])
                           + 1j * np.asarray(ref["sigma0_im"]))))))
        print(f"spin-orbit Nbath=2 {label} solve: {dt:.3f} s egs={r.egs!r} "
              f"dens={o.dens.tolist()} docc={o.docc.tolist()} peak device "
              f"memory {_peak_gib():.3f} GiB; against the JAX package's: "
              + " ".join(f"|d {k}|={v:.3e}" for k, v in d.items())
              + f" (bounds egs {TOL_JZ_EGS:g}, dens/docc {TOL_JZ_OBS:g}, "
              f"G/Σ {TOL_JZ_GF:g})\n  stages " + _stages(solver.timers))
        if not (d["egs"] <= TOL_JZ_EGS and d["dens"] <= TOL_JZ_OBS
                and d["docc"] <= TOL_JZ_OBS and d["g0"] <= TOL_JZ_GF
                and d["sigma0"] <= TOL_JZ_GF):
            bad.append(f"the {label} solve disagrees with the JAX package")
        if not all(np.all(np.isfinite(x)) for x in (r.gmats, r.smats,
                                                      r.greal, r.sreal)):
            bad.append(f"the {label} solve has non-finite G or Σ")
    (ej, dj, oj), (ep, dp, op) = got["jz"], got["plain"]
    d_egs = abs(ej - ep)
    d_obs = float(max(np.max(np.abs(dj - dp)), np.max(np.abs(oj - op))))
    print(f"spin-orbit Nbath=2 Jz vs plain N: |d egs|={d_egs:.3e} "
          f"max|d dens|, |d docc|={d_obs:.3e}")
    if not (d_egs <= TOL_JZ_EGS and d_obs <= TOL_JZ_OBS):
        bad.append("Jz and plain N disagree")
    if bad:
        raise AssertionError("spin-orbit Nbath=2: " + "; ".join(bad))


def spin_orbit_impurity(device):
    """Phase 12: at Nbath=3, the sweeps of N = JZ_NGS - 1 .. JZ_NGS + 1,
    (a) in the Jz basis and (b) in plain N sectors, each chosen through
    ed_sectors from a sectors_list.restart, held to each other; (c)
    jz2_solve. Returns the launches per kernel."""
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.sectors import sector_table
    import numpy as np
    reset_launches()
    cfg_a = EDConfig(**dict(JZ_CFG, nbath=3, jz_basis=True, ed_sectors=True,
                            ed_sectors_shift=0)).validate()
    with open("sectors_list.restart", "w") as fh:
        for sec in sector_table(cfg_a).sectors:
            if abs(sec.qn[1] - JZ_NGS) <= 1:
                fh.write(f"{sec.qn[1]} {sec.qn[2]}\n")
    egs_a, dens_a, docc_a, n_a = jz_sweep(device, cfg_a)
    with open("sectors_list.restart", "w") as fh:
        fh.write(f"{JZ_NGS}\n")
    egs_b, dens_b, docc_b, n_b = jz_sweep(device, EDConfig(
        **dict(JZ_CFG, nbath=3, ed_sectors=True)).validate())
    os.remove("sectors_list.restart")
    if not n_a == n_b == JZ_NGS:
        raise AssertionError(f"spin-orbit Nbath=3: ground state at N = "
                             f"{n_a} (Jz), {n_b} (plain), not {JZ_NGS}")
    d_egs = abs(egs_a - egs_b)
    d_obs = float(max(np.max(np.abs(dens_a - dens_b)),
                      np.max(np.abs(docc_a - docc_b))))
    print(f"spin-orbit Nbath=3 Jz vs plain N: |d egs|={d_egs:.3e} (bound "
          f"{TOL_JZ_EGS:g}) max|d dens|, |d docc|={d_obs:.3e} (bound "
          f"{TOL_JZ_OBS:g})")
    if not (d_egs <= TOL_JZ_EGS and d_obs <= TOL_JZ_OBS):
        raise AssertionError("spin-orbit Nbath=3: Jz and plain N disagree")
    jz2_solve(device)
    return {n: fn.launches for n, fn in KERNELS.items()}


def _flake_values(r, lat2ineq):
    """dens, docc of each class's first site and Σ(iω_0) per class
    (chip_reference.flake_values)."""
    import numpy as np
    first = [int(np.nonzero(np.asarray(lat2ineq) == i)[0][0])
             for i in range(len(r.smats_ineq))]
    return (np.array([r.dens[i] for i in first]),
            np.array([r.docc[i] for i in first]),
            r.smats_ineq[:, 0, 0, 0, 0, 0])


def flake_loop(device, cfg_kwargs, label):
    """hm_square_lattice.run at the default geometry with `cfg_kwargs`:
    seconds per iteration and per stage of the lattice solver, the
    matvecs and torch calls per matvec of the largest sector, the peak
    device memory and the kernel's launches. Returns (result, lat2ineq,
    launches)."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.bath import unpack_bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.models import hm_square_lattice
    from dmft_ed_tpu_torch.models.nano import square_flake_hij
    from dmft_ed_tpu_torch.sectors import sector_table
    cfg = EDConfig(**cfg_kwargs).validate()
    lat2ineq = square_flake_hij(FLAKE_RUN["lx"], FLAKE_RUN["ly"])[1]
    marks = []

    def log(msg):
        if msg.startswith("--- real-space DMFT loop"):
            torch.cuda.synchronize()
            marks.append(time.time())
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    with count_matvecs() as mv:
        r = hm_square_lattice.run(cfg, log=log, device=device, **FLAKE_RUN)
    torch.cuda.synchronize()
    marks.append(time.time())
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    peak = _peak_gib()
    sec = max(sector_table(cfg).sectors, key=lambda x: x.dim)
    calls, ms, _, _ = matvec_calls(cfg, sec, unpack_bath(cfg, r.baths[0]),
                                   np.zeros((1, 1, 1, 1)), device)
    iters = [round(marks[i + 1] - marks[i], 3) for i in range(len(marks) - 1)]
    dens, docc, s0 = _flake_values(r, lat2ineq)
    print(f"{label}: Nbath={cfg.nbath}, {r.solver.nineq} inequivalent of "
          f"{len(lat2ineq)} sites, {r.iterations} iterations in "
          f"{marks[-1] - t0:.3f} s (per iteration {iters})\n  stages "
          + _stages(r.solver.timers)
          + f"\n  largest sector dim {sec.dim}: {mv.get(sec.dim, 0)} matvecs "
          f"(one per site and step), {calls} torch calls and {ms:.3f} ms "
          f"per matvec; {sum(mv.values())} matvecs in all; peak device "
          f"memory {peak:.3f} GiB; launches={launches}\n  dens per class "
          f"{dens.tolist()} docc {docc.tolist()} Σ(iω_0) "
          f"{[complex(x) for x in s0]} ekin={r.ekin!r} error={r.error!r}")
    bad = [f"non-finite {f}" for f in ("smats_ineq", "gmats_lat", "baths",
                                       "dens", "docc")
           if not np.all(np.isfinite(getattr(r, f)))]
    if not np.isfinite(r.ekin):
        bad.append("non-finite ekin")
    if r.iterations != cfg.nloop:
        bad.append(f"{r.iterations} iterations, not {cfg.nloop}")
    # the symmetry classes of the flake (tests/test_models.py): corners,
    # edges and centre sites carry equal values
    for cls in range(r.solver.nineq):
        grp = np.nonzero(np.asarray(lat2ineq) == cls)[0]
        if not (np.ptp(r.dens[grp]) <= 1e-12 and np.ptp(r.docc[grp])
                <= 1e-12):
            bad.append(f"class {cls} sites differ")
    if not np.all((r.docc > 0.0) & (r.docc < 0.25)):
        bad.append(f"docc {r.docc} outside (0, 1/4)")
    if bad:
        raise AssertionError(f"{label}: " + "; ".join(bad))
    return r, lat2ineq, launches


def check_flake(r, lat2ineq):
    """Phase 13(a) against the JAX package's CPU run (FLAKE_JAX)."""
    import numpy as np
    dens, docc, s0 = _flake_values(r, lat2ineq)
    ref = FLAKE_JAX
    s0_ref = np.asarray(ref["sigma0_re"]) + 1j * np.asarray(ref["sigma0_im"])
    d = dict(dens=float(np.max(np.abs(dens - ref["dens"]))),
             docc=float(np.max(np.abs(docc - ref["docc"]))),
             ekin=abs(r.ekin - ref["ekin"]),
             sigma0=float(np.max(np.abs(s0 - s0_ref) / np.abs(s0_ref))),
             error=abs(r.error - ref["error"]))
    tol = dict(dens=TOL_FLAKE_DENS, docc=TOL_FLAKE_DOCC, ekin=TOL_FLAKE_EKIN,
               sigma0=TOL_FLAKE_SIGMA_REL, error=TOL_FLAKE_ERROR)
    print("flake loop against the JAX package's: "
          + " ".join(f"|d {k}|={v:.3e} (bound {tol[k]:g})"
                     for k, v in d.items()))
    bad = [k for k in d if not d[k] <= tol[k]]
    if bad:
        raise AssertionError(f"flake loop disagrees with the JAX package: "
                             f"{bad}")


def check_flake11(r):
    """Phase 13(b): half filling per site, 0 < docc < 1/4."""
    import numpy as np
    d = float(np.max(np.abs(r.dens - 1.0)))
    print(f"flake Nbath=11: max|dens - 1|={d:.3e} (bound "
          f"{TOL_FLAKE11_DENS:g}), docc {r.docc.tolist()}")
    if not d <= TOL_FLAKE11_DENS:
        raise AssertionError("flake Nbath=11: not half filling")


@contextlib.contextmanager
def held_kernel(samples: int = 2):
    """While active, the first `samples` digit-matmul calls of every
    operand shape the Ozaki products make are held bitwise against the
    plain version on the same operands (on the card, after the kernel's
    own launch, which counts as the path's); yields the list of
    (shape, max|kernel - plain|)."""
    import torch
    from dmft_ed_tpu_torch import ozaki
    from dmft_ed_tpu_torch.kernels import digit_matmul, digit_matmul_plain
    seen, out = {}, []

    def held(*a, **k):
        got = digit_matmul(*a, **k)
        key = (tuple(a[0].shape), tuple(a[1].shape), k.get("k"))
        if seen.get(key, 0) < samples:
            seen[key] = seen.get(key, 0) + 1
            ref = digit_matmul_plain(*a, **k)
            err = float((got - ref).abs().max())
            out.append((key, err))
            if not torch.equal(got, ref):
                raise AssertionError(f"digit_matmul differs from its plain "
                                     f"version at {key} by {err:.3e}")
        return got
    ozaki.digit_matmul = held
    try:
        yield out
    finally:
        ozaki.digit_matmul = digit_matmul


def sites_fixed_bath(device):
    """Phase 13(c): one fixed-bath LatticeEDSolver.solve of the Nbath=8
    flake (its 3 classes, the initial baths perturbed from a seed):
    batched=True against batched=False under native, and ozaki5x7 (over
    the sectors of each site's native ground state) against native, with
    the kernel's launches (and a sample of its calls held bitwise against
    the plain version). Returns the ozaki5x7 solve's launches."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.aux import lso2nnn
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.lattice_solver import LatticeEDSolver
    from dmft_ed_tpu_torch.models.nano import square_flake_hij
    hij, l2i = square_flake_hij(FLAKE_RUN["lx"], FLAKE_RUN["ly"],
                                t=FLAKE_RUN["ts"])
    i2l = [int(np.nonzero(l2i == i)[0][0]) for i in range(l2i.max() + 1)]
    hloc = lso2nnn(hij, len(l2i), 1, 1)[i2l]
    res, launches = {}, {}
    baths = None
    for label, prec, batched in (("batched native", "native", True),
                                 ("per-site native", "native", False),
                                 ("batched ozaki5x7", "ozaki5x7", True)):
        extra = dict(ed_sectors=True, ed_sectors_shift=0) \
            if prec != "native" else {}
        cfg = EDConfig(**dict(FLAKE8_CFG, matmul_precision=prec,
                              **extra)).validate()
        ls = LatticeEDSolver(cfg, hloc, log=lambda m: None, device=device)
        if baths is None:
            baths = ls.init_solvers()
            baths = baths + 0.02 * np.random.default_rng(13).normal(
                size=baths.shape)
        reset_launches()
        t0 = time.time()
        with held_kernel() as held:
            rs = ls.solve(baths, batched=batched)
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches[label] = {n: fn.launches for n, fn in KERNELS.items()}
        res[label] = rs
        stages = ls.timers if batched else ls.solvers[0].timers
        print(f"flake Nbath=8 {label}: {dt:.3f} s egs="
              f"{[r.egs for r in rs]} launches={launches[label]} "
              f"kernel calls held bitwise: {len(held)}\n  stages "
              + _stages(stages))
    a, p, o = (res["batched native"], res["per-site native"],
               res["batched ozaki5x7"])
    d_egs = max(abs(x.egs - y.egs) for x, y in zip(a, p))
    d_g = max(float(np.max(np.abs(x.gmats - y.gmats))) for x, y in zip(a, p))
    d_oe = max(abs(x.egs - y.egs) for x, y in zip(a, o))
    d_od = max(float(np.max(np.abs(x.observables.docc - y.observables.docc)))
               for x, y in zip(a, o))
    print(f"flake Nbath=8 batched vs per-site: max|d egs|={d_egs:.3e} "
          f"(bound {TOL_SITES_EGS:g}) max|d G(iω)|={d_g:.3e} (bound "
          f"{TOL_SITES_G:g}); ozaki5x7 vs native: max|d egs|={d_oe:.3e} "
          f"(bound {TOL_EGS:g}) max|d docc|={d_od:.3e} (bound "
          f"{TOL_DOCC:g})")
    bad = []
    if not (d_egs <= TOL_SITES_EGS and d_g <= TOL_SITES_G):
        bad.append("batched and per-site solves disagree")
    if not (d_oe <= TOL_EGS and d_od <= TOL_DOCC):
        bad.append("ozaki5x7 and native disagree")
    if not launches["batched ozaki5x7"]["digit_matmul"] > 0:
        bad.append("the ozaki5x7 site-batched solve launched no kernel")
    if launches["batched native"]["digit_matmul"] != 0:
        bad.append("the native site-batched solve launched the kernel")
    if bad:
        raise AssertionError("flake Nbath=8: " + "; ".join(bad))
    return launches["batched ozaki5x7"]


def soc_ineq_loop(device):
    """Phase 13(d): soc_ineq.run with the driver's defaults for
    SOC_INEQ_NLOOP iterations, held to SOC_INEQ_JAX. Returns the
    launches per kernel."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.models import soc_ineq
    cfg = EDConfig(**SOC_INEQ_CFG).validate()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    r = soc_ineq.run(cfg, log=lambda *a, **k: None, device=device)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    sud = np.array([np.linalg.norm(r.smats_ineq[i, 0, 1])
                    for i in range(len(r.smats_ineq))])
    ref = SOC_INEQ_JAX
    d_dens = float(np.max(np.abs(r.dens - np.asarray(ref["dens"]))))
    d_sud = float(np.max(np.abs(sud - ref["smats_ud"])
                         / np.asarray(ref["smats_ud"])))
    d_err = abs(r.error - ref["error"])
    print(f"soc_ineq: {r.iterations} iterations in {dt:.3f} s, peak device "
          f"memory {_peak_gib():.3f} GiB, launches={launches}\n  stages "
          + _stages(r.solver.timers)
          + f"\n  dens={r.dens.tolist()} |S_ud|={sud.tolist()} "
          f"error={r.error!r}; against the JAX package's: max|d dens|="
          f"{d_dens:.3e} (bound {TOL_LOOP_DENS:g}) |d S_ud|/|S_ud|="
          f"{d_sud:.3e} (bound {TOL_LOOP_SIGMA_REL:g}) |d error|="
          f"{d_err:.3e} (bound {TOL_LOOP_ERROR:g})")
    bad = [f"non-finite {f}" for f in ("smats_ineq", "gmats_ineq", "baths",
                                       "dens")
           if not np.all(np.isfinite(getattr(r, f)))]
    if r.iterations != cfg.nloop:
        bad.append(f"{r.iterations} iterations, not {cfg.nloop}")
    if not (d_dens <= TOL_LOOP_DENS and d_sud <= TOL_LOOP_SIGMA_REL
            and d_err <= TOL_LOOP_ERROR):
        bad.append("disagrees with the JAX package")
    if bad:
        raise AssertionError("soc_ineq loop: " + "; ".join(bad))
    return launches


def flake_phases(device, work):
    """Phase 13 (a)-(d), each in a directory of its own (init_solvers
    reads hamiltonian_ineq####.restart from the cwd, nano.run writes
    magXY.ed). Returns the launches per kernel of each path."""
    out = {}
    t13 = time.time()
    for part in ("a", "b", "c", "d"):
        os.mkdir(f"phase13{part}")
        os.chdir(f"phase13{part}")
        t0 = time.time()
        if part == "a":
            r, l2i, out["flake_loop_native"] = flake_loop(
                device, FLAKE_CFG, "flake loop")
            check_flake(r, l2i)
        elif part == "b":
            r, _, out["flake_nbath11_native"] = flake_loop(
                device, FLAKE11_CFG, "flake Nbath=11")
            check_flake11(r)
        elif part == "c":
            out["flake_sites_ozaki5x7"] = sites_fixed_bath(device)
        else:
            out["soc_ineq_native"] = soc_ineq_loop(device)
        print(f"phase 13({part}): {time.time() - t0:.3f} s")
        os.chdir(work)
    print(f"phase 13: {time.time() - t13:.3f} s")
    return out


@contextlib.contextmanager
def record_solves():
    """While active, every EDSolver.solve appends (egs, dens, docc) to the
    yielded list."""
    from dmft_ed_tpu_torch.solver import EDSolver as cls
    seen, orig = [], cls.solve

    def solve(self, bath):
        r = orig(self, bath)
        o = r.observables
        seen.append((float(r.egs), o.dens.tolist(), o.docc.tolist()))
        return r
    cls.solve = solve
    try:
        yield seen
    finally:
        cls.solve = orig


def run_driver(name: str, device):
    """DRIVER_CASES[name] through models.<name> on `device`, in the cwd:
    material's H(k) file is written there by its write_hk_w90."""
    import importlib
    import numpy as np
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.models import kspace
    entry, cfg_kw, run_kw, hk = DRIVER_CASES[name]
    mod = importlib.import_module(f"dmft_ed_tpu_torch.models.{name}")
    cfg = EDConfig(**cfg_kw).validate()
    args = ()
    if hk is not None:
        H = getattr(kspace, hk[0])(**hk[1])
        args = (H,)
        if name == "material":
            mod.write_hk_w90("hk.in", H, np.zeros((H.shape[-1], 3)))
            args = ("hk.in",)
    return getattr(mod, entry)(cfg, *args, log=lambda *a, **k: None,
                               device=device, **run_kw)


def site_values(results) -> dict:
    """Per-site (egs, dens, docc, phi) of a LatticeEDSolver.solve's results
    (either package); dens, docc and phi as nested lists per site."""
    return dict(egs=[float(r.egs) for r in results],
                dens=[r.observables.dens.tolist() for r in results],
                docc=[r.observables.docc.tolist() for r in results],
                phi=[r.observables.phisc.tolist() for r in results])


@contextlib.contextmanager
def record_site_solves(cls):
    """While active, every cls.solve (a LatticeEDSolver class of either
    package) appends (the solver, site_values of its results, the baths it
    solved) to the yielded list."""
    seen, orig = [], cls.solve

    def solve(self, baths, batched=True):
        out = orig(self, baths, batched=batched)
        seen.append((self, site_values(out), baths.copy()))
        return out
    cls.solve = solve
    try:
        yield seen
    finally:
        cls.solve = orig


def drivers_small(device):
    """Phase 14(a): every DRIVER_CASES driver on the card, each in a
    directory of its own: seconds, the first solve's egs and the last
    solve's dens and docc against DRIVERS_JAX. Returns the launches per
    kernel over all ten."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    bad, here = [], os.getcwd()
    reset_launches()
    for name in DRIVER_CASES:
        os.mkdir(name)
        os.chdir(name)
        t0 = time.time()
        with record_solves() as seen:
            r = run_driver(name, device)
        torch.cuda.synchronize()
        dt = time.time() - t0
        os.chdir(here)
        ref = DRIVERS_JAX[name]
        (e1, _, _), (_, dens, docc) = seen[0], seen[-1]
        d = dict(egs=abs(e1 - ref["first_egs"]),
                 dens=float(np.max(np.abs(np.subtract(dens, ref["dens"])))),
                 docc=float(np.max(np.abs(np.subtract(docc, ref["docc"])))))
        tol = dict(egs=TOL_DRIVER_EGS, dens=TOL_DRIVER_DENS,
                   docc=TOL_DRIVER_DOCC)
        print(f"{name}: {r.iterations} iterations in {dt:.3f} s, first egs "
              f"{e1!r}, dens {dens} docc {docc}; against the JAX "
              "package's: " + " ".join(f"|d {k}|={v:.3e} (bound {tol[k]:g})"
                                        for k, v in d.items()))
        if r.iterations != len(seen) or r.iterations != ref["iterations"]:
            bad.append(f"{name}: {r.iterations} iterations")
        if not all(np.all(np.isfinite(x)) for x in (r.dens, r.smats,
                                                     r.bath)):
            bad.append(f"{name}: non-finite results")
        bad += [f"{name}: {k}" for k in d if not d[k] <= tol[k]]
    if bad:
        raise AssertionError("drivers: " + "; ".join(bad))
    return {n: fn.launches for n, fn in KERNELS.items()}


def lattice_case_args(name: str, models):
    """(positional arguments, extra keywords) of LATTICE_CASES[name]'s
    entry point, built from LATTICE_SEED with `models` (either package's
    models package): a 3x3 flake with a uniform disorder on [-0.5, 0.5]
    (ahm_disorder), a 4x4 flake at Nspin=2 with a staggered seed and every
    site its own class (hartree_nano), synthetic Wannier hoppings
    (tblg)."""
    import numpy as np
    geom = LATTICE_CASES[name][4]
    rng = np.random.default_rng(LATTICE_SEED)
    if geom == "disordered_flake":
        hij = models.nano.square_flake_hij(3, 3, 0.5)[0]
        return (hij, rng.uniform(-0.5, 0.5, hij.shape[0])), {}
    if geom == "staggered_flake":
        h1 = models.nano.square_flake_hij(4, 4, 0.5)[0]
        n = h1.shape[0]
        seed = 0.2 * np.array([(-1.0) ** ((i % 4) + (i // 4))
                               for i in range(n)])
        return (np.kron(h1, np.eye(2)), np.arange(n)), dict(seed_mag=seed)
    if geom == "synthetic_hopping":
        return models.tblg.synthetic_hopping(LATTICE_SEED), {}
    return (), {}


def lattice_values(name: str, r, seen) -> dict:
    """What phase 15(a) holds of a LATTICE_CASES run (either package), read
    in the run's directory: the iterations, the first solve's egs per site,
    each site's chi^2 after the first joint fit, the last solve's dens,
    docc and phi per site (seen: record_site_solves' list); hartree_nano's
    dens and mag; nano_isoc_sq's chi0(q) and local Chern marker too."""
    import glob
    import numpy as np
    if name == "hartree_nano":
        return dict(iterations=int(r.iterations), dens=r.dens.tolist(),
                    mag=r.mag.tolist())
    out = dict(iterations=int(getattr(r, "dmft", r).iterations),
               first_egs=seen[0][1]["egs"],
               chi2=[float(np.loadtxt(f, ndmin=2)[0, 0]) for f in sorted(
                   glob.glob("chi2fit_results_ineq*.ed"))],
               dens=seen[-1][1]["dens"], docc=seen[-1][1]["docc"],
               phi=seen[-1][1]["phi"])
    if name == "nano_isoc_sq":
        out.update(chi0=r.chi0.tolist(), chern=r.chern.tolist())
    return out


def lattice_drivers_small(device):
    """Phase 15(a): every LATTICE_CASES driver on the card, each in a
    directory of its own, held to LATTICE_JAX: the first solve's egs per
    site, dens and docc after the loop, phi of the superc drivers;
    hartree_nano's dens and mag; nano_isoc_sq's chi0(q) and Chern marker.
    Returns the launches per kernel over all of them."""
    import importlib
    import numpy as np
    import torch
    from dmft_ed_tpu_torch import models
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.lattice_solver import LatticeEDSolver
    bad, here = [], os.getcwd()
    reset_launches()
    for name, (modname, entry, cfg_kw, run_kw, _) in LATTICE_CASES.items():
        os.mkdir(name)
        os.chdir(name)
        mod = importlib.import_module(f"dmft_ed_tpu_torch.models.{modname}")
        args, extra = lattice_case_args(name, models)
        t0 = time.time()
        with record_site_solves(LatticeEDSolver) as seen:
            r = getattr(mod, entry)(EDConfig(**cfg_kw).validate(), *args,
                                    log=lambda *a, **k: None, device=device,
                                    **run_kw, **extra)
        torch.cuda.synchronize()
        dt = time.time() - t0
        got, ref = lattice_values(name, r, seen), LATTICE_JAX[name]
        os.chdir(here)
        tol = dict(first_egs=TOL_DRIVER_EGS, dens=TOL_DRIVER_DENS,
                   docc=TOL_DRIVER_DOCC, phi=TOL_LATTICE_PHI,
                   chi2=TOL_FIT_CHI2, mag=TOL_HARTREE, chi0=TOL_CHI0,
                   chern=TOL_CHI0)
        if name == "hartree_nano":
            tol["dens"] = TOL_HARTREE
        if cfg_kw.get("ed_mode") == "superc":
            tol.update(dens=TOL_LATTICE_SC, docc=TOL_LATTICE_SC,
                       phi=TOL_LATTICE_SC, chi2=None)
        d = {k: float(np.max(np.abs(np.subtract(got[k], ref[k]))))
             for k in got if k != "iterations"}
        if "chi2" in d:     # relative to the summed objective's scale
            d["chi2"] /= max(ref["chi2"])
        print(f"{name}: {got['iterations']} iterations in {dt:.3f} s; "
              "against the JAX package's: " + " ".join(
                  f"|d {k}|={v:.3e} " + ("(not held)" if tol[k] is None
                                         else f"(bound {tol[k]:g})")
                  for k, v in d.items()))
        if got["iterations"] != ref["iterations"]:
            bad.append(f"{name}: {got['iterations']} iterations")
        if not all(np.all(np.isfinite(np.asarray(v, dtype=float)))
                   for k, v in got.items()):
            bad.append(f"{name}: non-finite results")
        bad += [f"{name}: {k}" for k in d
                if tol[k] is not None and not d[k] <= tol[k]]
    if bad:
        raise AssertionError("lattice drivers: " + "; ".join(bad))
    return {n: fn.launches for n, fn in KERNELS.items()}


def stack_full(device):
    """Phase 15(b): ahm_stripe.run_stack on STACK_CFG, one iteration: the
    stage seconds, the member matvecs at Sz=0 and in all, the torch calls
    of one Sz=0 matvec (eager and graphed), the Nambu k-sum's seconds, the
    peak device memory; the first solve per layer against STACK_JAX; each
    layer's ground-state sectors solved again per site (ed_sectors over
    the sectors_list_ineq####.restart files the batched solve wrote):
    egs to TOL_SITES_EGS. Returns the launches per kernel."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.bath import unpack_bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.lattice_solver import LatticeEDSolver
    from dmft_ed_tpu_torch.models import ahm_stripe
    from dmft_ed_tpu_torch.sectors import sector_table
    from dmft_ed_tpu_torch.solver import EDSolver
    cfg = EDConfig(**STACK_CFG).validate()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    with count_matvecs() as mv, \
            record_site_solves(LatticeEDSolver) as seen:
        r = ahm_stripe.run_stack(cfg, log=lambda *a, **k: None,
                                 device=device)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    peak = _peak_gib()
    ls, got, baths0 = seen[0]
    sec = max(sector_table(cfg).sectors, key=lambda x: x.dim)
    calls, ms, ms_g, nmix = matvec_calls(
        ls.cfgs[-1], sec, unpack_bath(cfg, baths0[-1], ls.solvers[-1].mask),
        ls.solvers[-1].hloc, device)
    ref = STACK_JAX
    d = {k: float(np.max(np.abs(np.subtract(got[k], ref[k]))))
         for k in ("egs", "dens", "docc", "phi")}
    tol = dict(egs=TOL_STACK_EGS, dens=TOL_STACK_OBS, docc=TOL_STACK_OBS,
               phi=TOL_STACK_OBS)
    print(f"U-stack Nbath={cfg.nbath} superc, {len(got['egs'])} layers U="
          f"{r.uloc_sites.tolist()}: {r.iterations} iteration in {dt:.3f} s"
          f"\n  stages {_stages(ls.timers)}\n  largest sector {sec.qn} dim "
          f"{sec.dim}: {mv.get(sec.dim, 0)} member matvecs, {nmix} mix "
          f"entries, {calls} torch calls, {ms:.3f} ms eager and {ms_g:.3f} "
          f"ms graphed per matvec; {sum(mv.values())} matvecs in all; peak "
          f"device memory {peak:.3f} GiB; launches={launches}\n  first "
          f"solve egs={got['egs']} dens={got['dens']} docc={got['docc']} "
          f"phi={got['phi']}; against the JAX package's: " + " ".join(
              f"|d {k}|={v:.3e} (bound {tol[k]:g})" for k, v in d.items()))
    bad = [f"{k} off the JAX package's" for k in d if not d[k] <= tol[k]]
    # each layer again, per site, over its ground-state sectors
    d_site = []
    t1 = time.time()
    for i, s in enumerate(ls.solvers):
        one = EDSolver(ls.cfgs[i].replace(ed_sectors=True,
                                          ed_sectors_shift=0), s.hloc,
                       suffix=s.suffix, log=lambda m: None, device=device)
        rs = one.solve(baths0[i])
        d_site.append(abs(rs.egs - got["egs"][i]))
    torch.cuda.synchronize()
    print(f"  per-site solves of each layer's ground-state sectors in "
          f"{time.time() - t1:.3f} s: max|d egs|={max(d_site):.3e} (bound "
          f"{TOL_SITES_EGS:g})")
    if not max(d_site) <= TOL_SITES_EGS:
        bad.append("batched and per-site egs disagree")
    if not all(np.all(np.isfinite(x)) for x in (r.dens, r.docc, r.phisc,
                                                r.baths)):
        bad.append("non-finite results")
    if bad:
        raise AssertionError("U-stack Nbath=9: " + "; ".join(bad))
    return launches


def lattice_phases(device, work):
    """Phase 15 (a)-(b), each in a directory of its own. Returns the
    launches per kernel of each path."""
    out = {}
    t15 = time.time()
    for part in ("a", "b"):
        os.mkdir(f"phase15{part}")
        os.chdir(f"phase15{part}")
        t0 = time.time()
        if part == "a":
            out["lattice_drivers_native"] = lattice_drivers_small(device)
        else:
            out["stack_nbath9_native"] = stack_full(device)
        print(f"phase 15({part}): {time.time() - t0:.3f} s")
        os.chdir(work)
    print(f"phase 15: {time.time() - t15:.3f} s")
    return out


def _p16_cfg(prec, **extra):
    from dmft_ed_tpu_torch.config import EDConfig
    return EDConfig(**dict(ARPACK_CFG, matmul_precision=prec,
                           **dict(ARPACK_OZAKI_SECTORS, **extra))).validate()


def _p16_flake():
    """Phase 16(b)'s problem: the flake's class hlocs and the initial
    baths of FLAKE_CFG perturbed from a seed."""
    import numpy as np
    from dmft_ed_tpu_torch.aux import lso2nnn
    from dmft_ed_tpu_torch.bath import init_bath, pack_bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.models.nano import square_flake_hij
    hij, l2i = square_flake_hij(FLAKE_RUN["lx"], FLAKE_RUN["ly"],
                                t=FLAKE_RUN["ts"])
    i2l = [int(np.nonzero(l2i == i)[0][0]) for i in range(l2i.max() + 1)]
    hloc = lso2nnn(hij, len(l2i), 1, 1)[i2l]
    cfg = EDConfig(**dict(FLAKE_CFG, nloop=1)).validate()
    baths = np.stack([pack_bath(init_bath(cfg, hloc[i]))
                      for i in range(len(hloc))])
    return cfg, hloc, baths + 0.02 * np.random.default_rng(16).normal(
        size=baths.shape)


def _solve_values(r):
    return dict(egs=r.egs, gmats=r.gmats, smats=r.smats,
                dens=r.observables.dens, docc=r.observables.docc)


def p16_rank(bath, sectors):
    """Phase 16's rank program (two ranks share cuda:0 in a gloo group):
    (a) the sharded Nbath=11 solves, native and ozaki5x7, and one sharded
    (6,6) matvec of each against the unsharded one (bitwise under
    ozaki5x7), timed beside its all-gather alone and the unsharded
    matvec, with its all-gathers counted; (b) the flake on a sites=2
    mesh. Both ranks run in one shared directory, each solve in a
    subdirectory of its own (``native/``, ``ozaki5x7/``, ``flake/``), and
    only rank 0 writes files. Returns this rank's results, launches and
    peak memory."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.bath import unpack_bath
    from dmft_ed_tpu_torch.hamiltonian import (apply_op,
                                               build_sector_hamiltonian,
                                               make_matvec_op)
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.lattice_solver import LatticeEDSolver
    from dmft_ed_tpu_torch.parallel import make_mesh, row_slice
    from dmft_ed_tpu_torch.parallel.hxv import row_gather, sharded_sector_op
    from dmft_ed_tpu_torch.parallel.mesh import writes_files
    from dmft_ed_tpu_torch.sectors import sector_table
    from dmft_ed_tpu_torch.solver import EDSolver
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    rows = make_mesh(device="cuda")
    calls = {"all_gather": 0, "all_reduce": 0}
    for name in calls:
        fn = getattr(rows, name)

        def counted(*a, _fn=fn, _n=name, **k):
            calls[_n] += 1
            return _fn(*a, **k)
        setattr(rows, name, counted)
    out = {"coord": rows.coord}
    for prec in ("native", "ozaki5x7"):
        # rank 0 writes the sectors file; the solve reads it through rank 0
        os.makedirs(prec, exist_ok=True)
        os.chdir(prec)
        if writes_files(rows):
            with open("sectors_list.restart", "w") as fh:
                fh.write(sectors)
        cfg = _p16_cfg(prec)
        hloc = np.zeros((1, 1, 1, 1))
        solver = EDSolver(cfg, hloc, log=lambda m: None, mesh=rows)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        for k in calls:
            calls[k] = 0
        t0 = time.time()
        with held_kernel() as held:
            r = solver.solve(bath)
        torch.cuda.synchronize()
        out[prec] = dict(
            _solve_values(r), seconds=time.time() - t0,
            launches={n: fn.launches for n, fn in KERNELS.items()},
            collectives=dict(calls), held=len(held), peak_gib=_peak_gib(),
            stages={k: round(v, 3)
                    for k, v in sorted(solver.timers.acc.items())})
        os.chdir("..")
    # one (6,6) matvec, sharded against unsharded (bitwise under
    # ozaki5x7), and the host-clock split of a sharded matvec: its
    # all-gather alone, the unsharded matvec in the same process
    def ms_per(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(P16_MATVECS):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.time() - t0) / P16_MATVECS

    out["matvec"] = {}
    for prec in ("native", "ozaki5x7"):
        cfg = _p16_cfg(prec)
        sec = sector_table(cfg).get(cfg.ns // 2, cfg.ns // 2)
        ham = build_sector_hamiltonian(cfg, sec, unpack_bath(cfg, bath),
                                       np.zeros((1, 1, 1, 1)))
        spec, arrays, blocks, _ = sharded_sector_op(ham, cfg, rows)
        s1, a1, b1 = make_matvec_op(ham, cfg, device)
        g = torch.Generator().manual_seed(160)
        x = torch.randn(b1[0], dtype=torch.float64, generator=g).to(device)
        sl = row_slice(rows, b1[0][0])
        xl = x[sl].contiguous()
        y1 = apply_op(s1, a1, (x,))[0][sl]
        gather = row_gather(rows)
        for k in calls:
            calls[k] = 0
        y2 = apply_op(spec, arrays, (xl,), gather)[0]
        out["matvec"][prec] = dict(
            bitwise=bool(torch.equal(y1, y2)),
            max_rel_err=float((y1 - y2).abs().max() / y1.abs().max()),
            gathers=calls["all_gather"], local=tuple(blocks[0]),
            ms=ms_per(lambda: apply_op(spec, arrays, (xl,), gather)),
            gather_ms=ms_per(lambda: gather(xl)),
            unsharded_ms=ms_per(lambda: apply_op(s1, a1, (x,))),
            gather_mb=8 * b1[0][0] * b1[0][1] / 1e6)
    # (b) the flake on a sites=2 mesh
    sites = make_mesh(n_rows=1, n_sites=P16_RANKS, device="cuda")
    fcfg, fhloc, fbaths = _p16_flake()
    os.makedirs("flake", exist_ok=True)
    os.chdir("flake")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rs = LatticeEDSolver(fcfg, fhloc, log=lambda m: None,
                         mesh=sites).solve(fbaths)
    torch.cuda.synchronize()
    out["flake"] = dict(
        values=[_solve_values(r) for r in rs], seconds=time.time() - t0,
        launches={n: fn.launches for n, fn in KERNELS.items()},
        peak_gib=_peak_gib())
    os.chdir("..")
    return out


def _file_lines(d):
    """{name: number of lines} of the files in directory `d`."""
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if os.path.isfile(path):
            with open(path) as fh:
                out[name] = sum(1 for _ in fh)
    return out


def _same_files(label, got_dir, ref_dir, bad):
    """Print and check that `got_dir` holds the file names and line counts
    of `ref_dir`."""
    got, ref = _file_lines(got_dir), _file_lines(ref_dir)
    diff = sorted(n for n in set(got) | set(ref) if got.get(n) != ref.get(n))
    print(f"phase 16 files {label}: {len(got)} files, {sum(got.values())} "
          f"lines; the single-process run's {len(ref)} files, "
          f"{sum(ref.values())} lines; differing: {diff}")
    if diff or not ref:
        bad.append(f"{label}: the shared directory's files differ from the "
                   "single-process run's")


def mesh_phases(device, work, bath=None, res7=None, secs7=None,
                sectors=None):
    """Phase 16 (a)-(c) in a directory of its own. Without phase 7's
    results (``--phases 16``) it solves its own single-process references
    on the initial bath first. The two ranks share one directory
    (``ranks/shared``), where rank 0 alone writes: their files are checked
    against phase 7's ozaki5x7 solve's (``P7_OZAKI_DIR``) and (b)'s
    single-process flake's. Returns the launches per kernel of each path
    (the ranks' launches summed)."""
    import shutil
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.bath import init_bath, pack_bath
    from dmft_ed_tpu_torch.diag import diagonalize
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.lattice_solver import LatticeEDSolver
    from dmft_ed_tpu_torch.parallel.spawn import run_ranks
    from dmft_ed_tpu_torch.solver import EDSolver
    t16 = time.time()
    os.mkdir("phase16")
    os.chdir("phase16")
    hloc = np.zeros((1, 1, 1, 1))
    ref_dir = os.path.join(work, P7_OZAKI_DIR)
    if res7 is None:
        cfg = _p16_cfg("native", ed_sectors=False)
        bath = pack_bath(init_bath(cfg, hloc))
        res7, secs7 = {}, {}
        ref_dir = os.path.join(os.getcwd(), P7_OZAKI_DIR)
        for prec in ("native", "ozaki5x7"):
            if prec != "native":     # as phase 7 runs it
                sectors = open("sectors_list.restart").read()
                os.mkdir(ref_dir)
                shutil.copy("sectors_list.restart", ref_dir)
                os.chdir(ref_dir)
            t0 = time.time()
            torch.cuda.reset_peak_memory_stats()
            res7[prec] = EDSolver(_p16_cfg(prec, ed_sectors=prec != "native"),
                                  hloc, log=lambda m: None,
                                  device=device).solve(bath)
            torch.cuda.synchronize()
            secs7[prec] = (time.time() - t0, _peak_gib())
        os.chdir(os.path.join(work, "phase16"))
    # (b)'s single-process reference, the batched solve
    fcfg, fhloc, fbaths = _p16_flake()
    os.mkdir("flake")
    os.chdir("flake")
    t0 = time.time()
    flake1 = LatticeEDSolver(fcfg, fhloc, log=lambda m: None,
                             device=device).solve(fbaths)
    torch.cuda.synchronize()
    dt_flake1 = time.time() - t0
    os.chdir("..")
    # (a), (b): the two ranks
    t0 = time.time()
    ranks = run_ranks(f"{os.path.abspath(__file__)}:p16_rank", P16_RANKS,
                      dict(bath=np.asarray(bath), sectors=sectors),
                      os.path.join(os.getcwd(), "ranks"), P16_TIMEOUT,
                      backend="gloo", threads=2)
    dt_ranks = time.time() - t0
    out, bad = {}, []
    shared = os.path.join("ranks", "shared")
    for prec in ("native", "ozaki5x7"):
        _same_files(f"(a) {prec}", os.path.join(shared, prec), ref_dir, bad)
    _same_files("(b) flake", os.path.join(shared, "flake"), "flake", bad)
    if _file_lines(shared):
        bad.append("(a-b) the ranks wrote files outside their solves' "
                   "directories")
    for prec in ("native", "ozaki5x7"):
        ref = _solve_values(res7[prec])
        for rk, rr in enumerate(ranks):
            x = rr[prec]
            d = dict(egs=abs(x["egs"] - ref["egs"]),
                     g=float(np.max(np.abs(x["gmats"] - ref["gmats"]))),
                     sigma=float(np.max(np.abs(x["smats"] - ref["smats"]))),
                     dens=float(np.max(np.abs(x["dens"] - ref["dens"]))),
                     docc=float(np.max(np.abs(x["docc"] - ref["docc"]))))
            print(f"phase 16(a) sharded {prec} rank {rk}: {x['seconds']:.3f}"
                  f" s (single process, phase 7: {secs7[prec][0]:.3f} s, "
                  f"peak {secs7[prec][1]:.3f} GiB) "
                  f"egs={x['egs']!r} launches={x['launches']} "
                  f"collectives={x['collectives']} kernel calls held "
                  f"bitwise: {x['held']} peak {x['peak_gib']:.3f} GiB\n"
                  f"  stages {json.dumps(x['stages'])}\n  against phase 7: "
                  f"|d egs|={d['egs']:.3e} (bound {TOL_P16_EGS:g}) "
                  f"max|d G(iω)|={d['g']:.3e} ({TOL_P16_G:g}) max|d Σ(iω)|="
                  f"{d['sigma']:.3e} ({TOL_P16_SIGMA:g}) |d dens|="
                  f"{d['dens']:.3e} |d docc|={d['docc']:.3e} "
                  f"({TOL_P16_OBS:g})")
            if not (d["egs"] <= TOL_P16_EGS and d["g"] <= TOL_P16_G
                    and d["sigma"] <= TOL_P16_SIGMA
                    and d["dens"] <= TOL_P16_OBS
                    and d["docc"] <= TOL_P16_OBS):
                bad.append(f"(a) {prec} rank {rk} differs from the "
                           "single-process solve")
        out[f"sharded_nbath11_{prec}"] = {
            n: sum(rr[prec]["launches"][n] for rr in ranks) for n in KERNELS}
    if out["sharded_nbath11_ozaki5x7"]["digit_matmul"] <= 0:
        bad.append("(a) the sharded ozaki5x7 solve launched no kernel")
    if out["sharded_nbath11_native"]["digit_matmul"] != 0:
        bad.append("(a) the sharded native solve launched the kernel")
    for rk, rr in enumerate(ranks):
        for prec, m in rr["matvec"].items():
            print(f"phase 16(a) (6,6) {prec} matvec rank {rk}: local block "
                  f"{m['local']}, against the unsharded one bitwise: "
                  f"{m['bitwise']} (max relative {m['max_rel_err']:.3e}), "
                  f"{m['gathers']} all-gather of {m['gather_mb']:.2f} MB; "
                  f"host clock, two ranks on one card: {m['ms']:.3f} ms "
                  f"per sharded matvec, {m['gather_ms']:.3f} ms of it the "
                  f"all-gather alone, {m['unsharded_ms']:.3f} ms per "
                  "unsharded matvec")
            if prec != "native" and not m["bitwise"]:
                bad.append(f"(a) rank {rk}'s sharded {prec} matvec is not "
                           "bitwise")
            if not m["max_rel_err"] <= TOL_P16_MATVEC_REL:
                bad.append(f"(a) rank {rk}'s sharded {prec} matvec "
                           "differs")
    for rk, rr in enumerate(ranks):
        f = rr["flake"]
        d_e = max(abs(a["egs"] - r.egs) for a, r in zip(f["values"], flake1))
        d_g = max(float(np.max(np.abs(a["gmats"] - r.gmats)))
                  for a, r in zip(f["values"], flake1))
        d_o = max(max(float(np.max(np.abs(a["dens"] - r.observables.dens))),
                      float(np.max(np.abs(a["docc"] - r.observables.docc))))
                  for a, r in zip(f["values"], flake1))
        print(f"phase 16(b) flake Nbath=6 on sites=2, rank {rk}: "
              f"{f['seconds']:.3f} s (single process {dt_flake1:.3f} s), "
              f"launches={f['launches']} peak {f['peak_gib']:.3f} GiB; "
              f"max|d egs|={d_e:.3e} ({TOL_P16_SITES_EGS:g}) max|d G(iω)|="
              f"{d_g:.3e} ({TOL_P16_SITES_G:g}) max|d dens, docc|={d_o:.3e} "
              f"({TOL_P16_SITES_OBS:g})")
        if not (len(f["values"]) == 3 and d_e <= TOL_P16_SITES_EGS
                and d_g <= TOL_P16_SITES_G and d_o <= TOL_P16_SITES_OBS):
            bad.append(f"(b) rank {rk}'s flake differs from the batched "
                       "solve")
    out["lattice_sites_mesh_native"] = {
        n: sum(rr["flake"]["launches"][n] for rr in ranks) for n in KERNELS}
    print(f"phase 16(a-b): the two ranks in {dt_ranks:.3f} s")
    # (c) float32
    cfg = _p16_cfg("native", ed_sectors=False, dtype="float32")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    r32 = EDSolver(cfg, hloc, log=lambda m: None, device=device).solve(bath)
    torch.cuda.synchronize()
    dt32 = time.time() - t0
    out["float32_nbath11"] = {n: fn.launches for n, fn in KERNELS.items()}
    e64 = res7["native"].egs
    rel = abs(r32.egs - e64) / abs(e64)
    print(f"phase 16(c) float32 Nbath=11 solve: {dt32:.3f} s, peak "
          f"{_peak_gib():.3f} GiB (float64, phase 7: {secs7['native'][0]:.3f}"
          f" s, peak {secs7['native'][1]:.3f} GiB) "
          f"egs={r32.egs!r} (float64 {e64!r}) relative {rel:.3e} (bound "
          f"{TOL_F32_EGS_REL:g}) docc={r32.observables.docc.tolist()} "
          f"launches={out['float32_nbath11']}")
    if not rel <= TOL_F32_EGS_REL:
        bad.append("(c) float32 egs differs from float64")
    with open("sectors_list.restart", "w") as fh:
        fh.write(f"{cfg.ns // 2} {cfg.ns // 2}\n")
    cfg66 = _p16_cfg("native", ed_sectors_shift=0, dtype="float32")
    t0 = time.time()
    sl66, _, _ = diagonalize(cfg66, init_bath(cfg66, hloc), hloc,
                             device=device)
    torch.cuda.synchronize()
    rel_j = abs(sl66.emin - F32_JAX_EGS) / abs(F32_JAX_EGS)
    print(f"phase 16(c) float32 (6,6) thick restart on the initial bath: "
          f"{time.time() - t0:.3f} s egs={sl66.emin!r}, the JAX package's "
          f"float32 {F32_JAX_EGS!r}: relative {rel_j:.3e} (bound "
          f"{TOL_F32_EGS_REL:g})")
    if not rel_j <= TOL_F32_EGS_REL:
        bad.append("(c) float32 egs differs from the JAX package's")
    if not all(np.all(np.isfinite(getattr(r32, f)))
               for f in ("gmats", "smats")):
        bad.append("(c) non-finite float32 G or Σ")
    os.chdir(work)
    print(f"phase 16: {time.time() - t16:.3f} s")
    if bad:
        raise AssertionError("phase 16: " + "; ".join(bad))
    return out


def nbands_full(device):
    """Phase 14(b): hm_bethe_nbands.run on NBANDS_CFG, one iteration:
    seconds per stage, the largest sector's matvecs, torch calls and ms
    per matvec (eager and graphed), the peak device memory; half filling
    before the fit; the ground state's sectors again with plain Lanczos.
    Returns (the initial bath, the first solve's egs, the launches per
    kernel)."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.bath import unpack_bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.models import hm_bethe_nbands
    from dmft_ed_tpu_torch.sectors import sector_table
    from dmft_ed_tpu_torch.solver import EDSolver
    cfg = EDConfig(**NBANDS_CFG).validate()
    hloc = np.zeros((1, 1, cfg.norb, cfg.norb))
    solver = EDSolver(cfg, hloc, log=lambda m: None, device=device)
    bath0 = solver.init_solver()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    with count_matvecs() as mv:
        r = hm_bethe_nbands.run(cfg, solver=solver, device=device,
                                log=lambda *a, **k: None)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    peak = _peak_gib()
    sec = max(sector_table(cfg).sectors, key=lambda x: x.dim)
    calls, ms, ms_g, nmix = matvec_calls(cfg, sec, unpack_bath(cfg, bath0),
                                         hloc, device)
    with open("sectors_list.restart") as fh:
        gs = [ln.strip() for ln in fh if ln.strip()]
    t1 = time.time()
    lz = EDSolver(cfg.replace(lanc_method="lanczos", ed_sectors=True,
                              ed_sectors_shift=0), hloc, log=lambda m: None,
                  device=device).solve(bath0)
    torch.cuda.synchronize()
    dt_l = time.time() - t1
    d_dens = float(np.max(np.abs(r.dens - 1.0)))
    d_egs = abs(r.egs - lz.egs)
    print(f"hm_bethe_nbands Nbath=10 hybrid Hund: 1 iteration in {dt:.3f} s"
          f"\n  stages {_stages(solver.timers)}\n  largest sector "
          f"{sec.qn} dim {sec.dim}: {mv.get(sec.dim, 0)} matvecs, {nmix} "
          f"mix entry (pmix), {calls} torch calls, {ms:.3f} ms eager and "
          f"{ms_g:.3f} ms graphed per matvec; {sum(mv.values())} matvecs "
          f"in all; peak device memory {peak:.3f} GiB; launches={launches}"
          f"\n  dens={r.dens.tolist()} docc={r.docc.tolist()} "
          f"egs={r.egs!r}; max|dens - 1|={d_dens:.3e} (bound "
          f"{TOL_NBANDS_DENS:g})\n  ground-state sectors {gs}: plain "
          f"Lanczos in {dt_l:.3f} s, egs={lz.egs!r}, |d egs|={d_egs:.3e} "
          f"(bound {TOL_EGS_METHODS:g})")
    bad = [f"non-finite {f}" for f in ("smats", "gmats", "bath", "dens",
                                       "docc")
           if not np.all(np.isfinite(getattr(r, f)))]
    if not d_dens <= TOL_NBANDS_DENS:
        bad.append("not half filling")
    if not d_egs <= TOL_EGS_METHODS:
        bad.append("arpack and lanczos egs disagree")
    if not np.all((r.docc > 0.0) & (r.docc < 0.25)):
        bad.append(f"docc {r.docc} outside (0, 1/4)")
    if bad:
        raise AssertionError("hm_bethe_nbands Nbath=10: " + "; ".join(bad))
    return bath0, r.egs, launches


def hund_operator(device, bath0):
    """Phase 14(c): the (6,6) sector of NBANDS_CFG on the initial bath,
    native against ozaki5x7 (operator_native_vs_ozaki, with the kernel's
    calls sampled bitwise against the plain version)."""
    import numpy as np
    from dmft_ed_tpu_torch.bath import unpack_bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.hamiltonian import build_sector_hamiltonian
    from dmft_ed_tpu_torch.sectors import sector_table
    cfg = EDConfig(**NBANDS_CFG).validate()
    hloc = np.zeros((1, 1, cfg.norb, cfg.norb))
    sec = sector_table(cfg).get(cfg.ns // 2, cfg.ns // 2)
    t0 = time.time()
    ham = build_sector_hamiltonian(cfg, sec, unpack_bath(cfg, bath0), hloc)
    print(f"Hund sector {sec.qn}: dim {sec.dim}, {len(ham.mix)} mix terms, "
          f"host build {time.time() - t0:.3f} s")
    if len(ham.mix) != 4:
        raise AssertionError(f"Hund sector: {len(ham.mix)} mix terms, not "
                             "4 (spin exchange and pair hopping)")
    return operator_native_vs_ozaki(device, cfg, ham, "Hund operator",
                                    HUND_KRYLOV, seed=140)


def mix_gather_phase(device, reps: int = 50):
    """Phase 18: the "pmix" kernel on the Hund cell's (7,7) operator in
    float64 and float32, against its plain version and the dense "bmix"
    path (bitwise), timed beside its byte bound and the dense batched
    products; then, in float64, the benchmark cell's thick restart from
    one start vector with the launch counts reset just before it (one
    launch per matvec). Returns (one record per dtype, the restart's
    launches per kernel); raises, after both dtypes have run, if any
    disagreed."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch import hamiltonian as tham
    from dmft_ed_tpu_torch.bath import Bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.diag import _ncv
    from dmft_ed_tpu_torch.kernels import (launch_counts, mix_gather,
                                           mix_gather_plain, reset_launches)
    from dmft_ed_tpu_torch.lanczos import eigs_lanczos_op
    from dmft_ed_tpu_torch.sectors import sector_table
    with open(os.path.join(REPO, "benchmark", "configs",
                           "hund2_nb12.json")) as fh:
        c = json.load(fh)
    out, bad = [], []
    for dtype in ("float64", "float32"):
        cfg = EDConfig(norb=2, nspin=1, bath_type=c["bath_type"],
                       nbath=c["nbath"], uloc=tuple(c["uloc"]),
                       ust=c["ust"], jh=c["jh"], jx=c["jx"], jp=c["jp"],
                       beta=c["beta"], xmu=c["xmu"], dtype=dtype).validate()
        bath = Bath(cfg)
        bath.e[0, :, :] = np.asarray(c["bath_e"])
        bath.v[0, :, :] = np.asarray(c["bath_v"])
        sec = sector_table(cfg).get(*c["sector"])
        ham = tham.build_sector_hamiltonian(cfg, sec, bath,
                                            np.zeros((1, 1, 2, 2)))
        spec, arrays, blocks = tham.make_matvec_op(ham, cfg, device)
        kinds = [m.kind for m in tham.mix_entries(spec)]
        if kinds != ["pmix"]:
            raise AssertionError(f"phase 18: mix entries {kinds}")
        ent = tham.mix_entries(spec)[0]
        tables = [arrays[i] for i in ent.tables]
        perm = tham._signed_perm
        tham._signed_perm = lambda coo: False
        try:
            dspec, darrays, _ = tham.make_matvec_op(ham, cfg, device)
        finally:
            tham._signed_perm = perm
        dent = tham.mix_entries(dspec)[0]
        g = torch.Generator(device=device).manual_seed(18)
        vt = getattr(torch, dtype)
        x = torch.randn(sec.dim, dtype=vt, device=device, generator=g)
        v = x.reshape(blocks[0])
        y0 = torch.randn(blocks[0], dtype=vt, device=device, generator=g)
        n0 = mix_gather.launches
        got = mix_gather(v, y0.clone(), *tables)
        launched = mix_gather.launches - n0
        ref = mix_gather_plain(v, y0.clone(), *tables)
        Vb = tham.unflatten_blocks(x, blocks)
        same_dense = torch.equal(
            tham.apply_op(spec, arrays, Vb)[0],
            tham.apply_op(dspec, darrays, Vb)[0])
        # least bytes: the distinct entries of V read and of Y written
        ds, us = (t.cpu().numpy() for t in (tables[0], tables[2]))
        ddw, dup = blocks[0]
        seen = 0
        for k in (0, 1):
            hit = np.zeros(ddw * dup, dtype=bool)
            for l in range(ds.shape[0]):
                r = np.flatnonzero(ds[l] >= 0)
                cc = np.flatnonzero(us[l] >= 0)
                if k == 0:
                    r, cc = ds[l][r], us[l][cc]
                hit[(r[:, None] * dup + cc[None, :]).ravel()] = True
            seen += int(hit.sum())
        nbytes = seen * x.element_size()
        y = y0.clone()
        rec = dict(dtype=dtype, shape=list(blocks[0]), terms=ent.nterms,
                   rows=ent.nrows, bitwise_plain=bool(torch.equal(got, ref)),
                   bitwise_dense=bool(same_dense), launches=launched,
                   least_bytes=nbytes,
                   bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                   ms=time_ms(lambda: mix_gather(v, y, *tables), reps),
                   plain_ms=time_ms(lambda: mix_gather_plain(v, y, *tables),
                                    5),
                   dense_ms=time_ms(lambda: dent.add(
                       darrays, lambda *_: v, y, blocks[0]), 10))
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        print("phase 18 mix_gather", json.dumps(rec))
        if not (rec["bitwise_plain"] and rec["bitwise_dense"]):
            bad.append(f"{dtype}: kernel {rec['bitwise_plain']}, dense "
                       f"{rec['bitwise_dense']}")
        if launched != 1:
            bad.append(f"{dtype}: {launched} launches")
        out.append(rec)
        del darrays
        if dtype == "float64":
            v0 = torch.randn(sec.dim, dtype=vt, device=device, generator=g)
            v0 = v0 / torch.linalg.vector_norm(v0)
            reset_launches()
            t0 = time.time()
            egs, _, niter = eigs_lanczos_op(
                spec, blocks, arrays, v0, 1, _ncv(cfg, sec.dim, 1),
                maxiter=min(sec.dim, cfg.lanc_niter), tol=cfg.lanc_tolerance)
            torch.cuda.synchronize()
            dt = time.time() - t0
            gs = launch_counts()
            print(f"phase 18 thick restart float64: egs={float(egs[0])!r} "
                  f"{int(niter)} matvecs in {dt:.3f} s, launches={gs}")
            if gs["mix_gather"] != int(niter):
                bad.append(f"thick restart: {gs['mix_gather']} launches "
                           f"for {int(niter)} matvecs")
        del arrays, tables
    if bad:
        raise AssertionError("phase 18: " + "; ".join(bad))
    return out, gs


def check_mix_gather_paths(per_path):
    """mix_gather launches on every path of MIX_PATHS, and on no ozaki5x7
    path (its mix terms take ozr/ozl) or Nbath=13 path (no mix terms)."""
    bad = [f"{k} launched none" for k in MIX_PATHS if not per_path[k] > 0]
    bad += [f"{k} launched {n}" for k, n in per_path.items()
            if ("ozaki5x7" in k or "nbath13" in k) and n]
    if bad:
        raise AssertionError("mix_gather launches: " + "; ".join(bad))


def hund_restart_ozaki(device, bath0, egs_native):
    """Phase 14(c), second path: the thick restart under ozaki5x7 of the
    (6,6) sector alone (ed_sectors over a sectors_list.restart written
    here; it holds a component of 14(b)'s ground-state triplet), on the
    initial bath. The mix terms keep the sector off the stacked p2-bucket
    restart, so this is the serial restart with the kernel inside every
    matvec. egs held to 14(b)'s native egs within TOL_EGS. Returns the
    launches per kernel."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.bath import unpack_bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.diag import diagonalize
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.timer import Timers
    cfg = EDConfig(**dict(NBANDS_CFG, matmul_precision="ozaki5x7",
                          ed_sectors=True, ed_sectors_shift=0,
                          ed_verbose=3)).validate()
    hloc = np.zeros((1, 1, cfg.norb, cfg.norb))
    with open("sectors_list.restart", "w") as fh:
        fh.write(f"{cfg.ns // 2} {cfg.ns // 2}\n")
    lines, timers = [], Timers()
    reset_launches()
    t0 = time.time()
    with count_matvecs() as mv:
        slist, _, _ = diagonalize(
            cfg, unpack_bath(cfg, bath0), hloc,
            log=lambda m: lines.append(m) if m.startswith("thick restart")
            else None, timers=timers, device=device)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    d_egs = abs(slist.emin - egs_native)
    nmv = sum(mv.values())
    ms_mv = 1e3 * timers.acc.get("diag.krylov_serial", 0.0) / max(nmv, 1)
    print(f"Hund thick restart ozaki5x7, the (6,6) sector: {dt:.3f} s, "
          f"{nmv} matvecs, {ms_mv:.3f} ms per matvec in the serial route, "
          f"launches={launches}, egs={slist.emin!r}; against 14(b)'s native "
          f"egs: |d egs|={d_egs:.3e} (bound {TOL_EGS:g})\n  stages "
          f"{_stages(timers)}\n  " + "\n  ".join(lines))
    bad = []
    if len(lines) != 1 or "bucket" in lines[0]:
        bad.append(f"not one serial restart: {lines}")
    if not d_egs <= TOL_EGS:
        bad.append("egs differs from the native solve's")
    for name in OZAKI_KERNELS:
        if launches[name] <= 0:
            bad.append(f"never launched {name}")
    if bad:
        raise AssertionError("Hund thick restart ozaki5x7: "
                             + "; ".join(bad))
    return launches


def hund_kernel_cases(device):
    """Phase-2 operands at phase 14's mix-term classes: the first mix term
    of NBANDS_CFG's (6,6) sector on its initial bath, a hop operator
    c+_a c_b of one spin (924x924), against a 924x4096 panel and against
    one (6,6) Krylov vector as a 924x924 panel, on both sides
    (C_dw @ W, V @ C_up^T). Krylov-like panels from a seed."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.bath import init_bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.hamiltonian import build_sector_hamiltonian
    from dmft_ed_tpu_torch.sectors import sector_table
    cfg = EDConfig(**NBANDS_CFG).validate()
    hloc = np.zeros((1, 1, cfg.norb, cfg.norb))
    sec = sector_table(cfg).get(cfg.ns // 2, cfg.ns // 2)
    t = build_sector_hamiltonian(cfg, sec, init_bath(cfg, hloc), hloc).mix[0]
    g = torch.Generator().manual_seed(5678)
    n = 2 ** cfg.ns     # the dw panel: every sector with n_dw = 6

    def randn(*shape):
        return (torch.randn(*shape, dtype=torch.float64, generator=g)
                / shape[0] ** 0.5).to(device)

    def dense(coo):
        return torch.as_tensor(coo.to_dense(), dtype=torch.float64,
                               device=device)
    K = t.dw.shape[0]
    return [c for w in (n, K) for c in (
        (f"mix dw K={K} N={w} (hop C @ W)", dense(t.dw), randn(K, w), 5, 7,
         None, None),
        (f"mix up K={K} M={w} (V @ hop C^T)", randn(w, K), dense(t.up).T,
         5, 7, None, None))]


def bench_kernel_cases(device):
    """Phase-2 operands at phase 17's classes: bench.py's Nbath=13 sector
    operators (3432x3432, K padded to 3440; M not a multiple of the
    kernel's 128-row tile) against a 3432x3432 Krylov-like panel from a
    seed, on both sides (H_dw @ V, V @ H_up^T); and the row slices a rank
    of a rows=2 mesh multiplies (bench_scaling's ozaki5x7 route)."""
    import torch
    from dmft_ed_tpu_torch.benches.bench import build_hamiltonian
    cfg, sec, ham = build_hamiltonian(P17_NBATH)
    K = sec.blocks[0].ddw
    g = torch.Generator().manual_seed(1700)
    V = (torch.randn(K, K, dtype=torch.float64, generator=g) / K).to(device)

    def dense(coo):
        return torch.as_tensor(coo.to_dense(), dtype=torch.float64,
                               device=device)
    Hdw, HupT = dense(ham.hdw[0]), dense(ham.hup[0]).T.contiguous()
    h = K // 2
    return [(f"bench dw K={K}", Hdw, V, 5, 7, None, None),
            (f"bench up K={K}", V, HupT, 5, 7, None, None),
            (f"bench rows dw {h} of {K}", Hdw[:h].contiguous(), V, 5, 7,
             None, None),
            (f"bench rows up {h} of {K}", V[:h].contiguous(), HupT, 5, 7,
             None, None)]


def _p17_diff(res, ref):
    """max_j |d alpha_j|, |d beta_j| of two runs over the largest |beta|
    of `ref`."""
    import numpy as np
    d = np.abs(np.r_[res["alphas"], res["betas"]]
               - np.r_[ref["alphas"], ref["betas"]])
    return float(d.max() / np.abs(ref["betas"]).max())


def entry_points(device):
    """Phase 17 (a), (c), (d): the benches at Nbath=13. Returns the
    launches per kernel of each path."""
    import numpy as np
    from dmft_ed_tpu_torch.benches import bench, bench_scaling
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    t17 = time.time()
    out, bad, runs = {}, [], {}
    for name, (dtype, prec) in bench.PRECISIONS.items():
        t0 = time.time()
        reset_launches()
        with held_kernel() as held:
            r = bench.run(P17_NBATH, dtype, P17_NITER, P17_REPEATS, prec,
                          device)
        out[f"bench_nbath13_{name}"] = {n: fn.launches
                                        for n, fn in KERNELS.items()}
        runs[name] = r
        print(f"phase 17(a) bench.run {name}: dim {r['dim']} nnz {r['nnz']}"
              f" {r['s_per_step'] * 1e3:.3f} ms per step, "
              f"{r['lanczos_iters_per_s']:.2f} Lanczos iterations/s, "
              f"{r['nnz_per_s']:.4e} nnz/s (warm-up {r['warmup_s']:.3f} s "
              f"for {P17_NITER} steps), launches "
              f"{out[f'bench_nbath13_{name}']}, kernel calls held bitwise: "
              f"{len(held)}, peak {r['peak_gib']:.3f} GiB, "
              f"{time.time() - t0:.3f} s in all")
        if not r["finite"]:
            bad.append(f"(a) {name}: non-finite Krylov vector")
    d_nat = _p17_diff(runs["native"], BENCH13_JAX)
    d_oz = _p17_diff(runs["ozaki5x7"], runs["native"])
    d_32 = _p17_diff(runs["float32"], runs["native"])
    print(f"phase 17(a) alphas, betas: native vs the JAX package "
          f"{d_nat:.3e} (bound {TOL_P17_NATIVE:g}); ozaki5x7 vs native "
          f"{d_oz:.3e} ({TOL_P17_OZAKI:g}); float32 vs native {d_32:.3e} "
          f"({TOL_P17_F32:g})")
    if not d_nat <= TOL_P17_NATIVE:
        bad.append("(a) native differs from the JAX package")
    if not d_oz <= TOL_P17_OZAKI:
        bad.append("(a) ozaki5x7 differs from native")
    if not d_32 <= TOL_P17_F32:
        bad.append("(a) float32 differs from native")
    if out["bench_nbath13_ozaki5x7"]["digit_matmul"] <= 0:
        bad.append("(a) the ozaki5x7 run launched no kernel")
    if out["bench_nbath13_native"]["digit_matmul"] \
            + out["bench_nbath13_float32"]["digit_matmul"]:
        bad.append("(a) a native or float32 run launched the kernel")
    gs = {}
    for prec in ("native", "ozaki5x7"):
        reset_launches()
        gs[prec] = bench.ground_state(P17_NBATH, prec, device)
        out[f"ground_state_nbath13_{prec}"] = {n: fn.launches
                                               for n, fn in KERNELS.items()}
        g = gs[prec]
        tol = TOL_P17_EGS if prec == "native" else TOL_P17_EGS_OZAKI
        print(f"phase 17(c) thick restart {prec}: egs={g['egs']!r} (the JAX"
              f" package's {BENCH13_JAX['egs']!r}, |d|="
              f"{abs(g['egs'] - BENCH13_JAX['egs']):.3e}, bound "
              f"{tol:g}) {g['matvecs']} matvecs (ncv {g['ncv']}; "
              f"the JAX package's {BENCH13_JAX['matvecs']}) in "
              f"{g['seconds']:.3f} s, launches "
              f"{out[f'ground_state_nbath13_{prec}']}, peak "
              f"{g['peak_gib']:.3f} GiB")
        if not (abs(g["egs"] - BENCH13_JAX["egs"]) <= tol and g["finite"]):
            bad.append(f"(c) {prec} egs differs from the JAX package's")
        # the vector operand's two splits per matvec, and the set-up's two
        # constant blocks (H_dw left, H_up^T right) under ozaki5x7
        want = 2 * g["matvecs"] + 2 if prec == "ozaki5x7" else 0
        n_split = out[f"ground_state_nbath13_{prec}"]["digit_split"]
        print(f"phase 17(c) {prec}: digit_split launches {n_split} "
              f"(expected {want})")
        if n_split != want:
            bad.append(f"(c) {prec}: {n_split} digit_split launches, not "
                       f"{want}")
    d_gs = abs(gs["native"]["egs"] - gs["ozaki5x7"]["egs"])
    print(f"phase 17(c) native vs ozaki5x7 egs |d|={d_gs:.3e} (bound "
          f"{TOL_P17_EGS_OZAKI:g})")
    if not d_gs <= TOL_P17_EGS_OZAKI:
        bad.append("(c) native and ozaki5x7 egs disagree")
    if out["ground_state_nbath13_ozaki5x7"]["digit_matmul"] <= 0:
        bad.append("(c) the ozaki5x7 restart launched no kernel")
    t0 = time.time()
    sc = bench_scaling.scaling(device, P17_NBATH, "native",
                               max_ranks=2, **P17_SCALING)
    for rec in sc:
        print(f"phase 17(d) bench_scaling native, {rec['ranks']} rank(s) "
              f"({rec['backend']}, sharing one card: {rec['shared_card']};"
              f" not a multi-GPU time): {rec['s_per_iter'] * 1e3:.3f} ms "
              f"per step, local block {rec['local_block']}, one matvec "
              f"{rec['matvec_ms']:.3f} ms, of it the {rec['gather_mb']:.1f}"
              f" MB all-gather alone {rec['gather_ms']:.3f} ms; "
              f"alphas, betas vs one rank {rec['max_rel_diff_vs_1rank']:.3e}"
              f" (bound {TOL_P17_SHARDED:g}); peak {rec['peak_gib']:.3f} "
              f"GiB per rank")
    out["scaling_nbath13_native"] = sc[-1]["launches_all_ranks"]
    if not (len(sc) == 2 and sc[1]["max_rel_diff_vs_1rank"]
            <= TOL_P17_SHARDED and np.isfinite(sc[1]["s_per_iter"])):
        bad.append("(d) the two ranks' alphas and betas differ from one "
                   "rank's")
    print(f"phase 17: {time.time() - t17:.3f} s")
    if bad:
        raise AssertionError("phase 17: " + "; ".join(bad))
    return out


def driver_phases(device, work):
    """Phase 14 (a)-(c), each in a directory of its own. Returns the
    launches per kernel of each path."""
    out = {}
    t14 = time.time()
    for part in ("a", "b", "c"):
        os.mkdir(f"phase14{part}")
        os.chdir(f"phase14{part}")
        t0 = time.time()
        if part == "a":
            out["drivers_native"] = drivers_small(device)
        elif part == "b":
            bath0, egs0, out["nbands_nbath10_native"] = nbands_full(device)
        else:
            out["hund_operator_ozaki5x7"] = hund_operator(device, bath0)
            out["hund_restart_ozaki5x7"] = hund_restart_ozaki(
                device, bath0, egs0)
        print(f"phase 14({part}): {time.time() - t0:.3f} s")
        os.chdir(work)
    print(f"phase 14: {time.time() - t14:.3f} s")
    return out


def nonsu2_phases(device, want, work):
    """Phases 10-12, each in a directory of its own; returns the launches
    per kernel of each (None for a phase not run)."""
    import numpy as np
    from dmft_ed_tpu_torch.aux import so2nn
    from dmft_ed_tpu_torch.models import bhz_2d, soc
    out = []
    for p in (10, 11, 12):
        if not want(p):
            out.append(None)
            continue
        os.mkdir(f"phase{p}")
        os.chdir(f"phase{p}")
        t0 = time.time()
        if p == 10:
            hloc = soc.build_hk_soc(SOC_RUN["nk"])[1]
            out.append(nonsu2_loop(device, soc, SOC_CFG, SOC_RUN, hloc,
                                   SOC_JAX))
        elif p == 11:
            nk = BHZ_RUN.get("nk", 20)
            hloc = so2nn(bhz_2d.build_hk_grid(nk, rh=BHZ_RUN["rh"])[1], 2, 2)
            out.append(nonsu2_loop(device, bhz_2d, BHZ_CFG, BHZ_RUN, hloc,
                                   BHZ_JAX))
        else:
            out.append(spin_orbit_impurity(device))
        print(f"phase {p}: {time.time() - t0:.3f} s")
        os.chdir(work)
    return out


def dev_phases(device, want, work):
    """--phases: the listed phases of 10-17 only; no result line."""
    nonsu2_phases(device, want, work)
    if want(13):
        flake_phases(device, work)
    if want(14):
        driver_phases(device, work)
    if want(15):
        lattice_phases(device, work)
    if want(16):
        mesh_phases(device, work)
    if want(17):
        p17 = bench_kernel_cases(device)
        digit_matmul_cases(device, p17)
        digit_split_cases(device, p17)
        entry_points(device)
    if want(18):
        mix_gather_phase(device)
    print("chip_smoke: development run of some phases only; no result")
    return 0


def main() -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="all",
                    help="comma-separated phases after phase 1, for "
                    "development (prints no result line)")
    only = ap.parse_args().phases
    want = (lambda p: True) if only == "all" \
        else (lambda p: str(p) in only.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.time()

    # ---- phase 1: the card and the build
    from dmft_ed_tpu_torch.benches import card_line
    card = card_line(device)
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    tensor_core = build_kernels()
    from dmft_ed_tpu_torch.models import ahm_bethe, bhz_2d, hm_bethe, soc
    if tensor_core["digit_matmul"] == 0:
        raise AssertionError("digit_matmul: no IGMMA/IMMA instruction in "
                             "the built library's SASS")

    # ---- phases 2-4 and 6-9 run in a scratch cwd (the solver writes .ed
    # files)
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            if only != "all":
                return dev_phases(device, want, work)
            # ---- phase 2: kernel vs plain at the main path's shapes
            p2 = (kernel_cases(device, MAIN_CFG)
                  + superc_kernel_cases(device) + hund_kernel_cases(device)
                  + bench_kernel_cases(device))
            cases = digit_matmul_cases(device, p2)
            splits = digit_split_cases(device, p2)
            del p2
            # ---- phase 3: the first slice's path
            r, obs, launches = main_path(device, MAIN_CFG, MAIN_RUN,
                                         hm_bethe)
            check_main_path(r, obs, launches)
            # ---- phase 4: precision of the ozaki path against native f64
            egs_lanczos = precision_check(device, MAIN_CFG, r.bath)
            # ---- phase 6: the canonical loop with the package defaults, in
            # a directory of its own (init_solver reads a bath restart file
            # from the cwd, and phase 3 left one there)
            os.mkdir("canonical")
            os.chdir("canonical")
            rc, _, launches_c = main_path(device, CANON_CFG, CANON_RUN,
                                          hm_bethe)
            os.chdir(work)
            check_canonical(rc)
            # ---- phase 7: the thick restart at Nbath=11, native + ozaki
            launches_a, res7, secs7 = arpack_solve(device, r.bath,
                                                   egs_lanczos)
            sectors7 = open("sectors_list.restart").read()
            # ---- phase 8: the canonical AHM loop, in a directory of its own
            os.mkdir("ahm")
            os.chdir("ahm")
            rs, _, launches_s = main_path(device, AHM_CFG, AHM_RUN,
                                          ahm_bethe)
            os.chdir(work)
            check_ahm(rs)
            # ---- phase 9: superc at Nbath=9 (a: solves, b: the operator)
            os.mkdir("superc")
            os.chdir("superc")
            superc_solve(device)
            launches_o = superc_operator(device)
            os.chdir(work)
            launches_soc, launches_bhz, launches_jz = nonsu2_phases(
                device, want, work)
            # ---- phase 13: inequivalent sites on the default flake
            launches_13 = flake_phases(device, work)
            # ---- phase 14: the single-site drivers, the Hund impurity
            launches_14 = driver_phases(device, work)
            # ---- phase 15: the lattice drivers, the superc U-stack
            launches_15 = lattice_phases(device, work)
            # ---- phase 16: the meshes (two ranks on the card), float32
            launches_16 = mesh_phases(device, work, r.bath, res7, secs7,
                                      sectors7)
            # ---- phase 17: the benchmark entry points at Nbath=13
            launches_17 = entry_points(device)
            # ---- phase 18: the mix terms' gather kernel, Hund (7,7)
            gathers, launches_18 = mix_gather_phase(device)
        finally:
            os.chdir(REPO)

    # ---- phase 5: the kernels line, the card, the result
    main_case = next(c for c in cases if c["label"] == MAIN_CASE)
    kernels = [{
        "name": "digit_matmul",
        "route": "cuda",
        "source": "dmft_ed_tpu_torch/csrc/digit_matmul.cu",
        "replaces": "dmft_ed_tpu/pallas_kernels.py:37",
        "launches": launches["digit_matmul"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "parity": "bitwise",
        "shape": "x".join(str(x) for x in main_case["shape"])
        + f" P={main_case['P']} B={main_case['B']}",
        "launches_per_path": {
            "lanczos_loop_ozaki5x7": launches["digit_matmul"],
            "canonical_loop_native": launches_c["digit_matmul"],
            "arpack_solve_ozaki5x7": launches_a["digit_matmul"],
            "ahm_loop_native": launches_s["digit_matmul"],
            "superc_operator_ozaki5x7": launches_o["digit_matmul"],
            "soc_loop_native": launches_soc["digit_matmul"],
            "bhz_loop_native": launches_bhz["digit_matmul"],
            "spin_orbit_impurity_native": launches_jz["digit_matmul"],
            **{k: v["digit_matmul"] for k, v in launches_13.items()},
            **{k: v["digit_matmul"] for k, v in launches_14.items()},
            **{k: v["digit_matmul"] for k, v in launches_15.items()},
            **{k: v["digit_matmul"] for k, v in launches_16.items()},
            **{k: v["digit_matmul"] for k, v in launches_17.items()}},
        "ms_per_class": {c["label"]: c["ms"] for c in cases
                         if "embedded" in c["label"]
                         or c["label"].startswith(("fused", "superc",
                                                   "mix", "rows", "bench"))},
    }]
    main_split = next(c for c in splits
                      if c["label"] == "bench up K=3432 left")
    kernels.append({
        "name": "digit_split",
        "route": "cuda",
        "source": "dmft_ed_tpu_torch/csrc/digit_split.cu",
        "replaces": None,
        "launches": launches["digit_split"],
        "ms": main_split["ms"],
        "plain_ms": main_split["plain_ms"],
        "bound_ms": main_split["bound_ms"],
        "bound_by": "bytes",
        "parity": "bitwise",
        "shape": "x".join(str(x) for x in main_split["shape"])
        + f" P={main_split['P']} B={main_split['B']}",
        "launches_per_path": {
            "lanczos_loop_ozaki5x7": launches["digit_split"],
            "canonical_loop_native": launches_c["digit_split"],
            **{k: v["digit_split"] for k, v in launches_17.items()
               if "digit_split" in v}},
        "ms_per_class": {c["label"]: c["ms"] for c in splits},
    })
    main_gather = gathers[0]
    gather_paths = {
        "lanczos_loop_ozaki5x7": launches["mix_gather"],
        "canonical_loop_native": launches_c["mix_gather"],
        "arpack_solve_ozaki5x7": launches_a["mix_gather"],
        "ahm_loop_native": launches_s["mix_gather"],
        "superc_operator_ozaki5x7": launches_o["mix_gather"],
        "soc_loop_native": launches_soc["mix_gather"],
        "bhz_loop_native": launches_bhz["mix_gather"],
        "spin_orbit_impurity_native": launches_jz["mix_gather"],
        **{k: v["mix_gather"] for d in (launches_13, launches_14, launches_15,
                                        launches_16, launches_17)
           for k, v in d.items() if "mix_gather" in v},
        "hund_gs_nbath12_native": launches_18["mix_gather"]}
    check_mix_gather_paths(gather_paths)
    kernels.append({
        "name": "mix_gather",
        "route": "cuda",
        "source": "dmft_ed_tpu_torch/csrc/mix_gather.cu",
        "replaces": None,
        "launches": launches_18["mix_gather"],
        "ms": main_gather["ms"],
        "plain_ms": main_gather["plain_ms"],
        "bound_ms": main_gather["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_gather["dense_ms"],
        "parity": "bitwise",
        "shape": "x".join(str(x) for x in main_gather["shape"])
        + f" L={main_gather['terms']}",
        "launches_per_path": gather_paths,
        "ms_per_class": {g["dtype"]: g["ms"] for g in gathers},
    })
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
