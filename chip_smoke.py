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
   final bath, with ``native`` and with ``ozaki5x7`` (its p2 buckets run
   the stacked restart over zero-embedded operators), held to phase 4's
   plain-Lanczos egs and to each other;
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
   other, with the kernel's launches;
5. printed last, after phases 6 to 9: a ``{"kernels": [...]}`` line, the
   card line, and as the last line ``{"ok": true, "device": {...}}``.

Phase 2 also holds the kernel at phase 9's classes: the 252 block class on
both sides and the largest pairing classes, 252 -> 210 and 210 -> 252, on
both sides.

Every path runs with the launch counts reset just before it and read just
after it.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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


def main_path(device, cfg_kwargs, run_kwargs, loop):
    """The port's DMFT loop ``loop.run`` (a module of ``models``) through
    its public entry points, with per-iteration seconds, stage splits and
    launches printed. Returns (result, per-iteration (dens, docc, egs,
    phi), launches per kernel)."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.solver import EDSolver
    cfg = EDConfig(**cfg_kwargs).validate()
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
    for name, n in launches.items():
        if n <= 0:
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
    per kernel."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.solver import EDSolver
    res, launches = {}, {}
    for prec in ("native", "ozaki5x7"):
        cfg = EDConfig(**dict(ARPACK_CFG, matmul_precision=prec,
                              ed_verbose=3)).validate()
        hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
        lines = []
        solver = EDSolver(cfg, hloc, device=device, log=lambda m: lines.append(
            m) if m.startswith("thick restart") else None)
        reset_launches()
        t0 = time.time()
        res[prec] = solver.solve(bath)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.time() - t0
        launches[prec] = {name: fn.launches for name, fn in KERNELS.items()}
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
    for name, n in launches["ozaki5x7"].items():
        if n <= 0:
            bad.append(f"the ozaki5x7 arpack solve never launched {name}")
    if bad:
        raise AssertionError("; ".join(bad))
    return launches["ozaki5x7"]


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
    and ozaki5x7, applied to 4 seeded vectors (one batched call) and run
    40 Lanczos steps from one seeded v0; the two agree within
    TOL_EXACT_REL (vectors) and TOL_KRYLOV (leading 24 alpha, beta).
    Returns the ozaki5x7 operator's kernel launches (counts reset before
    the ozaki5x7 encode, read after its Lanczos run)."""
    import numpy as np
    import torch
    from dmft_ed_tpu_torch.bath import init_bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.hamiltonian import (build_sector_hamiltonian,
                                               make_matvec_op, apply_op,
                                               flatten_blocks,
                                               unflatten_blocks)
    from dmft_ed_tpu_torch.kernels import KERNELS, reset_launches
    from dmft_ed_tpu_torch.lanczos import lanczos_tridiag_op
    from dmft_ed_tpu_torch.sectors import sector_table
    cfg = EDConfig(**SUPERC_CFG).validate()
    hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    sec = sector_table(cfg).get(0)
    t0 = time.time()
    ham = build_sector_hamiltonian(cfg, sec, init_bath(cfg, hloc), hloc)
    print(f"superc Sz=0 sector: dim {sec.dim}, {len(sec.blocks)} blocks, "
          f"{len(ham.mix)} mix terms, host build {time.time() - t0:.3f} s")
    rng = np.random.default_rng(90)
    X = torch.as_tensor(rng.normal(size=(4, sec.dim)), device=device)
    v0 = torch.as_tensor(rng.normal(size=sec.dim), device=device)
    v0 = v0 / torch.linalg.vector_norm(v0)
    def stamp():
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.time()

    out, launches = {}, {}
    for prec in ("native", "ozaki5x7"):
        c = cfg.replace(matmul_precision=prec)
        reset_launches()
        t0 = stamp()
        spec, arrays, blocks = make_matvec_op(ham, c, device)
        t1 = stamp()
        Y = flatten_blocks(apply_op(spec, arrays,
                                    unflatten_blocks(X, blocks)))
        t2 = stamp()
        al, be, ns = lanczos_tridiag_op(spec, blocks, arrays, v0, 40)
        t3 = stamp()
        launches[prec] = {n: fn.launches for n, fn in KERNELS.items()}
        out[prec] = (Y, al.cpu().numpy(), be.cpu().numpy(), int(ns))
        print(f"superc operator {prec}: encode {t1 - t0:.3f} s, apply to 4 "
              f"vectors {t2 - t1:.3f} s, 40 Lanczos steps {t3 - t2:.3f} s, "
              f"launches={launches[prec]}")
    (Yn, an, bn, nn), (Yo, ao, bo, no) = out["native"], out["ozaki5x7"]
    rel = float((Yn - Yo).abs().max()) / float(Yn.abs().max())
    d_kry = float(max(np.max(np.abs(an[:24] - ao[:24])),
                      np.max(np.abs(bn[:24] - bo[:24]))))
    print(f"superc operator native vs ozaki5x7: max|d Hv|/max|Hv|={rel:.3e} "
          f"(bound {TOL_EXACT_REL:g}); leading 24 alpha, beta "
          f"max|d|={d_kry:.3e} (bound {TOL_KRYLOV:g}); steps {nn}, {no}")
    bad = []
    if not rel <= TOL_EXACT_REL:
        bad.append("H v differs")
    if not d_kry <= TOL_KRYLOV or nn < 24 or no < 24:
        bad.append("Lanczos coefficients differ")
    for name, n in launches["ozaki5x7"].items():
        if n <= 0:
            bad.append(f"the ozaki5x7 operator never launched {name}")
    if bad:
        raise AssertionError("superc operator: " + "; ".join(bad))
    return launches["ozaki5x7"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.time()

    # ---- phase 1: the card and the build
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    tensor_core = build_kernels()
    from dmft_ed_tpu_torch.models import ahm_bethe, hm_bethe
    if tensor_core["digit_matmul"] == 0:
        raise AssertionError("digit_matmul: no IGMMA/IMMA instruction in "
                             "the built library's SASS")

    # ---- phases 2-4 and 6-9 run in a scratch cwd (the solver writes .ed
    # files)
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            # ---- phase 2: kernel vs plain at the main path's shapes
            cases = digit_matmul_cases(
                device, kernel_cases(device, MAIN_CFG)
                + superc_kernel_cases(device))
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
            launches_a = arpack_solve(device, r.bath, egs_lanczos)
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
            "superc_operator_ozaki5x7": launches_o["digit_matmul"]},
        "ms_per_class": {c["label"]: c["ms"] for c in cases
                         if "embedded" in c["label"]
                         or c["label"].startswith(("fused", "superc"))},
    }]
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
