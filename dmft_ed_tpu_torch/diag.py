"""Spectrum determination: the sector sweep — PyTorch port of
dmft_ed_tpu/diag.py (normal mode).

Replaces ED_DIAG.f90: per-sector choice of dense eigh vs (thick-restart or
plain) Lanczos, T=0 ground-state windowing vs the finite-T capacity-bounded
state list, Boltzmann trimming with `lanc_nstates_total` auto-tuning and
per-sector `neigen_sector` feedback (ED_DIAG.f90:49-565). Krylov vectors
live on the solver's device; start vectors come from the reference's numpy
Generator stream in the same draw order and are then moved to the device.

Batched routes: ``lanc_method="lanczos"`` sectors run in the whole-sweep
lockstep engine (sweep_plain.py); ``"arpack"`` sectors whose dims share a
power-of-two class run as one stacked thick restart over zero-embedded
operators (``_solve_deferred_ragged``).

Inequivalent sites: ``diagonalize_sites`` sweeps every site's sectors in
one pass, one batched dense eigh per small sector and one stacked thick
restart over the sites' operators per large one.

Meshes (parallel/): with a ``(sites, rows)`` mesh, sectors of dim >=
cfg.shard_dim_threshold solve row-sharded (parallel.hxv), and
``diagonalize_sites`` splits its eigh batches and stacked restarts over
the sites group. Every rank draws the same start vectors in sweep order
and returns the whole result.

``dtype="float32"`` runs the Krylov vectors in float32 / complex64 (a
complex start vector stays complex128, as in the JAX package) with the
plain-Lanczos convergence test at 1e-5.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from .config import EDConfig
from .sectors import SectorTable, sector_table, sector_label
from .bath import Bath
from .eigenspace import StateList
from .hamiltonian import (build_sector_hamiltonian, assemble_dense,
                          make_matvec_op)
from .lanczos import (_sizes, eigs_lanczos_op, lanczos_tridiag_op,
                      tridiag_eigh)
from .parallel.hxv import solve_sector_sharded
from .parallel.mesh import (from_rank0, rows_sharded, site_chunk,
                            sites_sharded, writes_files)


@dataclass
class DiagState:
    """Mutable across-DMFT-iteration solver memory (neigen feedback etc.)."""
    neigen_sector: Dict[int, int] = field(default_factory=dict)
    lanc_nstates_total: int = 1
    trim_counter: int = 0
    # per-sector converged plain-Lanczos iteration counts: DMFT iterations
    # revisit near-identical baths, so the previous count (+headroom)
    # replaces the blind lanc_niter-length scan (see _solve_sector_lanczos)
    lanc_niter_sector: Dict[int, int] = field(default_factory=dict)


def sectors_mask(cfg: EDConfig, table: SectorTable,
                 suffix: str = "", mesh=None) -> np.ndarray:
    """ed_sectors restriction from sectors_list restart file
    (ed_pre_diag, ED_DIAG.f90:263-363).

    Two-quantum-number sectors read two-column rows: (nup, ndw) for
    normal mode and (n, 2Jz) for nonsu2 with jz_basis
    (ED_DIAG.f90:322-343), each qn shifted independently by
    ed_sectors_shift. (The reference's inner n-shift loop accumulates M
    across the sign loop — a transcription slip; the intended independent
    +/-shift of each qn is implemented here.) The candidate audit trail
    goes to ``list_of_sectors<suffix>.ed`` as in ED_DIAG.f90:283-356.
    With a `mesh`, rank 0 alone wrote the restart file: it reads it, writes
    the audit trail and sends every rank the mask."""
    if not cfg.ed_sectors:
        return np.ones(len(table), dtype=bool)
    return from_rank0(mesh, lambda: _read_sectors_mask(cfg, table, suffix))


def _read_sectors_mask(cfg: EDConfig, table: SectorTable,
                       suffix: str) -> np.ndarray:
    mask = np.ones(len(table), dtype=bool)
    path = f"sectors_list{suffix}.restart"
    if not os.path.exists(path):
        return mask
    mask[:] = False
    with open(path) as fh:
        rows = [tuple(int(float(x)) for x in ln.split())
                for ln in fh if ln.strip()]
    sh = cfg.ed_sectors_shift
    two_qn = cfg.ed_mode == "normal" or \
        (cfg.ed_mode == "nonsu2" and cfg.jz_basis)
    audit = []    # (sector index | 0, matched?, qns) per candidate
    for row in rows:
        if two_qn:
            a, b = row[0], row[1]
            cands = [(a, b)]
            for s in range(1, sh + 1):
                cands += [(a + s, b), (a - s, b),
                          (a, b + s), (a, b - s)]
        else:
            q = row[0]
            cands = [(q,)] + [(q + s * sgn,) for s in range(1, sh + 1)
                              for sgn in (-1, 1)]
        for c in cands:
            sec = table.get(*c)
            if sec is not None:
                mask[sec.index] = True
                audit.append((sec.index + 1, True, c))
            else:
                audit.append((0, False, c))
    try:
        with open(f"list_of_sectors{suffix}.ed", "w") as fh:
            for idx, ok, c in audit:
                fh.write(f"{idx:6d} {'T' if ok else 'F'} "
                         + " ".join(f"{q:4d}" for q in c) + "\n")
    except OSError:
        pass
    return mask


def _is_self_twin(cfg: EDConfig, sec) -> bool:
    """Whether a sector coincides with its ed_twin conjugate (no mirror
    state to add; ED_DIAG.f90:220-236 adds twins only when the sectors
    differ)."""
    if sec.qn[0] == "normal":
        return sec.qn[1] == sec.qn[2]
    if sec.qn[0] == "superc":
        return sec.qn[1] == 0
    if sec.qn[0] == "nonsu2jz":
        return sec.qn[1] == cfg.ns and sec.qn[2] == 0
    return sec.qn[1] == cfg.ns


def _solve_sector_dense(ham, neigen: int, device):
    H = assemble_dense(ham)
    evals, evecs = np.linalg.eigh(H)
    return evals[:neigen], torch.as_tensor(evecs[:, :neigen].T.copy(),
                                           device=device)


def _draw_v0(cfg: EDConfig, cplx: bool, dim: int, rng, device):
    """Normalized random Krylov start vector (one rng draw per sector, in
    sweep order — the reference's stream and order), moved to `device`."""
    v0 = rng.normal(size=dim)
    if cplx:
        v0 = v0 + 1j * rng.normal(size=dim)
    v0 = torch.as_tensor(v0, device=device).to(
        torch.complex128 if cplx else getattr(torch, cfg.dtype))
    return v0 / torch.linalg.vector_norm(v0)


def _plain_tol(cfg: EDConfig) -> float:
    """The plain-Lanczos convergence test's tolerance: float32-class
    Krylov jitters E0 at ~1e-6, so 1e-5 there."""
    return max(cfg.lanc_tolerance,
               1e-5 if cfg.dtype == "float32" else 1e-14)


def _tridiag_e0(al, be, k: int) -> float:
    """Ground Ritz value of the leading k x k tridiagonal block (host)."""
    import scipy.linalg as sla
    if k <= 1:
        return float(al[0])
    return float(sla.eigh_tridiagonal(al[:k], be[1:k],
                                      select="i",
                                      select_range=(0, 0))[0][0])


def _min_converged(al, be, n: int, tol: float) -> int:
    """Smallest k with |E0(k) - E0(n)| <= tol*max(1, |E0(n)|): the point
    the reference's per-iteration deltaE test would have stopped at
    (PLAIN_LANCZOS.f90:235-259). E0(k) decreases monotonically in k
    (variational), so binary search applies."""
    e_n = _tridiag_e0(al, be, n)
    thr = tol * max(1.0, abs(e_n))
    lo, hi = 1, n
    while lo < hi:
        mid = (lo + hi) // 2
        if _tridiag_e0(al, be, mid) - e_n <= thr:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _ncv(cfg: EDConfig, dim: int, neigen: int) -> int:
    """Thick-restart basis size (ED_DIAG.f90's lanc_ncv rule)."""
    return min(dim, cfg.lanc_ncv_factor * max(neigen, cfg.lanc_nstates_sector)
               + cfg.lanc_ncv_add)


def _log_restart(log, cfg, what, dim, neigen, ncv, niter):
    """One line per thick-restart solve: its basis (as the solver clamps
    it), its matvecs per member and its expansions (the first plus one per
    restart)."""
    if log and cfg.ed_verbose >= 3:
        k, ncv, _ = _sizes(dim, neigen, ncv, 0)
        log(f"thick restart: {what} k={k} ncv={ncv} matvecs={niter} "
            f"expansions={1 + max(0, niter - ncv) // max(ncv - k, 1)}")


def _solve_sector_lanczos(cfg: EDConfig, ham, neigen: int, rng, device,
                          v0=None, timers=None, niter_mem=None, log=None,
                          mesh=None):
    from contextlib import nullcontext
    tm = timers if timers is not None else (lambda name: nullcontext())
    sec = ham.sector
    if rows_sharded(mesh) and sec.dim >= cfg.shard_dim_threshold:
        # the row-sharded solve over the mesh (the reference's MPI sector
        # solve, ED_MAIN.f90:284-327)
        with tm("diag.sharded"):
            return solve_sector_sharded(cfg, ham, neigen, rng, mesh, v0=v0)
    with tm("diag.encode"):
        spec, arrays, blocks = make_matvec_op(ham, cfg, device)
    cplx = spec[-1].startswith("complex")
    if v0 is None:
        v0 = _draw_v0(cfg, cplx, sec.dim, rng, device)
    if cfg.lanc_method.lower() != "lanczos":
        ncv = _ncv(cfg, sec.dim, neigen)
        with tm("diag.thick_restart"):
            evals, evecs, niter = eigs_lanczos_op(
                spec, blocks, arrays, v0, neigen, ncv,
                maxiter=min(sec.dim, cfg.lanc_niter), tol=cfg.lanc_tolerance)
        _log_restart(log, cfg, f"sector {sec.index} dim={sec.dim}", sec.dim,
                     neigen, ncv, niter)
        return np.asarray(evals), evecs
    # plain-Lanczos T=0 path: two-pass ground state — tridiagonalize
    # once, then replay the recurrence with the STORED (alpha, beta) to
    # accumulate |gs> (2n matvecs, dot-free second pass;
    # PLAIN_LANCZOS.f90:189-397).
    #
    # Convergence-adaptive length: the converged count from the previous
    # DMFT iteration (niter_mem) sizes this iteration's scan; the result
    # is convergence-verified on the host from the tridiagonal and the
    # scan doubles on a miss. Lengths are quantized to quarters of
    # lanc_niter exactly as in the reference — the quantization no longer
    # saves compiles here, but it fixes the chain lengths (and so the
    # numerics) that parity with the reference is held to.
    from .lanczos import lanczos_rebuild_gs_op
    niter_max = min(sec.dim, cfg.lanc_niter)
    tol = _plain_tol(cfg)
    q = max(32, niter_max // 4)
    hint = niter_mem.get(sec.index) if niter_mem is not None else None
    ni = niter_max if hint is None \
        else min(niter_max, _round_up(max(hint + 16, 32), q))
    while True:
        with tm("diag.tridiag"):
            al, be, ns_ = lanczos_tridiag_op(spec, blocks, arrays, v0, ni)
        n = max(int(ns_), 1)
        al_h = al[:n].cpu().numpy().astype(np.float64)
        be_h = be[:n].cpu().numpy().astype(np.float64)
        if n < ni or ni >= niter_max:
            break    # breakdown (exact subspace) or at the cap
        # converged if the last 8 steps moved E0 by < tol
        e_n = _tridiag_e0(al_h, be_h, n)
        if _tridiag_e0(al_h, be_h, max(1, n - 8)) - e_n \
                <= tol * max(1.0, abs(e_n)):
            break
        ni = min(niter_max, ni * 2)    # hint too small: extend (rare)
    if niter_mem is not None:
        niter_mem[sec.index] = _min_converged(al_h, be_h, n, tol)
    evals, Y = tridiag_eigh(al_h, be_h)
    with tm("diag.rebuild"):
        gs = lanczos_rebuild_gs_op(spec, blocks, arrays, v0,
                                   al.cpu().numpy(), be.cpu().numpy(),
                                   Y[:, 0], n)
    return np.array([evals[0]]), gs[None, :]


def _solve_deferred_ragged(cfg: EDConfig, tasks, results, rng, device,
                           timers=None, log=None):
    """Solve deferred single-block thick-restart sector tasks, batching
    sectors whose flat dims share a power-of-two class into ONE stacked
    thick restart over zero-embedded operators
    (hamiltonian.make_padded_matvec_op + lanczos.eigs_lanczos_op_stacked).

    Exact: a Krylov chain started from a zero-padded vector never leaves
    the embedded subspace, so the Ritz spectrum is the sector's own;
    per-member convergence and exact-subspace breakdown are finalized
    individually by the stacked restart. A singleton bucket, one whose pad
    exceeds twice its class (ddw_pad·dup_pad > 2·p2), or a device that
    does not batch solves per sector.

    tasks: list of (sector, ham, neigen, v0); results[sec.index] is
    filled with (evals, evecs)."""
    from contextlib import nullcontext
    tm = timers if timers is not None else (lambda name: nullcontext())
    from .device import ragged_batching
    from .hamiltonian import make_padded_matvec_op
    from .lanczos import eigs_lanczos_op_stacked
    buckets = {}
    for t in tasks:
        p2 = 1 << (t[0].dim - 1).bit_length()
        cplx = np.issubdtype(t[1].dtype, np.complexfloating)
        buckets.setdefault((cplx, p2), []).append(t)
    for (cplx, p2), ts in sorted(buckets.items(),
                                 key=lambda kv: (kv[0][1], kv[0][0])):
        ddw_pad = max(t[0].blocks[0].ddw for t in ts)
        dup_pad = max(t[0].blocks[0].dup for t in ts)
        if len(ts) < 2 or ddw_pad * dup_pad > 2 * p2 \
                or not ragged_batching(device):
            for sec, ham, neigen, v0 in ts:
                results[sec.index] = _solve_sector_lanczos(
                    cfg, ham, neigen, rng, device, v0=v0, timers=timers,
                    log=log)
            continue
        nnz_up = max(t[1].hup[0].rows.size for t in ts)
        nnz_dw = max(t[1].hdw[0].rows.size for t in ts)
        with tm("diag.encode"):
            spec_p = blocks_p = None
            ops = []
            V0 = torch.zeros((len(ts), ddw_pad * dup_pad),
                             dtype=torch.complex128 if cplx
                             else getattr(torch, cfg.dtype), device=device)
            for s, (sec, ham, neigen, v0) in enumerate(ts):
                sp, ar, bl = make_padded_matvec_op(ham, cfg, ddw_pad, dup_pad,
                                                   nnz_up, nnz_dw, device)
                if spec_p is None:
                    spec_p, blocks_p = sp, bl
                elif sp != spec_p:
                    raise AssertionError("bucket key must force a common spec")
                ops.append(ar)
                blk = sec.blocks[0]
                V0[s].view(ddw_pad, dup_pad)[:blk.ddw, :blk.dup] = \
                    v0.reshape(blk.ddw, blk.dup)
            arrays_stacked = tuple(torch.stack([op[i] for op in ops])
                                   for i in range(len(ops[0])))
            del ops
        k = max(t[2] for t in ts)
        ncv = max(_ncv(cfg, t[0].dim, t[2]) for t in ts)
        maxiter = max(min(t[0].dim, cfg.lanc_niter) for t in ts)
        with tm("diag.thick_restart"):
            evals_b, evecs_b, niter = eigs_lanczos_op_stacked(
                spec_p, blocks_p, arrays_stacked, V0, k, ncv,
                maxiter=maxiter, tol=cfg.lanc_tolerance)
        del arrays_stacked, V0
        _log_restart(log, cfg, f"bucket p2={p2} members={len(ts)} "
                     f"pad={ddw_pad}x{dup_pad}", ddw_pad * dup_pad, k, ncv,
                     niter)
        for s, (sec, ham, neigen, v0) in enumerate(ts):
            blk = sec.blocks[0]
            ev = evals_b[s]
            kk = min(neigen, int(np.sum(np.isfinite(ev))),
                     evecs_b[s].shape[0])
            vec = evecs_b[s][:kk].reshape(-1, ddw_pad, dup_pad)
            vec = vec[:, :blk.ddw, :blk.dup].reshape(kk, sec.dim)
            results[sec.index] = (ev[:kk], vec)
        del evecs_b


def _solve_deferred_plain(cfg: EDConfig, tasks, results, rng, device,
                          timers=None, niter_mem=None):
    """Whole-sweep lockstep plain-Lanczos (sweep_plain.py): every
    mix-free single-block Krylov sector of the sweep runs its two-pass
    ground-state solve inside ONE lockstep loop whose matvec shares the
    per-(spin, n) operators across sectors and concatenates their vectors
    into ~Ns wide products per orientation. Scan lengths follow the
    convergence-adaptive quantized scheme of _solve_sector_lanczos."""
    from contextlib import nullcontext
    tm = timers if timers is not None else (lambda name: nullcontext())
    from .device import ragged_batching
    from .sweep_plain import (sweep_supported, make_sweep_op, sweep_tridiag,
                              sweep_rebuild)
    hams = [t[1] for t in tasks]
    if len(tasks) < 2 or not sweep_supported(cfg, hams) \
            or not ragged_batching(device):
        for sec, ham, neigen, v0 in tasks:
            results[sec.index] = _solve_sector_lanczos(
                cfg, ham, neigen, rng, device, v0=v0, timers=timers,
                niter_mem=niter_mem)
        return
    S = len(tasks)
    with tm("diag.encode"):
        spec, arrays = make_sweep_op(cfg, hams, device)
        V0 = tuple(t[3].reshape(t[0].blocks[0].ddw, t[0].blocks[0].dup)
                   for t in tasks)
    niter_maxes = [min(t[0].dim, cfg.lanc_niter) for t in tasks]
    nm = max(niter_maxes)
    q = max(32, nm // 4)
    tol = _plain_tol(cfg)
    hints = [niter_mem.get(t[0].index) if niter_mem is not None
             else None for t in tasks]
    ni = nm if any(h is None for h in hints) \
        else min(nm, _round_up(max(h + 16 for h in hints), q))
    while True:
        with tm("diag.tridiag"):
            al, be, ns_ = sweep_tridiag(spec, arrays, ni, V0)
            al_h = al.cpu().numpy().astype(np.float64)  # [ni, S]
            be_h = be.cpu().numpy().astype(np.float64)
            ns_h = ns_.cpu().numpy()
        if ni >= nm:
            break
        need_more = False
        for s in range(S):
            n_s = max(int(ns_h[s]), 1)
            if n_s < ni or ni >= niter_maxes[s]:
                continue    # breakdown / member at its cap
            als, bes = al_h[:n_s, s], be_h[:n_s, s]
            e_n = _tridiag_e0(als, bes, n_s)
            if _tridiag_e0(als, bes, max(1, n_s - 8)) - e_n \
                    > tol * max(1.0, abs(e_n)):
                need_more = True
                break
        if not need_more:
            break
        ni = min(nm, ni * 2)
    Ys = np.zeros((al_h.shape[0], S))
    e0s = np.empty(S)
    for s in range(S):
        n_s = max(int(ns_h[s]), 1)
        evals_s, Y_s = tridiag_eigh(al_h[:n_s, s], be_h[:n_s, s])
        Ys[:n_s, s] = Y_s[:, 0]
        e0s[s] = evals_s[0]
        if niter_mem is not None:
            niter_mem[tasks[s][0].index] = _min_converged(
                al_h[:n_s, s], be_h[:n_s, s], n_s, tol)
    with tm("diag.rebuild"):
        GS = sweep_rebuild(spec, arrays, int(al_h.shape[0]), V0, al_h, be_h,
                           Ys)
        if GS[0].is_cuda:    # the stage timer reads device time
            torch.cuda.synchronize(GS[0].device)
    for s, (sec, ham, neigen, v0) in enumerate(tasks):
        results[sec.index] = (np.array([e0s[s]]), GS[s].reshape(-1)[None, :])


def diagonalize(cfg: EDConfig, bath: Bath, hloc: np.ndarray,
                state: Optional[DiagState] = None,
                suffix: str = "", log=None, timers=None,
                device="cuda", mesh=None) -> tuple:
    """Full sector sweep. Returns (StateList, zeta, DiagState).

    timers: optional timer.Timers — accumulates the sweep's sub-stages
    (ham assembly / Krylov routes / dense eigh).
    mesh: optional parallel.Mesh with a 'rows' axis — sectors with dim >=
    cfg.shard_dim_threshold are then solved row-sharded over it
    (parallel.hxv); its device replaces `device`."""
    if mesh is not None:
        device = mesh.device
    from contextlib import nullcontext
    tm = timers if timers is not None else (lambda name: nullcontext())
    table = sector_table(cfg)
    if state is None:
        state = DiagState(lanc_nstates_total=cfg.lanc_nstates_total)
    if not state.neigen_sector:
        for sec in table.sectors:
            state.neigen_sector[sec.index] = min(sec.dim,
                                                 cfg.lanc_nstates_sector)

    smask = sectors_mask(cfg, table, suffix, mesh)
    tmask = table.twin_mask() if cfg.ed_twin else np.ones(len(table), bool)
    finite_t = state.lanc_nstates_total > 1

    slist = StateList()
    oldzero = 1000.0
    rng = np.random.default_rng(cfg.seed + 7)
    t0 = time.time()
    sweep = []
    for sec in table.sectors:
        if not (smask[sec.index] and tmask[sec.index]) or sec.dim == 0:
            continue
        # Jz_max pruning (ED_DIAG.f90:73)
        if cfg.jz_basis and cfg.jz_max and \
                abs(sec.qn[2]) > int(2 * cfg.jz_max_value):
            continue
        tflag = cfg.ed_twin and tmask[sec.index] \
            and not _is_self_twin(cfg, sec)
        sweep.append((sec, tflag,
                      min(sec.dim, state.neigen_sector[sec.index])))

    # ---- route plan (structural — no per-sector H build): dense /
    # serial-Krylov sectors stream one at a time; mix-free single-block
    # Krylov sectors batch: plain-Lanczos ones into the whole-sweep
    # lockstep engine, thick-restart ones in power-of-two size classes
    # into one stacked restart each (_solve_deferred_ragged).
    from .hamiltonian import single_particle_parts
    Tuu_s, _, Tud_s, P_s = single_particle_parts(cfg, bath, hloc)
    struct_mix = bool(np.any(Tud_s)) or bool(np.any(P_s)) \
        or (cfg.norb > 1 and (cfg.jx != 0.0 or cfg.jp != 0.0))
    struct_cplx = np.issubdtype(
        np.result_type(Tuu_s.dtype,
                       np.complex128 if np.any(Tud_s) else np.float64),
        np.complexfloating)
    plain = cfg.lanc_method.lower() == "lanczos"
    buckets: dict = {}
    routes = []
    v0s = {}
    for pos, (sec, tflag, neigen) in enumerate(sweep):
        lanc_solve = (neigen < sec.dim) and (sec.dim > cfg.lanc_dim_threshold)
        sharded = rows_sharded(mesh) and sec.dim >= cfg.shard_dim_threshold
        # every Krylov start vector is drawn HERE, in sweep order, so the
        # serial, sharded and batched routes consume the identical rng
        # stream
        if lanc_solve:
            v0s[pos] = _draw_v0(cfg, struct_cplx, sec.dim, rng, device)
        if lanc_solve and len(sec.blocks) == 1 and not struct_mix \
                and not sharded:
            key = ("sweep",) if plain \
                else (struct_cplx, 1 << (sec.dim - 1).bit_length())
            routes.append(key)
            buckets.setdefault(key, []).append(pos)
        else:
            routes.append(None)

    pending = {}
    it = 0
    for pos, (sec, tflag, neigen) in enumerate(sweep):
        it += 1
        if log and cfg.ed_verbose >= 3:
            log(f" {it:4d}-Solving sector {sec.index:4d} "
                f"{sector_label(sec)} dim={sec.dim} neigen={neigen}")
        if routes[pos] is None:
            lanc_solve = (neigen < sec.dim) \
                and (sec.dim > cfg.lanc_dim_threshold)
            with tm("diag.ham_build"):
                ham = build_sector_hamiltonian(cfg, sec, bath, hloc)
            if lanc_solve:
                with tm("diag.krylov_serial"):
                    evals, evecs = _solve_sector_lanczos(
                        cfg, ham, neigen, rng, device, v0=v0s.pop(pos),
                        timers=timers, niter_mem=state.lanc_niter_sector,
                        log=log, mesh=mesh)
            else:
                with tm("diag.dense_eigh"):
                    evals, evecs = _solve_sector_dense(ham, neigen, device)
                evals, evecs = evals[:neigen], evecs[:neigen]
            del ham
        else:
            if pos not in pending:
                tasks = []
                with tm("diag.ham_build"):
                    for p in buckets[routes[pos]]:
                        s2, _, n2 = sweep[p]
                        ham2 = build_sector_hamiltonian(cfg, s2, bath, hloc)
                        tasks.append((s2, ham2, n2, v0s.pop(p)))
                res = {}
                with tm("diag.krylov_ragged"):
                    if plain:
                        _solve_deferred_plain(
                            cfg, tasks, res, rng, device, timers=timers,
                            niter_mem=state.lanc_niter_sector)
                    else:
                        _solve_deferred_ragged(cfg, tasks, res, rng, device,
                                               timers=timers, log=log)
                del tasks
                for p in buckets[routes[pos]]:
                    pending[p] = res[sweep[p][0].index]
            evals, evecs = pending.pop(pos)
        _append_eigenvalues(suffix, sec, evals, mesh)

        if finite_t:
            for e, v in zip(evals, evecs):
                slist.add(e, v, sec, table, twin=tflag,
                          size=state.lanc_nstates_total)
        else:
            for e, v in zip(evals, evecs):
                if e < oldzero - 10 * cfg.gs_threshold:
                    oldzero = e
                    slist.clear()
                    slist.add(e, v, sec, table, twin=tflag)
                elif abs(e - oldzero) <= cfg.gs_threshold:
                    oldzero = min(oldzero, e)
                    slist.add(e, v, sec, table, twin=tflag)

    # ---- post-diag (ED_DIAG.f90:383-566)
    zeta = _post_diag(cfg, table, slist, state, finite_t, suffix, log,
                      mesh)
    if log and cfg.ed_verbose >= 2:
        log(f"Diagonalization done in {time.time() - t0:.2f}s: "
            f"{len(slist)} states, Egs={slist.emin:.12f}, Z={zeta:.6f}")
    return slist, zeta, state

def _append_eigenvalues(suffix: str, sec, evals, mesh=None) -> None:
    """eigenvalues_list file (ED_DIAG.f90:238-243, appended per sector;
    on a mesh by rank 0 alone)."""
    if not writes_files(mesh):
        return
    try:
        with open(f"eigenvalues_list{suffix}.ed", "a") as fh:
            fh.write(f"# sector {sec.index + 1} {sector_label(sec)}\n")
            for e in np.atleast_1d(evals):
                fh.write(f"{e:.12f}\n")
    except OSError:
        pass


def _post_diag(cfg: EDConfig, table, slist, state: DiagState,
               finite_t: bool, suffix: str, log=None, mesh=None) -> float:
    """Finite-T spectrum adaptation after a sector sweep
    (ED_DIAG.f90:445-566): histogram_states file, per-sector
    neigen_sector feedback, Boltzmann-cutoff trimming and
    lanc_nstates_total auto-tuning. Shared between the single-impurity
    sweep and the per-site state lists of diagonalize_sites. Returns the
    partition function."""
    zeta = slist.partition_function(cfg.beta, finite_t)
    if not finite_t:
        return zeta
    # histogram of sectors contributing to the kept spectrum
    # (histogram_states.ed, ED_DIAG.f90:474-490; rank 0 of a mesh)
    try:
        counts_h = np.zeros(len(table), dtype=int)
        for s in slist:
            counts_h[s.sector.index] += 1
        if writes_files(mesh):
            with open(f"histogram_states{suffix}.ed", "a") as fh:
                for i, c in enumerate(counts_h):
                    if c:
                        fh.write(f"{i + 1} {c}\n")
                fh.write("\n")
    except OSError:
        pass
    # per-sector neigen feedback (ED_DIAG.f90:494-515)
    counts = {i: 0 for i in state.neigen_sector}
    for s in slist:
        counts[s.sector.index] += 1
    for i in state.neigen_sector:
        if counts[i] > 0:
            state.neigen_sector[i] += 1
        else:
            state.neigen_sector[i] -= 1
        if state.neigen_sector[i] > counts[i]:
            state.neigen_sector[i] = counts[i] + 1
        if state.neigen_sector[i] <= 0:
            state.neigen_sector[i] = 1
    # Boltzmann-cutoff feedback on total kept states (ED_DIAG.f90:516-565)
    egs, ec = slist.emin, slist.emax
    if np.exp(-cfg.beta * (ec - egs)) > cfg.cutoff:
        state.lanc_nstates_total += cfg.lanc_nstates_step
        if log:
            log(f"Increasing lanc_nstates_total: {state.lanc_nstates_total}")
    else:
        while len(slist) > 1 and np.exp(
                -cfg.beta * (slist.emax - egs)) <= cfg.cutoff:
            slist.pop_last()
        state.lanc_nstates_total = max(len(slist), cfg.lanc_nstates_step) \
            + cfg.lanc_nstates_step
    return zeta


def write_state_list(cfg: EDConfig, slist: StateList, zeta: float,
                     suffix: str = "", mesh=None) -> None:
    """state_list<suffix>.ed + .restart files (print_state_list +
    sectors_list restart, ED_DIAG.f90:396-450); on a mesh, rank 0's."""
    if not writes_files(mesh):
        return
    beta = cfg.beta
    egs = slist.emin
    for name in (f"state_list{suffix}.ed", f"state_list{suffix}.restart"):
        with open(name, "w") as fh:
            fh.write("# i E E-Egs qn sector exp(-beta(E-Egs))/Z\n")
            for i, s in enumerate(slist):
                qn = " ".join(str(q) for q in s.sector.qn[1:])
                w = np.exp(-beta * (s.energy - egs)) / max(zeta, 1e-300)
                fh.write(f"{i + 1:6d} {s.energy:18.12f} {w: .12E} "
                         f"{qn} {s.sector.index + 1:4d}\n")
    with open(f"sectors_list{suffix}.restart", "w") as fh:
        for s in slist:
            fh.write(" ".join(str(q) for q in s.sector.qn[1:]) + "\n")



# ----------------------------------------------------------------------
# site-batched sweep (real-space DMFT): one batched eigh per sector
# ----------------------------------------------------------------------

def diagonalize_sites(cfg: EDConfig, baths, hlocs, states=None, log=None,
                      cfgs=None, mesh=None, suffixes=None, timers=None,
                      device="cuda"):
    """Batched sector sweep over N inequivalent impurity sites.

    `cfgs`: optional per-site configs differing only in interaction /
    level VALUES (e.g. the U stripe modulation of ed_ahm_stripe.f90) —
    the sector structure must match `cfg`. Per sector the dense
    Hamiltonians of every active site are stacked and diagonalized with ONE
    batched eigh on `device`, replacing the reference's round-robin MPI
    site loop (ED_MAIN.f90:576-678). Above lanc_dim_threshold the
    structurally identical per-site operators stack into ONE lockstep
    thick restart (lanczos.eigs_lanczos_op_stacked), whatever lanc_method
    is; sectors whose operators differ in structure, or a single active
    site, take the per-site _solve_sector_lanczos.

    `suffixes`: per-site file suffixes for the sectors_list restart masks
    (ed_pre_diag, ED_DIAG.f90:263-363); defaults to the lattice convention
    ``_ineq####``. The ed_twin trimming of ED_DIAG.f90:71-101 and the
    jz_max pruning apply as in the single-impurity sweep; the full
    ed_post_diag (ED_DIAG.f90:445-566) runs per site.

    Start vectors come from ONE numpy Generator (seed + 7) in sector order:
    one [active sites, dim] draw per stacked sector (a second one for a
    complex operator), one draw per site and sector on the per-site route.

    `mesh`: optional (sites, rows) parallel.Mesh — the dense eigh batch and
    the stacked large-sector restart split their site axis over 'sites'
    (the reference's MPI site distribution, ED_MAIN.f90:576-678), and the
    per-site fallback row-shards sectors above cfg.shard_dim_threshold
    over 'rows'; its device replaces `device`.

    Returns (list of StateList, list of zeta, list of DiagState).
    """
    from contextlib import nullcontext
    from .device import resolve
    device = mesh.device if mesh is not None else resolve(device)
    tm = timers if timers is not None else (lambda name: nullcontext())
    nsites = len(baths)
    if cfgs is None:
        cfgs = [cfg] * nsites
    table = sector_table(cfg)
    if states is None:
        states = [None] * nsites
    states = [s or DiagState(lanc_nstates_total=cfg.lanc_nstates_total)
              for s in states]
    for st in states:
        if not st.neigen_sector:
            for sec in table.sectors:
                st.neigen_sector[sec.index] = min(sec.dim,
                                                  cfg.lanc_nstates_sector)
    if suffixes is None:
        suffixes = [f"_ineq{i + 1:04d}" for i in range(nsites)]
    smasks = [sectors_mask(cfgs[i], table, suffixes[i], mesh)
              for i in range(nsites)]
    tmask = table.twin_mask() if cfg.ed_twin else np.ones(len(table), bool)
    finite_t = any(st.lanc_nstates_total > 1 for st in states)
    slists = [StateList() for _ in range(nsites)]
    oldzero = [1000.0] * nsites
    rng = np.random.default_rng(cfg.seed + 7)
    t0 = time.time()
    for sec in table.sectors:
        if sec.dim == 0 or not tmask[sec.index]:
            continue
        # Jz_max pruning (ED_DIAG.f90:73), as in the single-impurity sweep
        if cfg.jz_basis and cfg.jz_max and \
                abs(sec.qn[2]) > int(2 * cfg.jz_max_value):
            continue
        active = [smasks[i][sec.index] for i in range(nsites)]
        if not any(active):
            continue
        tflag = cfg.ed_twin and tmask[sec.index] \
            and not _is_self_twin(cfg, sec)
        idx = [i for i in range(nsites) if active[i]]
        neigen = [min(sec.dim, st.neigen_sector[sec.index]) for st in states]
        dense_ok = sec.dim <= cfg.lanc_dim_threshold or \
            max(neigen[i] for i in idx) >= sec.dim
        if dense_ok:
            with tm("diag.ham_build"):
                Hs = np.stack([
                    assemble_dense(build_sector_hamiltonian(
                        cfgs[i], sec, baths[i], hlocs[i]))
                    for i in idx])
            with tm("diag.dense_eigh"):
                evals_b, evecs_b = _sites_eigh(
                    torch.as_tensor(Hs, device=device), mesh)
                evals_b = evals_b.cpu().numpy()
            for bi, i in enumerate(idx):
                ne = neigen[i]
                evals = evals_b[bi][:ne]
                evecs = evecs_b[bi][:, :ne].T.contiguous()
                _append_eigenvalues(suffixes[i], sec, evals, mesh)
                _collect(cfg, table, slists[i], sec, evals, evecs,
                         finite_t, states[i], oldzero, i, twin=tflag)
            continue
        # large-sector site-batched Krylov: stack the structurally
        # identical per-site operators and run ONE lockstep thick restart
        # over the site axis
        from .lanczos import eigs_lanczos_op_stacked
        with tm("diag.ham_build"):
            hams = {i: build_sector_hamiltonian(cfgs[i], sec, baths[i],
                                                hlocs[i]) for i in idx}
        with tm("diag.encode"):
            ops = {i: make_matvec_op(hams[i], cfgs[i], device) for i in idx}
        specs = {(o[0], o[2]) for o in ops.values()}
        ne = max(neigen[i] for i in idx)
        if len(specs) == 1 and len(idx) > 1:
            spec, _, blocks = ops[idx[0]]
            arrays_stacked = tuple(
                torch.stack([ops[i][1][a] for i in idx])
                for a in range(len(ops[idx[0]][1])))
            del ops
            cplx = spec[-1].startswith("complex")
            v0 = rng.normal(size=(len(idx), sec.dim))
            if cplx:
                v0 = v0 + 1j * rng.normal(size=(len(idx), sec.dim))
            v0 = torch.as_tensor(v0, device=device).to(
                torch.complex128 if cplx else getattr(torch, cfg.dtype))
            ncv = _ncv(cfg, sec.dim, ne)
            with tm("diag.thick_restart"):
                evals_b, evecs_b, niter = eigs_lanczos_op_stacked(
                    spec, blocks, arrays_stacked, v0, ne, ncv,
                    maxiter=min(sec.dim, cfg.lanc_niter),
                    tol=cfg.lanc_tolerance, mesh=mesh)
            del arrays_stacked, v0
            _log_restart(log, cfg, f"sector {sec.index} dim={sec.dim} "
                         f"sites={len(idx)}", sec.dim, ne, ncv, niter)
            for bi, i in enumerate(idx):
                k = min(neigen[i], len(evecs_b[bi]))
                evals = np.asarray(evals_b[bi][:k])
                _append_eigenvalues(suffixes[i], sec, evals, mesh)
                _collect(cfg, table, slists[i], sec, evals,
                         evecs_b[bi][:k], finite_t, states[i], oldzero, i,
                         twin=tflag)
            del evecs_b
        else:
            del ops
            for i in idx:
                with tm("diag.krylov_serial"):
                    evals, evecs = _solve_sector_lanczos(
                        cfg, hams[i], neigen[i], rng, device, timers=timers,
                        niter_mem=states[i].lanc_niter_sector, log=log,
                        mesh=mesh)
                _append_eigenvalues(suffixes[i], sec, evals, mesh)
                _collect(cfg, table, slists[i], sec, evals, evecs,
                         finite_t, states[i], oldzero, i, twin=tflag)
        del hams
    # per-site finite-T post-diag (Boltzmann trimming, neigen feedback,
    # lanc_nstates_total tuning, histogram files) — the FULL ed_post_diag
    # the reference runs per site (ED_DIAG.f90:445-566), shared with the
    # single-impurity sweep
    zetas = [_post_diag(cfg, table, slists[i], states[i], finite_t,
                        suffixes[i], log, mesh) for i in range(nsites)]
    if log and cfg.ed_verbose >= 2:
        log(f"Site-batched diagonalization of {nsites} sites done in "
            f"{time.time() - t0:.2f}s: Egs="
            + " ".join(f"{s.emin:.12f}" for s in slists))
    return slists, zetas, states


def _sites_eigh(Hs, mesh):
    """Batched eigh of a [S, n, n] site stack; with a sites mesh, the stack
    is zero-padded to the axis multiple, each sites rank solves its chunk
    and the results are all-gathered (the padding is discarded)."""
    if not sites_sharded(mesh):
        return torch.linalg.eigh(Hs)
    S = Hs.shape[0]
    npad = (-S) % mesh.shape["sites"]
    if npad:
        Hs = torch.cat([Hs, Hs.new_zeros((npad,) + Hs.shape[1:])])
    e, v = torch.linalg.eigh(Hs[site_chunk(mesh, Hs.shape[0])])
    return (mesh.all_gather("sites", e)[:S],
            mesh.all_gather("sites", v)[:S])


def _collect(cfg, table, slist, sec, evals, evecs, finite_t, state,
             oldzero, i, twin=False):
    """Add one site's eigenpairs of a sector to its state list: the
    capacity-bounded finite-T list, or the T=0 ground-state window with
    the site's running `oldzero[i]`."""
    if finite_t:
        for e, v in zip(evals, evecs):
            slist.add(e, v, sec, table, twin=twin,
                      size=state.lanc_nstates_total)
    else:
        for e, v in zip(evals, evecs):
            if e < oldzero[i] - 10 * cfg.gs_threshold:
                oldzero[i] = e
                slist.clear()
                slist.add(e, v, sec, table, twin=twin)
            elif abs(e - oldzero[i]) <= cfg.gs_threshold:
                oldzero[i] = min(oldzero[i], e)
                slist.add(e, v, sec, table, twin=twin)
