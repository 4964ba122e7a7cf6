"""Whole-sweep lockstep plain-Lanczos engine — PyTorch port of
dmft_ed_tpu/sweep_plain.py.

All mix-free single-block sectors of a sweep (or all GF chains whose
target sectors are) run their recurrences in ONE lockstep loop whose matvec
exploits the block-Kronecker structure across sectors:

* ``H_up`` depends only on n_up and ``H_dw`` only on n_dw, so the sweep
  shares ONE operator per (spin, n), digit-sliced once per sweep on the
  Ozaki path;
* the dw-products of every sector sharing n_dw run as ONE wide matmul
  ``H_dw @ [V_a | V_b | ...]`` and the up-products of every sector sharing
  n_up as ``[V_a ; V_b ; ...] @ H_upᵀ`` — on the Ozaki path each is one
  launch of the digit-matmul kernel;
* per-sector (alpha, beta) come from per-sector reductions, breakdown is
  masked per sector on the device.

The diagonal ships in factored form and is rebuilt on the device once per
call, with the reference's expression and add order
``nd @ W @ nu.T + d_up[None, :] + d_dw[:, None] + const`` (bit-identical
to SectorHamiltonian.diag in f64).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .config import EDConfig
from .hamiltonian import Encoder, SectorHamiltonian
from .lanczos import _pdot_pair, _real_dtype, _BREAKDOWN


def sweep_supported(cfg: EDConfig, hams: List[SectorHamiltonian]) -> bool:
    """All sectors single-block, mix-free, per-spin dims dense-class."""
    thr = cfg.dense_matmul_threshold
    for h in hams:
        if len(h.sector.blocks) != 1 or h.mix:
            return False
        b = h.sector.blocks[0]
        if max(b.ddw, b.dup) > thr:
            return False
        if h.sector.subsel is not None:
            return False
    return True


def make_sweep_op(cfg: EDConfig, hams: List[SectorHamiltonian], device):
    """(spec, arrays) for the whole-sweep collection matvec: spec holds the
    per-sector (ddw, dup, dw_gid, up_gid) and one spin-part record per
    group (hamiltonian's dense-class encoding, which sweep_supported
    guarantees); arrays the device tensors (per-group operators + diagonal
    factors, or per-sector dense diagonals where a sector has no
    factors)."""
    enc = Encoder(cfg, device, any(
        np.issubdtype(h.dtype, np.complexfloating) for h in hams))
    have_fac = all(h.dfac is not None for h in hams)
    w_idx = c_idx = -1
    if have_fac:
        w_idx, c_idx = enc.push(enc.dev(hams[0].dfac[0], enc.rdtype),
                                enc.dev(hams[0].dfac[1], enc.rdtype))
    dw_groups, up_groups = {}, {}
    dw_ops, up_ops, dw_fac, up_fac = [], [], [], []
    sec_entries, diag_idx = [], []
    diag_seen = {}      # repeated sectors (GF chains) share one diagonal
    for h in hams:
        blk = h.sector.blocks[0]
        nup, ndw = blk.nup, blk.ndw
        if ndw not in dw_groups:
            dw_ops.append(enc.dense(h.hdw[0].to_dense(), "left"))
            if have_fac:
                d_dw, _, nd, _ = h.dfac[2][0]
                dw_fac.append(enc.push(enc.dev(d_dw, enc.rdtype),
                                       enc.dev(nd, enc.rdtype)))
            dw_groups[ndw] = len(dw_ops) - 1
        if nup not in up_groups:
            up_ops.append(enc.dense(h.hup[0].to_dense(), "right"))
            if have_fac:
                _, d_up, _, nu = h.dfac[2][0]
                up_fac.append(enc.push(enc.dev(d_up, enc.rdtype),
                                       enc.dev(nu, enc.rdtype)))
            up_groups[nup] = len(up_ops) - 1
        if not have_fac:
            if id(h) not in diag_seen:
                diag_seen[id(h)] = enc.push(enc.dev(h.diag[0],
                                                    enc.rdtype))[0]
            diag_idx.append(diag_seen[id(h)])
        sec_entries.append((blk.ddw, blk.dup, dw_groups[ndw],
                            up_groups[nup]))
    spec = (tuple(sec_entries), tuple(diag_idx), tuple(dw_ops),
            tuple(up_ops), str(enc.vdtype).replace("torch.", ""), enc.nsl,
            enc.bits,
            (w_idx, c_idx, tuple(dw_fac), tuple(up_fac)) if have_fac
            else None)
    return spec, tuple(enc.arrays)


def _sweep_applier(sweep):
    """(prepare, matvec) of the collection operator: prepare(arrays) gives
    the per-sector dense diagonals, matvec(arrays, Ds, V) the products."""
    sec_entries, diag_idx, dw_ops, up_ops, _, _, _, fac = sweep
    dw_members = [[] for _ in dw_ops]
    up_members = [[] for _ in up_ops]
    for s, (_, _, dg, ug) in enumerate(sec_entries):
        dw_members[dg].append(s)
        up_members[ug].append(s)

    def prepare(arrays):
        """Per-sector dense diagonals rebuilt on the device from the
        factored form (same expression and add order as
        SectorHamiltonian.diag)."""
        if fac is None:
            return tuple(arrays[diag_idx[s]]
                         for s in range(len(sec_entries)))
        w_idx, c_idx, dw_fac, up_fac = fac
        W, const = arrays[w_idx], arrays[c_idx]
        cache = {}
        Ds = []
        for ddw, dup, dg, ug in sec_entries:
            if (dg, ug) not in cache:
                d_dw, nd = arrays[dw_fac[dg][0]], arrays[dw_fac[dg][1]]
                d_up, nu = arrays[up_fac[ug][0]], arrays[up_fac[ug][1]]
                cache[(dg, ug)] = (nd @ W @ nu.T + d_up[None, :]
                                   + d_dw[:, None] + const)
            Ds.append(cache[(dg, ug)])
        return tuple(Ds)

    def matvec(arrays, Ds, V):
        Y = [Ds[s] * V[s] for s in range(len(sec_entries))]
        # the dw family, one wide product per n_dw group over the members
        # side by side (axis 1), then the up family, one per n_up group
        # over the members stacked (axis 0)
        for ops, members, side, ax in ((dw_ops, dw_members, "left", 1),
                                       (up_ops, up_members, "right", 0)):
            for op, mem in zip(ops, members):
                if not mem:
                    continue
                C = torch.cat([V[s] for s in mem], dim=ax) if len(mem) > 1 \
                    else V[mem[0]]
                R = op.product(arrays, C, side, None)
                off = 0
                for s in mem:
                    n = sec_entries[s][ax]
                    Y[s] = Y[s] + R.narrow(ax, off, n)
                    off += n
        return Y

    return prepare, matvec


def sweep_tridiag(spec, arrays, niter: int, V0):
    """Lockstep 3-term recurrence over the whole collection.

    V0: tuple of per-sector [ddw, dup] normalized start vectors. Returns
    (alphas [niter, S], betas [niter, S] reference layout, nsteps [S])."""
    prepare, matvec = _sweep_applier(spec)
    Ds = prepare(arrays)
    S = len(V0)
    dev = V0[0].device
    rdt = _real_dtype(V0[0].dtype)
    zero = torch.zeros((), dtype=rdt, device=dev)
    one = torch.ones((), dtype=rdt, device=dev)
    Vp = [torch.zeros_like(v) for v in V0]
    V = list(V0)
    bp = torch.zeros(S, dtype=rdt, device=dev)
    alive = torch.ones(S, dtype=torch.bool, device=dev)
    out_a, out_b, alives = [], [], []
    for _ in range(niter):
        W = matvec(arrays, Ds, V)
        a = torch.stack([_pdot_pair(v, w) for v, w in zip(V, W)])
        W = [w - a[s] * v - bp[s] * vp
             for s, (w, v, vp) in enumerate(zip(W, V, Vp))]
        b = torch.sqrt(torch.stack([_pdot_pair(w, w) for w in W]))
        ok = alive & (b > _BREAKDOWN)
        bsafe = torch.where(b > 0, b, one)
        Vn = [torch.where(ok[s], w / bsafe[s], torch.zeros_like(w))
              for s, w in enumerate(W)]
        Vp = [torch.where(ok[s], v, vp)
              for s, (v, vp) in enumerate(zip(V, Vp))]
        out_a.append(torch.where(alive, a, zero))
        out_b.append(torch.where(ok, b, zero))
        alives.append(alive)
        V = Vn
        bp = torch.where(ok, b, zero)
        alive = ok
    alphas = torch.stack(out_a)
    betas = torch.stack(out_b)
    nsteps = torch.stack(alives).to(torch.int64).sum(0)
    betas_out = torch.cat([torch.ones((1, S), dtype=rdt, device=dev),
                           betas[:-1]])
    return alphas, betas_out, nsteps


def sweep_rebuild(spec, arrays, niter: int, V0, alphas, betas, Y0):
    """Dot-free lockstep rebuild: |gs_s> = Σ_j Y0[j, s] |v_j(s)>.

    alphas/betas [niter, S] (reference layout), Y0 [niter, S] zero-padded
    past each sector's chain; masking past a breakdown keeps the replay
    finite (Y0 is zero there, so the accumulators are exact)."""
    prepare, matvec = _sweep_applier(spec)
    Ds = prepare(arrays)
    S = len(V0)
    dev = V0[0].device
    rdt = _real_dtype(V0[0].dtype)

    def host(x):
        return torch.as_tensor(np.asarray(x), device=dev).to(rdt)

    alphas, betas, Y0 = host(alphas), host(betas), host(Y0)
    one = torch.ones((), dtype=rdt, device=dev)
    beta_next = torch.cat([betas[1:], torch.zeros((1, S), dtype=rdt,
                                                  device=dev)])
    Vp = [torch.zeros_like(v) for v in V0]
    V = list(V0)
    acc = [torch.zeros_like(v) for v in V0]
    for j in range(niter):
        acc = [a + Y0[j, s] * v for s, (a, v) in enumerate(zip(acc, V))]
        W = matvec(arrays, Ds, V)
        W = [w - alphas[j, s] * v - betas[j, s] * vp
             for s, (w, v, vp) in enumerate(zip(W, V, Vp))]
        bn = beta_next[j]
        bsafe = torch.where(bn > 0, bn, one)
        ok = bn > _BREAKDOWN
        Vn = [torch.where(ok[s], w / bsafe[s], torch.zeros_like(w))
              for s, w in enumerate(W)]
        Vp, V = V, Vn
    return tuple(a / torch.linalg.vector_norm(a) for a in acc)
