"""Row-sharded sector H·v and Krylov solves — port of
dmft_ed_tpu/parallel/hxv.py.

The reference distributes every sector solve by a 1-D row partition
(ED_HAMILTONIAN.f90:56-62) and all-gathers the whole vector per SpMV
(ED_HAMILTONIAN_STORED_HxV.f90:163-196). Here every block's down (row)
dimension is zero-padded to a multiple of the mesh's ``rows`` axis, and
each rank keeps the rows it owns of every block, V_b[rows, dup]. Its
**local operator** (``sharded_sector_op``) holds

  * the diagonal's rows, and the dw-side operators' rows (Hdw, and the dw
    factor of every mix term whose destination rows land on the rank; a
    "pmix" entry's dw-side tables and its compact rows);
  * the up-side operators whole.

A matvec (``hamiltonian.apply_op`` with ``gather``) all-gathers each block
the dw side reads, applies the dw-side products to the full block and the
diagonal and up-side products to the local rows. Padded rows stay exactly
zero through the Krylov recurrence (zero diagonal, zero operator rows and
columns), so norms, dots and tridiagonal coefficients are the unpadded
ones. The Ozaki digits of a row slice of a left operand are that slice of
its digits (per-row scales), and a right operand is scaled per column, so
the row-sliced Ozaki products are bitwise those of the unsharded operator.
The Krylov engines of lanczos.py run on the flat vector of a rank's rows
of every block; their dots are summed locally and all-reduced.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import EDConfig
from ..sectors import Block, Sector
from ..hamiltonian import (SectorHamiltonian, SpinCOO, make_matvec_op,
                           np_unflatten_blocks)
from .mesh import Mesh, row_slice


def pad_rows_sector(sector: Sector, n_rows: int) -> Sector:
    """Padded twin of `sector`: every block ddw rounded up to a multiple of
    n_rows, offsets recomputed. Only the block SHAPES of the result are
    consumed (by make_matvec_op / flatten helpers)."""
    blocks = []
    off = 0
    for b in sector.blocks:
        ddw_p = -(-b.ddw // n_rows) * n_rows
        blocks.append(Block(b.nup, b.ndw, b.dup, ddw_p, off))
        off += b.dup * ddw_p
    return Sector(sector.index, sector.qn, tuple(blocks), sector.ns)


def pad_rows_ham(ham: SectorHamiltonian, n_rows: int) -> SectorHamiltonian:
    """Zero-pad every block's row dimension of the factorized operator."""
    sec_p = pad_rows_sector(ham.sector, n_rows)
    diag = []
    hdw = []
    for bi, (b, bp) in enumerate(zip(ham.sector.blocks, sec_p.blocks)):
        diag.append(np.pad(ham.diag[bi], ((0, bp.ddw - b.ddw), (0, 0))))
        d = ham.hdw[bi]
        hdw.append(SpinCOO(d.rows, d.cols, d.vals, (bp.ddw, bp.ddw)))
    mix = []
    for t in ham.mix:
        dw = t.dw
        if dw is not None:
            dw = SpinCOO(dw.rows, dw.cols, dw.vals,
                         (sec_p.blocks[t.dst].ddw, sec_p.blocks[t.src].ddw))
        elif sec_p.blocks[t.dst].ddw != sec_p.blocks[t.src].ddw:
            raise ValueError("identity dw mix term needs equal padded row "
                             "dims")
        mix.append(t._replace(dw=dw))
    return SectorHamiltonian(sec_p, diag, ham.hup, hdw, mix, ham.dtype)


def pad_flat_to_blocks(x: np.ndarray, sector: Sector,
                       sector_padded: Sector):
    """Flat [dim] vector in the UNPADDED layout -> tuple of padded
    per-block matrices [ddw_pad, dup]."""
    Vb = np_unflatten_blocks(np.asarray(x), sector)
    out = []
    for V, b, bp in zip(Vb, sector.blocks, sector_padded.blocks):
        out.append(np.pad(V, ((0, bp.ddw - b.ddw), (0, 0))))
    return tuple(out)


def unpad_blocks_to_flat(V, sector: Sector):
    """Inverse of pad_flat_to_blocks (also accepts a leading batch axis);
    numpy arrays or torch tensors."""
    torch_in = isinstance(V[0], torch.Tensor)
    parts = []
    for Vp, b in zip(V, sector.blocks):
        Vp = Vp if torch_in else np.asarray(Vp)
        if Vp.ndim == 2:
            parts.append(Vp[:b.ddw].reshape(-1))
        else:
            parts.append(Vp[:, :b.ddw].reshape(Vp.shape[0], -1))
    return torch.cat(parts, dim=-1) if torch_in \
        else np.concatenate(parts, axis=-1)


def _take_rows(kind_spec, arrays, sl: slice):
    """One dw-side operator of the spec restricted to the output rows `sl`
    (arrays is updated in place); returns its new kind spec."""
    kind = kind_spec[0]
    if kind == "dense":
        arrays[kind_spec[1]] = arrays[kind_spec[1]][sl].contiguous()
        return kind_spec
    if kind == "ozl":
        i_dg, i_sc = kind_spec[3], kind_spec[4]
        arrays[i_dg] = arrays[i_dg][:, sl].contiguous()
        arrays[i_sc] = arrays[i_sc][sl].contiguous()
        return kind_spec
    if kind == "coo":
        # kept as "coo" even where no entry lands on this rank: whether a
        # matvec gathers a block must not differ between the ranks
        ir, ic, iv = kind_spec[1:4]
        rows = arrays[ir]
        keep = (rows >= sl.start) & (rows < sl.stop)
        arrays[ir] = rows[keep] - sl.start
        arrays[ic] = arrays[ic][keep]
        arrays[iv] = arrays[iv][keep]
        return kind_spec
    if kind == "none":
        return kind_spec
    raise ValueError(f"row-sharded operator: no row split for {kind!r}")


def local_operator(spec, arrays, mesh: Mesh):
    """(spec, arrays, blocks) of the padded operator restricted to this
    rank's rows: the diagonal and the dw-side operators keep the rank's
    output rows, the up side stays whole; blocks become [rows, dup]."""
    blocks, diag_idx, hup_spec, hdw_spec, mix_spec, vtag = spec
    arrays = list(arrays)
    sls = [row_slice(mesh, ddw) for ddw, _ in blocks]
    for bi, i in enumerate(diag_idx):
        arrays[i] = arrays[i][sls[bi]].contiguous()
    hdw_l = tuple(_take_rows(s, arrays, sls[bi])
                  for bi, s in enumerate(hdw_spec))
    mix_l = []
    for (src, dst, up, dw, cidx) in mix_spec:
        if up is not None and up[0] == "pmix":
            # the dw-side tables keep the rank's destination rows (their
            # sources index the gathered block); the compact rows are the
            # rank's local rows that some term writes
            i_ds, i_dw, i_rows = up[3], up[4], up[7]
            arrays[i_ds] = arrays[i_ds][:, sls[dst]].contiguous()
            arrays[i_dw] = arrays[i_dw][:, sls[dst]].contiguous()
            rows = torch.nonzero((arrays[i_ds] >= 0).any(0)).flatten()
            arrays[i_rows] = rows.to(torch.int32)
            up = ("pmix", up[1], int(rows.numel())) + up[3:]
        elif up is not None and up[0] == "bmix":
            arrays[up[2]] = arrays[up[2]][:, sls[dst]].contiguous()
        elif dw is not None:
            dw = _take_rows(dw, arrays, sls[dst])
        mix_l.append((src, dst, up, dw, cidx))
    blocks_l = tuple((s.stop - s.start, dup)
                     for s, (_, dup) in zip(sls, blocks))
    spec_l = (blocks_l, diag_idx, hup_spec, hdw_l, tuple(mix_l), vtag)
    return spec_l, tuple(arrays), blocks_l


def sharded_sector_op(ham: SectorHamiltonian, cfg: EDConfig, mesh: Mesh):
    """(spec, arrays, blocks, sector_padded): this rank's local operator
    of the row-padded sector (see the module note); blocks are the local
    [rows, dup] shapes. Apply with ``apply_op(spec, arrays, V,
    gather=row_gather(mesh))``."""
    ham_p = pad_rows_ham(ham, mesh.shape["rows"])
    spec, arrays, _ = make_matvec_op(ham_p, cfg, mesh.device, fused=False)
    spec, arrays, blocks = local_operator(spec, arrays, mesh)
    return spec, arrays, blocks, ham_p.sector


def row_gather(mesh):
    """The map from a block's local rows [..., rows, dup] to all its rows,
    for apply_op; None without a row split."""
    if mesh is None or mesh.shape["rows"] == 1:
        return None
    return lambda v: mesh.all_gather("rows", v, dim=v.dim() - 2)


def shard_flat(x, sector: Sector, sector_padded: Sector, mesh: Mesh,
               dtype):
    """Flat unpadded vectors [..., dim] (numpy or tensor) -> this rank's
    flat local vectors [..., local dim]: its rows of every padded block,
    block after block, on the mesh's device."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    lead = x.shape[:-1]
    parts = []
    for b, bp in zip(sector.blocks, sector_padded.blocks):
        v = x[..., b.offset:b.offset + b.dim].reshape(lead + (b.ddw, b.dup))
        v = np.pad(v, [(0, 0)] * len(lead) + [(0, bp.ddw - b.ddw), (0, 0)])
        parts.append(v[..., row_slice(mesh, bp.ddw), :].reshape(lead + (-1,)))
    return torch.as_tensor(np.ascontiguousarray(
        np.concatenate(parts, axis=-1)), device=mesh.device).to(dtype)


def gather_flat(v, blocks, mesh: Mesh, sector: Sector):
    """This rank's flat local vectors [k, local dim] (local block shapes
    `blocks`) -> the replicated flat unpadded [k, dim] tensor."""
    from ..hamiltonian import unflatten_blocks
    full = tuple(mesh.all_gather("rows", b, dim=b.dim() - 2)
                 for b in unflatten_blocks(v, blocks))
    return unpad_blocks_to_flat(full, sector)


def solve_sector_sharded(cfg: EDConfig, ham: SectorHamiltonian, neigen: int,
                         rng, mesh: Mesh, v0=None):
    """Distributed replacement of diag._solve_sector_lanczos for sectors
    above cfg.shard_dim_threshold: thick-restart (or, with
    lanc_method="lanczos", two-pass plain) Lanczos on row-sharded vectors
    (ED_MAIN.f90:284-327 with sp_eigh / P-ARPACK). Returns (evals,
    evecs_flat [neigen, dim]) with the eigenvectors gathered to every rank
    in the unpadded layout (es_return_cvector's gather,
    ED_EIGENSPACE.f90:448-517)."""
    from ..lanczos import (eigs_lanczos_op, lanczos_rebuild_gs_op,
                           lanczos_tridiag_op, tridiag_eigh)
    sec = ham.sector
    spec, arrays, blocks, sec_p = sharded_sector_op(ham, cfg, mesh)
    cplx = spec[-1].startswith("complex")
    if v0 is None:
        v0 = rng.normal(size=sec.dim)
        if cplx:
            v0 = v0 + 1j * rng.normal(size=sec.dim)
        v0 = v0 / np.linalg.norm(v0)
    dt = torch.complex128 if cplx else getattr(torch, cfg.dtype)
    v0 = shard_flat(v0, sec, sec_p, mesh, dt)
    if cfg.lanc_method.lower() == "lanczos":
        niter = min(sec.dim, cfg.lanc_niter)
        al, be, ns_ = lanczos_tridiag_op(spec, blocks, arrays, v0, niter,
                                         mesh)
        n = max(int(ns_), 1)
        al_h, be_h = al.cpu().numpy(), be.cpu().numpy()
        evals, Y = tridiag_eigh(al_h[:n], be_h[:n])
        # second pass to rebuild |gs> (two-pass plain Lanczos; dot-free —
        # the stored betas replay the normalization)
        gs = lanczos_rebuild_gs_op(spec, blocks, arrays, v0, al_h, be_h,
                                   Y[:, 0], n, mesh)
        return np.array([evals[0]]), gather_flat(gs[None], blocks, mesh,
                                                 sec)
    ncv = min(sec.dim,
              cfg.lanc_ncv_factor * max(neigen, cfg.lanc_nstates_sector)
              + cfg.lanc_ncv_add)
    evals, evecs, _ = eigs_lanczos_op(
        spec, blocks, arrays, v0, neigen, ncv,
        maxiter=min(sec.dim, cfg.lanc_niter), tol=cfg.lanc_tolerance,
        mesh=mesh)
    flat = gather_flat(evecs, blocks, mesh, sec)        # [k, dim]
    flat = flat / torch.linalg.vector_norm(flat, dim=1, keepdim=True)
    return np.asarray(evals), flat
