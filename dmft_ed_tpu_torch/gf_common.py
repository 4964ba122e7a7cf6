"""Shared Krylov Green's-function machinery — PyTorch port of
dmft_ed_tpu/gf_common.py.

The Lanczos resolvent of an excitation vector yields (weights, poles); the
spectral accumulation Σ_j w_j/(z - p_j) is one vectorized outer-product
sum over all frequencies on the host (ED_GF_NORMAL.f90:580-632).

One ResolventBatch serves one impurity or several inequivalent sites
(``add_site``; jobs keyed by (site, sector)). Routes of ResolventBatch.run,
in order: the wide-concat sweep engine, one per site (sweep_plain — every
chain of mix-free single-block target sectors, when the device batches,
except complex chains against real Ozaki operators); then, when the
device batches, the ragged merge: groups whose flat dims share a
power-of-two class zero-embed into one bucket shape and run as one stacked
scan; then stacked scans of structurally identical operators, the same
sector of several sites on the member axis. With a mesh (HamCache(...,
mesh=)), a target sector of dim >= cfg.shard_dim_threshold runs first, its
channels batched on row-sharded vectors (``_run_sharded``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .config import EDConfig
from .sectors import Sector
from .bath import Bath
from .eigenspace import StateList
from .hamiltonian import (SectorHamiltonian, build_sector_hamiltonian,
                          is_complex, make_matvec_op, mix_entries,
                          vector_dtype)
from .lanczos import lanczos_tridiag_op, tridiag_eigh
from .parallel.hxv import shard_flat, sharded_sector_op
from .parallel.mesh import rows_sharded


class HamCache:
    """Per-solve cache of sector Hamiltonians and their device operators
    (with a mesh, also of the row-sharded local operators; the mesh's
    device replaces `device`)."""

    def __init__(self, cfg: EDConfig, bath: Bath, hloc: np.ndarray,
                 device="cuda", mesh=None):
        self.cfg, self.bath, self.hloc = cfg, bath, hloc
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else device
        self._ham: Dict[int, SectorHamiltonian] = {}
        self._op: Dict[int, tuple] = {}
        self._op_sharded: Dict[int, tuple] = {}

    def ham(self, sector: Sector) -> SectorHamiltonian:
        key = sector.index
        if key not in self._ham:
            self._ham[key] = build_sector_hamiltonian(self.cfg, sector,
                                                      self.bath, self.hloc)
        return self._ham[key]

    def op(self, sector: Sector):
        key = sector.index
        if key not in self._op:
            self._op[key] = make_matvec_op(self.ham(sector), self.cfg,
                                           self.device)
        return self._op[key]

    def sharded(self, sector: Sector) -> bool:
        """Whether this sector's Krylov runs row-sharded over the mesh."""
        return rows_sharded(self.mesh) \
            and sector.dim >= self.cfg.shard_dim_threshold

    def op_sharded(self, sector: Sector):
        """(spec, arrays, blocks, sector_padded) of this rank's row-sharded
        local operator (parallel.hxv.sharded_sector_op)."""
        key = sector.index
        if key not in self._op_sharded:
            self._op_sharded[key] = sharded_sector_op(
                self.ham(sector), self.cfg, self.mesh)
        return self._op_sharded[key]


def accumulate_poles(z: np.ndarray, weights: np.ndarray, poles: np.ndarray,
                     isign: int) -> np.ndarray:
    """G(z) += Σ_j w_j / (z - isign*dE_j), vectorized over (poles x freqs)
    on the host (O(npoles * L) complex128 work)."""
    if weights.size == 0:
        return np.zeros(z.shape, dtype=complex)
    zz = np.asarray(z)[None, :]
    pp = isign * np.asarray(poles)[:, None]
    ww = np.asarray(weights)[:, None]
    return np.sum(ww / (zz - pp), axis=0)


def state_iter(slist: StateList):
    """(sector, energy, flat host vector) per kept state (twins rebuilt)."""
    for s in slist:
        yield s.sector, s.energy, s.get_vector().cpu().numpy()


class ResolventBatch:
    """Collects excitation channels and runs their Krylov resolvents
    batched: the whole-sweep concat engine first (one per site), then the
    ragged merge, then stacked scans of structurally identical target
    operators — channels of one sector on a batch axis, and the same
    sector of different inequivalent sites (or equal-shape sectors of one
    impurity) on the operator axis (lanczos_tridiag_op_stacked).

    Single-impurity use: ResolventBatch(cfg, cache, egs, zeta, finite_t)
    (site 0); multi-site use: ResolventBatch(cfg) + add_site(site, ...)
    per site, with the site passed to ``add`` and carried in the channel
    metas for routing."""

    def __init__(self, cfg: EDConfig, cache: Optional[HamCache] = None,
                 egs: float = 0.0, zeta: float = 1.0,
                 finite_t: bool = False):
        self.cfg = cfg
        self.sites: Dict[int, tuple] = {}
        if cache is not None:
            self.add_site(0, cache, egs, zeta, finite_t)
        self.jobs: Dict[tuple, list] = {}
        self.jsecs: Dict[tuple, Sector] = {}

    def add_site(self, site: int, cache: HamCache, egs: float, zeta: float,
                 finite_t: bool) -> None:
        self.sites[site] = (cache, egs, zeta, finite_t)

    @property
    def device(self):
        return next(iter(self.sites.values()))[0].device

    def add(self, jsec: Sector, vvinit: np.ndarray, state_e: float,
            meta, site: int = 0) -> None:
        norm2 = float(np.real(np.vdot(vvinit, vvinit)))
        if norm2 < 1e-300:
            return
        key = (site, jsec.index)
        self.jsecs[key] = jsec
        self.jobs.setdefault(key, []).append(
            (vvinit / np.sqrt(norm2), norm2, state_e, meta))

    def _weights_poles(self, site, joblist, al, be, ns):
        cfg = self.cfg
        _, egs, zeta, finite_t = self.sites[site]
        for b, (v0, norm2, state_e, meta) in enumerate(joblist):
            n = max(int(ns[b]), 1)
            evals, Z = tridiag_eigh(al[b, :n], be[b, :n])
            beta_T = cfg.beta
            if finite_t and beta_T * (state_e - egs) < 200:
                peso_bz = np.exp(-beta_T * (state_e - egs)) / zeta
            elif not finite_t:
                peso_bz = 1.0 / zeta
            else:
                peso_bz = 0.0
            cnorm2 = meta.get("cnorm2", 1.0) if isinstance(meta, dict) \
                else 1.0
            weights = cnorm2 * norm2 * peso_bz * Z[0, :] ** 2
            poles = evals - state_e
            yield meta, np.asarray(weights, dtype=complex), np.asarray(poles)

    def run(self):
        """Yields (meta, weights, poles) per channel."""
        from .lanczos import lanczos_tridiag_op_stacked
        cfg = self.cfg
        dev = self.device
        # entry: (spec, blocks, arrays, nlanc, joblist, jsec, site, cache)
        entries = []
        for key, joblist in self.jobs.items():
            site, _ = key
            jsec = self.jsecs[key]
            cache = self.sites[site][0]
            if cache.sharded(jsec):
                yield from self._run_sharded(site, cache, jsec, joblist)
                continue
            spec, arrays, blocks = cache.op(jsec)
            nlanc = min(jsec.dim, cfg.lanc_ngfiter)
            entries.append((spec, blocks, arrays, nlanc, joblist, jsec,
                            site, cache))
        yield from self._run_sweep_concat(entries)    # consumes in place
        groups: Dict[tuple, list] = {}
        for e in entries:
            gkey = (e[0], e[1], e[3],
                    tuple((tuple(a.shape), str(a.dtype)) for a in e[2]))
            groups.setdefault(gkey, []).append(e)
        from .device import ragged_batching
        consumed = set()
        if ragged_batching(dev):
            # ragged merge: paddable groups whose flat dims share a
            # power-of-two class zero-embed into one bucket shape and run
            # as ONE stacked scan (different-dimension sectors, of one
            # site or several, on the member axis)
            buckets: Dict[tuple, list] = {}
            for gkey, ents in groups.items():
                bkey = self._bucket_key(ents[0])
                if bkey is not None:
                    buckets.setdefault(bkey, []).append(gkey)
            for bkey, gkeys in buckets.items():
                if len(gkeys) < 2:
                    continue
                ents = [e for gk in gkeys for e in groups[gk]]
                ddw_pad = max(e[1][0][0] for e in ents)
                dup_pad = max(e[1][0][1] for e in ents)
                # aspect-ratio guard: in the small, dispatch-bound regime
                # accept up to ~4x the dim class (merging transposed
                # (a,b)/(b,a) target shapes); large sectors are
                # compute-bound — require tight packing
                pad = ddw_pad * dup_pad
                if pad > 2 * bkey[-1] and not (pad <= 4 * bkey[-1]
                                               and pad <= 16384):
                    continue
                yield from self._run_ragged(ents, ddw_pad, dup_pad)
                consumed.update(gkeys)
        for gkey, ents in groups.items():
            if gkey in consumed:
                continue
            spec, blocks, nlanc, _ = gkey
            # common channel-count bucket (next power of two), as in the
            # reference, so the batch shapes match its
            Bmax = max(len(e[4]) for e in ents)
            Bpad = 1 << (Bmax - 1).bit_length()
            v0s = []
            for e in ents:
                stack = [j[0] for j in e[4]]
                stack += [stack[0]] * (Bpad - len(stack))
                v0s.append(np.stack(stack))
            V0 = torch.as_tensor(np.stack(v0s), device=dev)  # [S, Bpad, dim]
            arrays_stacked = tuple(torch.stack(a) for a in
                                   zip(*(e[2] for e in ents)))
            al, be, ns = lanczos_tridiag_op_stacked(
                spec, blocks, arrays_stacked, V0, nlanc)
            al, be, ns = al.cpu().numpy(), be.cpu().numpy(), ns.cpu().numpy()
            for si, e in enumerate(ents):
                yield from self._weights_poles(e[6], e[4], al[si], be[si],
                                               ns[si])
        self.jobs.clear()
        self.jsecs.clear()

    def _run_sweep_concat(self, entries):
        """Wide-concat GF backend (sweep_plain.py): all (sector, channel)
        chains of one site whose target sectors are mix-free single blocks
        run as ONE lockstep loop whose matvec shares the per-(spin, n)
        operators across sectors. Consumed entries are removed from
        `entries`; the rest flow to the ragged and stacked routes."""
        from .device import ragged_batching
        from .sweep_plain import (sweep_supported, make_sweep_op,
                                  sweep_tridiag)
        consumed = set()
        by_site: Dict[int, list] = {}
        for i, e in enumerate(entries):
            by_site.setdefault(e[6], []).append((i, e))
        for site, idx_ents in by_site.items():
            ents = [e for _, e in idx_ents]
            cache = self.sites[site][0]
            cfg = cache.cfg
            dev = cache.device
            hams = [e[7].ham(e[5]) for e in ents]
            nchains = sum(len(e[4]) for e in ents)
            hams_cplx = any(np.issubdtype(h.dtype, np.complexfloating)
                            for h in hams)
            chain_cplx = any(np.iscomplexobj(j[0])
                             for e in ents for j in e[4])
            cplx = hams_cplx or chain_cplx
            if nchains < 2 or not sweep_supported(cfg, hams) \
                    or not ragged_batching(dev):
                continue
            if chain_cplx and not hams_cplx \
                    and cfg.matmul_precision.startswith("ozaki"):
                # complex chain vectors against real ozaki-encoded
                # operators: digit slicing is real-only — leave these to
                # the stacked path
                continue
            members = []    # (entry, job), flattened (sector x channel)
            mhams = []
            for e, h in zip(ents, hams):
                for j in e[4]:
                    members.append((e, j))
                    mhams.append(h)
            spec, arrays = make_sweep_op(cfg, mhams, dev)
            dt = np.complex128 if cplx else np.dtype(cfg.dtype)
            V0 = tuple(torch.as_tensor(np.asarray(j[0], dtype=dt).reshape(
                e[5].blocks[0].ddw, e[5].blocks[0].dup), device=dev)
                for e, j in members)
            nlanc = max(e[3] for e in ents)
            al, be, ns = sweep_tridiag(spec, arrays, nlanc, V0)
            al = al.cpu().numpy().astype(np.float64)    # [nlanc, S]
            be = be.cpu().numpy().astype(np.float64)
            ns = ns.cpu().numpy()
            for s, (e, j) in enumerate(members):
                # clamp to the member's own chain length (prefix-stable
                # Lanczos coefficients)
                n_s = min(int(ns[s]), e[3])
                yield from self._weights_poles(
                    e[6], [j], al[:, s][None, :], be[:, s][None, :], [n_s])
            consumed.update(i for i, _ in idx_ents)
        for i in sorted(consumed, reverse=True):
            del entries[i]

    def _bucket_key(self, e):
        """Ragged-merge bucket of a paddable entry (single block, no mix
        terms), or None — the reference's grouping key, with the cfg
        fields of the entry's own site."""
        spec, blocks, cfg = e[0], e[1], e[7].cfg
        if len(blocks) != 1 or mix_entries(spec):
            return None
        dim = blocks[0][0] * blocks[0][1]
        p2 = 1 << (max(dim, 1) - 1).bit_length()
        return (vector_dtype(spec), str(cfg.dtype), cfg.matmul_precision,
                cfg.dense_matmul_threshold, p2)

    def _run_ragged(self, ents, ddw_pad, dup_pad):
        """ONE stacked Lanczos scan over sectors of UNEQUAL shape: each
        member operator zero-embeds into the bucket block (ddw_pad,
        dup_pad) through hamiltonian.make_padded_matvec_op — exact, since
        the padded components of H and of the start vectors are zero, the
        chain never leaves the embedded subspace and its coefficients are
        the unpadded recurrence's. Members sub-group by their padded spec
        (a spec can still differ, e.g. when only some members carry
        nonzeros of a COO kind, or per-site cfgs encode differently), each
        sub-group its own stack."""
        from .hamiltonian import make_padded_matvec_op
        hams = [e[7].ham(e[5]) for e in ents]
        nnz_up = max(h.hup[0].rows.size for h in hams)
        nnz_dw = max(h.hdw[0].rows.size for h in hams)
        subgroups: Dict[tuple, list] = {}
        for e, h in zip(ents, hams):
            sp, ar, bl = make_padded_matvec_op(h, e[7].cfg, ddw_pad, dup_pad,
                                               nnz_up, nnz_dw, e[7].device)
            subgroups.setdefault((sp, bl), []).append((e, ar))
        for (sp, bl), sub in subgroups.items():
            yield from self._run_ragged_stack(sp, bl, sub, ddw_pad, dup_pad)

    def _run_ragged_stack(self, spec_p, blocks_p, sub, ddw_pad, dup_pad):
        from .lanczos import lanczos_tridiag_op_stacked
        ents = [e for e, _ in sub]
        ops = [ar for _, ar in sub]
        nlanc = max(e[3] for e in ents)
        Bpad = 1 << (max(len(e[4]) for e in ents) - 1).bit_length()
        # complex excitation vectors (chi's combined channels) against a
        # real operator promote the whole stack, as np.result_type does
        vdt = np.result_type(np.dtype(vector_dtype(spec_p)),
                             *(j[0].dtype for e in ents for j in e[4]))
        V0 = np.zeros((len(ents), Bpad, ddw_pad * dup_pad), dtype=vdt)
        for si, e in enumerate(ents):
            ddw, dup = e[1][0]
            for b in range(Bpad):
                j = e[4][min(b, len(e[4]) - 1)]
                V0[si, b].reshape(ddw_pad, dup_pad)[:ddw, :dup] = \
                    j[0].reshape(ddw, dup)
        arrays_stacked = tuple(torch.stack(a) for a in zip(*ops))
        al, be, ns = lanczos_tridiag_op_stacked(
            spec_p, blocks_p, arrays_stacked,
            torch.as_tensor(V0, device=self.device), nlanc)
        al, be, ns = al.cpu().numpy(), be.cpu().numpy(), ns.cpu().numpy()
        for si, e in enumerate(ents):
            # clamp to the member's OWN chain length: the first k Lanczos
            # coefficients do not depend on later steps, so this reproduces
            # the per-sector run (the shared longer scan would otherwise add
            # spurious duplicate Ritz values)
            yield from self._weights_poles(e[6], e[4], al[si], be[si],
                                           np.minimum(ns[si], e[3]))

    def _run_sharded(self, site, cache, jsec, joblist):
        """Row-sharded batched tridiagonalization of one large target
        sector, the distributed GF pass (the reference scatters excitation
        vectors and Lanczos-iterates under MPI, ED_GF_NORMAL.f90:156-187):
        the channel batch [B, local rows] through lanczos_tridiag_op."""
        cfg = self.cfg
        spec, arrays, blocks, sec_p = cache.op_sharded(jsec)
        nlanc = min(jsec.dim, cfg.lanc_ngfiter)
        # complex128 for a complex operator, else cfg.dtype (the JAX
        # package's choice); complex excitation vectors (chi's combined
        # channels) against a real operator keep their imaginary part
        dt = np.complex128 if is_complex(spec) \
            else np.dtype(cfg.dtype)
        if any(np.iscomplexobj(j[0]) for j in joblist):
            dt = np.result_type(dt, np.complex64)
        V0 = shard_flat(np.stack([j[0] for j in joblist]).astype(dt), jsec,
                        sec_p, cache.mesh, getattr(torch, np.dtype(dt).name))
        al, be, ns = lanczos_tridiag_op(spec, blocks, arrays, V0, nlanc,
                                        cache.mesh)
        yield from self._weights_poles(site, joblist, al.T.cpu().numpy(),
                                       be.T.cpu().numpy(), ns.cpu().numpy())
