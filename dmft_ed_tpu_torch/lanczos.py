"""Krylov eigensolvers in PyTorch — port of dmft_ed_tpu/lanczos.py.

Two families:
  * the plain 3-term Lanczos recurrence (GF resolvents and the
    ``lanc_method="lanczos"`` two-pass ground state);
  * the thick-restart Lanczos with full two-pass reorthogonalization
    (``eigs_lanczos*``, the ``lanc_method="arpack"`` default, replacing
    P-ARPACK's ``sp_eigh``).

The reference's ``lax.scan`` loops become Python loops over device tensors
(no host synchronisation inside a loop: breakdown is masked on the device,
exactly as in the reference), and its ``vmap`` axes become written-out
leading batch dimensions or, for the stacked thick restart, a loop over the
members. Dot products are the exact ``vdot`` form (``_pdot_pair``), the
reference's CPU semantics. The thick restart's Rayleigh–Ritz step runs on
the host, as in the reference: ``betas`` and ``T`` are read once per
restart. Coefficients take the vectors' real dtype (float32 for float32 /
complex64 vectors, as in the reference).

Under a running ``torch.profiler`` (timer.py) every matvec records a
``hamiltonian.apply_op`` span and the counter ``lanczos.matvecs``; the
thick restart records a ``lanczos.eigs_lanczos`` span around each solve,
``lanczos.reorth`` around each step's Gram–Schmidt passes, norm and
writes, ``lanczos.rayleigh_ritz`` around the host Rayleigh–Ritz with its
reads, ``lanczos.restart`` around the restart's and the final Ritz
vectors' device work, and counts its blocking host-device transfers in
``lanczos.host_transfers``.

Meshes (parallel/): with ``mesh=``, the ``*_op`` engines run on
row-sharded sector vectors — flat vectors of this rank's rows of each
(row-padded) block, under parallel.hxv's local operator. They are the
reference's block-tuple Krylov (its ``lanczos_tridiag_blocks``,
``_batched``, ``_expand_blocks``, ``eigs_lanczos_blocks``): every dot and
Gram-Schmidt projection is summed locally, then all-reduced over the
mesh's rows group (the reference's MPI allreduce inside P-ARPACK,
ED_HAMILTONIAN_STORED_HxV.f90:147-197), and the matvec, eager (a CUDA
graph cannot hold a gloo collective), all-gathers the blocks its dw side
reads. ``eigs_lanczos_op_stacked(mesh=)`` splits its members over the
sites group.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels, timer
from .hamiltonian import (apply_op, flatten_blocks, graphable,
                          unflatten_blocks)
from .parallel.hxv import row_gather
from .parallel.mesh import rows_sharded, site_chunk, sites_sharded

_BREAKDOWN = 1e-13


def _real_dtype(dt):
    """float64 for float64 / complex128 vectors, float32 otherwise."""
    return torch.float64 if dt in (torch.float64, torch.complex128) \
        else torch.float32


def _pdot_pair(a, b, dims=None):
    """Re<a|b> reduced over `dims` (all axes by default)."""
    p = torch.conj(a) * b if a.is_complex() else a * b
    s = torch.sum(p) if dims is None else torch.sum(p, dim=dims)
    return s.real if s.is_complex() else s


def _rows_sum(x, mesh):
    """A partial sum over this rank's rows, summed over the mesh's rows
    group (unchanged without a row split)."""
    return mesh.all_reduce("rows", x) if rows_sharded(mesh) else x


def _norm(v, mesh):
    """||v|| over the whole vector (every rank's rows under a mesh)."""
    if not rows_sharded(mesh):
        return torch.linalg.vector_norm(v)
    return torch.sqrt(mesh.all_reduce("rows", _pdot_pair(v, v)))


def tridiag_eigh(alpha: np.ndarray, beta: np.ndarray):
    """Eigendecomposition of the symmetric tridiagonal (host scipy).

    alpha: diag [n]; beta: [n] with beta[0] unused (reference layout)."""
    import scipy.linalg as sla
    n = len(alpha)
    if n == 1:
        return np.asarray(alpha), np.ones((1, 1))
    return sla.eigh_tridiagonal(np.asarray(alpha), np.asarray(beta[1:n]))


def _lanczos_tridiag_impl(matvec, v0, niter: int, mesh=None):
    """3-term recurrence from normalized v0 [..., dim] (leading dims are
    independent chains; with a row-sharded `mesh`, dim is this rank's
    rows). Returns (alphas [niter, ...], betas [niter, ...] with the
    beta[0] = 1 sentinel, nsteps [...]); after a breakdown (beta < 1e-13)
    a chain is frozen and nsteps counts its usable steps."""
    lead = v0.shape[:-1]
    dev = v0.device
    rdt = _real_dtype(v0.dtype)
    v_prev = torch.zeros_like(v0)
    v = v0
    b_prev = torch.zeros(lead, dtype=rdt, device=dev)
    alive = torch.ones(lead, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=rdt, device=dev)
    one = torch.ones((), dtype=rdt, device=dev)
    alphas, betas, alives = [], [], []
    for _ in range(niter):
        w = matvec(v)
        a = _rows_sum(_pdot_pair(v, w, -1), mesh)
        w = w - a[..., None] * v - b_prev[..., None] * v_prev
        b = torch.sqrt(_rows_sum(_pdot_pair(w, w, -1), mesh))
        ok = alive & (b > _BREAKDOWN)
        v_next = torch.where(ok[..., None],
                             w / torch.where(b > 0, b, one)[..., None],
                             torch.zeros_like(w))
        alphas.append(torch.where(alive, a, zero))
        betas.append(torch.where(ok, b, zero))
        alives.append(alive)
        v_prev = torch.where(ok[..., None], v, v_prev)
        v = v_next
        b_prev = torch.where(ok, b, zero)
        alive = ok
    alphas = torch.stack(alphas)
    betas = torch.stack(betas)
    nsteps = torch.stack(alives).to(torch.int64).sum(0)
    betas_out = torch.cat([torch.ones((1,) + lead, dtype=rdt, device=dev),
                           betas[:-1]])
    return alphas, betas_out, nsteps


class _Graphed:
    """A matvec replayed from one CUDA graph per input shape and dtype.

    A multi-block sector's matvec is a chain of small launches, one to a
    few per block and per mix entry (~1,700 at the Jz basis's 49 blocks
    and 160 mix entries), and the host's cost of launching them one by
    one is most of its time; a graph replays the chain in one host call,
    with the same kernels on the same inputs. Captured on first use; the
    input is copied into the graph's static buffer and the output cloned
    out of it. The hand-written kernels' launch counters
    (kernels.KERNELS) count what each replay launches, not the capture."""

    def __init__(self, mv):
        self.mv = mv
        self.graphs = {}

    def __call__(self, x):
        with _matvec_span(x):
            return self._replay(x)

    def _replay(self, x):
        key = (tuple(x.shape), x.dtype)
        if key not in self.graphs:
            x_in = x.clone()
            side = torch.cuda.Stream(x.device)
            side.wait_stream(torch.cuda.current_stream(x.device))
            with torch.cuda.stream(side):
                self.mv(x_in)            # warm-up before capture
            torch.cuda.current_stream(x.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            n0 = kernels.launch_counts()
            with torch.cuda.graph(graph):
                y_out = self.mv(x_in)
            took = {k: n - n0[k] for k, n in kernels.launch_counts().items()}
            kernels.add_launches({k: -n for k, n in took.items()})
            self.graphs[key] = (graph, x_in, y_out, took)
        graph, x_in, y_out, took = self.graphs[key]
        x_in.copy_(x)
        graph.replay()
        kernels.add_launches(took)
        return y_out.clone()


def _matvec_span(x):
    """Count one matvec of x and open its span (timer.py: both only under
    a running profiler)."""
    timer.count("lanczos.matvecs")
    return timer.span("hamiltonian.apply_op", x)


def _op_matvec(spec, blocks, arrays, mesh=None):
    """The sector matvec on flat vectors. On a card, an operator that
    hamiltonian.graphable admits (several blocks, no Ozaki part: superc,
    nonsu2) replays from a CUDA graph (_Graphed): the same kernels,
    bitwise the same result. An operator with Ozaki parts stays eager: its
    matvec records the ``ozaki.split`` spans that a replay would not, and
    its capture has not been tried on a card. A row-sharded operator
    stays eager too (its gathers are collectives). Leading batch axes of
    x pass through."""
    gather = row_gather(mesh)

    def mv(x):
        return flatten_blocks(apply_op(spec, arrays,
                                       unflatten_blocks(x, blocks), gather))
    if graphable(spec) and arrays and arrays[0].is_cuda and gather is None:
        return _Graphed(mv)

    def eager(x):
        with _matvec_span(x):
            return mv(x)
    return eager


def lanczos_tridiag_op(spec, blocks, arrays, v0, niter: int, mesh=None):
    """3-term recurrence with the operator in spec/arrays form (v0 flat
    [..., dim]: leading axes are independent chains, the reference's
    ``lanczos_tridiag_blocks_batched``). Returns (alphas [niter, ...],
    betas [niter, ...], nsteps [...]) on v0's device, the same on every
    rank of a `mesh`."""
    return _lanczos_tridiag_impl(_op_matvec(spec, blocks, arrays, mesh), v0,
                                 niter, mesh)


def lanczos_rebuild_gs_op(spec, blocks, arrays, v0, alphas, betas, y,
                          n: int, mesh=None):
    """Dot-free second pass of the two-pass plain-Lanczos ground state:
    |gs> = Σ_j y_j |v_j>, replaying the recurrence with the stored
    (alpha, beta) (reference layout, betas[0] = 1 sentinel); normalized
    over the whole vector (every rank's rows under a `mesh`)."""
    mv = _op_matvec(spec, blocks, arrays, mesh)
    dev = v0.device
    rdt = _real_dtype(v0.dtype)

    def host(x):
        return torch.as_tensor(np.asarray(x), device=dev).to(rdt)

    alphas, betas, y = host(alphas), host(betas), host(y)
    beta_next = torch.cat([betas[1:], torch.ones(1, dtype=rdt, device=dev)])
    one = torch.ones((), dtype=rdt, device=dev)
    v_prev = torch.zeros_like(v0)
    v = v0
    acc = torch.zeros_like(v0)
    for j in range(n):
        acc = acc + y[j] * v
        w = mv(v)
        w = w - alphas[j] * v - betas[j] * v_prev
        bn = beta_next[j]
        vn = w / torch.where(bn > _BREAKDOWN, bn, one)
        v_prev, v = v, vn
    return acc / _norm(acc, mesh)


def lanczos_tridiag_op_stacked(spec, blocks, arrays_stacked, V0,
                               niter: int):
    """Recurrence over a stack of S structurally identical operators and B
    channels each: arrays_stacked holds the spec's arrays with a leading
    operator axis [S, ...]; V0 [S, B, dim] -> (alphas [S, B, niter],
    betas [S, B, niter], nsteps [S, B])."""
    mvs = [_op_matvec(spec, blocks, tuple(a[s] for a in arrays_stacked))
           for s in range(V0.shape[0])]

    def mv(x):                                        # x [S, B, dim]
        return torch.stack([m(x[s]) for s, m in enumerate(mvs)])

    al, be, ns = _lanczos_tridiag_impl(mv, V0, niter)
    return al.permute(1, 2, 0), be.permute(1, 2, 0), ns


# ----------------------------------------------------------------------
# thick-restart Lanczos with full reorthogonalization (ARPACK replacement)
# ----------------------------------------------------------------------

def _expand(matvec, V, T, j0: int, m: int, mesh=None):
    """Grow the orthonormal basis V[j0+1..m] and the projection T's columns
    j0..m-1, in place; returns betas [m - j0] on V's device. With a
    row-sharded `mesh`, V holds this rank's rows and every projection is
    all-reduced.

    V: [m+1, dim] with rows <= j0 filled (orthonormal; row j0 the next
    start vector), rows beyond zero, so the full-basis Gram-Schmidt
    products need no masking. T: [m+1, m+1] projected operator
    (arrowhead + tridiagonal after restarts). Two orthogonalization passes
    give machine-precision orthogonality. A breakdown (beta < 1e-13) is
    masked on the device: the next vector is zero."""
    rdt = _real_dtype(V.dtype)
    one = torch.ones((), dtype=rdt, device=V.device)
    zero = torch.zeros((), dtype=rdt, device=V.device)
    betas = []
    for j in range(j0, m):
        w = matvec(V[j])
        with timer.span("lanczos.reorth", V):
            h1 = _rows_sum(V.conj() @ w, mesh)
            w = w - h1 @ V
            h2 = _rows_sum(V.conj() @ w, mesh)
            w = w - h2 @ V
            h = h1 + h2
            b = torch.sqrt(_rows_sum(_pdot_pair(w, w), mesh))
            safe = b > _BREAKDOWN
            V[j + 1] = torch.where(safe, one, zero) * w \
                / torch.where(safe, b, one)
            T[:, j] = h
            T[j, :] = h.conj()
            T[j + 1, j] = b
            T[j, j + 1] = b
        betas.append(b)
    return torch.stack(betas)


def _rayleigh_ritz(Th, betas_h, j0: int, ncv: int, k: int, tol: float):
    """Host Rayleigh–Ritz of one expanded basis, the reference's rules:
    the basis is cut at the first breakdown (exact subspace, m_eff), the
    k_eff = min(k, m_eff) lowest Ritz pairs are tested by their residual
    |beta_m · y_last| < max(tol, 1e-14)·max(1, |e|). Returns (evals_all,
    Y, m_eff, k_eff, beta_m, converged)."""
    m_eff = ncv
    bad = np.nonzero(betas_h < _BREAKDOWN)[0]
    if bad.size:
        m_eff = j0 + int(bad[0]) + 1
    evals_all, Y = np.linalg.eigh(Th[:m_eff, :m_eff])
    k_eff = min(k, m_eff)
    beta_m = float(Th[m_eff, m_eff - 1].real) if m_eff < ncv + 1 else 0.0
    resid = np.abs(beta_m * Y[m_eff - 1, :k_eff])
    conv = bool(np.all(resid < max(tol, 1e-14)
                       * np.maximum(1.0, np.abs(evals_all[:k_eff]))))
    return evals_all, Y, m_eff, k_eff, beta_m, conv


def _host_read(*xs):
    """The tensors xs as numpy arrays on the host (blocking reads)."""
    timer.count("lanczos.host_transfers", len(xs))
    return [x.cpu().numpy() for x in xs]


def _ritz_vectors(Y, k: int, V, m_eff: int):
    """[k, dim] = Y[:, :k]^T @ V[:m_eff] on V's device."""
    with timer.span("lanczos.restart", V):
        timer.count("lanczos.host_transfers")
        Yk = torch.as_tensor(np.ascontiguousarray(Y[:, :k]), device=V.device)
        return Yk.to(V.dtype).T @ V[:m_eff]


def _thick_restart(V, T, Y, evals_all, beta_m: float, k: int):
    """Restart one member in place with its k lowest Ritz vectors and the
    residual direction V[ncv]: T becomes diag(evals) with the coupling
    row/column s = beta_m · Y[last, :k]."""
    ncv = V.shape[0] - 1
    ritz = _ritz_vectors(Y, k, V, ncv)
    with timer.span("lanczos.restart", V):
        V[k] = V[ncv]
        V[:k] = ritz
        V[k + 1:] = 0
        Tn = np.zeros((ncv + 1, ncv + 1),
                      dtype=np.result_type(Y.dtype, np.float64))
        Tn[np.arange(k), np.arange(k)] = evals_all[:k]
        s = beta_m * Y[ncv - 1, :k]
        Tn[k, :k] = np.conj(s)
        Tn[:k, k] = s
        timer.count("lanczos.host_transfers")
        T.copy_(torch.as_tensor(Tn, device=T.device).to(T.dtype))


def _sizes(dim: int, neigen: int, ncv: int, maxiter: int):
    neigen = min(neigen, dim)
    ncv = int(min(max(ncv, neigen + 2), dim))
    restarts = max(1, int(np.ceil(maxiter / max(ncv - neigen, 1))))
    return neigen, ncv, restarts


def eigs_lanczos(matvec, v0, neigen: int, ncv: int, maxiter: int = 512,
                 tol: float = 1e-12, mesh=None):
    """Lowest `neigen` eigenpairs of the Hermitian operator `matvec` (flat
    [dim] -> [dim]). Thick-restart Lanczos: expand a Krylov basis to ncv
    vectors (full reorthogonalization), Rayleigh–Ritz on the projected
    (ncv x ncv) matrix, restart with the k = neigen best Ritz vectors plus
    the residual direction (ED_DIAG.f90:149-166's sp_eigh / P-ARPACK).
    With a row-sharded `mesh`, v0 and the eigenvectors are this rank's
    rows, and every rank takes the same decisions from the same T.

    Returns (evals [k_eff] ascending, numpy; evecs [k_eff, dim] on v0's
    device; matvec count)."""
    with timer.span("lanczos.eigs_lanczos", v0):
        dim = v0.shape[0] * (mesh.shape["rows"] if rows_sharded(mesh)
                             else 1)
        k, ncv, restarts = _sizes(dim, neigen, ncv, maxiter)
        V = torch.zeros((ncv + 1, v0.shape[0]), dtype=v0.dtype,
                        device=v0.device)
        V[0] = v0 / _norm(v0, mesh)
        T = torch.zeros((ncv + 1, ncv + 1), dtype=v0.dtype, device=v0.device)
        niter = 0
        j0 = 0
        for _ in range(restarts):
            betas = _expand(matvec, V, T, j0, ncv, mesh)
            niter += ncv - j0
            with timer.span("lanczos.rayleigh_ritz", V):
                evals_all, Y, m_eff, k_eff, beta_m, conv = _rayleigh_ritz(
                    *_host_read(T, betas), j0, ncv, k, tol)
            if conv or m_eff < ncv or niter >= maxiter:
                break
            _thick_restart(V, T, Y, evals_all, beta_m, k_eff)
            j0 = k_eff
        return evals_all[:k_eff], _ritz_vectors(Y, k_eff, V, m_eff), niter


def eigs_lanczos_op(spec, blocks, arrays, v0, neigen: int, ncv: int,
                    maxiter: int = 512, tol: float = 1e-12, mesh=None):
    """eigs_lanczos with the operator in spec/arrays form (v0 flat
    [dim]; this rank's rows of the padded blocks under a `mesh`, with
    parallel.hxv's local operator)."""
    return eigs_lanczos(_op_matvec(spec, blocks, arrays, mesh), v0, neigen,
                        ncv, maxiter, tol, mesh)


def eigs_lanczos_op_stacked(spec, blocks, arrays_stacked, V0, neigen: int,
                            ncv: int, maxiter: int = 512, tol: float = 1e-12,
                            mesh=None):
    """Lockstep thick-restart Lanczos over S structurally identical
    operators (arrays with a leading member axis [S, ...]; V0 [S, dim]):
    every restart expands each running member's basis, then runs the
    Rayleigh–Ritz of eigs_lanczos per member on the host. A member that
    converges (or meets an exact-subspace breakdown) is finalized and
    frozen while the rest keep restarting; the last restart finalizes
    all. The reference vmaps the expansion over every member, frozen ones
    included, and discards theirs; here a frozen member is not expanded,
    which changes no result.

    With `mesh` (parallel.make_mesh) of more than one sites rank, the
    members split over the sites group, S padded to the axis multiple by
    repeating the last member (as the reference pads), each rank running
    its members' restarts; the results are all-gathered in member order
    (every rank returns all of them) and the padding is discarded.

    Returns (evals [S, k] numpy, padded with inf where a member has
    k_eff < k; evecs list of [k_eff, dim]; matvec count per member)."""
    if sites_sharded(mesh):
        S_orig = V0.shape[0]
        npad = (-S_orig) % mesh.shape["sites"]
        if npad:
            arrays_stacked = tuple(
                torch.cat([a, a[-1:].expand((npad,) + a.shape[1:])])
                for a in arrays_stacked)
            V0 = torch.cat([V0, V0[-1:].expand(npad, -1)])
        sl = site_chunk(mesh, V0.shape[0])
        evals, evecs, niter = eigs_lanczos_op_stacked(
            spec, blocks, tuple(a[sl] for a in arrays_stacked), V0[sl],
            neigen, ncv, maxiter, tol)
        return _gather_members(mesh, evals, evecs, niter, V0, S_orig)
    S, dim = V0.shape
    k, ncv, restarts = _sizes(dim, neigen, ncv, maxiter)
    V = torch.zeros((S, ncv + 1, dim), dtype=V0.dtype, device=V0.device)
    V[:, 0] = V0 / torch.linalg.vector_norm(V0, dim=1, keepdim=True)
    T = torch.zeros((S, ncv + 1, ncv + 1), dtype=V0.dtype, device=V0.device)
    mvs = [_op_matvec(spec, blocks, tuple(a[s] for a in arrays_stacked))
           for s in range(S)]
    out_evals = [None] * S
    out_evecs = [None] * S
    running = list(range(S))
    niter = 0
    j0 = 0
    for it in range(restarts):
        betas = torch.stack([_expand(mvs[s], V[s], T[s], j0, ncv)
                             for s in running])
        niter += ncv - j0
        betas_h, Th = _host_read(betas, T)          # [running, ncv - j0]
        last = niter >= maxiter or it == restarts - 1
        still = []
        for i, s in enumerate(running):
            evals_all, Y, m_eff, k_eff, beta_m, conv = _rayleigh_ritz(
                Th[s], betas_h[i], j0, ncv, k, tol)
            if conv or m_eff < ncv or last:
                out_evals[s] = evals_all[:k_eff]
                out_evecs[s] = _ritz_vectors(Y, k_eff, V[s], m_eff)
            else:
                # m_eff == ncv, so k_eff == k for every running member
                _thick_restart(V[s], T[s], Y, evals_all, beta_m, k)
                still.append(s)
        running = still
        if not running:
            break
        j0 = k
    evals = np.stack([np.pad(e, (0, k - len(e)), constant_values=np.inf)
                      for e in out_evals])
    return evals, out_evecs, niter


def _gather_members(mesh, evals, evecs, niter, V0, S_orig):
    """All-gather a sites rank's stacked-restart results (evals [S_loc, k]
    inf-padded, evecs list of [k_eff, dim]) in member order; the padded
    members past S_orig are dropped."""
    k = evals.shape[1]
    dev = V0.device
    ev = mesh.all_gather("sites", torch.as_tensor(evals, device=dev))
    vecs = torch.zeros((len(evecs), k, V0.shape[1]), dtype=evecs[0].dtype,
                       device=dev)
    for s, e in enumerate(evecs):
        vecs[s, :e.shape[0]] = e
    vecs = mesh.all_gather("sites", vecs)
    niter = int(mesh.all_reduce("sites", torch.tensor(niter, device=dev),
                                op=torch.distributed.ReduceOp.MAX))
    ev = ev.cpu().numpy()[:S_orig]
    kk = np.isfinite(ev).sum(axis=1)
    return ev, [vecs[s, :kk[s]] for s in range(S_orig)], niter

