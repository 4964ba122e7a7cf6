"""The port's meshes (dmft_ed_tpu_torch/parallel/) on the CPU: the
counterpart of tests/test_parallel.py's eight cases, with rank processes
on torch.distributed's gloo backend.

Two groups run once per file (module-scoped fixtures, each rank in a
directory of its own, a FileStore under tmp_path, one torch thread per
rank, every join under a timeout):

* two ranks: the row-sharded matvec (single block, the multi-block superc
  Sz=0 sector, and both under ozaki5x7), the sharded tridiagonal
  coefficients (single and a batch of channels), EDSolver on a rows=2
  mesh in normal (thick restart and plain Lanczos), superc and nonsu2
  mode and with chi_dens at Norb=2 (complex channels on the sharded
  chains, whose imaginary part the JAX package's sharded route drops),
  and on a sites=2 mesh the stacked restart with S = 3 members (padded
  by repeating the last) and the joint bath fit;
* four ranks, a (sites=2, rows=2) mesh: LatticeEDSolver on 3 sites.

The ranks import only torch and the port; every comparison runs here,
against the port's unsharded solves and, for the normal-mode solve, the
JAX package's sharded solve on its 8 virtual CPU devices.

Bounds: the matvec 1e-12 (measured 8.9e-16), bitwise under ozaki5x7 (the
digits of a row slice are the slice of the digits); the tridiagonal
coefficients 1e-9 (as tests/test_parallel.py); the solves those of
tests/test_parallel.py:145-155 and :264-270 (measured 1.1e-14 in egs,
2.6e-13 in G); the stacked restart's members bitwise (each member runs the
same operations on any rank); the fit's objective and gradient bitwise,
one L-BFGS-B iteration 1e-12.
"""

import contextlib
import os

import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads the OpenBLAS of jax's LAPACK calls)
import torch
try:
    from threadpoolctl import threadpool_limits
except ImportError:           # without it the BLAS pools keep their size
    def threadpool_limits(limits=None):
        return contextlib.nullcontext()

from dmft_ed_tpu_torch.config import EDConfig
from dmft_ed_tpu_torch.bath import Bath, init_bath, pack_bath
from dmft_ed_tpu_torch.hamiltonian import (apply_op, build_sector_hamiltonian,
                                           flatten_blocks, make_matvec_op,
                                           unflatten_blocks)
from dmft_ed_tpu_torch.sectors import sector_table

RANK_TIMEOUT = 240.0


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread and one BLAS thread per test (see
    tests/test_torch_nano.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


MATVEC_CASES = [("native", "normal"), ("ozaki5x7", "normal"),
                ("native", "superc"), ("ozaki5x7", "superc")]
SOLVE_CFGS = {
    "normal": dict(norb=1, nbath=4, nspin=1, uloc=(2.0,), beta=50.0,
                   lmats=30, lreal=20, ed_verbose=0, lanc_dim_threshold=24,
                   shard_dim_threshold=25, lanc_nstates_sector=2),
    "superc": dict(norb=1, nbath=4, nspin=1, uloc=(-2.0,), ed_mode="superc",
                   deltasc=0.1, beta=50.0, lmats=30, lreal=20, ed_verbose=0,
                   lanc_dim_threshold=60, shard_dim_threshold=61,
                   lanc_nstates_sector=2),
    "nonsu2": dict(norb=1, nbath=3, nspin=2, uloc=(1.5,), ed_mode="nonsu2",
                   beta=50.0, lmats=30, lreal=20, ed_verbose=0,
                   lanc_dim_threshold=32, shard_dim_threshold=33,
                   lanc_nstates_sector=2),
}
# the two-pass plain-Lanczos ground state, sharded
SOLVE_CFGS["normal_lanczos"] = dict(SOLVE_CFGS["normal"],
                                    lanc_method="lanczos")
# chi_dens at Norb=2: its combined channels are complex vectors against
# the real operator, on the sharded chains too
SOLVE_CFGS["chi_dens"] = dict(norb=2, nbath=2, nspin=1, uloc=(2.0, 2.0),
                              ust=1.0, beta=50.0, lmats=30, lreal=20,
                              ed_verbose=0, chidens_flag=True,
                              lanc_dim_threshold=50, shard_dim_threshold=51,
                              lanc_nstates_sector=2)


# ----------------------------------------------------------------------
# problems, built the same way in the ranks and here
# ----------------------------------------------------------------------

def _matvec_problem(prec, mode):
    """tests/test_parallel.py's operators: the (3,3) sector of Nbath=9
    (120x120) and the Sz=0 sector of the Nbath=5 superc config (7
    blocks)."""
    if mode == "normal":
        cfg = EDConfig(norb=1, nbath=9, nspin=1, uloc=(2.0,),
                       dense_matmul_threshold=8192,
                       matmul_precision=prec).validate()
    else:
        cfg = EDConfig(norb=1, nbath=5, nspin=1, uloc=(-2.0,),
                       ed_mode="superc", deltasc=0.1,
                       dense_matmul_threshold=8192,
                       matmul_precision=prec).validate()
    rng = np.random.default_rng(71 if mode == "normal" else 91)
    bath = Bath(cfg)
    bath.e[:] = np.linspace(-1, 1, cfg.nbath)[None, None, :]
    bath.v[:] = rng.uniform(0.3, 0.7, size=bath.v.shape)
    if mode == "superc":
        bath.d[:] = 0.2
    sec = sector_table(cfg).get(3, 3) if mode == "normal" \
        else sector_table(cfg).get(0)
    ham = build_sector_hamiltonian(cfg, sec, bath, np.zeros((1, 1, 1, 1)))
    return cfg, sec, ham


def _solve_hloc(kind):
    if kind != "nonsu2":
        return None
    hloc = np.zeros((2, 2, 1, 1))
    hloc[0, 1, 0, 0] = hloc[1, 0, 0, 0] = 0.2          # spin-mixing
    return hloc


def _solve(kind, mesh):
    """tests/test_parallel.py's _solve_pair, one side."""
    from dmft_ed_tpu_torch.solver import EDSolver
    cfg = EDConfig(**SOLVE_CFGS[kind]).validate()
    s = EDSolver(cfg, _solve_hloc(kind), log=lambda m: None, device="cpu",
                 mesh=mesh)
    b = Bath(cfg)
    b.e[:] = np.linspace(-1.2, 1.2, cfg.nbath)[None, None, :]
    b.v[:] = np.linspace(0.3, 0.6, cfg.nbath)[None, None, :]
    if b.d is not None:
        b.d[:] = 0.15
    if b.u is not None:
        b.u[:] = 0.1
    r = s.solve(pack_bath(b))
    return dict(egs=r.egs, gmats=r.gmats, smats=r.smats, fmats=r.fmats,
                dens=r.observables.dens, docc=r.observables.docc,
                chi_dens=r.chi_dens)


def _stacked_problem():
    """S = 3 structurally identical operators: the (2,2) sector of Nbath=4
    on three baths; seeded start vectors."""
    cfg = EDConfig(norb=1, nbath=4, nspin=1, uloc=(2.0,)).validate()
    sec = sector_table(cfg).get(2, 2)
    ops = []
    for i in range(3):
        b = init_bath(cfg, np.zeros((1, 1, 1, 1)))
        b.e[:] += 0.07 * i
        ops.append(make_matvec_op(build_sector_hamiltonian(
            cfg, sec, b, np.zeros((1, 1, 1, 1))), cfg, "cpu"))
    spec, _, blocks = ops[0]
    arrays = tuple(torch.stack([o[1][a] for o in ops])
                   for a in range(len(ops[0][1])))
    V0 = torch.as_tensor(np.random.default_rng(5).normal(size=(3, sec.dim)))
    return spec, blocks, arrays, V0


def _fit_problem():
    """A 2-site joint weiss fit whose targets are a known bath stack's G0;
    the fit starts 0.1 away."""
    from dmft_ed_tpu_torch.bath_fns import bath_params, g0and
    cfg = EDConfig(norb=1, nbath=3, nspin=1, uloc=(2.0,), beta=50.0,
                   lmats=100, lreal=8, ed_verbose=0).validate()
    hlocs = [np.zeros((1, 1, 1, 1)), np.full((1, 1, 1, 1), 0.2)]
    x = torch.as_tensor(1j * np.pi / cfg.beta
                        * (2 * np.arange(1, cfg.lmats + 1) - 1))
    baths, fgs = [], []
    for i in range(2):
        b = init_bath(cfg, hlocs[i])
        b.e[:] += 0.05 * (i + 1)
        b.v[:] *= 1.0 + 0.1 * i
        baths.append(pack_bath(b))
        fgs.append(g0and(cfg, x, bath_params(b, "cpu"), hlocs[i]).numpy())
    return cfg, np.stack(fgs), np.stack(baths) + 0.1, hlocs


def _fit(mesh):
    """(objective and gradient at the start, one L-BFGS-B iteration)."""
    from dmft_ed_tpu_torch import fit
    cfg, fgs, b0, hlocs = _fit_problem()
    first = []
    orig = fit.minimize

    def spy(fun, x0, **kw):
        if not first:
            first.append(fun(x0))
        return orig(fun, x0, **kw)
    fit.minimize = spy
    try:
        one = fit.chi2_fitgf_sites(cfg.replace(cg_niter=1), fgs, b0, hlocs,
                                   save=False, precondition=False,
                                   device="cpu", mesh=mesh)
    finally:
        fit.minimize = orig
    return dict(f0=first[0][0], g0=first[0][1], one=one)


# ----------------------------------------------------------------------
# rank programs (run in the rank processes)
# ----------------------------------------------------------------------

def _rank_two():
    """Every case of the two-rank group; returns this rank's results."""
    import torch.distributed as dist
    from dmft_ed_tpu_torch.lanczos import (eigs_lanczos_op_stacked,
                                           lanczos_tridiag_op)
    from dmft_ed_tpu_torch.parallel import make_mesh
    from dmft_ed_tpu_torch.parallel.hxv import (gather_flat, row_gather,
                                                shard_flat,
                                                sharded_sector_op)
    rows = make_mesh(device="cpu")
    out = dict(rank=dist.get_rank(), rows_shape=rows.shape,
               rows_coord=rows.coord)
    for prec, mode in MATVEC_CASES:
        cfg, sec, ham = _matvec_problem(prec, mode)
        spec, arrays, blocks, sec_p = sharded_sector_op(ham, cfg, rows)
        x = np.random.default_rng(72).normal(size=sec.dim)
        Y = apply_op(spec, arrays, unflatten_blocks(
            shard_flat(x, sec, sec_p, rows, torch.float64), blocks),
            row_gather(rows))
        out["matvec", prec, mode] = gather_flat(
            flatten_blocks(Y)[None], blocks, rows, sec)[0].numpy()
        out["local_rows", prec, mode] = [tuple(y.shape) for y in Y]
    cfg, sec, ham = _matvec_problem("native", "normal")
    spec, arrays, blocks, sec_p = sharded_sector_op(ham, cfg, rows)
    v = np.random.default_rng(73).normal(size=sec.dim)
    v /= np.linalg.norm(v)
    al, be, ns = lanczos_tridiag_op(
        spec, blocks, arrays, shard_flat(v, sec, sec_p, rows, torch.float64),
        30, rows)
    out["tridiag"] = (al.numpy(), be.numpy(), int(ns))
    vs = np.random.default_rng(74).normal(size=(3, sec.dim))
    vs /= np.linalg.norm(vs, axis=1, keepdims=True)
    al, be, ns = lanczos_tridiag_op(
        spec, blocks, arrays, shard_flat(vs, sec, sec_p, rows, torch.float64),
        25, rows)
    out["tridiag_batched"] = (al.T.numpy(), be.T.numpy(), ns.numpy())
    for kind in SOLVE_CFGS:
        out["solve", kind] = _solve(kind, rows)
    sites = make_mesh(n_rows=1, n_sites=2, device="cpu")
    out["sites_shape"] = sites.shape
    spec, blocks, arrays, V0 = _stacked_problem()
    ev, vecs, niter = eigs_lanczos_op_stacked(spec, blocks, arrays, V0, 2,
                                              12, maxiter=200, tol=1e-12,
                                              mesh=sites)
    out["stacked"] = (ev, [v.numpy() for v in vecs], niter)
    out["fit"] = _fit(sites)
    return out


def _rank_four():
    """The (sites=2, rows=2) lattice solve on 3 sites."""
    from dmft_ed_tpu_torch.parallel import make_mesh
    mesh = make_mesh(n_rows=2, n_sites=2, device="cpu")
    return dict(shape=mesh.shape, coord=mesh.coord,
                lattice=_lattice(mesh))


def _lattice(mesh, nineq=3):
    """tests/test_parallel.py's _lattice_pair, one side."""
    from dmft_ed_tpu_torch.lattice_solver import LatticeEDSolver
    cfg = EDConfig(**SOLVE_CFGS["normal"]).validate()
    hloc = np.zeros((nineq, cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    for i in range(nineq):
        hloc[i, :, :, 0, 0] = np.eye(cfg.nspin) * (0.1 * (i - 1))
    ls = LatticeEDSolver(cfg, hloc, log=lambda m: None, mesh=mesh,
                         device="cpu")
    baths = ls.init_solvers()
    for i in range(nineq):
        b = Bath(cfg)
        b.e[:] = np.linspace(-1.2, 1.2, cfg.nbath)[None, None, :] + 0.05 * i
        b.v[:] = np.linspace(0.3, 0.6, cfg.nbath)[None, None, :]
        baths[i] = pack_bath(b)
    return [dict(egs=r.egs, gmats=r.gmats, dens=r.observables.dens,
                 docc=r.observables.docc) for r in ls.solve(baths)]


# ----------------------------------------------------------------------
# the groups, once per file
# ----------------------------------------------------------------------

def _run(tmp_path_factory, fn, world):
    from dmft_ed_tpu_torch.parallel.spawn import run_ranks
    return run_ranks(f"{os.path.abspath(__file__)}:{fn}", world, {},
                     str(tmp_path_factory.mktemp(fn)), RANK_TIMEOUT)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run(tmp_path_factory, "_rank_two", 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run(tmp_path_factory, "_rank_four", 4)


def _assert_equiv(r1, r8, atol=1e-8):
    """tests/test_parallel.py:145-155."""
    assert abs(r1["egs"] - r8["egs"]) < 1e-10
    np.testing.assert_allclose(r8["gmats"], r1["gmats"], atol=atol)
    np.testing.assert_allclose(r8["smats"], r1["smats"], atol=1e-6)
    np.testing.assert_allclose(r8["dens"], r1["dens"], atol=1e-9)
    np.testing.assert_allclose(r8["docc"], r1["docc"], atol=1e-9)
    if r1["fmats"] is not None:
        np.testing.assert_allclose(r8["fmats"], r1["fmats"], atol=atol)
    if r1.get("chi_dens") is not None:
        for a, b in zip(r8["chi_dens"], r1["chi_dens"]):
            np.testing.assert_allclose(a, b, atol=atol)


# ----------------------------------------------------------------------
# tests
# ----------------------------------------------------------------------

def test_make_mesh_needs_a_process_group():
    from dmft_ed_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")


def test_mesh_coordinates(two, four):
    assert [r["rows_coord"] for r in two] == [{"sites": 0, "rows": 0},
                                              {"sites": 0, "rows": 1}]
    assert two[0]["rows_shape"] == {"sites": 1, "rows": 2}
    assert two[0]["sites_shape"] == {"sites": 2, "rows": 1}
    assert [r["coord"] for r in four] == [
        {"sites": s, "rows": r} for s in (0, 1) for r in (0, 1)]


def test_pad_helpers_match_jax():
    """pad_rows_sector / pad_flat_to_blocks / unpad_blocks_to_flat against
    the JAX package's (numpy in both)."""
    from dmft_ed_tpu.parallel import hxv as jhxv
    from dmft_ed_tpu import sectors as jsec
    from dmft_ed_tpu import config as jconfig
    from dmft_ed_tpu_torch.parallel import hxv
    kw = dict(norb=1, nbath=5, nspin=1, uloc=(-2.0,), ed_mode="superc",
              deltasc=0.1)
    sj = jsec.sector_table(jconfig.EDConfig(**kw).validate()).get(0)
    st = sector_table(EDConfig(**kw).validate()).get(0)
    for n in (2, 3, 8):
        pj, pt = jhxv.pad_rows_sector(sj, n), hxv.pad_rows_sector(st, n)
        assert [(b.ddw, b.dup, b.offset) for b in pj.blocks] == \
            [(b.ddw, b.dup, b.offset) for b in pt.blocks]
        x = np.random.default_rng(n).normal(size=st.dim)
        bj = jhxv.pad_flat_to_blocks(x, sj, pj)
        bt = hxv.pad_flat_to_blocks(x, st, pt)
        assert all(np.array_equal(a, b) for a, b in zip(bj, bt))
        assert np.array_equal(hxv.unpad_blocks_to_flat(bt, st), x)
        assert np.array_equal(
            hxv.unpad_blocks_to_flat(tuple(torch.as_tensor(b) for b in bt),
                                     st).numpy(), x)


@pytest.mark.parametrize("prec,mode", MATVEC_CASES)
def test_sharded_matvec_matches_single_device(two, prec, mode):
    """Row-sharded (padded, multi-block in superc) operator == unsharded
    port: 1e-12, and bitwise under ozaki5x7."""
    cfg, sec, ham = _matvec_problem(prec, mode)
    spec, arrays, blocks = make_matvec_op(ham, cfg, "cpu")
    x = np.random.default_rng(72).normal(size=sec.dim)
    y1 = flatten_blocks(apply_op(spec, arrays, unflatten_blocks(
        torch.as_tensor(x), blocks))).numpy()
    for r in two:
        y2 = r["matvec", prec, mode]
        np.testing.assert_allclose(y2, y1, atol=1e-12)
        if prec.startswith("ozaki"):
            assert np.array_equal(y2, y1)
    # each rank held half of every padded block's rows
    assert sum(s[0] for s in two[0]["local_rows", prec, mode]) * 2 == \
        sum(-(-b.ddw // 2) * 2 for b in sec.blocks)


def test_sharded_lanczos_tridiag_matches(two):
    from dmft_ed_tpu_torch.lanczos import lanczos_tridiag_op, tridiag_eigh
    cfg, sec, ham = _matvec_problem("native", "normal")
    spec, arrays, blocks = make_matvec_op(ham, cfg, "cpu")
    v = np.random.default_rng(73).normal(size=sec.dim)
    v /= np.linalg.norm(v)
    al1, be1, _ = lanczos_tridiag_op(spec, blocks, arrays,
                                     torch.as_tensor(v), 30)
    for r in two:
        al, be, ns = r["tridiag"]
        assert ns == 30
        np.testing.assert_allclose(al1.numpy(), al, atol=1e-9)
        np.testing.assert_allclose(be1.numpy(), be, atol=1e-9)
        e1, _ = tridiag_eigh(al1.numpy(), be1.numpy())
        e2, _ = tridiag_eigh(al, be)
        assert abs(e1[0] - e2[0]) < 1e-9
    assert np.array_equal(two[0]["tridiag"][0], two[1]["tridiag"][0])


def test_batched_sharded_lanczos(two):
    from dmft_ed_tpu_torch.lanczos import lanczos_tridiag_op
    cfg, sec, ham = _matvec_problem("native", "normal")
    spec, arrays, blocks = make_matvec_op(ham, cfg, "cpu")
    vs = np.random.default_rng(74).normal(size=(3, sec.dim))
    vs /= np.linalg.norm(vs, axis=1, keepdims=True)
    for r in two:
        al_b, be_b, ns_b = r["tridiag_batched"]
        assert list(ns_b) == [25] * 3
        for i in range(3):
            al1, be1, _ = lanczos_tridiag_op(spec, blocks, arrays,
                                             torch.as_tensor(vs[i]), 25)
            np.testing.assert_allclose(al_b[i], al1.numpy(), atol=1e-9)
            np.testing.assert_allclose(be_b[i], be1.numpy(), atol=1e-9)


@pytest.mark.parametrize("kind", list(SOLVE_CFGS))
def test_ed_solve_sharded(two, kind, tmp_path, monkeypatch):
    """EDSolver on the rows=2 mesh == the unsharded port (every
    Lanczos-solved sector and GF target row-shards)."""
    monkeypatch.chdir(tmp_path)
    r1 = _solve(kind, None)
    for r in two:
        _assert_equiv(r1, r["solve", kind])


def test_ed_solve_sharded_normal_vs_jax(two, tmp_path, monkeypatch):
    """The port's sharded normal-mode solve (rows=2) against the JAX
    package's sharded solve on its 8 virtual CPU devices (rows=8)."""
    import jax
    from dmft_ed_tpu.config import EDConfig as JConfig
    from dmft_ed_tpu.bath import Bath as JBath, pack_bath as jpack
    from dmft_ed_tpu.parallel import make_mesh as jmesh
    from dmft_ed_tpu.solver import EDSolver as JSolver
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    monkeypatch.chdir(tmp_path)
    cfg = JConfig(**SOLVE_CFGS["normal"]).validate()
    b = JBath(cfg)
    b.e[:] = np.linspace(-1.2, 1.2, cfg.nbath)[None, None, :]
    b.v[:] = np.linspace(0.3, 0.6, cfg.nbath)[None, None, :]
    rj = JSolver(cfg, None, log=lambda m: None,
                 mesh=jmesh(n_rows=8, n_sites=1)).solve(jpack(b))
    r1 = dict(egs=rj.egs, gmats=rj.gmats, smats=rj.smats, fmats=None,
              dens=rj.observables.dens, docc=rj.observables.docc)
    for r in two:
        _assert_equiv(r1, r["solve", "normal"])


def test_stacked_restart_sites_mesh(two):
    """eigs_lanczos_op_stacked over S = 3 members on sites=2 (padded to 4
    by repeating the last member) == the unsharded stacked restart,
    bitwise per member; every rank returns all three."""
    from dmft_ed_tpu_torch.lanczos import eigs_lanczos_op_stacked
    spec, blocks, arrays, V0 = _stacked_problem()
    ev1, vecs1, _ = eigs_lanczos_op_stacked(spec, blocks, arrays, V0, 2, 12,
                                            maxiter=200, tol=1e-12)
    for r in two:
        ev, vecs, niter = r["stacked"]
        assert ev.shape == ev1.shape == (3, 2)
        assert np.array_equal(ev, ev1)
        assert len(vecs) == 3
        for a, b in zip(vecs, vecs1):
            assert np.array_equal(a, b.numpy())
        assert niter > 0


def test_chi2_fitgf_sites_mesh(two, tmp_path, monkeypatch):
    """The joint fit with its two sites split over sites=2: objective and
    gradient at the start bitwise, one L-BFGS-B iteration 1e-12, against
    the unsharded fit."""
    monkeypatch.chdir(tmp_path)
    ref = _fit(None)
    for r in two:
        f = r["fit"]
        assert f["f0"] == ref["f0"]
        assert np.array_equal(f["g0"], ref["g0"])
        np.testing.assert_allclose(f["one"], ref["one"], atol=1e-12)
        _, _, b0, _ = _fit_problem()
        assert np.max(np.abs(f["one"] - b0)) > 1e-6


def test_lattice_solve_sites_mesh(four, tmp_path, monkeypatch):
    """LatticeEDSolver on a (sites=2, rows=2) mesh, 3 sites (the sites
    axis pads) == no mesh (tests/test_parallel.py:264-270)."""
    monkeypatch.chdir(tmp_path)
    r1s = _lattice(None)
    for r in four:
        assert len(r["lattice"]) == 3
        for r1, r8 in zip(r1s, r["lattice"]):
            assert abs(r1["egs"] - r8["egs"]) < 1e-9
            np.testing.assert_allclose(r8["gmats"], r1["gmats"], atol=1e-7)
            np.testing.assert_allclose(r8["dens"], r1["dens"], atol=1e-8)
            np.testing.assert_allclose(r8["docc"], r1["docc"], atol=1e-8)
