"""Output files on a mesh: only global rank 0 writes them
(parallel.mesh.writes_files), so the ranks of a mesh share one working
directory, as ``torchrun`` started in one directory gives them.

One group of two gloo ranks runs in one shared directory
(``run_ranks``' ``workdir/shared``):

* ``solve/``: a rows=2 EDSolver (tests/test_torch_parallel.py's normal
  config) solves twice with ``ed_sectors`` (the second solve reads the
  ``sectors_list.restart`` that rank 0 wrote), reads its Sigma files
  back, fits its bath once (``EDSolver.chi2_fitgf``) and runs
  ``aux.search_variable``, ``aux.search_chemical_potential`` and a
  ``lattice.ConvergenceMonitor`` check twice each;
* ``lattice/``: a sites=2 LatticeEDSolver solve of three sites (the
  sites axis pads);
* ``own<r>/``: each rank in a directory of its own, the calls of
  ``solve/`` on the mesh (rank 1 finds none of rank 0's files in its
  directory: it reads the sectors list, Sigma and the bath restart through
  rank 0, ``parallel.mesh.from_rank0``) and a single solve with
  ``mesh=None``.

Each is compared with one process in another directory: the same file
names, the same number of lines in every file (an appended file gets one
line per call, not one per rank), and every number in the files within
1e-6, the loosest bound tests/test_torch_parallel.py holds a sharded solve
to (Sigma; an all-reduced dot can differ in its last bit, so no bytes are
demanded). The returned results are held to that file's per-quantity
bounds. Rank 1 writes nothing under a mesh; with ``mesh=None`` it writes
every file.
"""

import contextlib
import os
import pathlib

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

RANK_TIMEOUT = 240.0
# tests/test_torch_parallel.py's normal-mode solve: the (2,2) sector and
# its neighbours above lanc_dim_threshold row-shard
CFG = dict(norb=1, nbath=4, nspin=1, uloc=(2.0,), beta=50.0, lmats=30,
           lreal=20, ed_verbose=0, lanc_dim_threshold=24,
           shard_dim_threshold=25, lanc_nstates_sector=2, ed_sectors=True,
           nread=1.0)
FILE_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread and one BLAS thread per test (see
    tests/test_torch_nano.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _bath(cfg, shift=0.0):
    b = Bath(cfg)
    b.e[:] = np.linspace(-1.2, 1.2, cfg.nbath)[None, None, :] + shift
    b.v[:] = np.linspace(0.3, 0.6, cfg.nbath)[None, None, :]
    return pack_bath(b)


def _target(cfg):
    """A fit target built on the host alone: the G0 of a bath 0.05 away
    from the initial one (the same bits in every process)."""
    from dmft_ed_tpu_torch.bath_fns import bath_params, g0and
    hloc = np.zeros((1, 1, 1, 1))
    b = init_bath(cfg, hloc)
    b.e[:] += 0.05
    b.v[:] *= 1.1
    x = torch.as_tensor(1j * np.pi / cfg.beta
                        * (2 * np.arange(1, cfg.lmats + 1) - 1))
    return g0and(cfg, x, bath_params(b, "cpu"), hloc).numpy()


def _solve_run(mesh, twice=True):
    """The solver's file-writing calls, in the current directory."""
    from dmft_ed_tpu_torch.aux import (search_chemical_potential,
                                       search_variable)
    from dmft_ed_tpu_torch.lattice import ConvergenceMonitor
    from dmft_ed_tpu_torch.solver import EDSolver
    cfg = EDConfig(**CFG).validate()
    if not twice:
        cfg = cfg.replace(ed_sectors=False)
    s = EDSolver(cfg, None, log=lambda m: None, device="cpu", mesh=mesh)
    bath = s.init_solver()
    r = s.solve(_bath(cfg))
    if twice:
        r = s.solve(_bath(cfg, 0.01))
    smats_file, _ = s.read_sigma()
    fitted = s.chi2_fitgf(_target(cfg), bath, ispin=0)
    # a second solver starts from the bath restart that the fit saved
    restart = EDSolver(cfg, None, log=lambda m: None, device="cpu",
                       mesh=mesh).init_solver()
    mon = ConvergenceMonitor(1e-4, 1, 10, mesh=mesh)
    state, state_mu, xmu, xmu2 = {}, {}, 0.0, 0.0
    for k in range(2):
        mon.check(r.gmats[0, 0, 0, 0] * (1.0 + 0.01 * k))
        dens = float(r.observables.dens.sum()) + 0.01 * k
        xmu, _ = search_variable(cfg, xmu, dens, state, mesh=mesh)
        xmu2, _ = search_chemical_potential(cfg, xmu2, dens, True, state_mu,
                                            mesh=mesh)
    return dict(egs=r.egs, gmats=r.gmats, smats=r.smats,
                dens=r.observables.dens, docc=r.observables.docc,
                smats_file=smats_file, fit=fitted, restart=restart,
                error=mon.error,
                xmu=xmu, xmu2=xmu2)


def _lattice_run(mesh, nineq=3):
    from dmft_ed_tpu_torch.lattice_solver import LatticeEDSolver
    cfg = EDConfig(**CFG).validate().replace(ed_sectors=False)
    hloc = np.zeros((nineq, cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    for i in range(nineq):
        hloc[i, :, :, 0, 0] = np.eye(cfg.nspin) * (0.1 * (i - 1))
    ls = LatticeEDSolver(cfg, hloc, log=lambda m: None, mesh=mesh,
                         device="cpu")
    ls.init_solvers()
    baths = np.stack([_bath(cfg, 0.05 * i) for i in range(nineq)])
    return [dict(egs=r.egs, gmats=r.gmats, dens=r.observables.dens,
                 docc=r.observables.docc) for r in ls.solve(baths)]


@contextlib.contextmanager
def _inside(d):
    os.makedirs(d, exist_ok=True)
    here = os.getcwd()
    os.chdir(d)
    try:
        yield
    finally:
        os.chdir(here)


# ----------------------------------------------------------------------
# the rank program (both ranks start in the one shared directory)
# ----------------------------------------------------------------------

def _rank_files():
    import torch.distributed as dist
    from dmft_ed_tpu_torch.parallel import make_mesh
    rank = dist.get_rank()
    rows = make_mesh(device="cpu")
    out = dict(rank=rank, cwd=os.getcwd())
    with _inside("solve"):
        out["solve"] = _solve_run(rows)
    sites = make_mesh(n_rows=1, n_sites=2, device="cpu")
    with _inside("lattice"):
        out["lattice"] = _lattice_run(sites)
    with _inside(os.path.join(f"own{rank}", "mesh")):
        out["own_mesh"] = _solve_run(rows)
    with _inside(os.path.join(f"own{rank}", "nomesh")):
        out["own_nomesh"] = _solve_run(None, twice=False)
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    from dmft_ed_tpu_torch.parallel.spawn import run_ranks
    work = tmp_path_factory.mktemp("mesh_files")
    res = run_ranks(f"{os.path.abspath(__file__)}:_rank_files", 2, {},
                    str(work), RANK_TIMEOUT)
    return work / "shared", res


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The same calls in one process, no mesh, in another directory."""
    base = tmp_path_factory.mktemp("single")
    out = {}
    with threadpool_limits(limits=1):
        with _inside(base / "solve"):
            out["solve"] = _solve_run(None)
        with _inside(base / "lattice"):
            out["lattice"] = _lattice_run(None)
        with _inside(base / "once"):
            out["once"] = _solve_run(None, twice=False)
    return base, out


# ----------------------------------------------------------------------
# comparisons
# ----------------------------------------------------------------------

def _files(d):
    return {p.name: p.read_text() for p in sorted(pathlib.Path(d).iterdir())
            if p.is_file()}


def _numbers(text):
    out = []
    for tok in text.split():
        try:
            out.append(float(tok))
        except ValueError:
            pass
    return np.array(out)


def _same_files(got_dir, ref_dir):
    got, ref = _files(got_dir), _files(ref_dir)
    assert sorted(got) == sorted(ref)
    assert len(ref) >= 5
    for name in ref:
        assert len(got[name].splitlines()) == len(ref[name].splitlines()), \
            name
        a, b = _numbers(got[name]), _numbers(ref[name])
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=FILE_ATOL,
                                   err_msg=name)


def _hold(r1, r):
    """tests/test_torch_parallel.py's _assert_equiv bounds."""
    assert abs(r1["egs"] - r["egs"]) < 1e-10
    np.testing.assert_allclose(r["gmats"], r1["gmats"], atol=1e-8)
    np.testing.assert_allclose(r["dens"], r1["dens"], atol=1e-9)
    np.testing.assert_allclose(r["docc"], r1["docc"], atol=1e-9)
    if "smats" in r1:
        np.testing.assert_allclose(r["smats"], r1["smats"], atol=1e-6)


def test_writes_files_predicate():
    """mesh=None always writes, in or out of a process group."""
    from dmft_ed_tpu_torch.parallel.mesh import from_rank0, writes_files
    assert writes_files(None)
    assert from_rank0(None, lambda: 7) == 7


def test_shared_directory_solve_files(group, single):
    """Two ranks in one directory leave the files of one process: the same
    names, one line per call in every appended file, the numbers within
    1e-6; both ranks return the whole result."""
    shared, res = group
    base, ref = single
    assert res[0]["cwd"] == res[1]["cwd"] == str(shared)
    _same_files(shared / "solve", base / "solve")
    lines = _files(shared / "solve")
    assert len(lines["error.err"].splitlines()) == 1    # none on the first
    assert len(lines["search_mu_iteration.ed"].splitlines()) == 2
    assert len(lines["chi2fit_results.ed"].splitlines()) == 1
    _hold_solve(ref["solve"], [r["solve"] for r in res])


def _hold_solve(r1, got):
    """The ranks' results `got` of _solve_run against one process's `r1`:
    every rank read back the same Sigma files and bath restart."""
    for r in got:
        _hold(r1, r)
        np.testing.assert_allclose(r["smats_file"], r1["smats_file"],
                                   atol=FILE_ATOL)
        np.testing.assert_allclose(r["smats_file"], r["smats"], atol=1e-12)
        np.testing.assert_allclose(r["fit"], r1["fit"], atol=1e-12)
        np.testing.assert_allclose(r["restart"], r1["restart"], atol=1e-10)
        assert abs(r["error"] - r1["error"]) < 1e-8
        assert abs(r["xmu"] - r1["xmu"]) < 1e-6
        assert abs(r["xmu2"] - r1["xmu2"]) < 1e-12
    for r in got[1:]:
        np.testing.assert_array_equal(r["smats_file"], got[0]["smats_file"])
        np.testing.assert_array_equal(r["restart"], got[0]["restart"])


def test_sites_mesh_lattice_files(group, single):
    """A sites=2 LatticeEDSolver solve writes the per-site files of the
    single-process batched solve, once."""
    shared, res = group
    base, ref = single
    _same_files(shared / "lattice", base / "lattice")
    assert any(n.endswith("_ineq0003.ed") for n in _files(shared / "lattice"))
    for r in res:
        assert len(r["lattice"]) == 3
        for r1, r8 in zip(ref["lattice"], r["lattice"]):
            _hold(r1, r8)


def test_per_rank_directories(group, single):
    """Rank 1 in its own directory under a mesh writes no .ed and no
    .restart file (rank 0 writes them all), and still solves twice with
    ed_sectors, reads Sigma back and starts from the bath restart as one
    process does: it reads them through rank 0. With mesh=None in the same
    process group every rank writes every file."""
    shared, res = group
    base, ref = single
    assert _files(shared / "own1" / "mesh") == {}
    _same_files(shared / "own0" / "mesh", base / "solve")
    assert "sectors_list.restart" in _files(shared / "own0" / "mesh")
    _hold_solve(ref["solve"], [r["own_mesh"] for r in res])
    for r in (0, 1):
        _same_files(shared / f"own{r}" / "nomesh", base / "once")
        _hold(ref["once"], res[r]["own_nomesh"])
    assert not [n for n in os.listdir(shared)
                if n.endswith((".ed", ".restart", ".err"))]
