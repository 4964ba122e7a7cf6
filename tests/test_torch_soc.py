"""The k-space drivers of broken-SU(2) mode in the PyTorch port against
the JAX package on the CPU: the k-sum local Green's function
(``lattice.gloc_hk``), two iterations of ``models.soc.run`` (t2g + atomic
SOC, nonsu2, replica bath) and of ``models.bhz_2d.run`` (rh != 0, nonsu2),
``models.bhz_3d``'s Bloch builder, the drivers' command lines, and the
SOC operators of the impurity.

The JAX package's nonsu2 G carries its off-diagonal components at the
transpose (ROADMAP.md §3); the JAX side of each loop here runs with that
G transposed back before its Dyson (``_jax_nonsu2_g_mended``), so both
loops solve the same equations.

Bounds, measured on these configs:

* gloc_hk: 1e-13 of max|G| (measured 1.1e-16);
* soc.run, 2 iterations (Norb=3, Nbath=1, nk=4, Lmats=100): dens 1e-9,
  Σ(iω) 1e-7 of its max, the bath vector 1e-6, the DMFT error 1e-6
  relative (measured 8.8e-14, 1.2e-12, 1.2e-13, 1.5e-12); the same .ed
  file names;
* bhz_2d.run, 2 iterations (rh = 0.2, nonsu2, Nbath=2, nk=6, Lmats=100):
  dens 1e-7, Σ(iω) and the Weiss field 1e-6 of their max, the bath 1e-6,
  the error 1e-5 relative (measured 4.4e-9, 2.1e-8, 6.0e-9, 4.3e-9,
  2.6e-8): the first fit agrees to rounding, the second parts the two
  packages at 1e-8 in the fit's flat valley, as in superc
  (tests/test_torch_ahm.py);
* the SOC operators <J>, <J^2>, <L.S> 1e-15 and J_imp.ed.
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

import dmft_ed_tpu.config as jconfig
import dmft_ed_tpu.gf_nonsu2 as jgf
import dmft_ed_tpu.lattice as jlattice
import dmft_ed_tpu.models.bhz_2d as jbhz
import dmft_ed_tpu.models.bhz_3d as jbhz3
import dmft_ed_tpu.models.soc as jsoc
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.lattice as tlattice
import dmft_ed_tpu_torch.models.bhz_2d as tbhz
import dmft_ed_tpu_torch.models.bhz_3d as tbhz3
import dmft_ed_tpu_torch.models.soc as tsoc


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_arpack.py), and
    one BLAS thread for the JAX package's LAPACK calls (see
    tests/test_torch_nano.py: spinning OpenBLAS threads made the SOC loop
    test take 704 s among the parallel suite's workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _dev(x, y, scale=1.0):
    """max|x - y| / scale."""
    return float(np.max(np.abs(np.asarray(x) - np.asarray(y)))) / scale


@pytest.fixture
def _jax_nonsu2_g_mended(monkeypatch):
    """The JAX package's build_gf_nonsu2 with its G transposed to the
    <<c_{a,s}; c†_{b,s'}>> convention of G0 (and of the port)."""
    orig = jgf.build_gf_nonsu2

    def mended(*a, **k):
        return tuple(np.ascontiguousarray(G.transpose(1, 0, 3, 2, 4))
                     for G in orig(*a, **k))
    monkeypatch.setattr(jgf, "build_gf_nonsu2", mended)


def test_gloc_hk_vs_jax():
    """The batched [chunk, Nk, Nso, Nso] inversion against the JAX
    package's, with a chunk that does not divide Lmats."""
    kw = dict(norb=3, nspin=2, nbath=1, ed_mode="nonsu2",
              bath_type="replica", lmats=70, beta=20.0, xmu=0.1)
    jcfg = jconfig.EDConfig(**kw).validate()
    tcfg = tconfig.EDConfig(**kw).validate()
    hk, _ = tsoc.build_hk_soc(4)
    rng = np.random.default_rng(3)
    sig = 0.1 * (rng.normal(size=(2, 2, 3, 3, 70))
                 + 1j * rng.normal(size=(2, 2, 3, 3, 70)))
    a = jlattice.gloc_hk(jcfg, hk, sig, "mats", chunk=32)
    b = tlattice.gloc_hk(tcfg, hk, sig, "mats", chunk=32, device="cpu")
    assert np.max(np.abs(a[0, 1])) > 1e-3
    assert _dev(a, b, np.max(np.abs(a))) <= 1e-13


def _soc_cfg(C, **kw):
    base = dict(norb=3, nspin=2, nbath=1, uloc=(1.0, 1.0, 1.0), ust=0.5,
                ed_mode="nonsu2", bath_type="replica", beta=50.0, lmats=100,
                lreal=30, lfit=100, nloop=2, dmft_error=1e-9, ed_verbose=0,
                lanc_dim_threshold=1000, lanc_nstates_sector=2,
                cg_niter=200)
    base.update(kw)
    return C.EDConfig(**base).validate()


def _in(path, fn):
    path.mkdir()
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def test_soc_run_two_iterations_vs_jax(tmp_path, _jax_nonsu2_g_mended):
    a = _in(tmp_path / "jax", lambda: jsoc.run(
        _soc_cfg(jconfig), nk=4, log=lambda m: None))
    b = _in(tmp_path / "torch", lambda: tsoc.run(
        _soc_cfg(tconfig), nk=4, log=lambda m: None, device="cpu"))
    assert a.iterations == b.iterations == 2
    assert _dev(a.dens, b.dens) <= 1e-9
    assert np.max(np.abs(b.smats[0, 1])) > 1e-4
    assert _dev(a.smats, b.smats, np.max(np.abs(a.smats))) <= 1e-7
    assert _dev(a.bath, b.bath) <= 1e-6
    assert abs(a.error - b.error) <= 1e-6 * a.error
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "torch"))


def _bhz_cfg(C, **kw):
    base = dict(norb=2, nspin=2, nbath=2, uloc=(2.0, 2.0), ust=1.0, jh=0.25,
                ed_mode="nonsu2", beta=50.0, lmats=100, lreal=30, lfit=100,
                nloop=2, dmft_error=1e-9, ed_verbose=0,
                lanc_dim_threshold=1000, lanc_nstates_sector=2,
                cg_niter=200)
    base.update(kw)
    return C.EDConfig(**base).validate()


def test_bhz_2d_run_two_iterations_vs_jax(tmp_path, _jax_nonsu2_g_mended):
    """rh != 0 mixes the spins: nonsu2 with a normal bath (e, v, u), the
    fit on ispin=0 and the spin-symmetrized bath."""
    kw = dict(nk=6, rh=0.2, mh=1.0, llambda=0.3)
    a = _in(tmp_path / "jax", lambda: jbhz.run(
        _bhz_cfg(jconfig), log=lambda m: None, **kw))
    b = _in(tmp_path / "torch", lambda: tbhz.run(
        _bhz_cfg(tconfig), log=lambda m: None, device="cpu", **kw))
    assert a.iterations == b.iterations == 2
    assert _dev(a.dens, b.dens) <= 1e-7
    assert np.max(np.abs(b.smats[0, 1])) > 1e-4
    assert _dev(a.smats, b.smats, np.max(np.abs(a.smats))) <= 1e-6
    assert _dev(a.weiss, b.weiss, np.max(np.abs(a.weiss))) <= 1e-6
    assert _dev(a.bath, b.bath) <= 1e-6
    assert abs(a.error - b.error) <= 1e-5 * a.error
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "torch"))


def test_bhz_3d_bloch_builder_vs_jax():
    a = jbhz3.build_hk_grid_3d(4, 1.0, 0.3, 1.0)
    b = tbhz3.build_hk_grid_3d(4, 1.0, 0.3, 1.0)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    a = jbhz.build_hk_grid(6, 1.0, 0.3, 0.2)
    b = tbhz.build_hk_grid(6, 1.0, 0.3, 0.2)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("driver", ["soc", "bhz_2d", "bhz_3d"])
def test_driver_cli_on_cpu(driver, tmp_path, monkeypatch):
    """``python -m dmft_ed_tpu_torch.models.<driver> DEVICE=cpu ...``: the
    command line reaches the loop on the CPU (one iteration, small)."""
    monkeypatch.chdir(tmp_path)
    mod = {"soc": tsoc, "bhz_2d": tbhz, "bhz_3d": tbhz3}[driver]
    argv = ["DEVICE=cpu", "NLOOP=1", "NBATH=1", "LMATS=40", "LREAL=10",
            "LFIT=40", "ED_VERBOSE=0", "CG_NITER=20", "BETA=20.0",
            "NK=4" if driver != "bhz_3d" else "NK=3"]
    if driver == "bhz_2d":
        argv += ["ED_MODE=nonsu2", "RH=0.1"]
    r = mod.main(argv)
    assert r.iterations == 1 and np.all(np.isfinite(r.dens))


def test_quantum_soc_operators_vs_jax(tmp_path):
    """<J>, <J^2>, <L.S> of the t2g shell from the port's density matrix,
    and J_imp.ed, against the JAX solver's accessor on the same result."""
    import dmft_ed_tpu.solver as jsolver
    import dmft_ed_tpu_torch.solver as tsolver
    cfg = _soc_cfg(tconfig, lmats=20, lreal=10)
    _, hloc = tsoc.build_hk_soc(2)
    s = tsolver.EDSolver(cfg, hloc, log=lambda m: None, device="cpu")
    js = jsolver.EDSolver(_soc_cfg(jconfig, lmats=20, lreal=10), hloc,
                          log=lambda m: None)

    def go(solver):
        ops = solver.get_quantum_soc_operators()
        return ops, np.loadtxt("J_imp.ed")
    res = _in(tmp_path / "torch", lambda: s.solve(s.init_solver()))
    js.result = res
    b, fb = _in(tmp_path / "t", lambda: go(s))
    a, fa = _in(tmp_path / "j", lambda: go(js))
    for k in ("J", "Jsq", "LS"):
        assert _dev(a[k], b[k]) <= 1e-15, k
    assert abs(b["LS"]) > 1e-3
    assert np.array_equal(fa, fb)
