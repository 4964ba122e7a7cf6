"""The inequivalent-site drivers of the PyTorch port against the JAX
package on the CPU: the real-space and site-resolved lattice functions
(``gloc_realspace`` and its full, superc and k-resolved forms,
``kinetic_energy_realspace``, transport, the effective exchange), two
iterations of ``models.hm_square_lattice.run`` on a 3x2 flake (2
inequivalent sites), ``models.nano.run`` on the isoc hexagon with its
``magXY.ed``, one ``nano.run_sc`` iteration, one ``models.soc_ineq.run``
iteration (the JAX package's nonsu2 G transposed back, as in
tests/test_torch_soc.py), the bath stack restart files between the two
packages (``convert.read_bath_stack`` / ``write_bath_stack``), the
drivers' command lines with ``DEVICE=cpu``, and that every new entry point
asks for a card by default. Two JAX DMFT loops run here (the flake, and
soc_ineq).

Bounds, measured on these configs:

* the lattice functions on random inputs: 1e-12 of max|f| (measured
  6.1e-15); kinetic_energy_realspace and effective_exchange 1e-12
  (measured 0, the same numpy arithmetic);
* the 3x2 flake, first iteration (before any fit): dens, docc 1e-10, Σ
  1e-8 of max (measured 1.9e-15, 3.3e-16, 2.5e-12). Its fits run to a
  tight stop (see the test); the second iteration: dens, docc 1e-6, Σ
  1e-5 of max, the bath 1e-4, ekin 1e-6 (measured 1.2e-7, 9.2e-8,
  1.3e-6, 3.0e-6, 1.3e-8);
* soc_ineq, one iteration: dens 1e-10, Σ(iω) and the Weiss field 1e-8
  of max, the bath after its fit 1e-6 (measured 4.4e-16, 8.2e-12,
  2.0e-12, 2.2e-13);
* the bath stack files: bitwise both ways.
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

import dmft_ed_tpu.bath as jbath
import dmft_ed_tpu.config as jconfig
import dmft_ed_tpu.gf_nonsu2 as jgfn
import dmft_ed_tpu.lattice as jlattice
import dmft_ed_tpu.lattice_solver as jls
import dmft_ed_tpu.models.hm_square_lattice as jsq
import dmft_ed_tpu.models.nano as jnano
import dmft_ed_tpu.models.soc_ineq as jsocineq
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.convert as tconvert
import dmft_ed_tpu_torch.lattice as tlattice
import dmft_ed_tpu_torch.lattice_solver as tls
import dmft_ed_tpu_torch.models.hm_square_lattice as tsq
import dmft_ed_tpu_torch.models.lattice_loop as tloop
import dmft_ed_tpu_torch.models.nano as tnano
import dmft_ed_tpu_torch.models.soc_ineq as tsocineq


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (see tests/test_torch_arpack.py), and
    one BLAS thread: the JAX package's LAPACK calls (its batched eigh of
    the 924-dim nonsu2 sectors) run on scipy's OpenBLAS (imported above,
    so that the limit reaches it), whose spinning threads slow a test
    ~20x when six workers of the parallel suite run such calls at once
    (measured: 24 s alone, over 600 s among six, 31 s limited)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.max(np.abs(x - y))) / max(float(np.max(np.abs(x))),
                                              1e-300)


def _in(path, fn):
    path.mkdir()
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _rand_sigma(rng, nlat, ns, no, L, scale=0.2):
    s = scale * (rng.normal(size=(nlat, ns, ns, no, no, L))
                 + 1j * rng.normal(size=(nlat, ns, ns, no, no, L)))
    return s


def _rand_hij(rng, n):
    h = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    return 0.3 * (h + h.conj().T)


_LATTICE = ["gloc_realspace_mats", "gloc_realspace_real", "kinetic_energy",
            "gij_realspace", "gloc_realspace_full", "transmission",
            "effective_exchange", "gloc_hk_lattice", "gloc_realspace_superc"]


@pytest.mark.parametrize("fn", _LATTICE)
def test_lattice_functions_vs_jax(fn):
    """Each real-space / site-resolved lattice function on seeded random
    inputs (Nlat=3, Nspin=2, Norb=1 unless the function fixes it; chunks
    that do not divide L)."""
    rng = np.random.default_rng(_LATTICE.index(fn))
    kw = dict(norb=1, nspin=2, nbath=1, beta=20.0, lmats=37, lreal=29,
              xmu=0.1, eps=0.02)
    if fn == "gloc_realspace_superc":
        kw.update(nspin=1, ed_mode="superc")
    jc = jconfig.EDConfig(**kw).validate()
    tc = tconfig.EDConfig(**kw).validate()
    ns = kw["nspin"]
    nlat = 3
    nlso = nlat * ns
    hij = _rand_hij(rng, nlso)
    L = kw["lmats"] if fn in ("gloc_realspace_mats", "kinetic_energy") \
        else kw["lreal"]
    sig = _rand_sigma(rng, nlat, ns, 1, L)
    cpu = {"device": "cpu"}
    if fn == "gloc_realspace_mats":
        a = jlattice.gloc_realspace(jc, hij, sig, "mats", chunk=16)
        b = tlattice.gloc_realspace(tc, hij, sig, "mats", chunk=16, **cpu)
    elif fn == "gloc_realspace_real":
        a = jlattice.gloc_realspace(jc, hij, sig, "real", chunk=8)
        b = tlattice.gloc_realspace(tc, hij, sig, "real", chunk=8, **cpu)
    elif fn == "kinetic_energy":
        # Σ decaying as 1/(iω) with a static part, as a real Σ does
        wm = np.pi / kw["beta"] * (2 * np.arange(L) + 1)
        sig = sig * 0 + (0.3 + 0.2 / (1j * wm))[None, None, None, None,
                                                   None, :]
        a = jlattice.kinetic_energy_realspace(jc, hij, sig)
        b = tlattice.kinetic_energy_realspace(tc, hij, sig)
        assert abs(a - b) <= 1e-12 * max(1.0, abs(a))
        return
    elif fn == "gij_realspace":
        a = jlattice.gij_realspace(jc, hij, sig, "real", chunk=8)
        b = tlattice.gij_realspace(tc, hij, sig, "real", chunk=8, **cpu)
    elif fn == "gloc_realspace_full":
        lead = 0.1j * rng.normal(size=(nlso, nlso, L))
        a = jlattice.gloc_realspace_full(jc, hij, sig, "real", lead=lead)
        b = tlattice.gloc_realspace_full(tc, hij, sig, "real", lead=lead,
                                         chunk=7, **cpu)
        assert _rel(a, b) <= 1e-12
        a = jlattice.gloc_realspace_full(jc, hij, sig, "real",
                                         lead=lead[..., 0])
        b = tlattice.gloc_realspace_full(tc, hij, sig, "real",
                                         lead=lead[..., 0], **cpu)
    elif fn == "transmission":
        gl, gr = jlattice.wideband_leads(nlso, [0], [nlat - 1], 0.4, nso=ns)
        gl2, gr2 = tlattice.wideband_leads(nlso, [0], [nlat - 1], 0.4,
                                           nso=ns)
        assert np.array_equal(gl, gl2) and np.array_equal(gr, gr2)
        a = jlattice.transmission(jc, hij, sig, gl, gr)
        b = tlattice.transmission(tc, hij, sig, gl, gr, chunk=8, **cpu)
        assert np.max(np.abs(a)) > 1e-3
    elif fn == "effective_exchange":
        g = _rand_sigma(rng, 1, 1, 1, 1, L)[0, 0, 0, 0, 0]
        gfull = rng.normal(size=(nlso, nlso, L)) + 1j * g[None, None, :]
        a = jlattice.effective_exchange(jc, gfull, sig)
        b = tlattice.effective_exchange(tc, gfull, sig)
    elif fn == "gloc_hk_lattice":
        hk = np.stack([_rand_hij(rng, nlso) for _ in range(5)], axis=-1)
        sigm = _rand_sigma(rng, nlat, ns, 1, kw["lmats"])
        a = jlattice.gloc_hk_lattice(jc, hk, sigm, "mats", chunk=16)
        b = tlattice.gloc_hk_lattice(tc, hk, sigm, "mats", chunk=16, **cpu)
    else:
        for axis in ("mats", "real"):
            Lx = kw["lmats"] if axis == "mats" else L
            s1 = _rand_sigma(rng, nlat, 1, 1, Lx)
            s2 = _rand_sigma(rng, nlat, 1, 1, Lx)
            a = jlattice.gloc_realspace_superc(jc, hij.real, s1, s2, axis)
            b = tlattice.gloc_realspace_superc(tc, hij.real, s1, s2, axis,
                                               chunk=9, **cpu)
            for x, y in zip(a, b):
                assert _rel(x, y) <= 1e-12, axis
        return
    assert np.asarray(a).shape == np.asarray(b).shape
    assert _rel(a, b) <= 1e-12


def _record_solves(monkeypatch, mod):
    """Record the per-site results of every LatticeEDSolver.solve."""
    seen = []
    orig = mod.LatticeEDSolver.solve

    def solve(self, baths, batched=True):
        out = orig(self, baths, batched=batched)
        seen.append(([r.observables.dens.copy() for r in out],
                     [r.observables.docc.copy() for r in out],
                     self.get_sigma_matsubara().copy(), baths.copy()))
        return out
    monkeypatch.setattr(mod.LatticeEDSolver, "solve", solve)
    return seen


def test_square_flake_two_iterations_vs_jax(tmp_path, monkeypatch):
    """hm_square_lattice.run on a 3x2 flake (2 inequivalent classes of 3
    sites), two iterations on the package's thick restart and native
    products (sectors above 20 through the stacked restart over both
    sites): the first solve exactly, the second after one joint fit; the
    C2v classes of the flake keep equal values. The fit runs to a tight
    stop (cg_ftol 1e-12) so that its flat valley does not hide the port's
    arithmetic behind a path-dependent stopping point (at the default
    1e-5 the second iteration's dens parts by 1.7e-3: the flat valley of
    tests/test_torch_sites.py's module note)."""
    kw = dict(norb=1, nbath=3, nspin=1, uloc=(2.0,), beta=50.0, lmats=100,
              lreal=20, nloop=2, ed_verbose=0, lanc_dim_threshold=20,
              cg_ftol=1e-12, cg_niter=3000)
    seen = {"jax": _record_solves(monkeypatch, jls),
            "torch": _record_solves(monkeypatch, tls)}
    a = _in(tmp_path / "jax", lambda: jsq.run(
        jconfig.EDConfig(**kw).validate(), lx=3, ly=2, ts=0.5,
        log=lambda m: None))
    b = _in(tmp_path / "torch", lambda: tsq.run(
        tconfig.EDConfig(**kw).validate(), lx=3, ly=2, ts=0.5,
        log=lambda m: None, device="cpu"))
    assert a.iterations == b.iterations == 2
    (dj, oj, sj, bj), (dt, ot, st, bt) = seen["jax"][0], seen["torch"][0]
    assert np.array_equal(bj, bt)
    assert np.max(np.abs(np.array(dj) - np.array(dt))) <= 1e-10
    assert np.max(np.abs(np.array(oj) - np.array(ot))) <= 1e-10
    assert _rel(sj, st) <= 1e-8
    assert np.max(np.abs(a.dens - b.dens)) <= 1e-6
    assert np.max(np.abs(a.docc - b.docc)) <= 1e-6
    assert _rel(a.smats_ineq, b.smats_ineq) <= 1e-5
    assert np.max(np.abs(a.baths - b.baths)) <= 1e-4
    assert abs(a.ekin - b.ekin) <= 1e-6
    for grp in ([0, 2, 3, 5], [1, 4]):          # corners, edge centres
        np.testing.assert_allclose(b.dens[grp], b.dens[grp[0]], atol=1e-12)
        np.testing.assert_allclose(b.docc[grp], b.docc[grp[0]], atol=1e-12)
    assert np.all((b.docc > 0.02) & (b.docc < 0.25))
    assert abs(b.dens.mean() - 1.0) <= 1e-3
    assert b.solver.timers.acc["diagonalize_sites"] > 0
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "torch"))


def test_nano_hexagon_mag_xy(tmp_path, monkeypatch):
    """nano.run on the 6-site isoc ring (Nspin=2, one inequivalent
    class): one iteration; mag_xy and magXY.ed against the JAX package's
    functions on the port's lattice G, and the loop's G_loc against the
    JAX package's gloc_realspace on the port's Σ."""
    monkeypatch.chdir(tmp_path)
    hij, l2i = tnano.hexagon_isoc_hij(1.0, 0.1)
    hj, lj = jnano.hexagon_isoc_hij(1.0, 0.1)
    assert np.array_equal(hij, hj) and np.array_equal(l2i, lj)
    kw = dict(norb=1, nbath=3, nspin=2, uloc=(2.0,), beta=40.0, lmats=60,
              lreal=10, nloop=1, ed_verbose=0)
    tc = tconfig.EDConfig(**kw).validate()
    r = tnano.run(tc, hij, l2i, log=lambda m: None, device="cpu")
    jc = jconfig.EDConfig(**kw).validate()
    sm = r.smats_ineq
    g = jlattice.gloc_realspace(jc, hij, sm[l2i], "mats")
    assert _rel(g, r.gmats_lat) <= 1e-12
    ref = jnano.mag_xy(jc, g[:1])
    assert _rel(ref + 1.0, r.mag_xy + 1.0) <= 1e-12
    np.testing.assert_allclose(r.mag_xy, 0.0, atol=1e-8)   # spin-conserving
    got = open("magXY.ed").read()
    os.mkdir("j")
    os.chdir("j")
    jnano.write_mag_xy(ref)
    assert open("magXY.ed").read() == got
    assert np.all(np.abs(r.dens - 1.0) <= 1e-6)


def test_nano_run_sc_one_iteration(tmp_path, monkeypatch):
    """nano.run_sc, one iteration on a 3-site chain (2 classes): the
    loop's steps recomposed from the port's parts, each held to the JAX
    package elsewhere (the cross-site superc solve and joint fit in
    tests/test_torch_sites.py, gloc_realspace_superc above); the anomalous
    Weiss field feeds the fit and phi is finite."""
    monkeypatch.chdir(tmp_path)
    hij = np.zeros((3, 3))
    hij[0, 1] = hij[1, 0] = hij[1, 2] = hij[2, 1] = -0.5
    l2i = np.array([0, 1, 0])
    kw = dict(norb=1, nbath=3, nspin=1, uloc=(-1.5,), beta=40.0,
              ed_mode="superc", lmats=60, lreal=10, nloop=1, ed_verbose=0)
    tc = tconfig.EDConfig(**kw).validate()
    calls = []
    orig = tls.LatticeEDSolver.chi2_fitgf

    def fit(self, w, b, ispin=None, fg_an_ineq=None):
        calls.append((w.copy(), b.copy(), ispin, fg_an_ineq))
        return orig(self, w, b, ispin=ispin, fg_an_ineq=fg_an_ineq)
    monkeypatch.setattr(tls.LatticeEDSolver, "chi2_fitgf", fit)
    r = tnano.run_sc(tc, hij, l2i, log=lambda m: None, device="cpu")
    assert r.iterations == 1 and len(calls) == 1
    w, b, ispin, wa = calls[0]
    assert ispin == 0 and wa is not None and np.max(np.abs(wa)) > 1e-4
    gm, fm = tlattice.gloc_realspace_superc(
        tc, hij, r.smats_ineq[l2i], r.smats_an_ineq[l2i], "mats",
        device="cpu")
    wn, wa2 = tlattice.self_consistency_superc(
        tc, gm[1], fm[1], r.smats_ineq[1], r.smats_an_ineq[1],
        np.zeros((1, 1, 1, 1)))
    assert _rel(w[1], wn) <= 1e-12 and _rel(wa[1], wa2) <= 1e-12
    assert np.all(np.isfinite(r.phisc)) and np.max(np.abs(r.phisc)) > 1e-4
    assert r.phisc[0] == r.phisc[2]


def test_soc_ineq_one_iteration_vs_jax(tmp_path, monkeypatch):
    """soc_ineq.run (nlat=2, Norb=3, nonsu2, normal bath) for one
    iteration at nk=2, the JAX package's nonsu2 G transposed back."""
    orig = jgfn.gf_nonsu2_plan

    def mended(*a, **k):
        fin = orig(*a, **k)
        return lambda results: tuple(
            np.ascontiguousarray(G.transpose(1, 0, 3, 2, 4))
            for G in fin(results))
    monkeypatch.setattr(jgfn, "gf_nonsu2_plan", mended)
    kw = dict(norb=3, nspin=2, nbath=1, uloc=(1.0, 1.0, 1.0), ust=0.5,
              ed_mode="nonsu2", beta=30.0, lmats=60, lreal=10, nloop=1,
              ed_verbose=0, lanc_nstates_sector=2, lanc_ngfiter=24,
              lanc_dim_threshold=1024)
    a = _in(tmp_path / "jax", lambda: jsocineq.run(
        jconfig.EDConfig(**kw).validate(), nk=2, log=lambda m: None))
    b = _in(tmp_path / "torch", lambda: tsocineq.run(
        tconfig.EDConfig(**kw).validate(), nk=2, log=lambda m: None,
        device="cpu"))
    assert a.iterations == b.iterations == 1
    assert np.max(np.abs(a.dens - b.dens)) <= 1e-10
    assert np.max(np.abs(b.smats_ineq[:, 0, 1])) > 0
    assert _rel(a.smats_ineq, b.smats_ineq) <= 1e-8
    assert _rel(a.weiss_ineq, b.weiss_ineq) <= 1e-8
    assert np.max(np.abs(a.baths - b.baths)) <= 1e-6
    ops = b.solver.get_quantum_soc_operators()
    assert len(ops) == 2 and all(np.isfinite(o["LS"]) for o in ops)


def test_bath_stack_restart_files_both_ways(tmp_path, monkeypatch):
    """A bath stack the JAX package writes (<hfile>_ineq####.restart, as
    its lattice solver saves them) reads back in the port bitwise as the
    JAX lattice solver reads it; the port writes the same bytes, and the
    JAX lattice solver starts from the port's files."""
    monkeypatch.chdir(tmp_path)
    kw = dict(norb=1, nbath=4, nspin=1, uloc=(2.0,))
    jc = jconfig.EDConfig(**kw).validate()
    tc = tconfig.EDConfig(**kw).validate()
    rng = np.random.default_rng(4)
    stack = []
    for i in range(3):
        b = jbath.Bath(jc)
        b.e[:] = rng.normal(size=b.e.shape)
        b.v[:] = rng.uniform(0.2, 0.9, size=b.v.shape)
        jbath.save_bath(b, suffix=f"_ineq{i + 1:04d}")
        stack.append(jbath.pack_bath(b))
    stack = np.stack(stack)

    def jax_start():
        return jls.LatticeEDSolver(jc, np.zeros((3, 1, 1, 1, 1)),
                                   log=lambda m: None).init_solvers()
    ref = jax_start()
    assert np.max(np.abs(ref - stack)) <= 1e-11     # 12 printed decimals
    np.testing.assert_array_equal(tconvert.read_bath_stack(tc, 3), ref)
    ts = tls.LatticeEDSolver(tc, np.zeros((3, 1, 1, 1, 1)),
                             log=lambda m: None, device="cpu")
    np.testing.assert_array_equal(ts.init_solvers(), ref)
    written = {p.name: p.read_bytes() for p in tmp_path.iterdir()}
    os.mkdir("p")
    os.chdir("p")
    tconvert.write_bath_stack(tc, stack)
    assert {p.name: p.read_bytes() for p in (tmp_path / "p").iterdir()} \
        == written
    np.testing.assert_array_equal(jax_start(), ref)


@pytest.mark.parametrize("driver", ["hm_square_lattice", "soc_ineq"])
def test_driver_cli_on_cpu(driver, tmp_path, monkeypatch):
    """``python -m dmft_ed_tpu_torch.models.<driver> DEVICE=cpu ...``: the
    command line reaches the loop on the CPU (one iteration, small)."""
    monkeypatch.chdir(tmp_path)
    argv = ["DEVICE=cpu", "NLOOP=1", "NBATH=2", "LMATS=40", "LREAL=10",
            "LFIT=40", "ED_VERBOSE=0", "CG_NITER=20", "BETA=20.0"]
    if driver == "hm_square_lattice":
        r = tsq.main(argv + ["LX=2", "LY=2", "TS=0.5"])
        assert np.all(np.isfinite(r.dens)) and len(r.dens) == 4
    else:
        r = tsocineq.main(argv[:2] + ["NBATH=1"] + argv[3:]
                          + ["NK=2", "NLAT=2", "SHIFTS=0.0,0.1",
                             "LANC_NGFITER=16", "LANC_NSTATES_SECTOR=2"])
        assert np.all(np.isfinite(r.dens)) and r.dens.shape == (2, 3)
    assert r.iterations == 1


def _entry_points():
    hij, l2i = tnano.square_flake_hij(2, 1, 0.5)
    c = tconfig.EDConfig(norb=1, nbath=2, nspin=1, lmats=8, lreal=4,
                         nloop=1, ed_verbose=0).validate()
    z = np.zeros((2, 1, 1, 1, 1))
    s = np.zeros((2, 1, 1, 1, 1, 8), dtype=complex)
    return {
        "LatticeEDSolver": lambda: tls.LatticeEDSolver(c, z),
        "diagonalize_sites": lambda: __import__(
            "dmft_ed_tpu_torch.diag", fromlist=["x"]).diagonalize_sites(
            c, [None, None], [z[0], z[0]]),
        "chi2_fitgf_sites": lambda: __import__(
            "dmft_ed_tpu_torch.fit", fromlist=["x"]).chi2_fitgf_sites(
            c, s, np.zeros((2, 4)), [z[0], z[0]]),
        "gloc_realspace": lambda: tlattice.gloc_realspace(c, hij, s),
        "gloc_hk_lattice": lambda: tlattice.gloc_hk_lattice(
            c, hij[..., None], s),
        "nano.run": lambda: tnano.run(c, hij, l2i),
        "hm_square_lattice.run": lambda: tsq.run(c, lx=2, ly=1),
        "run_sites": lambda: tloop.run_sites(c, hij[..., None]),
        "soc_ineq.run": lambda: tsocineq.run(c.replace(
            norb=3, nspin=2, ed_mode="nonsu2", uloc=(1.0, 1.0, 1.0)),
            nk=2),
    }


@pytest.mark.parametrize("name", [
    "LatticeEDSolver", "diagonalize_sites", "chi2_fitgf_sites",
    "gloc_realspace", "gloc_hk_lattice", "nano.run", "hm_square_lattice.run",
    "run_sites", "soc_ineq.run"])
def test_entry_points_need_a_card_by_default(name, tmp_path, monkeypatch):
    """Every new entry point runs on cuda unless asked for the CPU, and
    raises without a card instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
