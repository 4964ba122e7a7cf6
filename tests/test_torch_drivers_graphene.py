"""The graphene, cluster and post-processing drivers of the PyTorch port
against the JAX package on the CPU: the static Hartree loop
``models.hartree_nano`` (its eigh on the device), ``nano_isoc_sq`` (the
isoc torus, chi0(q) from the inter-site GF, the local Chern marker), the
numpy copies of ``lattice.chi0_ij_static`` / ``chi0_q_static`` and of
``topology``, the bilayer ``blg`` (AA with a bias: four sites), ``tblg``
on synthetic Wannier hoppings (the file written by ``write_hopping`` and
read by ``read_hopping``), the commensurate ``twisted_blg`` cell (28
sites), the drivers' command lines with ``DEVICE=cpu`` and that every new
entry point asks for a card by default. Four JAX DMFT loops run here.

Every loop runs its fits to a tight stop (cg_ftol 1e-12), as in
tests/test_torch_drivers_kspace.py. Bounds, measured on these configs (the
CPU, one thread):

* the builders, chi0_ij_static, chi0_q_static and topology: bitwise (the
  same numpy code on the same inputs), the hopping file byte for byte;
* hartree_nano (one-body; numpy's eigh against torch's): dens, mag, egs
  1e-10 after the whole loop (measured at most 1.0e-15, 1.1e-15,
  7.1e-15), the same iterations (54 and 60);
* nano_isoc_sq, one iteration: the solve's dens, docc 1e-10, chi0(q) 1e-10
  of its max, the Chern marker 1e-10 (measured 6.7e-16, 1.4e-17, 1.5e-15,
  3.0e-15);
* blg and tblg, two iterations: the first solve's egs, dens, docc 1e-10,
  Σ 1e-10 of its max (measured at most 1.8e-15, 7.3e-13); after two,
  dens, docc 1e-6, Σ 1e-5 of its max, the baths 1e-4 (measured at most
  9.4e-8, 5.1e-8, 1.1e-6, 2.7e-6);
* twisted_blg, one iteration over 28 sites: the same first-solve bounds
  (measured 0 and 4.3e-13), the fitted baths 1e-4 (measured 2.0e-14).
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
import dmft_ed_tpu.lattice as jlattice
import dmft_ed_tpu.lattice_solver as jls
import dmft_ed_tpu.models.blg as jblg
import dmft_ed_tpu.models.hartree_nano as jhn
import dmft_ed_tpu.models.kspace as jks
import dmft_ed_tpu.models.nano as jnano
import dmft_ed_tpu.models.nano_isoc_sq as jiso
import dmft_ed_tpu.models.tblg as jtblg
import dmft_ed_tpu.models.twisted_blg as jtw
import dmft_ed_tpu.topology as jtop
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.lattice as tlattice
import dmft_ed_tpu_torch.lattice_solver as tls
import dmft_ed_tpu_torch.models.blg as tblg
import dmft_ed_tpu_torch.models.hartree_nano as thn
import dmft_ed_tpu_torch.models.nano_isoc_sq as tiso
import dmft_ed_tpu_torch.models.tblg as ttblg
import dmft_ed_tpu_torch.models.twisted_blg as ttw
import dmft_ed_tpu_torch.topology as ttop


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread and one BLAS thread per test (see
    tests/test_torch_nano.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.max(np.abs(x - y))) / max(float(np.max(np.abs(x))),
                                              1e-300)


def _dev(x, y):
    return float(np.max(np.abs(np.asarray(x) - np.asarray(y))))


def _in(path, fn):
    path.mkdir()
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


# ----------------------------------------------------------------------
# numpy copies: builders, chi0, topology

def _gij(seed, nlat=4, ns=2, no=2, L=30):
    rng = np.random.default_rng(seed)
    return 0.3 * (rng.normal(size=(nlat, nlat, ns, ns, no, no, L))
                  + 1j * rng.normal(size=(nlat, nlat, ns, ns, no, no, L)))


_CHI_CFG = dict(norb=2, nspin=2, beta=20.0, lmats=30)

_COPIES = {
    "nano_isoc_sq.square_torus_isoc_hij": (
        jiso, tiso, lambda m: m.square_torus_isoc_hij(3, 0.8, 0.15)),
    "nano_isoc_sq.cluster_qgrid": (jiso, tiso,
                                   lambda m: m.cluster_qgrid(4)),
    "blg.blg_hk[AA]": (jblg, tblg, lambda m: m.blg_hk(
        4, "AA", 1.0, 0.2, 0.0, 0.1, 0.3, 0.1, 0.2)),
    "blg.blg_hk[AB]": (jblg, tblg, lambda m: m.blg_hk(
        4, "AB", 1.0, 0.2, 0.1, 0.0, 0.0, 0.0, 0.0)),
    "blg._hk_layer": (jblg, tblg, lambda m: m._hk_layer(0.3, -1.1, 1.0,
                                                        0.1, 0.5, 0.2)),
    "tblg.moire_vectors": (jtblg, ttblg, lambda m: m.moire_vectors()),
    "tblg.synthetic_hopping": (jtblg, ttblg,
                               lambda m: m.synthetic_hopping(3, 2)),
    "tblg.tblg_hk": (jtblg, ttblg, lambda m: m.tblg_hk(
        *m.synthetic_hopping(4), nk=3)),
    "twisted_blg.twist_angle": (jtw, ttw, lambda m: m.twist_angle(2, 1)),
    "twisted_blg._vectors": (jtw, ttw, lambda m: m._vectors(2.46, 2, 1)),
    "hartree_nano.fermi": (jhn, thn, lambda m: m.fermi(
        np.linspace(-3.0, 3.0, 41), 20.0)),
    "twisted_blg.build_unit_cell": (jtw, ttw,
                                    lambda m: m.build_unit_cell(2.46, 1, 1)),
    "twisted_blg.hk_twisted_blg": (jtw, ttw,
                                   lambda m: m.hk_twisted_blg(2, m0=1, r=1)),
    "lattice.chi0_ij_static": (jlattice, tlattice, lambda m: m.chi0_ij_static(
        m.EDConfig(**_CHI_CFG).validate(), _gij(1))),
    "lattice.chi0_q_static": (jlattice, tlattice, lambda m: m.chi0_q_static(
        m.EDConfig(**_CHI_CFG).validate(), _gij(2),
        np.random.default_rng(3).normal(size=(4, 2)),
        np.random.default_rng(4).normal(size=(6, 2)))),
    "topology.chern_number": (jtop, ttop, lambda m: m.chern_number(
        jks.hk_haldane(6, 1.0, 0.2, np.pi / 2, 0.1), 6, 1)),
    "topology.topological_hamiltonian": (
        jtop, ttop, lambda m: m.topological_hamiltonian(
            jks.hk_haldane(3, 1.0, 0.2), np.array([[0.1 + 0.2j, 0.0],
                                                   [0.0, -0.3j]]))),
    "topology.qwz_flake": (jtop, ttop, lambda m: m.qwz_flake(3, 4, 1.2)),
    "topology.local_chern_marker": (jtop, ttop, lambda m: m.local_chern_marker(
        *jtop.qwz_flake(4, 4, 1.0), nso=2,
        sigma0=np.random.default_rng(6).normal(size=(16, 2, 2)))),
}


@pytest.mark.parametrize("name", sorted(_COPIES))
def test_numpy_copies_bitwise(name):
    j, t, fn = _COPIES[name]
    a, b = fn(j), fn(t)
    if name == "topology.chern_number":
        assert abs(a) > 0.5          # a topological phase
    _same(a, b)


def test_hopping_file_round_trip(tmp_path, monkeypatch):
    """write_hopping writes the JAX package's bytes; read_hopping reads
    back what the JAX package reads."""
    monkeypatch.chdir(tmp_path)
    idx, t = ttblg.synthetic_hopping(11)
    jtblg.write_hopping("j.dat", idx, t)
    ttblg.write_hopping("t.dat", idx, t)
    assert open("j.dat", "rb").read() == open("t.dat", "rb").read()
    _same(jtblg.read_hopping("j.dat"), ttblg.read_hopping("t.dat"))
    ri, rt = ttblg.read_hopping("t.dat")
    assert np.array_equal(ri, idx) and _dev(rt, t) <= 1e-12


# ----------------------------------------------------------------------
# hartree_nano: the one-body loop

def _staggered(lx, ly):
    h1 = jnano.square_flake_hij(lx, ly, 0.5)[0]
    n = lx * ly
    seed = 0.3 * np.array([(-1.0) ** ((i % lx) + (i // lx))
                           for i in range(n)])
    return np.kron(h1, np.eye(2)), np.arange(n), seed


@pytest.mark.parametrize("case", ["neel", "nread_phsym"])
def test_hartree_nano_vs_jax(case, tmp_path):
    """The static Hartree loop to convergence: a staggered 4x3 flake at
    U=3 (every site its own class), and the same flake's symmetry classes
    with the nread xmu search and phsym."""
    if case == "neel":
        hij, l2i, seed = _staggered(4, 3)
        kw = dict(norb=1, nspin=2, uloc=(3.0,), beta=50.0, nloop=200,
                  dmft_error=1e-12, ed_verbose=0)
        run_kw = dict(wmixing=0.5, seed_mag=seed)
    else:
        h1, l2i = jnano.square_flake_hij(4, 3, 0.5)
        hij = np.kron(h1, np.eye(2))
        kw = dict(norb=1, nspin=2, uloc=(2.0,), beta=50.0, nloop=60,
                  dmft_error=1e-10, ed_verbose=0, nread=0.9, nerr=1e-8,
                  ndelta=0.1)
        run_kw = dict(wmixing=0.6, phsym=True)
    a = _in(tmp_path / "jax", lambda: jhn.run(
        jconfig.EDConfig(**kw).validate(), hij, l2i,
        log=lambda *x, **k: None, **run_kw))
    b = _in(tmp_path / "torch", lambda: thn.run(
        tconfig.EDConfig(**kw).validate(), hij, l2i,
        log=lambda *x, **k: None, device="cpu", **run_kw))
    assert a.iterations == b.iterations
    assert _dev(a.dens, b.dens) <= 1e-10 and _dev(a.mag, b.mag) <= 1e-10
    assert abs(a.egs - b.egs) <= 1e-10 and _dev(a.sigma, b.sigma) <= 1e-10
    if case == "neel":
        assert b.converged and np.all(np.abs(b.mag) > 0.1)
    for p in ("jax", "torch"):
        assert os.path.exists(tmp_path / p /
                              "observables_last_site0001.hartree")
    assert open(tmp_path / "jax" / "observables_last_site0001.hartree").read() \
        == open(tmp_path / "torch" /
                "observables_last_site0001.hartree").read()


# ----------------------------------------------------------------------
# the DMFT loops

def _record_solves(monkeypatch):
    """{"jax": [...], "torch": [...]}: per LatticeEDSolver.solve of either
    package, the sites' egs, dens, docc, Σ and the baths."""
    seen = {"jax": [], "torch": []}
    for key, mod in (("jax", jls), ("torch", tls)):
        orig = mod.LatticeEDSolver.solve

        def solve(self, baths, batched=True, _orig=orig, _out=seen[key]):
            out = _orig(self, baths, batched=batched)
            _out.append((np.array([r.egs for r in out]),
                         np.stack([r.observables.dens for r in out]),
                         np.stack([r.observables.docc for r in out]),
                         np.stack([r.smats for r in out]), np.array(baths)))
            return out
        monkeypatch.setattr(mod.LatticeEDSolver, "solve", solve)
    return seen


def _check_first_solve(seen):
    (ej, dj, oj, sj, bj), (et, dt, ot, st, bt) = (seen["jax"][0],
                                                  seen["torch"][0])
    assert np.array_equal(bj, bt)
    assert _dev(ej, et) <= 1e-10
    assert _dev(dj, dt) <= 1e-10 and _dev(oj, ot) <= 1e-10
    assert _rel(sj, st) <= 1e-10


LOOP = dict(norb=1, nspin=1, beta=50.0, lmats=100, lreal=20, lfit=100,
            nloop=2, dmft_error=1e-12, ed_verbose=0, cg_ftol=1e-12,
            cg_niter=3000)


def _both(tmp_path, jrun, trun, kw):
    a = _in(tmp_path / "jax", lambda: jrun(
        jconfig.EDConfig(**kw).validate(), log=lambda *x, **k: None))
    b = _in(tmp_path / "torch", lambda: trun(
        tconfig.EDConfig(**kw).validate(), log=lambda *x, **k: None,
        device="cpu"))
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "torch"))
    return a, b


def test_nano_isoc_sq_one_iteration(tmp_path, monkeypatch):
    """nano_isoc_sq.run on the 3x3 isoc torus (one inequivalent class,
    Nspin=2), one iteration: the solve, chi0(q) from the inter-site GF and
    its chi0_up/dw.ed files, the local Chern marker; post_chi0 with
    self_zero on the port's Σ against the JAX package's."""
    seen = _record_solves(monkeypatch)
    kw = dict(LOOP, nspin=2, nbath=2, uloc=(2.0,), nloop=1)
    run_kw = dict(nx=3, t=1.0, lam=0.2, chern=True)
    a, b = _both(tmp_path, lambda c, **k: jiso.run(c, **run_kw, **k),
                 lambda c, **k: tiso.run(c, **run_kw, **k), kw)
    assert a.dmft.iterations == b.dmft.iterations == 1
    _check_first_solve(seen)
    assert _rel(a.chi0, b.chi0) <= 1e-10 and _dev(a.chern, b.chern) <= 1e-10
    assert np.array_equal(a.qpts, b.qpts) and b.chi0.shape == (2, 9)
    for f in ("chi0_up.ed", "chi0_dw.ed"):
        assert (tmp_path / "torch" / f).exists()
    hij, l2i, pos = tiso.square_torus_isoc_hij(3, 1.0, 0.2)
    sl = b.dmft.smats_ineq[l2i]
    tc = tconfig.EDConfig(**kw).validate()
    jc = jconfig.EDConfig(**kw).validate()
    x0 = tiso.post_chi0(tc, hij, sl, pos, self_zero=True, write=False,
                        device="cpu")[0]
    y0 = jiso.post_chi0(jc, hij, sl, pos, self_zero=True, write=False)[0]
    assert _rel(y0, x0) <= 1e-10
    assert b.chi0[0].max() < x0[0].max()       # U suppresses the bubble


@pytest.mark.parametrize("name", ["blg", "tblg"])
def test_graphene_loops_two_iterations(name, tmp_path, monkeypatch):
    """blg (AA stacking with an interlayer bias: four inequivalent
    sublattices) and tblg (four Wannier impurities over synthetic
    hoppings), two iterations each."""
    seen = _record_solves(monkeypatch)
    if name == "blg":
        kw = dict(LOOP, nbath=3, uloc=(2.0,))
        run_kw = dict(stacking="AA", nk=5, bias=0.2)
        jrun = lambda c, **k: jblg.run(c, **run_kw, **k)      # noqa: E731
        trun = lambda c, **k: tblg.run(c, **run_kw, **k)      # noqa: E731
    else:
        kw = dict(LOOP, nbath=2, uloc=(2.0,))
        idx, t = ttblg.synthetic_hopping(9)
        jrun = lambda c, **k: jtblg.run(c, idx, t, nk=4, **k)   # noqa
        trun = lambda c, **k: ttblg.run(c, idx, t, nk=4, **k)   # noqa
    a, b = _both(tmp_path, jrun, trun, kw)
    assert a.iterations == b.iterations == 2
    _check_first_solve(seen)
    (_, dj, oj, _, _), (_, dt, ot, _, _) = seen["jax"][1], seen["torch"][1]
    assert _dev(dj, dt) <= 1e-6 and _dev(oj, ot) <= 1e-6
    assert _dev(a.dens, b.dens) <= 1e-6 and _dev(a.docc, b.docc) <= 1e-6
    assert _rel(a.smats_ineq, b.smats_ineq) <= 1e-5
    assert _dev(a.baths, b.baths) <= 1e-4
    assert len(b.dens) == 4


def test_twisted_blg_one_iteration(tmp_path, monkeypatch):
    """twisted_blg.run on the (1, 1) commensurate cell: 28 inequivalent
    carbon sites in one site-batched solve and one joint fit."""
    seen = _record_solves(monkeypatch)
    kw = dict(LOOP, nbath=1, uloc=(2.0,), nloop=1)
    a, b = _both(tmp_path, lambda c, **k: jtw.run(c, nk=2, **k),
                 lambda c, **k: ttw.run(c, nk=2, **k), kw)
    assert a.iterations == b.iterations == 1
    _check_first_solve(seen)
    assert b.dens.shape == (28,)
    assert _dev(a.baths, b.baths) <= 1e-4


# ----------------------------------------------------------------------
# command lines and the default device

def _hopfile():
    ttblg.write_hopping("hop.dat", *ttblg.synthetic_hopping(2))
    return ["HOPFILE=hop.dat", "NK=3"]


_CLI = {
    "hartree_nano": (thn, lambda: ["NSPIN=2", "LX=3", "LY=2",
                                   "STAGGER=0.3", "NLOOP=20"]),
    "nano_isoc_sq": (tiso, lambda: ["NSPIN=2", "NX=2", "CHERN=T",
                                    "SELF_ZERO=T"]),
    "blg": (tblg, lambda: ["STACKING=AB", "NK=3"]),
    "tblg[2bands]": (ttblg, lambda: _hopfile() + ["NORB=2",
                                                  "VARIANT=2bands"]),
    "twisted_blg": (ttw, lambda: ["NK=1", "NBATH=1"]),
}


@pytest.mark.parametrize("name", sorted(_CLI))
def test_driver_cli_on_cpu(name, tmp_path, monkeypatch):
    """``python -m dmft_ed_tpu_torch.models.<driver> DEVICE=cpu ...``: the
    command line reaches the loop on the CPU (one iteration, small); tblg
    reads its hopping file and runs the 2-band regrouping."""
    monkeypatch.chdir(tmp_path)
    argv = ["inputED.in", "DEVICE=cpu", "NLOOP=1", "NBATH=2", "LMATS=40",
            "LREAL=10", "LFIT=40", "ED_VERBOSE=0", "CG_NITER=20",
            "BETA=20.0"]
    mod, extra = _CLI[name]
    r = mod.main(argv + extra())
    r = getattr(r, "dmft", r)
    assert np.all(np.isfinite(r.dens))
    if name != "hartree_nano":
        assert r.iterations == 1


def _tiny(**kw):
    return tconfig.EDConfig(**dict(dict(norb=1, nbath=1, lmats=8, lreal=4,
                                        nloop=1, ed_verbose=0), **kw))


def _post_chi0_default():
    hij, _, pos = tiso.square_torus_isoc_hij(2)
    return tiso.post_chi0(_tiny(nspin=2).validate(), hij,
                          np.zeros((4, 2, 2, 1, 1, 8)), pos, write=False)


_ENTRY = {
    "hartree_nano.run": lambda: thn.run(_tiny(nspin=2), np.eye(4),
                                        np.zeros(2, dtype=int)),
    "nano_isoc_sq.run": lambda: tiso.run(_tiny(nspin=2), nx=2),
    "nano_isoc_sq.post_chi0": _post_chi0_default,
    "blg.run": lambda: tblg.run(_tiny(), nk=2),
    "tblg.run": lambda: ttblg.run(_tiny(), *ttblg.synthetic_hopping(1),
                                  nk=2),
    "tblg.run_2bands": lambda: ttblg.run_2bands(
        _tiny(norb=2), *ttblg.synthetic_hopping(1), nk=2),
    "twisted_blg.run": lambda: ttw.run(_tiny(), nk=1),
}


@pytest.mark.parametrize("name", sorted(_ENTRY))
def test_entry_points_need_a_card_by_default(name, tmp_path, monkeypatch):
    """Every new entry point runs on cuda unless asked for the CPU, and
    raises without a card instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _ENTRY[name]()


@pytest.mark.parametrize("name", ["hartree_nano", "blg", "tblg",
                                  "twisted_blg", "nano_isoc_sq"])
def test_wrong_shape_raises(name):
    """Where the JAX driver asserts (Norb=1; nano_isoc_sq raises itself),
    the port raises ValueError, before it asks for a device."""
    cfg = _tiny(norb=2)
    call = {"hartree_nano": lambda: thn.run(cfg, np.eye(4), None),
            "blg": lambda: tblg.run(cfg, nk=2),
            "tblg": lambda: ttblg.run(cfg, *ttblg.synthetic_hopping(1),
                                      nk=2),
            "twisted_blg": lambda: ttw.run(cfg, nk=1),
            "nano_isoc_sq": lambda: tiso.run(cfg, nx=2)}[name]
    with pytest.raises(ValueError, match="Norb"):
        call()
