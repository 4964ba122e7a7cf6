"""The single-site k-space and superc drivers of the PyTorch port against
the JAX package on the CPU: the Bloch builders of ``models.kspace``, the
Nambu k-sum ``lattice.gloc_hk_superc``, two iterations of
``kspace.run_kspace`` (the square band at Nspin=2 with the spin-symmetric
fit and the ``nread`` density search; the Haldane model),
``hm_multiband.run`` (2b_square, 3b_square), ``material.run`` on an H(k)
file written by ``write_hk_w90`` and read by ``read_hk_w90``,
``ahm_square.run`` and ``ahm_2bands.run``, the drivers' command lines with
``DEVICE=cpu`` and that every new entry point asks for a card by default.
Seven JAX DMFT loops run here.

Every loop runs its fits to a tight stop (cg_ftol 1e-12), as in
tests/test_torch_drivers_bethe.py. Bounds, measured on these configs (the
CPU, one thread):

* the Bloch builders and the H(k) file: bitwise (the file's bytes, and
  what each package reads back);
* gloc_hk_superc: 1e-13 of max|G| and of max|F| (measured 2.1e-16,
  2.6e-16 on the imaginary axis, 1.2e-14, 1.3e-14 on the real one);
* every loop's first solve (before any fit): dens, docc, egs 1e-10, Σ
  1e-10 of its max (measured at most 4.7e-15 and 6.6e-12);
* the normal-mode loops after two iterations: dens, docc 1e-6, Σ and
  the Weiss field 1e-5 of max, the bath 1e-4, the DMFT error 1e-6
  (measured at most 4.8e-8, 1.2e-8, 5.2e-7, 3.5e-7, 2.7e-7, 1.8e-8); the
  searched xmu 1e-9 (measured 0);
* the superc loops (ahm_square, ahm_2bands): their first fits reach the
  same chi^2 (1e-4 relative; measured 1.6e-9 and 1.5e-5) at baths that
  part by up to 0.1, the anomalous fit's flat valley
  (tests/test_torch_ahm.py). After two iterations: dens 1e-3, docc 2e-3
  (the backend-parity contract, PERF_NOTES.md), phi 1e-4 (measured
  5.9e-5, 2.9e-5, 2.6e-8; 2.6e-5, 1.3e-5, 1.7e-7). With phsym=True the
  ahm_2bands loop parts by 1e-2 in docc after its second solve (first
  fits at chi^2 equal to 1e-5): the valley again, so phsym runs in the
  command line's case only.
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
import dmft_ed_tpu.models.ahm_2bands as j2ahm
import dmft_ed_tpu.models.ahm_square as jsq
import dmft_ed_tpu.models.hm_multiband as jmb
import dmft_ed_tpu.models.kspace as jks
import dmft_ed_tpu.models.material as jmat
import dmft_ed_tpu.solver as jsolver
import dmft_ed_tpu_torch.bath as tbath
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.lattice as tlattice
import dmft_ed_tpu_torch.models.ahm_2bands as t2ahm
import dmft_ed_tpu_torch.models.ahm_square as tsq
import dmft_ed_tpu_torch.models.hm_multiband as tmb
import dmft_ed_tpu_torch.models.kspace as tks
import dmft_ed_tpu_torch.models.material as tmat
import dmft_ed_tpu_torch.solver as tsolver


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


def _record_solves(monkeypatch):
    """{"jax": [...], "torch": [...]}: (egs, dens, docc, smats, bath, xmu)
    of every EDSolver.solve of either package."""
    seen = {"jax": [], "torch": []}
    for key, mod in (("jax", jsolver), ("torch", tsolver)):
        orig = mod.EDSolver.solve

        def solve(self, bath, _orig=orig, _out=seen[key]):
            r = _orig(self, bath)
            o = r.observables
            _out.append((r.egs, o.dens.copy(), o.docc.copy(),
                         r.smats.copy(), np.array(bath), self.cfg.xmu))
            return r
        monkeypatch.setattr(mod.EDSolver, "solve", solve)
    return seen


def _check_first_solve(seen):
    (ej, dj, oj, sj, bj, _), (et, dt, ot, st, bt, _) = (seen["jax"][0],
                                                        seen["torch"][0])
    assert np.array_equal(bj, bt)
    assert abs(ej - et) <= 1e-10
    assert _dev(dj, dt) <= 1e-10 and _dev(oj, ot) <= 1e-10
    assert _rel(sj, st) <= 1e-10


LOOP = dict(beta=50.0, lmats=100, lreal=20, lfit=100, nloop=2,
            dmft_error=1e-12, ed_verbose=0, cg_ftol=1e-12, cg_niter=3000)


def _both(tmp_path, jrun, trun, kw):
    a = _in(tmp_path / "jax", lambda: jrun(
        jconfig.EDConfig(**kw).validate(), log=lambda *x, **k: None))
    b = _in(tmp_path / "torch", lambda: trun(
        tconfig.EDConfig(**kw).validate(), log=lambda *x, **k: None,
        device="cpu"))
    assert a.iterations == b.iterations == kw["nloop"]
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "torch"))
    return a, b


def _check_normal_loop(a, b):
    assert _dev(a.dens, b.dens) <= 1e-6 and _dev(a.docc, b.docc) <= 1e-6
    assert _rel(a.smats, b.smats) <= 1e-5
    assert _rel(a.weiss, b.weiss) <= 1e-5
    assert _dev(a.bath, b.bath) <= 1e-4
    assert _dev(a.error, b.error) <= 1e-6


def _fit_chi2(path):
    return np.loadtxt(path / "chi2fit_results.ed", ndmin=2)[:, 0]


# ----------------------------------------------------------------------
# Bloch builders and the Nambu k-sum

_BUILDERS = {
    "hk_square": dict(nk=6, t=0.3, nso=2),
    "hk_multiband_square": dict(nk=5, ts=0.4, norb=3,
                                shifts=[0.0, 0.0, 0.2]),
    "hk_multiband_cubic": dict(nk=4, ts=0.5, norb=2),
    "hk_square_2nn": dict(nk=6, ts=0.25, tsp=-0.05),
    "hk_daghofer": dict(nk=4, alpha=0.9, theta=0.1, etanm=0.02),
    "hk_2bands_hyb_fcc3d": dict(nk=4, e0=1.0, mh=0.2, lam=0.5),
    "hk_graphene": dict(nk=5, t=1.0, mass=0.1),
    "hk_haldane": dict(nk=5, t1=1.0, t2=0.1, phi=np.pi / 3, mass=0.2),
    "hk_kane_mele": dict(nk=4, t=1.0, soc=0.1),
    "hk_wsm_3d": dict(nk=4, t=1.0, mh=2.0, lam=1.0),
}


@pytest.mark.parametrize("name", sorted(_BUILDERS))
def test_bloch_builders_bitwise(name):
    a = getattr(jks, name)(**_BUILDERS[name])
    b = getattr(tks, name)(**_BUILDERS[name])
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("axis", ["mats", "real"])
def test_gloc_hk_superc_vs_jax(axis):
    """The batched [chunk, Nk, 2Nso, 2Nso] inversion against the JAX
    package's, on the complex Haldane H(k) (so +H(k) in the hole block is
    not conj(H(k))), with random Σ and Σᴬ and a chunk that does not divide
    L."""
    kw = dict(norb=2, nspin=1, ed_mode="superc", lmats=70, lreal=50,
              beta=20.0, xmu=0.1)
    jc, tc = (C.EDConfig(**kw).validate() for C in (jconfig, tconfig))
    hk = jks.hk_haldane(4, 1.0, 0.15, np.pi / 3, 0.1)
    L = 70 if axis == "mats" else 50
    rng = np.random.default_rng(21)

    def rand():
        return 0.2 * (rng.normal(size=(1, 1, 2, 2, L))
                      + 1j * rng.normal(size=(1, 1, 2, 2, L)))
    sig, san = rand(), rand()
    gj, fj = jlattice.gloc_hk_superc(jc, hk, sig, san, axis, chunk=32)
    gt, ft = tlattice.gloc_hk_superc(tc, hk, sig, san, axis, chunk=32,
                                     device="cpu")
    assert gt.shape == gj.shape == (1, 1, 2, 2, L)
    assert np.max(np.abs(fj)) > 1e-3
    assert _rel(gj, gt) <= 1e-13 and _rel(fj, ft) <= 1e-13


# ----------------------------------------------------------------------
# the loops

def test_kspace_square_spin_symmetric_nread(tmp_path, monkeypatch):
    """run_kspace on the square band at Nspin=2: the spin-symmetric fit
    (spin 0 fitted, copied to spin 1) and the nread search moving xmu
    between the solves."""
    seen = _record_solves(monkeypatch)
    kw = dict(LOOP, norb=1, nbath=3, nspin=2, uloc=(2.0,), nread=0.9,
              nerr=1e-6, ndelta=0.05)
    hk = jks.hk_square(6, 0.3, nso=2)
    a, b = _both(tmp_path,
                 lambda c, **k: jks.run_kspace(c, hk, **k),
                 lambda c, **k: tks.run_kspace(c, hk, **k), kw)
    _check_first_solve(seen)
    _check_normal_loop(a, b)
    xj, xt = seen["jax"][1][5], seen["torch"][1][5]
    assert abs(xt) > 1e-3 and _dev(xj, xt) <= 1e-9
    tb = tbath.unpack_bath(tconfig.EDConfig(**kw).validate(), b.bath)
    np.testing.assert_array_equal(tb.e[0], tb.e[1])
    np.testing.assert_array_equal(tb.v[0], tb.v[1])


@pytest.mark.parametrize("model", ["haldane", "2b_square", "3b_square"])
def test_kspace_models_two_iterations(model, tmp_path, monkeypatch):
    """run_kspace on the Haldane model (complex H(k), Norb=2 sublattices),
    and hm_multiband's 2b_square and 3b_square (the dxy shift)."""
    seen = _record_solves(monkeypatch)
    if model == "haldane":
        kw = dict(LOOP, norb=2, nbath=2, uloc=(2.0, 2.0))
        hk = jks.hk_haldane(5, 0.5, 0.1, np.pi / 2, 0.1)
        jrun = lambda c, **k: jks.run_kspace(c, hk, **k)      # noqa: E731
        trun = lambda c, **k: tks.run_kspace(c, hk, **k)      # noqa: E731
    else:
        norb = int(model[0])
        kw = dict(LOOP, norb=norb, nbath=2 if norb == 2 else 1,
                  uloc=(2.0,) * norb, ust=1.0, jh=0.5)
        jrun = lambda c, **k: jmb.run(c, model=model, nk=5, **k)  # noqa
        trun = lambda c, **k: tmb.run(c, model=model, nk=5, **k)  # noqa
    a, b = _both(tmp_path, jrun, trun, kw)
    _check_first_solve(seen)
    _check_normal_loop(a, b)


def test_material_hk_file_round_trip_and_loop(tmp_path, monkeypatch):
    """write_hk_w90 writes the JAX package's bytes, read_hk_w90 reads back
    what the JAX package reads, and material.run loops on the file."""
    monkeypatch.chdir(tmp_path)
    hk = jks.hk_2bands_hyb_fcc3d(3, 1.0, 0.1, 0.4)
    ks = np.linspace(-np.pi, np.pi, 3, endpoint=False)
    kpts = np.array([[x, y, z] for x in ks for y in ks for z in ks])
    jmat.write_hk_w90("j.in", hk, kpts)
    tmat.write_hk_w90("t.in", hk, kpts)
    assert open("j.in", "rb").read() == open("t.in", "rb").read()
    rj, rt = jmat.read_hk_w90("j.in"), tmat.read_hk_w90("t.in")
    for x, y in zip(rj, rt):
        assert np.array_equal(x, y)
    assert rt[2] == (27, 2, 0, 1)
    assert _dev(rt[0], hk) <= 5e-13 and _dev(rt[1], kpts) <= 5e-13
    seen = _record_solves(monkeypatch)
    kw = dict(LOOP, norb=2, nbath=2, uloc=(2.0, 2.0), ust=1.0)
    path = str(tmp_path / "t.in")
    a, b = _both(tmp_path, lambda c, **k: jmat.run(c, path, **k),
                 lambda c, **k: tmat.run(c, path, **k), kw)
    _check_first_solve(seen)
    _check_normal_loop(a, b)
    with pytest.raises(ValueError, match="Nso"):
        tmat.run(tconfig.EDConfig(norb=3).validate(), path, device="cpu")


@pytest.mark.parametrize("driver", ["ahm_square", "ahm_2bands"])
def test_superc_drivers_two_iterations(driver, tmp_path, monkeypatch):
    """ahm_square (the Nambu k-sum) and ahm_2bands (two Bethe bands of
    ratio alpha, phsym): the first solve exactly, the first fit by its
    chi^2, two iterations by the backend contract."""
    seen = _record_solves(monkeypatch)
    if driver == "ahm_square":
        kw = dict(LOOP, norb=1, nbath=3, ed_mode="superc", uloc=(-2.0,))
        jrun = lambda c, **k: jsq.run(c, nk=6, **k)           # noqa: E731
        trun = lambda c, **k: tsq.run(c, nk=6, **k)           # noqa: E731
    else:
        # dense eigh for every sector (the Nambu sectors of Ns=6 reach
        # 924): the JAX package's Lanczos here took 15 s of the test's 48
        kw = dict(LOOP, norb=2, nbath=2, ed_mode="superc",
                  uloc=(-2.0, -2.0), lanc_dim_threshold=1024)
        run_kw = dict(alpha=0.6, le=200, wmixing=0.5)
        jrun = lambda c, **k: j2ahm.run(c, **run_kw, **k)     # noqa: E731
        trun = lambda c, **k: t2ahm.run(c, **run_kw, **k)     # noqa: E731
    a, b = _both(tmp_path, jrun, trun, kw)
    _check_first_solve(seen)
    cj, ct = _fit_chi2(tmp_path / "jax"), _fit_chi2(tmp_path / "torch")
    assert abs(cj[0] - ct[0]) <= 1e-4 * cj[0]
    assert _dev(a.dens, b.dens) <= 1e-3 and _dev(a.docc, b.docc) <= 2e-3
    assert _dev(a.phisc, b.phisc) <= 1e-4
    assert np.all(np.abs(b.phisc) > 1e-2)
    for f in ("smats_an", "gmats", "fmats"):
        assert np.all(np.isfinite(getattr(b, f)))


# ----------------------------------------------------------------------
# command lines and the default device

@pytest.mark.parametrize("driver", ["hm_multiband", "material", "ahm_square",
                                    "ahm_2bands"])
def test_driver_cli_on_cpu(driver, tmp_path, monkeypatch):
    """``python -m dmft_ed_tpu_torch.models.<driver> DEVICE=cpu ...``: the
    command line reaches the loop on the CPU (one iteration, small)."""
    monkeypatch.chdir(tmp_path)
    argv = ["inputED.in", "DEVICE=cpu", "NLOOP=1", "NBATH=2", "LMATS=40",
            "LREAL=10", "LFIT=40", "ED_VERBOSE=0", "CG_NITER=20",
            "BETA=20.0"]
    if driver == "material":
        tmat.write_hk_w90("hk.in", tks.hk_graphene(3),
                          np.zeros((9, 3)))
    mod, extra = {
        "hm_multiband": (tmb, ["NORB=2", "MODEL=2b_cubic", "NK=3"]),
        "material": (tmat, ["NORB=2", "HKFILE=hk.in"]),
        "ahm_square": (tsq, ["ULOC=-2.0", "NK=4", "TS=0.3"]),
        "ahm_2bands": (t2ahm, ["NORB=2", "ULOC=-2.0,-2.0", "ALPHA=0.5",
                               "PHSYM=T"]),
    }[driver]
    r = mod.main(argv + extra)
    assert r.iterations == 1 and np.all(np.isfinite(r.dens))


def _tiny(**kw):
    return tconfig.EDConfig(**dict(dict(norb=1, nbath=2, lmats=8, lreal=4,
                                        nloop=1, ed_verbose=0), **kw))


def _material_default():
    tmat.write_hk_w90("hk.in", tks.hk_square(3), np.zeros((9, 3)))
    return tmat.run(_tiny(), "hk.in")


_ENTRY = {
    "gloc_hk_superc": lambda: tlattice.gloc_hk_superc(
        _tiny(ed_mode="superc").validate(), tks.hk_square(2),
        np.zeros((1, 1, 1, 1, 8)), np.zeros((1, 1, 1, 1, 8))),
    "kspace.run_kspace": lambda: tks.run_kspace(_tiny(), tks.hk_square(2)),
    "hm_multiband.run": lambda: tmb.run(_tiny(norb=2), nk=2),
    "material.run": _material_default,
    "ahm_square.run": lambda: tsq.run(_tiny(ed_mode="superc",
                                            uloc=(-2.0,)), nk=2),
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
