"""The superconducting lattice drivers of the PyTorch port against the JAX
package on the CPU: the Nambu k-sum ``lattice.gloc_hk_lattice_superc`` on
both axes, the stripe and U-stack builders of ``models.ahm_stripe``, the
loops of ``ahm_stripe.run`` (a 2x1 stripe with per-site U),
``ahm_stripe.run_stack`` (the ed_ahm_stackU heterostructure, four layers
in two U domains), ``haldane_sc.run`` (two Nambu sublattices) and
``ahm_disorder.run`` (a 3-site chain with a seeded disorder, every site
inequivalent, closed in real space), the drivers' command lines with
``DEVICE=cpu`` and that every new entry point asks for a card by default.
Four JAX DMFT loops run here.

Every loop runs its fits to a tight stop (cg_ftol 1e-12), as in
tests/test_torch_drivers_kspace.py. The stack and the disorder loops run
one iteration (a solve and a joint fit), the stripe and haldane_sc loops
two. Bounds, measured on these configs (the CPU, one thread):

* the builders: bitwise;
* gloc_hk_lattice_superc: 1e-13 of max|G| and of max|F| (measured
  3.3e-16, 5.4e-16 on the imaginary axis, 3.8e-15, 3.8e-15 on the real
  one);
* every loop's first solve (before any fit), per site: egs, dens, docc,
  phi 1e-10, Σ and Σᴬ 1e-10 of their max (measured at most 5.2e-13 and
  1.0e-11);
* the first joint fit: each site's chi^2 within 5e-3 of the largest
  site's chi^2, the scale of the summed objective the fit minimises
  (measured 2.2e-3 stripe, 1.4e-3 disorder, 1.2e-6 stack, 6.4e-7
  haldane_sc). The anomalous joint fit walks a flat valley: from the same
  inputs the two packages' baths agree to 1.3e-10 after one L-BFGS-B step
  and part by 2.6e-2 after 50 (the stripe's first fit); both fits then
  stop at equal chi^2 on different baths (ROADMAP.md §3);
* after two iterations, the backend-parity contract (PERF_NOTES.md): dens
  1e-3, docc 2e-3 (measured 2.9e-4, 4.1e-4 stripe; 5.9e-7, 2.8e-7
  haldane_sc); phi 1e-4 for haldane_sc (measured 2.6e-6) and 2e-2 for the
  stripe, whose U/2 site's phi parts by 9.6e-3 after the valley's first
  fit (its U site's by 1.3e-6).
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
import dmft_ed_tpu.models.ahm_disorder as jdis
import dmft_ed_tpu.models.ahm_stripe as jstripe
import dmft_ed_tpu.models.haldane_sc as jhsc
import dmft_ed_tpu.models.kspace as jks
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.lattice as tlattice
import dmft_ed_tpu_torch.lattice_solver as tls
import dmft_ed_tpu_torch.models.ahm_disorder as tdis
import dmft_ed_tpu_torch.models.ahm_stripe as tstripe
import dmft_ed_tpu_torch.models.haldane_sc as thsc
import dmft_ed_tpu_torch.models.nano as tnano


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
    """{"jax": [...], "torch": [...]}: per LatticeEDSolver.solve of either
    package, the sites' (egs, dens, docc, phi), Σ, Σᴬ and the baths."""
    seen = {"jax": [], "torch": []}
    for key, mod in (("jax", jls), ("torch", tls)):
        orig = mod.LatticeEDSolver.solve

        def solve(self, baths, batched=True, _orig=orig, _out=seen[key]):
            out = _orig(self, baths, batched=batched)
            _out.append((
                np.array([[r.egs, r.observables.dens[0],
                           r.observables.docc[0], r.observables.phisc[0]]
                          for r in out]),
                np.stack([r.smats for r in out]),
                np.stack([r.smats_an for r in out]), np.array(baths)))
            return out
        monkeypatch.setattr(mod.LatticeEDSolver, "solve", solve)
    return seen


def _check_first_solve(seen):
    (oj, sj, aj, bj), (ot, st, at, bt) = seen["jax"][0], seen["torch"][0]
    assert np.array_equal(bj, bt)
    assert _dev(oj, ot) <= 1e-10
    assert _rel(sj, st) <= 1e-10 and _rel(aj, at) <= 1e-10


LOOP = dict(norb=1, nspin=1, ed_mode="superc", beta=50.0, lmats=100,
            lreal=20, lfit=100, nloop=2, dmft_error=1e-12, ed_verbose=0,
            cg_ftol=1e-12, cg_niter=3000)


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


def _first_fit_chi2(path):
    """Each site's chi^2 after the first joint fit."""
    return np.array([np.loadtxt(f, ndmin=2)[0, 0] for f in sorted(
        path.glob("chi2fit_results_ineq*.ed"))])


def _check_superc_loop(tmp_path, a, b, tol_phi=1e-4):
    cj = _first_fit_chi2(tmp_path / "jax")
    ct = _first_fit_chi2(tmp_path / "torch")
    assert len(cj) == len(ct) == len(b.dens)
    assert np.max(np.abs(cj - ct)) <= 5e-3 * np.max(cj)
    assert _dev(a.dens, b.dens) <= 1e-3 and _dev(a.docc, b.docc) <= 2e-3
    assert _dev(a.phisc, b.phisc) <= tol_phi
    assert np.all(np.abs(b.phisc) > 1e-3)
    assert np.all(np.isfinite(b.baths))


# ----------------------------------------------------------------------
# builders and the Nambu k-sum

_BUILDERS = {
    "stripe_hk": dict(lx=3, ly=2, nk=4, t=0.3),
    "stripe_upattern": dict(lx=5, ly=2, u0=-2.0, u1=-1.0),
    "stack_hk": dict(nlayers=5, n_umin=2, nk=3, nkz=3, ts=0.25,
                     t_perp=0.4, alpha_join=0.7),
    "stack_upattern": dict(nlayers=6, n_umin=2, u_min=-1.0, u_max=-3.0),
}


@pytest.mark.parametrize("name", sorted(_BUILDERS))
def test_builders_bitwise(name):
    a = getattr(jstripe, name)(**_BUILDERS[name])
    b = getattr(tstripe, name)(**_BUILDERS[name])
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _gloc_case(axis):
    """A 2-site Norb=2 supercell with a complex H(k) (Haldane blocks on
    the diagonal, a complex inter-site hop), random Σ, Σᴬ per site and a
    chunk that does not divide L."""
    kw = dict(norb=2, nspin=1, ed_mode="superc", lmats=70, lreal=50,
              beta=20.0, xmu=0.1)
    h1 = jks.hk_haldane(3, 1.0, 0.15, np.pi / 3, 0.1)        # [2, 2, 9]
    nk = h1.shape[-1]
    hk = np.zeros((4, 4, nk), dtype=complex)
    hk[:2, :2] = h1
    hk[2:, 2:] = h1.conj()
    hop = 0.3 * np.exp(1j * np.linspace(0.0, 2.0, nk))
    hk[0, 2], hk[2, 0] = hop, hop.conj()
    L = 70 if axis == "mats" else 50
    rng = np.random.default_rng(23)

    def rand():
        return 0.2 * (rng.normal(size=(2, 1, 1, 2, 2, L))
                      + 1j * rng.normal(size=(2, 1, 1, 2, 2, L)))
    return kw, hk, rand(), rand(), L


@pytest.mark.parametrize("axis", ["mats", "real"])
def test_gloc_hk_lattice_superc_vs_jax(axis):
    """The batched [chunk, Nk, 2Nlso, 2Nlso] inversion against the JAX
    package's, so +H(k) in the hole block and the reversed grid of Σ̄ on
    the real axis show."""
    kw, hk, sig, san, L = _gloc_case(axis)
    jc, tc = (C.EDConfig(**kw).validate() for C in (jconfig, tconfig))
    gj, fj = jlattice.gloc_hk_lattice_superc(jc, hk, sig, san, axis,
                                             chunk=32)
    gt, ft = tlattice.gloc_hk_lattice_superc(tc, hk, sig, san, axis,
                                             chunk=32, device="cpu")
    assert gt.shape == gj.shape == (2, 1, 1, 2, 2, L)
    assert np.max(np.abs(fj)) > 1e-3
    assert _rel(gj, gt) <= 1e-13 and _rel(fj, ft) <= 1e-13


@pytest.mark.gpu
@pytest.mark.parametrize("axis", ["mats", "real"])
def test_gloc_hk_lattice_superc_on_card(axis):
    """The same inversion on the card against the CPU (run there with
    ``python -m pytest -m gpu tests/test_torch_drivers_superc_lattice.py``):
    1e-12 of max|G| and of max|F|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kw, hk, sig, san, _ = _gloc_case(axis)
    tc = tconfig.EDConfig(**kw).validate()
    gc, fc = tlattice.gloc_hk_lattice_superc(tc, hk, sig, san, axis,
                                             device="cpu")
    gg, fg = tlattice.gloc_hk_lattice_superc(tc, hk, sig, san, axis,
                                             device="cuda")
    assert _rel(gc, gg) <= 1e-12 and _rel(fc, fg) <= 1e-12


# ----------------------------------------------------------------------
# the loops

def test_ahm_stripe_two_iterations(tmp_path, monkeypatch):
    """ahm_stripe.run on a 2x1 stripe: two sites of U and U/2 in one
    site-batched solve (per-site cfgs), the Nambu k-sum over the
    supercell, the joint anomalous fit."""
    seen = _record_solves(monkeypatch)
    kw = dict(LOOP, nbath=3, uloc=(-2.0,))
    a, b = _both(tmp_path,
                 lambda c, **k: jstripe.run(c, lx=2, ly=1, nk=4, **k),
                 lambda c, **k: tstripe.run(c, lx=2, ly=1, nk=4, **k), kw)
    _check_first_solve(seen)
    _check_superc_loop(tmp_path, a, b, tol_phi=2e-2)
    assert np.array_equal(a.uloc_sites, b.uloc_sites)
    assert b.uloc_sites.tolist() == [-2.0, -1.0]
    # the stronger U pairs more
    assert abs(b.phisc[0]) > abs(b.phisc[1])


def test_ahm_stack_one_iteration(tmp_path, monkeypatch):
    """ahm_stripe.run_stack: four layers, U_min on the first two, the
    Bloch-phased wrap bond along the stack, alpha_join-scaled junctions;
    four inequivalent superc impurities of two U values."""
    seen = _record_solves(monkeypatch)
    kw = dict(LOOP, nbath=2, uloc=(-3.0,), nloop=1)
    run_kw = dict(nlayers=4, n_umin=2, nk=3, nkz=2, alpha_join=0.8)
    a, b = _both(tmp_path,
                 lambda c, **k: jstripe.run_stack(c, **run_kw, **k),
                 lambda c, **k: tstripe.run_stack(c, **run_kw, **k), kw)
    _check_first_solve(seen)
    _check_superc_loop(tmp_path, a, b)
    assert b.uloc_sites.tolist() == [-1.5, -1.5, -3.0, -3.0]


def test_haldane_sc_two_iterations(tmp_path, monkeypatch):
    """haldane_sc.run: the two honeycomb sublattices (a staggered mass
    makes them inequivalent) over the complex Haldane H(k)."""
    seen = _record_solves(monkeypatch)
    kw = dict(LOOP, nbath=3, uloc=(-3.0,))
    run_kw = dict(nk=4, t1=0.5, t2=0.1, phi=np.pi / 2, mass=0.2)
    a, b = _both(tmp_path, lambda c, **k: jhsc.run(c, **run_kw, **k),
                 lambda c, **k: thsc.run(c, **run_kw, **k), kw)
    _check_first_solve(seen)
    _check_superc_loop(tmp_path, a, b)


def test_ahm_disorder_one_iteration(tmp_path, monkeypatch):
    """ahm_disorder.run on a 3-site open chain with a seeded on-site
    disorder: every site inequivalent, the lattice closed through the
    Nambu real-space inversion."""
    seen = _record_solves(monkeypatch)
    kw = dict(LOOP, nbath=2, uloc=(-2.0,), nloop=1)
    hij = tnano.square_flake_hij(3, 1, 0.5)[0]
    eps = np.random.default_rng(5).uniform(-0.3, 0.3, 3)
    a, b = _both(tmp_path, lambda c, **k: jdis.run(c, hij, eps, **k),
                 lambda c, **k: tdis.run(c, hij, eps, **k), kw)
    _check_first_solve(seen)
    _check_superc_loop(tmp_path, a, b)


# ----------------------------------------------------------------------
# command lines and the default device

@pytest.mark.parametrize("argv", [["ULOC=-2.0", "LX=2", "LY=1", "NK=3"],
                                  ["ULOC=-2.0", "NK=3", "TSP=0.1"]],
                         ids=["ahm_stripe", "haldane_sc"])
def test_driver_cli_on_cpu(argv, tmp_path, monkeypatch):
    """``python -m dmft_ed_tpu_torch.models.<driver> DEVICE=cpu ...``: the
    command line reaches the loop on the CPU (one iteration, small)."""
    monkeypatch.chdir(tmp_path)
    base = ["inputED.in", "DEVICE=cpu", "NLOOP=1", "NBATH=2", "LMATS=40",
            "LREAL=10", "LFIT=40", "ED_VERBOSE=0", "CG_NITER=20",
            "BETA=20.0"]
    mod = thsc if "TSP=0.1" in argv else tstripe
    r = mod.main(base + argv)
    assert r.iterations == 1 and np.all(np.isfinite(r.dens))
    assert np.all(np.isfinite(r.phisc))


def _tiny(**kw):
    return tconfig.EDConfig(**dict(dict(norb=1, nbath=2, lmats=8, lreal=4,
                                        nloop=1, ed_verbose=0,
                                        ed_mode="superc", uloc=(-2.0,)),
                                   **kw))


_ENTRY = {
    "gloc_hk_lattice_superc": lambda: tlattice.gloc_hk_lattice_superc(
        _tiny().validate(), np.zeros((1, 1, 2)),
        np.zeros((1, 1, 1, 1, 1, 8)), np.zeros((1, 1, 1, 1, 1, 8))),
    "ahm_stripe.run": lambda: tstripe.run(_tiny(), nk=2),
    "ahm_stripe.run_stack": lambda: tstripe.run_stack(
        _tiny(), nlayers=2, n_umin=1, nk=2, nkz=2),
    "haldane_sc.run": lambda: thsc.run(_tiny(), nk=2),
    "ahm_disorder.run": lambda: tdis.run(_tiny(), -np.eye(2)[::-1],
                                         np.zeros(2)),
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


@pytest.mark.parametrize("mod", [tstripe, thsc, tdis],
                         ids=["ahm_stripe", "haldane_sc", "ahm_disorder"])
def test_normal_mode_raises(mod):
    """Where the JAX driver asserts superc, Norb=1, Nspin=1, the port
    raises ValueError."""
    cfg = tconfig.EDConfig(norb=1, nbath=2, lmats=8, lreal=4, nloop=1)
    args = (-np.eye(2)[::-1], np.zeros(2)) if mod is tdis else ()
    with pytest.raises(ValueError, match="superc"):
        mod.run(cfg, *args, device="cpu")
