"""The single-site DOS drivers of the PyTorch port against the JAX package
on the CPU: the DOS functions (``lattice.flat_dos``, ``square2d_dos``,
``dos_bands``, ``_trapz_weights``), two iterations of
``models.hm_bethe_nbands.run`` (Norb=2, hybrid bath, U'=U-2J, Jx=Jp=J),
``hm_2bands_bethe.run`` (SC_METHOD 1 on the hybrid Hund impurity, 2 on a
normal bath), ``hm_dos.run`` (flat, 2dsquare, file), ``ehm_bethe.run``
(the Hartree shift of xmu) and ``hm_bethe_afm.run`` (Nspin=2), the AFM
bath's restart file through ``convert``, the Hund operator of the hybrid
impurity under ozaki5x7, the drivers' command lines with ``DEVICE=cpu``
and that every new entry point asks for a card by default. Eight JAX DMFT
loops run here.

Every loop runs its fits to a tight stop (cg_ftol 1e-12), so that the
stopping point does not hide the port's arithmetic (tests/test_torch_nano.py).
Bounds, measured on these configs (the CPU, one thread):

* the DOS functions: bitwise;
* every driver's first solve (before any fit): dens, docc and egs 1e-10,
  Σ(iω) 1e-10 of its max (measured at most 1.2e-12 in Σ, 2.2e-16
  elsewhere);
* hm_bethe_nbands with degenerate orbitals: both packages' first fits
  reach the same chi^2 (1e-9 relative, measured equal) at baths that
  differ by an orbital rotation of the hybridizations V_ak. The fit
  starts on the orbital-symmetric initial bath, a saddle of that
  rotation, and the last bits pick the direction; the Kanamori
  interaction with U'=U-2J, Jx=Jp=J is invariant under it, so the
  second solve is held by the invariants: egs 1e-5, the total density
  1e-6, the trace and the eigenvalues of Σ(iω_n) 1e-5 of max|Σ|
  (measured 8.0e-9, 4.0e-11, 2.3e-8, 1.5e-8); per-orbital docc parts by
  ~1e-2;
* hm_2bands_bethe, SC_METHOD 1 on the hybrid Hund impurity (distinct
  bands, no such rotation): dens, docc, ekin 1e-7, Σ and the Weiss field
  1e-5 of max, the bath 1e-5, the DMFT error 1e-7 (measured 9.0e-9,
  1.5e-8, 1.7e-7, 7.6e-8, 1.4e-7, 6.0e-9); SC_METHOD 2 with MIX_METHOD 2
  on a normal bath: 1e-6, 1e-5, 1e-4, 1e-7 (measured 2.8e-8, 4.5e-9,
  6.9e-7, 8.2e-8, 7.3e-7, 3.3e-9). G on the real axis (broadening 0.01)
  parts by up to 1e-3 of max there: a pole moved by the bath's 1e-7
  changes G by ~1e-7/0.01^2 beside it;
* hm_dos, after two iterations: dens, docc, ekin 1e-6, Σ 1e-5 of max,
  the bath 1e-4 (measured at most 1.7e-8, 1.6e-8, 2.3e-8, 3.4e-7, 4.5e-7
  over flat, 2dsquare and file);
* ehm_bethe: xmu_eff, dens, docc 1e-9, Σ and Δ 1e-9 of max, the bath
  1e-9 (measured 0, 2.0e-13, 7.3e-15, 3.0e-12, 1.4e-12, 3.3e-12);
* hm_bethe_afm: dens, magz 1e-6, Σ 1e-4 of max, the error 1e-5, both
  fits' chi^2 1e-3 relative (measured 3.2e-7, 1.9e-7, 1.9e-6, 3.6e-8);
  its fit's highest level sits in a flat valley, the bath held at 1e-2
  (measured 6.0e-5);
* the AFM restart file: bitwise both ways; the Hund operator: ozaki5x7
  against the JAX package's ozaki5x7 1e-12 of max|Hv| and against native
  1e-9.
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

import jax.numpy as jnp

import dmft_ed_tpu.bath as jbath
import dmft_ed_tpu.config as jconfig
import dmft_ed_tpu.hamiltonian as jham
import dmft_ed_tpu.lattice as jlattice
import dmft_ed_tpu.models.ehm_bethe as jehm
import dmft_ed_tpu.models.hm_2bands_bethe as j2b
import dmft_ed_tpu.models.hm_bethe_afm as jafm
import dmft_ed_tpu.models.hm_bethe_nbands as jnb
import dmft_ed_tpu.models.hm_dos as jdos
import dmft_ed_tpu.sectors as jsectors
import dmft_ed_tpu.solver as jsolver
import dmft_ed_tpu_torch.bath as tbath
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.convert as tconvert
import dmft_ed_tpu_torch.hamiltonian as tham
import dmft_ed_tpu_torch.lattice as tlattice
import dmft_ed_tpu_torch.models.ahm_2bands as t2ahm
import dmft_ed_tpu_torch.models.ehm_bethe as tehm
import dmft_ed_tpu_torch.models.hm_2bands_bethe as t2b
import dmft_ed_tpu_torch.models.hm_bethe_afm as tafm
import dmft_ed_tpu_torch.models.hm_bethe_nbands as tnb
import dmft_ed_tpu_torch.models.hm_dos as tdos
import dmft_ed_tpu_torch.sectors as tsectors
import dmft_ed_tpu_torch.solver as tsolver


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread and one BLAS thread per test (see
    tests/test_torch_nano.py: the JAX package's LAPACK calls spin scipy's
    OpenBLAS threads among the parallel suite's workers)."""
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
    """{"jax": [...], "torch": [...]}: (egs, dens, docc, smats, bath) of
    every EDSolver.solve of either package."""
    seen = {"jax": [], "torch": []}
    for key, mod in (("jax", jsolver), ("torch", tsolver)):
        orig = mod.EDSolver.solve

        def solve(self, bath, _orig=orig, _out=seen[key]):
            r = _orig(self, bath)
            o = r.observables
            _out.append((r.egs, o.dens.copy(), o.docc.copy(),
                         r.smats.copy(), np.array(bath)))
            return r
        monkeypatch.setattr(mod.EDSolver, "solve", solve)
    return seen


def _check_first_solve(seen):
    """The first solve of both loops, on the same initial bath."""
    (ej, dj, oj, sj, bj), (et, dt, ot, st, bt) = (seen["jax"][0],
                                                  seen["torch"][0])
    assert np.array_equal(bj, bt)
    assert abs(ej - et) <= 1e-10
    assert _dev(dj, dt) <= 1e-10 and _dev(oj, ot) <= 1e-10
    assert _rel(sj, st) <= 1e-10


LOOP = dict(beta=50.0, lmats=100, lreal=20, lfit=100, nloop=2,
            dmft_error=1e-12, ed_verbose=0, cg_ftol=1e-12, cg_niter=3000)
HUND = dict(LOOP, norb=2, nbath=3, bath_type="hybrid", uloc=(2.0, 2.0),
            ust=1.5, jh=0.25, jx=0.25, jp=0.25)


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


# ----------------------------------------------------------------------
# DOS functions

def _dos_file(path, e, rho):
    np.savetxt(path, np.column_stack([e, rho]))
    return str(path)


@pytest.mark.parametrize("case", ["flat_dos", "square2d_dos", "trapz",
                                  "bethe", "flat", "2dsquare", "file"])
def test_dos_functions_bitwise(case, tmp_path):
    e = np.linspace(-2.5, 2.5, 301)
    if case == "flat_dos":
        pairs = [(jlattice.flat_dos(e, 1.3), tlattice.flat_dos(e, 1.3))]
    elif case == "square2d_dos":
        pairs = [(jlattice.square2d_dos(e, 0.5),
                  tlattice.square2d_dos(e, 0.5))]
    elif case == "trapz":
        x = np.sort(np.random.default_rng(5).uniform(-1, 1, (3, 40)))
        pairs = [(jlattice._trapz_weights(x), tlattice._trapz_weights(x))]
    else:
        files = None
        if case == "file":
            files = [_dos_file(tmp_path / "a.dat", e, np.exp(-e ** 2)),
                     _dos_file(tmp_path / "b.dat", e[:-7],
                               np.cosh(e[:-7]) ** -2)]
        kw = dict(wband=[1.0, 1.7], le=200, h0=[-0.1, 0.1], ts=0.5,
                  dos_file=files)
        pairs = list(zip(jlattice.dos_bands(2, case, **kw),
                         tlattice.dos_bands(2, case, **kw)))
    for a, b in pairs:
        assert np.asarray(a).shape == np.asarray(b).shape
        assert np.array_equal(a, b)
        assert np.all(np.isfinite(b))


def test_dos_bands_unknown_model():
    with pytest.raises(ValueError, match="unknown dos_model"):
        tlattice.dos_bands(1, "cubic")
    with pytest.raises(ValueError, match="DOS files"):
        tlattice.dos_bands(2, "file", dos_file=["x.dat"])


# ----------------------------------------------------------------------
# the loops

def _fit_chi2(path):
    return np.loadtxt(path / "chi2fit_results.ed", ndmin=2)[:, 0]


def test_hm_bethe_nbands_hund_two_iterations(tmp_path, monkeypatch):
    """The BASELINE 2-band Hund config at small size: degenerate bands,
    hybrid bath. Held by the quantities invariant under the orbital
    rotation the fit leaves free (module docstring)."""
    seen = _record_solves(monkeypatch)
    a, b = _both(tmp_path, jnb.run, tnb.run, HUND)
    _check_first_solve(seen)
    cj, ct = _fit_chi2(tmp_path / "jax"), _fit_chi2(tmp_path / "torch")
    assert abs(cj[0] - ct[0]) <= 1e-9 * cj[0]
    (ej, dj, _, sj, _), (et, dt, _, st, _) = seen["jax"][1], seen["torch"][1]
    assert _dev(ej, et) <= 1e-5
    assert _dev(dj.sum(), dt.sum()) <= 1e-6
    smax = np.max(np.abs(sj))
    trj = np.trace(sj[0, 0], axis1=0, axis2=1)
    trt = np.trace(st[0, 0], axis1=0, axis2=1)
    assert _dev(trj, trt) <= 1e-5 * smax
    evj, evt = (np.linalg.eigvals(s[0, 0].transpose(2, 0, 1))
                for s in (sj, st))
    evj, evt = (np.take_along_axis(ev, np.argsort(ev.imag, axis=1), 1)
                for ev in (evj, evt))
    assert _dev(evj, evt) <= 1e-5 * smax
    assert np.all(np.abs(b.dens - 1.0) <= 1e-3)
    assert np.all((b.docc > 0.0) & (b.docc < 0.25))
    assert np.max(np.abs(b.smats[0, 0, 0, 1])) > 1e-3   # hybrid: Σ_01 != 0


@pytest.mark.parametrize("sc", [1, 2])
def test_hm_2bands_bethe_two_iterations(sc, tmp_path, monkeypatch):
    """SC_METHOD 1 (matrix Weiss update, bath mixing) on the hybrid Hund
    impurity with distinct bands; SC_METHOD 2 (the Bethe shortcut on
    Gimp) with MIX_METHOD 2 (Weiss mixing) on a normal bath."""
    seen = _record_solves(monkeypatch)
    if sc == 1:
        kw, run_kw = HUND, dict(wratio=1.3, delta=0.2, sc_method=1)
        tol = dict(dens=1e-7, sigma=1e-5, bath=1e-5, error=1e-7)
    else:
        kw = dict(LOOP, norb=2, nbath=2, uloc=(2.0, 2.0), ust=1.0, jh=0.5)
        run_kw = dict(wratio=2.0, delta=0.3, sc_method=2, mix_method=2)
        tol = dict(dens=1e-6, sigma=1e-5, bath=1e-4, error=1e-7)
    a, b = _both(tmp_path, lambda c, **k: j2b.run(c, **run_kw, **k),
                 lambda c, **k: t2b.run(c, **run_kw, **k), kw)
    _check_first_solve(seen)
    assert _dev(a.dens, b.dens) <= tol["dens"]
    assert _dev(a.docc, b.docc) <= tol["dens"]
    assert _rel(a.smats, b.smats) <= tol["sigma"]
    assert _dev(a.bath, b.bath) <= tol["bath"]
    assert _dev(a.error, b.error) <= tol["error"]
    assert _dev(a.ekin, b.ekin) <= tol["dens"]
    assert _rel(a.weiss, b.weiss) <= tol["sigma"]


@pytest.mark.parametrize("model", ["flat", "2dsquare", "file"])
def test_hm_dos_two_iterations(model, tmp_path, monkeypatch):
    seen = _record_solves(monkeypatch)
    kw = dict(LOOP, norb=2, nbath=2, uloc=(2.0, 2.0), ust=1.0)
    run_kw = dict(dos_model=model, wband=[1.0, 1.5], delta=0.2, le=200,
                  ts=0.25)
    if model == "file":
        e = np.linspace(-1.0, 1.0, 151)
        run_kw["dos_file"] = [
            _dos_file(tmp_path / "a.dat", e, 0.75 * (1 - e ** 2)),
            _dos_file(tmp_path / "b.dat", e, np.full_like(e, 0.5))]
    a, b = _both(tmp_path, lambda c, **k: jdos.run(c, **run_kw, **k),
                 lambda c, **k: tdos.run(c, **run_kw, **k), kw)
    _check_first_solve(seen)
    assert _dev(a.dens, b.dens) <= 1e-6 and _dev(a.docc, b.docc) <= 1e-6
    assert _rel(a.smats, b.smats) <= 1e-5
    assert _dev(a.bath, b.bath) <= 1e-4
    assert _dev(a.ekin, b.ekin) <= 1e-6


def test_ehm_bethe_two_iterations(tmp_path, monkeypatch):
    """The Hartree shift moves xmu between the solves (replacing
    solver.cfg): the second solve runs at xmu_eff = xmu + W0 - W0 dens."""
    seen = _record_solves(monkeypatch)
    kw = dict(LOOP, norb=1, nbath=3, uloc=(2.0,), xmu=0.1)
    a, b = _both(tmp_path, lambda c, **k: jehm.run(c, w0=0.4, le=200, **k),
                 lambda c, **k: tehm.run(c, w0=0.4, le=200, **k), kw)
    _check_first_solve(seen)
    assert _dev(a.xmu_eff, b.xmu_eff) <= 1e-9
    dens1 = float(seen["torch"][0][1].sum())
    assert b.xmu_eff == pytest.approx(0.1 + 0.4 - 0.4 * dens1, abs=1e-15)
    assert abs(b.xmu_eff - 0.1) > 1e-3
    assert _dev(a.dens, b.dens) <= 1e-9 and _dev(a.docc, b.docc) <= 1e-9
    assert _rel(a.smats, b.smats) <= 1e-9
    assert _dev(a.bath, b.bath) <= 1e-9
    assert _rel(a.delta, b.delta) <= 1e-9


def test_hm_bethe_afm_two_iterations(tmp_path, monkeypatch):
    """Nspin=2, the bath split by sb_field, the spin-swapped Bethe
    self-consistency: a staggered moment grows."""
    seen = _record_solves(monkeypatch)
    kw = dict(LOOP, norb=1, nbath=3, nspin=2, uloc=(3.0,))
    a, b = _both(tmp_path, jafm.run, tafm.run, kw)
    _check_first_solve(seen)
    assert _dev(a.dens, b.dens) <= 1e-6 and _dev(a.magz, b.magz) <= 1e-6
    assert abs(float(b.magz[0])) > 1e-2
    assert _rel(a.smats, b.smats) <= 1e-4
    assert _dev(a.bath, b.bath) <= 1e-2
    assert _dev(a.error, b.error) <= 1e-5
    cj, ct = _fit_chi2(tmp_path / "jax"), _fit_chi2(tmp_path / "torch")
    assert np.all(np.abs(cj - ct) <= 1e-3 * cj)


def test_afm_bath_restart_through_convert(tmp_path, monkeypatch):
    """The AFM driver's Nspin=2 bath (sb_field split): the port's initial
    bath equals the JAX package's bitwise; the restart file the JAX
    package writes reads back through convert as the JAX package reads
    it, and the port writes the same bytes."""
    monkeypatch.chdir(tmp_path)
    kw = dict(norb=1, nbath=4, nspin=2, uloc=(2.0,), sb_field=0.15)
    jc = jconfig.EDConfig(**kw).validate()
    tc = tconvert.config_from_reference(jc)
    hloc = np.zeros((2, 2, 1, 1))
    js = jsolver.EDSolver(jc, hloc, log=lambda m: None)
    jflat = jbath.break_symmetry_bath(jc, js.init_solver(), jc.sb_field, 1.0)
    ts = tsolver.EDSolver(tc, hloc, log=lambda m: None, device="cpu")
    tflat = tbath.break_symmetry_bath(tc, ts.init_solver(), tc.sb_field, 1.0)
    assert np.array_equal(jflat, tflat)
    jb = jbath.unpack_bath(jc, jflat)
    assert np.max(np.abs(jb.e[0] - jb.e[1])) > 0.1   # the spins differ
    jbath.save_bath(jb, path="ref.restart")
    flat = tconvert.read_bath_restart(tc, "ref.restart")
    jread = jbath.Bath(jc)
    jbath.load_bath(jread, "ref.restart")
    assert np.array_equal(flat, jbath.pack_bath(jread))
    tconvert.write_bath_restart(tc, flat, "port.restart")
    assert open("port.restart", "rb").read() == \
        open("ref.restart", "rb").read()


def test_hund_hybrid_operator_ozaki(monkeypatch):
    """The hybrid Hund impurity's largest sector (spin exchange and pair
    hopping as mix terms): the port's ozaki5x7 operator against the JAX
    package's and against its own native one."""
    kw = dict(HUND, nbath=4, matmul_precision="ozaki5x7")
    jc = jconfig.EDConfig(**kw).validate()
    tc = tconfig.EDConfig(**kw).validate()
    rng = np.random.default_rng(12)
    jb, tb = jbath.Bath(jc), tbath.Bath(tc)
    jb.e[:] = tb.e[:] = rng.uniform(-1.0, 1.0, jb.e.shape)
    jb.v[:] = tb.v[:] = rng.uniform(0.2, 0.7, jb.v.shape)
    hloc = np.zeros((1, 1, 2, 2))
    sec = max(tsectors.sector_table(tc).sectors, key=lambda s: s.dim)
    jsec = jsectors.sector_table(jc).sectors[sec.index]
    ht = tham.build_sector_hamiltonian(tc, sec, tb, hloc)
    assert len(ht.mix) == 4
    x = rng.normal(size=(2, sec.dim))
    out = {}
    for prec in ("ozaki5x7", "native"):
        spec, arrays, blocks = tham.make_matvec_op(
            ht, tc.replace(matmul_precision=prec), "cpu")
        assert {m.up.kind if m.kind == "chain" else m.kind
                for m in tham.mix_entries(spec)} == (
            {"ozr"} if prec == "ozaki5x7" else {"pmix"})
        out[prec] = tham.flatten_blocks(tham.apply_op(
            spec, arrays, tham.unflatten_blocks(torch.from_numpy(x),
                                                blocks))).numpy()
    sj, aj, _ = jham.make_matvec_op(
        jham.build_sector_hamiltonian(jc, jsec, jb, hloc), jc)
    for i, xi in enumerate(x):
        yj = np.asarray(jham.flatten_blocks(jham.apply_op(
            sj, aj, jham.unflatten_blocks(jnp.asarray(xi), jsec))))
        assert _rel(yj, out["ozaki5x7"][i]) <= 1e-12
    assert _rel(out["native"], out["ozaki5x7"]) <= 1e-9


@pytest.mark.gpu
def test_hund_operator_ozaki_on_card(monkeypatch):
    """The Norb=2 Hund operator under ozaki5x7 on the card (run there with
    ``python -m pytest -m gpu tests/test_torch_drivers_bethe.py``): every
    digit-matmul launch, the mix terms' included, bitwise equal to its
    plain version on the same operands, and H v within 1e-9 of native."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from dmft_ed_tpu_torch import ozaki as tozaki
    from dmft_ed_tpu_torch.kernels import digit_matmul, digit_matmul_plain
    calls = []

    def held(*a, **k):
        got = digit_matmul(*a, **k)
        calls.append(torch.equal(got, digit_matmul_plain(*a, **k)))
        return got
    monkeypatch.setattr(tozaki, "digit_matmul", held)
    tc = tconfig.EDConfig(**dict(HUND, nbath=6)).validate()
    rng = np.random.default_rng(13)
    tb = tbath.Bath(tc)
    tb.e[:] = rng.uniform(-1.0, 1.0, tb.e.shape)
    tb.v[:] = rng.uniform(0.2, 0.7, tb.v.shape)
    sec = max(tsectors.sector_table(tc).sectors, key=lambda s: s.dim)
    ht = tham.build_sector_hamiltonian(tc, sec, tb, np.zeros((1, 1, 2, 2)))
    x = torch.from_numpy(rng.normal(size=sec.dim)).cuda()
    n0 = digit_matmul.launches
    ys = []
    for prec in ("ozaki5x7", "native"):
        spec, arrays, blocks = tham.make_matvec_op(
            ht, tc.replace(matmul_precision=prec), "cuda")
        ys.append(tham.flatten_blocks(tham.apply_op(
            spec, arrays, tham.unflatten_blocks(x, blocks))))
    torch.cuda.synchronize()
    assert len(calls) == 10 and all(calls)      # hup, hdw, 4 mix terms x 2
    assert digit_matmul.launches - n0 == 10     # the plain ones launch none
    assert _rel(ys[1].cpu().numpy(), ys[0].cpu().numpy()) <= 1e-9


# ----------------------------------------------------------------------
# command lines and the default device

@pytest.mark.parametrize("driver", ["hm_bethe_nbands", "hm_2bands_bethe",
                                    "hm_dos", "ehm_bethe", "hm_bethe_afm"])
def test_driver_cli_on_cpu(driver, tmp_path, monkeypatch):
    """``python -m dmft_ed_tpu_torch.models.<driver> DEVICE=cpu ...``: the
    command line reaches the loop on the CPU (one iteration, small)."""
    monkeypatch.chdir(tmp_path)
    argv = ["inputED.in", "DEVICE=cpu", "NLOOP=1", "NBATH=2", "LMATS=40",
            "LREAL=10", "LFIT=40", "ED_VERBOSE=0", "CG_NITER=20",
            "BETA=20.0"]
    mod, extra = {
        "hm_bethe_nbands": (tnb, ["NORB=2", "BATH_TYPE=hybrid", "JH=0.25",
                                  "ULOC=2.0,2.0", "WBETHE=1.0,1.5"]),
        "hm_2bands_bethe": (t2b, ["NORB=2", "WRATIO=1.5", "SC_METHOD=2"]),
        "hm_dos": (tdos, ["DOS_MODEL=2dsquare", "TS=0.25", "LE=100"]),
        "ehm_bethe": (tehm, ["W0=0.3", "LE=100"]),
        "hm_bethe_afm": (tafm, ["ULOC=3.0"]),
    }[driver]
    r = mod.main(argv + extra)
    assert r.iterations == 1 and np.all(np.isfinite(r.dens))


def _tiny(**kw):
    return tconfig.EDConfig(**dict(dict(norb=1, nbath=2, lmats=8, lreal=4,
                                        nloop=1, ed_verbose=0), **kw))


_ENTRY = {
    "hm_bethe_nbands.run": lambda: tnb.run(_tiny(norb=2,
                                                  bath_type="hybrid")),
    "hm_2bands_bethe.run": lambda: t2b.run(_tiny(norb=2)),
    "hm_dos.run": lambda: tdos.run(_tiny(), dos_model="flat"),
    "ehm_bethe.run": lambda: tehm.run(_tiny()),
    "hm_bethe_afm.run": lambda: tafm.run(_tiny(nspin=2)),
    "ahm_2bands.run": lambda: t2ahm.run(_tiny(norb=2, ed_mode="superc",
                                              uloc=(-2.0, -2.0))),
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
