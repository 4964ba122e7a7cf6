"""The superconducting DMFT loop of the PyTorch port against the JAX
package on the CPU: the Nambu lattice functions, the anomalous chi^2 fit,
two iterations of ``models.ahm_bethe.run`` and the superc bath's restart
files through ``convert``. Inputs come from numpy seeds.

Bounds, measured on these configs:

* ``gloc_superc_dos`` (both axes), ``self_consistency_superc`` (weiss and
  delta) and ``kinetic_energy_superc``: bitwise (the same numpy code on
  the same inputs);
* ``chi2_fitgf`` with ``fg_an`` on the target of another Nbath=3 bath,
  from the initial bath: fitted bath within 1e-2 of the JAX package's
  (the bound of the normal fit's parity in tests/test_torch_dmft_loop.py;
  measured 8.6e-6 weiss, 4.5e-10 delta, after 43 and 41 L-BFGS-B steps
  in both packages) and chi^2 within 1e-3 relative (measured 1.2e-4,
  3.4e-8; both stop near 5e-7 on the fit's ftol). The fit walks an
  ill-conditioned valley, so the packages part step by step (bath 1.4e-12
  after 2 steps, 6.1e-9 after 10, weiss); after one L-BFGS-B step, which
  reads the objective and its gradient at x0 only, they agree within
  1e-12 (measured 5.6e-17 weiss, 2.2e-16 delta). The superc fit takes no Δ-target pre-conditioning, so the first fit of
  ``EDSolver.chi2_fitgf`` equals ``precondition=False``, bitwise;
* ``ahm_bethe.run``, two iterations at Nbath=3, U=-2
  (tests/test_dmft_ahm.py's config, thick restart on): the first
  iteration's docc, phi and dens within 1e-9 (measured 4.3e-15); both
  first fits stop after 56 L-BFGS-B steps at chi^2 4.3632e-5 (to 2e-5
  relative), on baths 3.0e-4 apart in the valley; the second fits stop
  after 34 and 20 steps, so the final baths differ by 1.2e-2, held to
  5e-2, and the second iteration's docc, phi and dens by up to 2.4e-4,
  held to 1e-3 (the normal loop's bound in tests/test_torch_dmft_loop.py);
* the superc restart file (e, d, v columns): read through ``convert``
  exactly as the JAX package reads it, written back byte-identical.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dmft_ed_tpu.bath as jbath
import dmft_ed_tpu.bath_fns as jfns
import dmft_ed_tpu.config as jconfig
import dmft_ed_tpu.fit as jfit
import dmft_ed_tpu.grids as jgrids
import dmft_ed_tpu.lattice as jlattice
import dmft_ed_tpu.models.ahm_bethe as jahm
import dmft_ed_tpu.solver as jsolver
import dmft_ed_tpu_torch.bath as tbath
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.convert as convert
import dmft_ed_tpu_torch.fit as tfit
import dmft_ed_tpu_torch.lattice as tlattice
import dmft_ed_tpu_torch.models.ahm_bethe as tahm
import dmft_ed_tpu_torch.solver as tsolver


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_arpack.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dev(x, y):
    return float(np.max(np.abs(np.asarray(x) - np.asarray(y))))


def _cfgs(**kw):
    base = dict(norb=1, nbath=3, nspin=1, ed_mode="superc", uloc=(-2.0,),
                beta=50.0, lmats=200, lreal=60, xmu=0.0, ed_verbose=0)
    base.update(kw)
    return (jconfig.EDConfig(**base).validate(),
            tconfig.EDConfig(**base).validate())


def test_lattice_superc_vs_jax():
    jcfg, tcfg = _cfgs(xmu=0.1)
    eb, db, h0 = tlattice.bethe_bands(1, 1.0, 200)
    rng = np.random.default_rng(61)
    out = {}
    for axis, L in (("mats", jcfg.lmats), ("real", jcfg.lreal)):
        sig = np.zeros((1, 1, 1, 1, L), dtype=complex)
        san = np.zeros_like(sig)
        sig[0, 0, 0, 0] = (rng.normal(size=L) * 0.1
                           - 1j * np.abs(rng.normal(size=L)) * 0.3)
        san[0, 0, 0, 0] = rng.normal(size=L) * 0.2
        a = jlattice.gloc_superc_dos(jcfg, eb, db, h0, sig, san, axis)
        b = tlattice.gloc_superc_dos(tcfg, eb, db, h0, sig, san, axis)
        for x, y in zip(a, b):
            assert np.array_equal(x, y), axis
        out[axis] = (sig, san, b)
    sig, san, (G, F) = out["mats"]
    hloc = np.zeros((1, 1, 1, 1))
    for sc in ("weiss", "delta"):
        a = jlattice.self_consistency_superc(jcfg, G, F, sig, san, hloc, sc)
        b = tlattice.self_consistency_superc(tcfg, G, F, sig, san, hloc, sc)
        for x, y in zip(a, b):
            assert np.array_equal(x, y), sc
    assert jlattice.kinetic_energy_superc(jcfg, eb, db, h0, sig, san) == \
        tlattice.kinetic_energy_superc(tcfg, eb, db, h0, sig, san)


def _fit_target(cfg, seed):
    """Weiss or Δ target (normal, anomalous) of a random Nbath=3 bath: a
    target the fit can reach exactly."""
    rng = np.random.default_rng(seed)
    b = jbath.Bath(cfg)
    b.e[:] = rng.uniform(-1.0, 1.0, b.e.shape)
    b.v[:] = rng.uniform(0.3, 0.7, b.v.shape)
    b.d[:] = rng.uniform(0.1, 0.3, b.d.shape)
    p = jfns.bath_params(b)
    x = jnp.asarray(jgrids.z_mats(cfg))
    hloc = np.zeros((1, 1, 1, 1))
    if cfg.cg_scheme == "weiss":
        return (np.asarray(jfns.g0and(cfg, x, p, hloc)),
                np.asarray(jfns.f0and(cfg, x, p, hloc)))
    return np.asarray(jfns.delta(cfg, x, p)), np.asarray(jfns.fdelta(cfg, x, p))


@pytest.mark.parametrize("scheme", ["weiss", "delta"])
def test_chi2_fitgf_superc_vs_jax(scheme, tmp_path):
    jcfg, tcfg = _cfgs(cg_scheme=scheme, lfit=100)
    fg, fg_an = _fit_target(jcfg, 12)
    hloc = np.zeros((1, 1, 1, 1))
    b0 = jbath.pack_bath(jbath.init_bath(jcfg, hloc))
    log_j, log_t = [], []
    bj = jfit.chi2_fitgf(jcfg, fg, b0, hloc, ispin=0, fg_an=fg_an,
                         log=log_j.append, save=False, precondition=False)
    bt = tfit.chi2_fitgf(tcfg, fg, b0, hloc, ispin=0, fg_an=fg_an,
                         log=log_t.append, save=False, precondition=False,
                         device="cpu")
    one = [F.chi2_fitgf(c.replace(cg_niter=1), fg, b0, hloc, ispin=0,
                        fg_an=fg_an, save=False, precondition=False, **kw)
           for F, c, kw in ((jfit, jcfg, {}),
                            (tfit, tcfg, {"device": "cpu"}))]
    assert _dev(*one) <= 1e-12
    assert _dev(one[0], b0) > 1e-3
    chi_j = float(log_j[-1].split("=")[1].split("|")[0])
    chi_t = float(log_t[-1].split("=")[1].split("|")[0])
    assert abs(chi_j - chi_t) <= 1e-3 * chi_j
    assert chi_t <= 1e-4 * float(np.sum(np.abs(fg[..., :100]) ** 2))
    assert _dev(bj, bt) <= 1e-2
    # EDSolver's first fit would pre-condition in normal mode; superc
    # never does (the JAX package skips it there too)
    s = tsolver.EDSolver(tcfg, hloc, log=lambda m: None, device="cpu")
    assert np.array_equal(s.chi2_fitgf(fg, b0, ispin=0, fg_an=fg_an), bt)


def test_ahm_bethe_two_iterations(tmp_path):
    """Two iterations of the superconducting Bethe loop in both packages
    (tests/test_dmft_ahm.py's config with the thick restart on)."""
    out = {}
    for name, C, S, A, extra in (
            ("jax", jconfig, jsolver, jahm, {}),
            ("torch", tconfig, tsolver, tahm, {"device": "cpu"})):
        cfg = C.EDConfig(norb=1, nbath=3, nspin=1, uloc=(-2.0,),
                         ed_mode="superc", deltasc=0.1, beta=100.0,
                         lmats=200, lreal=60, lfit=200, nloop=2,
                         dmft_error=1e-15, ed_verbose=0,
                         lanc_dim_threshold=16).validate()
        solver = S.EDSolver(cfg, np.zeros((1, 1, 1, 1)), log=lambda m: None,
                            **extra)
        obs = []

        def log(msg, *a, solver=solver, obs=obs, **k):
            if msg.startswith("--- DMFT loop") and solver.result is not None:
                o = solver.result.observables
                obs.append((o.docc.copy(), o.phisc.copy(), o.dens.copy()))

        d = tmp_path / name
        d.mkdir()
        os.chdir(d)
        r = A.run(cfg, le=200, wbethe=1.0, wmixing=0.5, solver=solver,
                  log=log)
        obs.append((r.docc, r.phisc, r.dens))
        out[name] = (r, obs)
    os.chdir(tmp_path)
    (a, oa), (t, ot) = out["jax"], out["torch"]
    assert a.iterations == t.iterations == 2
    assert len(oa) == len(ot) == 2
    for it, tol in ((0, 1e-9), (1, 1e-3)):
        for x, y in zip(oa[it], ot[it]):
            assert _dev(x, y) <= tol, it
    assert _dev(a.bath, t.bath) <= 5e-2
    assert abs(t.phisc[0]) > 0.05
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "torch"))


def test_ahm_bethe_cli(tmp_path):
    """The port's CLI on the CPU, one iteration."""
    os.chdir(tmp_path)
    r = tahm.main(["inputED.in", "DEVICE=cpu", "NBATH=2", "NLOOP=1",
                   "LMATS=64", "LREAL=16", "ULOC=-2.0"])
    assert r.iterations == 1
    assert np.all(np.isfinite(r.smats_an))
    with pytest.raises(ValueError):
        tahm.run(tconfig.EDConfig(), device="cpu")


@pytest.mark.parametrize("bath_type", ["normal", "hybrid"])
def test_superc_restart_roundtrip(bath_type, tmp_path):
    """A superc restart file (e, d, v) the JAX package writes reads back
    through convert as the JAX package reads it, and the port writes it
    back byte-identical."""
    norb = 2 if bath_type == "hybrid" else 1
    jcfg, _ = _cfgs(norb=norb, uloc=(-2.0,) * norb, bath_type=bath_type)
    tcfg = convert.config_from_reference(jcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(70)
    jb = jbath.Bath(jcfg)
    jb.e[:] = rng.uniform(-1.0, 1.0, jb.e.shape)
    jb.d[:] = rng.uniform(0.1, 0.4, jb.d.shape)
    jb.v[:] = rng.uniform(0.2, 0.8, jb.v.shape)
    ref = tmp_path / "ref.restart"
    jbath.save_bath(jb, path=str(ref))
    flat = convert.read_bath_restart(tcfg, str(ref))
    jread = jbath.Bath(jcfg)
    jbath.load_bath(jread, str(ref))
    assert np.array_equal(flat, jbath.pack_bath(jread))
    tb = tbath.unpack_bath(tcfg, flat)
    assert np.array_equal(tb.d, jread.d) and np.any(tb.d != 0)
    out = tmp_path / "port.restart"
    convert.write_bath_restart(tcfg, flat, str(out))
    assert out.read_bytes() == ref.read_bytes()
