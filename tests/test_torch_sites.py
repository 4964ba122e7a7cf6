"""Inequivalent sites in the PyTorch port against the JAX package on the
CPU: the site-batched sector sweep (``diag.diagonalize_sites``: the
batched dense eigh, the stacked thick restart over the sites' operators,
twins, finite T with its per-site post-diag, per-site configs and restart
masks), the cross-site Green's functions and susceptibilities
(``ResolventBatch.add_site``, ``LatticeEDSolver._batched_gf`` /
``_batched_chi``) in normal, superc and nonsu2 mode, the joint bath fit
(``fit.chi2_fitgf_sites``) and ``LatticeEDSolver.solve(batched=True)``
against ``batched=False``. Sizes follow tests/test_site_batched.py
(Nbath=3-4, 2-3 sites).

The JAX package's nonsu2 G is the transpose of G0's convention
(ROADMAP.md §3); its cross-site pass is held here with that G transposed
back (``_jax_nonsu2_plan_mended``), as tests/test_torch_soc.py does for the
single site.

Bounds, measured on these configs:

* sweep energies and Z, both routes, twins, finite T, per-site cfgs:
  1e-10 against the JAX package and against the port's single-site sweep
  (measured 9.8e-15 and 4.4e-15); the ground state as |<v_jax|v_port>|
  within 1e-10 of 1 (measured 2.1e-15); the finite-T DiagState evolution
  equal;
* cross-site G, Σ (and F, Σᴬ in superc) on the Matsubara axis: 1e-10 of
  max|f| against the JAX package and against the port's per-site solve
  (measured 4.2e-12 and 4.7e-12), on the real axis 1e-8 (measured
  5.9e-10 and 1.0e-9; nonsu2: the spin-diagonal G only against the JAX
  package, see the test);
* cross-site chi in τ, iν, ω: 1e-10 of max|chi| (measured 6.5e-13
  against the JAX package, 4.1e-13 against the per-site chi);
* the joint fit: one L-BFGS-B iteration (cg_niter=1) 1e-12 against the
  JAX package (measured 2.7e-13), 1e-9 with the Δ pre-conditioning pass
  before it (measured 2.7e-10). A whole fit stops in a flat valley at a
  point that depends on the last bits of the objective: with the
  objectives equal to 1e-16 the two packages' fitted baths part by up to
  2.6e-3 at equal chi^2 (measured on the first fit of a 3x2 flake), as
  the single-site fit does (tests/test_torch_dmft_loop.py). Held: chi^2
  per site within 1e-3 relative, baths within 1e-2.
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
import dmft_ed_tpu.diag as jdiag
import dmft_ed_tpu.fit as jfit
import dmft_ed_tpu.gf_nonsu2 as jgfn
import dmft_ed_tpu.lattice_solver as jls
import dmft_ed_tpu_torch.bath as tbath
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.diag as tdiag
import dmft_ed_tpu_torch.fit as tfit
import dmft_ed_tpu_torch.gf_common as tgfc
import dmft_ed_tpu_torch.lanczos as tlanczos
import dmft_ed_tpu_torch.lattice_solver as tls

TOL_E = 1e-10
TOL_G = 1e-10
TOL_GR = 1e-8


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


@pytest.fixture
def _jax_nonsu2_plan_mended(monkeypatch):
    """The JAX package's gf_nonsu2_plan with its finalized G transposed to
    the <<c_{a,s}; c†_{b,s'}>> convention of G0 (and of the port)."""
    orig = jgfn.gf_nonsu2_plan

    def mended(*a, **k):
        fin = orig(*a, **k)
        return lambda results: tuple(
            np.ascontiguousarray(G.transpose(1, 0, 3, 2, 4))
            for G in fin(results))
    monkeypatch.setattr(jgfn, "gf_nonsu2_plan", mended)


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.max(np.abs(x - y))) / max(float(np.max(np.abs(x))),
                                              1e-300)


def _site_problem(kw, nsites, seed):
    """Per-site random baths (sorted levels, V in [0.3, 0.8]) and local
    levels, as the same numpy arrays for both packages."""
    rng = np.random.default_rng(seed)
    jcfg = jconfig.EDConfig(**kw).validate()
    tcfg = tconfig.EDConfig(**kw).validate()
    jb, tb, hlocs = [], [], []
    for _ in range(nsites):
        b = jbath.Bath(jcfg)
        e = np.sort(rng.normal(size=b.e.shape), axis=-1)
        v = rng.uniform(0.3, 0.8, size=b.v.shape)
        for B, c, out in ((jbath, jcfg, jb), (tbath, tcfg, tb)):
            x = B.Bath(c)
            x.e[:] = e
            x.v[:] = v
            out.append(x)
        h = np.zeros((1, 1, 1, 1))
        h[0, 0, 0, 0] = rng.normal() * 0.3
        hlocs.append(h)
    return jcfg, tcfg, jb, tb, hlocs


def _hold_sweeps(jres, tres, tcfg, tb, hlocs, ref_states=None):
    (slj, zj, stj), (slt, zt, stt) = jres, tres
    for i in range(len(hlocs)):
        assert len(slj[i]) == len(slt[i]), i
        np.testing.assert_allclose([s.energy for s in slt[i]],
                                   [s.energy for s in slj[i]], atol=TOL_E)
        assert abs(zj[i] - zt[i]) <= TOL_E * max(1.0, abs(zj[i]))
        gj = np.asarray(next(iter(slj[i])).get_vector())
        gt = next(iter(slt[i])).get_vector().numpy()
        if len(slj[i]) == 1:
            assert abs(abs(np.vdot(gj, gt)) - 1.0) <= TOL_E
        # degenerate levels (mirror sectors) may come in either order
        assert sorted(s.sector.index for s in slj[i]) == \
            sorted(s.sector.index for s in slt[i])
        assert stj[i].lanc_nstates_total == stt[i].lanc_nstates_total
        assert stj[i].neigen_sector == stt[i].neigen_sector
        # the port's single-site sweep of the same site
        sl, z, _ = tdiag.diagonalize(tcfg, tb[i], hlocs[i],
                                     None if ref_states is None
                                     else ref_states[i],
                                     suffix=f"_ref{i:04d}", device="cpu")
        assert abs(sl.emin - slt[i].emin) <= TOL_E


@pytest.mark.parametrize("route", ["dense", "stacked"])
def test_diagonalize_sites_vs_jax(route, tmp_path, monkeypatch):
    """Small sectors through the batched eigh; above lanc_dim_threshold
    the three sites' operators through ONE stacked thick restart per
    sector (whatever lanc_method is, as in the JAX package)."""
    monkeypatch.chdir(tmp_path)
    if route == "dense":
        kw = dict(norb=1, nbath=3, nspin=1, uloc=(2.0,), beta=50.0,
                  lanc_dim_threshold=4096)
    else:
        kw = dict(norb=1, nbath=4, nspin=1, uloc=(1.8,), beta=50.0,
                  lanc_dim_threshold=24, lanc_method="lanczos")
    jcfg, tcfg, jb, tb, hlocs = _site_problem(kw, 3, 121)
    calls = []
    orig = tlanczos.eigs_lanczos_op_stacked

    def spy(spec, blocks, arrays_stacked, V0, *a, **k):
        calls.append(tuple(V0.shape))
        return orig(spec, blocks, arrays_stacked, V0, *a, **k)
    monkeypatch.setattr(tlanczos, "eigs_lanczos_op_stacked", spy)
    jres = jdiag.diagonalize_sites(jcfg, jb, hlocs)
    tres = tdiag.diagonalize_sites(tcfg, tb, hlocs, device="cpu")
    if route == "dense":
        assert not calls
    else:
        assert calls and all(c[0] == 3 for c in calls), calls
    _hold_sweeps(jres, tres, tcfg, tb, hlocs)
    assert (tmp_path / "eigenvalues_list_ineq0003.ed").exists()


def test_diagonalize_sites_twin_vs_jax(tmp_path, monkeypatch):
    """ed_twin: twin sectors are rebuilt, not solved; the spectra equal
    the JAX package's and the full sweep's."""
    monkeypatch.chdir(tmp_path)
    out = {}
    for tw in (False, True):
        kw = dict(norb=1, nbath=3, nspin=1, uloc=(2.0,), beta=50.0,
                  ed_twin=tw, lanc_dim_threshold=4096)
        jcfg, tcfg, jb, tb, hlocs = _site_problem(kw, 2, 121)
        for x in jb + tb:
            x.e[:] = np.array([-0.8, 0.0, 0.8])[None, None, :]
        tres = tdiag.diagonalize_sites(tcfg, tb, hlocs, device="cpu")
        if tw:
            _hold_sweeps(jdiag.diagonalize_sites(jcfg, jb, hlocs), tres,
                         tcfg, tb, hlocs)
        out[tw] = tres
    for i in range(2):
        assert abs(out[True][0][i].emin - out[False][0][i].emin) <= TOL_E
        assert sorted(s.sector.index for s in out[True][0][i]) == \
            sorted(s.sector.index for s in out[False][0][i])


def test_diagonalize_sites_finite_t_vs_jax(tmp_path, monkeypatch):
    """Finite T over two DMFT iterations carrying the DiagState: the full
    per-site post-diag (trimming, neigen feedback, lanc_nstates_total
    tuning) as in the JAX package and the single-site sweep."""
    monkeypatch.chdir(tmp_path)
    kw = dict(norb=1, nbath=3, nspin=1, uloc=(2.0,), beta=5.0,
              lanc_nstates_total=12, lanc_nstates_sector=4, cutoff=1e-6,
              lanc_dim_threshold=10 ** 9)
    jcfg, tcfg, jb, tb, hlocs = _site_problem(kw, 2, 42)
    sj = st = [None, None]
    for _ in range(2):
        jres = jdiag.diagonalize_sites(jcfg, jb, hlocs, states=sj)
        tres = tdiag.diagonalize_sites(tcfg, tb, hlocs, states=st,
                                       device="cpu")
        sj, st = jres[2], tres[2]
    assert len(tres[0][0]) > 1
    assert (tmp_path / "histogram_states_ineq0001.ed").exists()
    ref = [None, None]
    for i in range(2):
        ref[i] = tdiag.diagonalize(tcfg, tb[i], hlocs[i], None,
                                   suffix=f"_ref{i:04d}", device="cpu")[2]
    _hold_sweeps(jres, tres, tcfg, tb, hlocs, ref_states=ref)


def test_diagonalize_sites_cfgs_and_masks_vs_jax(tmp_path, monkeypatch):
    """Per-site configs (U per site) on the stacked route, and a
    sectors_list restart that restricts one site's sweep (ed_sectors,
    suffix _ineq0002)."""
    monkeypatch.chdir(tmp_path)
    kw = dict(norb=1, nbath=4, nspin=1, uloc=(1.8,), beta=50.0,
              lanc_dim_threshold=24, ed_sectors=True, ed_sectors_shift=1)
    jcfg, tcfg, jb, tb, hlocs = _site_problem(kw, 3, 7)
    with open("sectors_list_ineq0002.restart", "w") as fh:
        fh.write("3 2\n")
    us = (1.2, 1.8, 2.6)
    jc = [jcfg.replace(uloc=(u,)) for u in us]
    tc = [tcfg.replace(uloc=(u,)) for u in us]
    (slj, zj, _), (slt, zt, _) = (
        jdiag.diagonalize_sites(jcfg, jb, hlocs, cfgs=jc),
        tdiag.diagonalize_sites(tcfg, tb, hlocs, cfgs=tc, device="cpu"))
    for i in range(3):
        np.testing.assert_allclose([s.energy for s in slt[i]],
                                   [s.energy for s in slj[i]], atol=TOL_E)
        assert sorted(s.sector.qn for s in slt[i]) == \
            sorted(s.sector.qn for s in slj[i])
    assert {s.sector.qn[1:] for s in slt[1]} <= {
        (3, 2), (4, 2), (2, 2), (3, 3), (3, 1)}


def _lattice_pair(kw, hloc_ineq, seed):
    """(jax LatticeEDSolver, port LatticeEDSolver, perturbed bath stack)."""
    jcfg = jconfig.EDConfig(**kw).validate()
    tcfg = tconfig.EDConfig(**kw).validate()
    js = jls.LatticeEDSolver(jcfg, hloc_ineq, log=lambda m: None)
    ts = tls.LatticeEDSolver(tcfg, hloc_ineq, log=lambda m: None,
                             device="cpu")
    baths = js.init_solvers()
    np.testing.assert_array_equal(baths, ts.init_solvers())
    rng = np.random.default_rng(seed)
    baths = baths + 0.05 * rng.normal(size=baths.shape)
    return js, ts, baths


_GF_CASES = {
    "normal": (dict(norb=1, nbath=3, nspin=1, uloc=(1.5,), beta=60.0,
                    lmats=60, lreal=20, lanc_dim_threshold=4096), 3, 7),
    "superc": (dict(norb=1, nbath=3, nspin=1, uloc=(-1.5,), beta=60.0,
                    ed_mode="superc", lmats=40, lreal=16,
                    lanc_dim_threshold=4096), 2, 8),
    # GF chains shorter than the sectors (up to 70): at a sector's full
    # dim plain Lanczos makes ghost poles that move the real axis
    # (ROADMAP.md §3)
    # complex operators (an imaginary spin flip in Hloc): sectors above 40
    # through the stacked restart with complex start vectors
    "nonsu2": (dict(norb=1, nbath=3, nspin=2, uloc=(1.5,), beta=60.0,
                    ed_mode="nonsu2", lmats=40, lreal=16, lanc_ngfiter=24,
                    lanc_dim_threshold=40), 2, 9),
}


@pytest.mark.parametrize("mode,ragged", [("normal", "0"), ("normal", "1"),
                                         ("superc", "0"), ("nonsu2", "0")])
def test_cross_site_gf_vs_jax(mode, ragged, tmp_path, monkeypatch,
                              _jax_nonsu2_plan_mended):
    """LatticeEDSolver.solve(batched=True): one ResolventBatch over every
    site's chains (the concat engine per site and the ragged merge with
    DMFT_ED_RAGGED=1, the stacked operator axis otherwise) against the
    JAX package's cross-site pass and the port's per-site solves."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DMFT_ED_RAGGED", ragged)
    kw, nsites, seed = _GF_CASES[mode]
    kw = dict(kw, ed_print_sigma=False, ed_print_g=False, ed_print_g0=False)
    rng = np.random.default_rng(seed)
    ns = kw["nspin"]
    hloc_ineq = np.zeros((nsites, ns, ns, 1, 1), dtype=complex)
    for i in range(nsites):
        if mode == "nonsu2":
            hloc_ineq[i, 0, 1, 0, 0] = 0.15j + 0.05 * i
            hloc_ineq[i, 1, 0, 0, 0] = -0.15j + 0.05 * i
        else:
            hloc_ineq[i, 0, 0, 0, 0] = rng.normal() * 0.3
    js, ts, baths = _lattice_pair(kw, hloc_ineq, seed)
    stacked = []
    orig = tlanczos.lanczos_tridiag_op_stacked

    def spy(spec, blocks, arrays_stacked, V0, niter):
        stacked.append(V0.shape[0])
        return orig(spec, blocks, arrays_stacked, V0, niter)
    monkeypatch.setattr(tlanczos, "lanczos_tridiag_op_stacked", spy)
    rj = js.solve(baths, batched=True)
    restarts = []
    orig_r = tlanczos.eigs_lanczos_op_stacked

    def spy_r(spec, blocks, arrays_stacked, V0, *a, **k):
        restarts.append((V0.shape[0], V0.dtype))
        return orig_r(spec, blocks, arrays_stacked, V0, *a, **k)
    monkeypatch.setattr(tlanczos, "eigs_lanczos_op_stacked", spy_r)
    rt = ts.solve(baths, batched=True)
    if ragged == "0":
        assert max(stacked) >= 2      # sectors of several sites stacked
    if mode == "nonsu2":
        assert restarts and all(r == (2, torch.complex128)
                                for r in restarts), restarts
    monkeypatch.setattr(tlanczos, "lanczos_tridiag_op_stacked", orig)
    os.mkdir("per_site")
    os.chdir("per_site")
    rp = ts.solve(baths, batched=False)
    fields = ["gmats", "smats", "greal", "sreal"]
    if mode == "superc":
        fields += ["fmats", "smats_an", "freal", "sreal_an"]
    for i in range(nsites):
        assert abs(rj[i].egs - rt[i].egs) <= TOL_E
        for f in fields:
            tol = TOL_GR if "real" in f else TOL_G
            assert _rel(getattr(rp[i], f), getattr(rt[i], f)) <= tol, (i, f)
            if mode == "nonsu2" and "real" in f:
                # an off-diagonal component of the port comes from the
                # (a, s) + i (b, s') chains, the JAX package's transposed
                # one from (b, s') + i (a, s): truncated chains from other
                # vectors differ near the real axis
                # (tests/test_torch_nonsu2.py); the diagonal is held
                if f == "greal":
                    for sp in range(2):
                        assert _rel(rj[i].greal[sp, sp],
                                    rt[i].greal[sp, sp]) <= tol, (i, sp)
                continue
            assert _rel(getattr(rj[i], f), getattr(rt[i], f)) <= tol, (i, f)
        np.testing.assert_allclose(rt[i].observables.docc,
                                   rj[i].observables.docc, atol=TOL_E)
    np.testing.assert_allclose(ts.get_sigma_matsubara(),
                               np.stack([r.smats for r in rt]))


def test_cross_site_chi_vs_jax(tmp_path, monkeypatch):
    """The cross-site chi pass (spin, dens, dens_mix, pair; one batch of
    site-tagged probe channels) against the JAX package's and the port's
    per-site chi."""
    monkeypatch.chdir(tmp_path)
    kw = dict(norb=2, nbath=2, nspin=1, uloc=(1.5, 1.2), ust=0.6,
              beta=40.0, lmats=16, lreal=8, ltau=20, chispin_flag=True,
              chidens_flag=True, chipair_flag=True, lanc_dim_threshold=4096,
              ed_print_sigma=False, ed_print_g=False, ed_print_g0=False)
    rng = np.random.default_rng(17)
    hloc_ineq = np.zeros((2, 1, 1, 2, 2))
    for i in range(2):
        hloc_ineq[i, 0, 0] = np.diag(rng.normal(size=2) * 0.3)
    js, ts, baths = _lattice_pair(kw, hloc_ineq, 17)
    rj = js.solve(baths, batched=True)
    rt = ts.solve(baths, batched=True)
    os.mkdir("per_site")
    os.chdir("per_site")
    rp = ts.solve(baths, batched=False)
    for i in range(2):
        for f in ("chi_spin", "chi_dens", "chi_dens_mix", "chi_pair"):
            for a, b, c in zip(getattr(rj[i], f), getattr(rt[i], f),
                               getattr(rp[i], f)):
                assert _rel(a, b) <= TOL_G, (i, f)
                assert _rel(c, b) <= TOL_G, (i, f)


def test_resolvent_batch_site_axis(monkeypatch):
    """Channels of the same sector on two sites run as ONE stacked call
    with both operators on the member axis; site 0 of a multi-site batch
    gives what the single-site batch gives, bitwise."""
    kw = dict(norb=1, nbath=4, nspin=1, uloc=(2.0,))
    _, tcfg, _, tb, hlocs = _site_problem(kw, 2, 5)
    from dmft_ed_tpu_torch.sectors import sector_table
    sec = sector_table(tcfg).get(2, 3)
    rng = np.random.default_rng(5)
    vecs = [rng.normal(size=sec.dim) for _ in range(2)]
    calls = []
    orig = tlanczos.lanczos_tridiag_op_stacked

    def spy(spec, blocks, arrays_stacked, V0, niter):
        calls.append(tuple(V0.shape))
        return orig(spec, blocks, arrays_stacked, V0, niter)
    monkeypatch.setattr(tlanczos, "lanczos_tridiag_op_stacked", spy)
    monkeypatch.setenv("DMFT_ED_RAGGED", "0")
    batch = tgfc.ResolventBatch(tcfg)
    for i in range(2):
        batch.add_site(i, tgfc.HamCache(tcfg, tb[i], hlocs[i], "cpu"),
                       -1.0, 1.0, False)
        batch.add(sec, vecs[i], -1.0, {"site": i}, site=i)
    multi = {m["site"]: (w, p) for m, w, p in batch.run()}
    assert calls == [(2, 1, sec.dim)]
    single = tgfc.ResolventBatch(tcfg, tgfc.HamCache(tcfg, tb[0], hlocs[0],
                                                     "cpu"), -1.0, 1.0,
                                 False)
    single.add(sec, vecs[0], -1.0, {"site": 0})
    (_, w0, p0), = list(single.run())
    np.testing.assert_array_equal(w0, multi[0][0])
    np.testing.assert_array_equal(p0, multi[0][1])


def _fit_problem(tmp_path, mode="normal"):
    """A 2-site joint fit problem: both packages' solvers, a bath stack,
    and as targets that stack's own G0 (and F0 in superc) — the exact
    answer of the fit."""
    if mode == "superc":
        kw = dict(norb=1, nbath=3, nspin=1, uloc=(-1.5,), beta=40.0,
                  ed_mode="superc", lmats=80, lreal=8, lfit=80)
    else:
        kw = dict(norb=1, nbath=3, nspin=1, uloc=(2.0,), beta=50.0,
                  lmats=100, lreal=8)
    hloc_ineq = np.zeros((2, 1, 1, 1, 1))
    hloc_ineq[1, 0, 0, 0, 0] = 0.2
    js, ts, baths = _lattice_pair(kw, hloc_ineq, 31)
    res = ts.solve(baths)
    fgs = np.stack([r.g0mats for r in res])
    fan = np.stack([r.f0mats for r in res]) if mode == "superc" else None
    return js, ts, baths, fgs, fan


@pytest.mark.parametrize("mode", ["normal", "superc"])
def test_chi2_fitgf_sites_vs_jax(mode, tmp_path, monkeypatch):
    """One L-BFGS-B iteration of the joint fit equals the JAX package's
    (1e-12; with the normal mode's Δ pre-conditioning pass before it,
    1e-9: measured 2.7e-10); the whole fit lands at the same chi^2 per
    site (see the module note on the flat valley) and writes one restart
    file per site."""
    monkeypatch.chdir(tmp_path)
    js, ts, baths, fgs, fan = _fit_problem(tmp_path, mode)
    b0 = baths + 0.1
    hl = [s.hloc for s in ts.solvers]
    ispin = 0 if mode == "superc" else None
    for pre, tol in ((False, 1e-12), (True, 1e-9)):
        if pre and mode == "superc":
            continue                   # superc fits never pre-condition
        one = [F.chi2_fitgf_sites(c.replace(cg_niter=1), fgs, b0, hl,
                                  ispin=ispin, fgs_an=fan, save=False,
                                  precondition=pre, **ex)
               for F, c, ex in ((jfit, js.cfg, {}),
                                (tfit, ts.cfg, {"device": "cpu"}))]
        assert np.max(np.abs(one[0] - one[1])) <= tol
        assert np.max(np.abs(one[1] - b0)) > 1e-6
    logs = {"jax": [], "torch": []}
    bj = jfit.chi2_fitgf_sites(js.cfg, fgs, b0, hl, ispin=ispin, fgs_an=fan,
                               log=logs["jax"].append, save=False)
    bt = tfit.chi2_fitgf_sites(ts.cfg, fgs, b0, hl, ispin=ispin, fgs_an=fan,
                               log=logs["torch"].append, device="cpu")
    chi = {k: [float(m.split("=")[1].split("|")[0]) for m in v]
           for k, v in logs.items()}
    assert len(chi["torch"]) == 2          # no site fell back
    for a, b in zip(chi["jax"], chi["torch"]):
        assert abs(a - b) <= 1e-3 * a + 1e-14
    assert np.max(np.abs(bj - bt)) <= 1e-2
    for i in range(2):
        assert (tmp_path / f"{ts.cfg.hfile}_ineq{i + 1:04d}.restart").exists()


def test_chi2_fitgf_sites_structure_errors(tmp_path, monkeypatch):
    """Unequal bath packs or replica masks across sites raise (the joint
    objective injects every site through site 0's layout)."""
    monkeypatch.chdir(tmp_path)
    kw = dict(norb=1, nbath=3, nspin=1, uloc=(2.0,), beta=50.0, lmats=40)
    c3 = tconfig.EDConfig(**kw).validate()
    c4 = c3.replace(nbath=4)
    fgs = np.ones((2, 1, 1, 1, 1, 40), dtype=complex) / 1j
    hl = [np.zeros((1, 1, 1, 1))] * 2
    b3 = tbath.pack_bath(tbath.init_bath(c3))
    b4 = tbath.pack_bath(tbath.init_bath(c4))
    with pytest.raises(ValueError, match="pack size"):
        tfit.chi2_fitgf_sites(c3, fgs, [b3, b4], hl, cfgs=[c3, c4],
                              device="cpu")
    kr = dict(norb=2, nspin=1, nbath=2, bath_type="replica", uloc=(2.0, 2.0),
              lmats=40)
    cr = tconfig.EDConfig(**kr).validate()
    h0 = np.zeros((1, 1, 2, 2))
    h1 = h0.copy()
    h1[0, 0, 0, 1] = h1[0, 0, 1, 0] = 0.3
    m0, m1 = tbath.replica_mask(cr, h0), tbath.replica_mask(cr, h1)
    f0 = tbath.Bath(cr)
    f0.mask = m0
    f1 = tbath.Bath(cr)
    f1.mask = m1
    with pytest.raises(ValueError, match="mask|pack size"):
        tfit.chi2_fitgf_sites(cr, np.ones((2, 1, 1, 2, 2, 40), complex),
                              [tbath.pack_bath(f0), tbath.pack_bath(f1)],
                              [h0, h1], masks=[m0, m1], device="cpu")


def test_chi2_fitgf_sites_backstop(tmp_path, monkeypatch):
    """A site whose joint fit clearly fails (a target no bath can fit)
    falls back to the single-site fit; the other site, which starts at
    its exact bath, does not — the JAX package makes the same calls."""
    monkeypatch.chdir(tmp_path)
    js, ts, b0, fgs, _ = _fit_problem(tmp_path)
    rng = np.random.default_rng(3)
    fgs = fgs.copy()
    fgs[1] = rng.normal(size=fgs[1].shape) + 1j * rng.normal(
        size=fgs[1].shape)
    hl = [s.hloc for s in ts.solvers]
    seen = {}
    for name, F, c, ex in (("jax", jfit, js.cfg, {}),
                           ("torch", tfit, ts.cfg, {"device": "cpu"})):
        calls = []
        orig = F.chi2_fitgf

        def spy(cfg, fg, *a, _o=orig, _c=calls, **k):
            _c.append(k.get("suffix"))
            return _o(cfg.replace(cg_niter=5), fg, *a, **k)
        monkeypatch.setattr(F, "chi2_fitgf", spy)
        F.chi2_fitgf_sites(c, fgs, b0, hl, save=False, **ex)
        seen[name] = calls
    assert seen["torch"] == seen["jax"] == ["_ineq0002"]


@pytest.mark.gpu
def test_stacked_restart_kernel_on_card(tmp_path, monkeypatch):
    """The digit matmul inside a 2-site stacked thick restart under
    ozaki5x7 (run there with ``python -m pytest -m gpu
    tests/test_torch_sites.py``): every kernel call bitwise against its
    plain version on the same operands, and the sweep within 1e-12 of the
    same sweep on the CPU (where the wrapper takes the plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from dmft_ed_tpu_torch import ozaki as tozaki
    from dmft_ed_tpu_torch.kernels import digit_matmul, digit_matmul_plain
    monkeypatch.chdir(tmp_path)
    kw = dict(norb=1, nbath=5, nspin=1, uloc=(2.0,), beta=50.0,
              lanc_dim_threshold=64, matmul_precision="ozaki5x7")
    _, tcfg, _, tb, hlocs = _site_problem(kw, 2, 11)
    checked = []

    def held(*a, **k):
        out = digit_matmul(*a, **k)
        if out.is_cuda:
            assert torch.equal(out, digit_matmul_plain(*a, **k))
            checked.append(tuple(out.shape))
        return out
    monkeypatch.setattr(tozaki, "digit_matmul", held)
    n0 = digit_matmul.launches
    slc, _, _ = tdiag.diagonalize_sites(tcfg, tb, hlocs, device="cuda")
    torch.cuda.synchronize()
    assert digit_matmul.launches - n0 == len(checked) > 0
    sl0, _, _ = tdiag.diagonalize_sites(tcfg, tb, hlocs, device="cpu")
    for i in range(2):
        assert abs(slc[i].emin - sl0[i].emin) <= 1e-12
