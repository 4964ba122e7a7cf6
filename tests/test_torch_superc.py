"""Superconducting mode (``ed_mode="superc"``) of the PyTorch port against
the JAX package on the CPU: the Nambu bath functions, the multi-block
sector operator with its pairing mix terms, the sector sweep, the Green's
functions G, F with Σ, Σᴬ, phi and chi_pair. Inputs come from numpy seeds
and go through both packages; every Krylov route is the same in both
(superc sectors are multi-block with mix terms: the serial restart or
plain Lanczos in the sweep, the stacked route in the GF).

Bounds, measured on these configs (Nbath=2-3, Norb=1 and 2):

* bath functions Δ, FΔ, G0^-1, G0, F0 on both axes, normal and hybrid
  (Norb=2) baths: 1e-13 of max|f| (measured 5.0e-15);
* ``apply_op`` of the Sz=0 and Sz=-1 sectors (5 and 4 blocks at Nbath=3,
  4 and 3 at Nbath=2; Nbath pairing mix terms per adjacent block pair
  and direction, one signed-gather ``pmix`` entry per pair under
  ``native``):
  1e-12 of max|Hv| under ``native`` (measured 2.2e-16, and against the
  dense H) and ``ozaki5x7`` against the JAX package's ``ozaki5x7``
  (measured bitwise);
* eigenvalues of the sweep (arpack and lanczos, T=0 and finite T,
  ``ed_twin`` on and off): 1e-10 against the JAX package (measured
  1.1e-15) and against the dense spectrum of ``tests/reference_ed.py``'s
  Fock-space H (measured 2.4e-15); the kept states as the projector of
  each sector, 1e-8 (measured 8.6e-11, plain Lanczos at finite T; 2.1e-15
  elsewhere);
* G, F, Σ, Σᴬ on the Matsubara axis: 1e-10 of max|f| (measured 1.3e-13);
  on the real axis, eps off the poles, 1e-6 of max|f| (measured 2.1e-12
  with a normal bath, 2.9e-8 with the hybrid Norb=2 bath, whose GF
  chains the two packages sum in another order); G0, F0 1e-13 (measured
  6.1e-14); phi, docc, dens 1e-10 (measured 8.0e-15);
* U = 0: G and F equal the port's BdG G0, F0 within 1e-7, Σ and Σᴬ
  vanish within 1e-6 (the tests/test_gf_superc.py bounds);
* chi_pair: 1e-10 of max|chi| in τ, iν and ω (measured 8.6e-14).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dmft_ed_tpu.bath as jbath
import dmft_ed_tpu.bath_fns as jfns
import dmft_ed_tpu.config as jconfig
import dmft_ed_tpu.diag as jdiag
import dmft_ed_tpu.grids as jgrids
import dmft_ed_tpu.hamiltonian as jham
import dmft_ed_tpu.sectors as jsectors
import dmft_ed_tpu.solver as jsolver
import dmft_ed_tpu_torch.bath as tbath
import dmft_ed_tpu_torch.bath_fns as tfns
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.diag as tdiag
import dmft_ed_tpu_torch.gf_common as tgfc
import dmft_ed_tpu_torch.hamiltonian as tham
import dmft_ed_tpu_torch.lanczos as tlanczos
import dmft_ed_tpu_torch.sectors as tsectors
import dmft_ed_tpu_torch.solver as tsolver
import reference_ed as ref


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_arpack.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dev(x, y, scale=1.0):
    """max|x - y| / scale."""
    return float(np.max(np.abs(np.asarray(x) - np.asarray(y)))) / scale


def _cfgs(**kw):
    base = dict(norb=1, nbath=3, nspin=1, ed_mode="superc", uloc=(-1.5,),
                beta=40.0, lmats=40, lreal=20, deltasc=0.3, xmu=0.2,
                lanc_dim_threshold=10, ed_verbose=0)
    base.update(kw)
    return (jconfig.EDConfig(**base).validate(),
            tconfig.EDConfig(**base).validate())


def _baths(jcfg, tcfg, seed):
    rng = np.random.default_rng(seed)
    jb, tb = jbath.Bath(jcfg), tbath.Bath(tcfg)
    jb.e[:] = rng.uniform(-1.0, 1.0, jb.e.shape)
    jb.v[:] = rng.uniform(0.3, 0.7, jb.v.shape)
    jb.d[:] = rng.uniform(0.1, 0.4, jb.d.shape)
    tb.e[:], tb.v[:], tb.d[:] = jb.e, jb.v, jb.d
    return jb, tb


@pytest.mark.parametrize("bath_type", ["normal", "hybrid"])
def test_bath_functions_superc_vs_jax(bath_type):
    """Δ, FΔ, G0^-1, G0 and F0 of the Nambu bath (torch, differentiable
    for the fit) against the JAX bath_fns on both axes."""
    norb = 2 if bath_type == "hybrid" else 1
    jcfg, tcfg = _cfgs(norb=norb, uloc=(-1.5,) * norb, lmats=64,
                       bath_type=bath_type)
    jb, tb = _baths(jcfg, tcfg, 8)
    rng = np.random.default_rng(9)
    hloc = np.zeros((1, 1, norb, norb))
    hloc[0, 0] = np.diag(rng.uniform(-0.2, 0.2, norb))
    if norb > 1:
        hloc[0, 0, 0, 1] = hloc[0, 0, 1, 0] = 0.05
    pj, pt = jfns.bath_params(jb), tfns.bath_params(tb, "cpu")
    for axis, x in (("mats", jgrids.z_mats(jcfg)),
                    ("real", jgrids.z_real(jcfg))):
        xt = torch.as_tensor(x)
        for fn in ("delta", "fdelta", "invg0", "g0and", "f0and"):
            args = () if fn in ("delta", "fdelta") else (hloc,)
            a = np.asarray(getattr(jfns, fn)(jcfg, jnp.asarray(x), pj, *args,
                                             axis=axis))
            b = getattr(tfns, fn)(tcfg, xt, pt, *args, axis=axis).numpy()
            assert a.shape == b.shape
            assert np.max(np.abs(a)) > 0, (fn, axis)
            assert _dev(a, b, np.max(np.abs(a))) <= 1e-13, (fn, axis)


def test_bath_functions_nonsu2_still_raise():
    """nonsu2 no longer raises (ported since; its parity with the JAX
    package is tests/test_torch_nonsu2.py's): Δ of an initial nonsu2 bath
    is finite and carries the spin off-diagonal from u."""
    cfg = tconfig.EDConfig(norb=1, nbath=2, nspin=2,
                           ed_mode="nonsu2").validate()
    b = tbath.Bath(cfg)
    b.e[:] = [[[-0.5, 0.5]]] * 2
    b.v[:] = 0.4
    b.u[:] = 0.1
    d = tfns.delta(cfg, 1j * torch.arange(1.0, 5.0, dtype=torch.float64),
                   tfns.bath_params(b, "cpu"))
    assert d.shape == (2, 2, 1, 1, 4)
    assert torch.all(torch.isfinite(d))
    assert torch.max(torch.abs(d[0, 1])) > 0


@pytest.mark.parametrize("prec", ["native", "ozaki5x7"])
def test_apply_op_superc_vs_jax(prec):
    """The multi-block superc operator with its pairing mix terms."""
    # the JAX package compiles its Ozaki products per shape: Nbath=2 there
    jcfg, tcfg = _cfgs(matmul_precision=prec,
                       nbath=3 if prec == "native" else 2)
    jb, tb = _baths(jcfg, tcfg, 3)
    hloc = np.zeros((1, 1, 1, 1))
    rng = np.random.default_rng(4)
    for sz in (0, -1):
        js = jsectors.sector_table(jcfg).get(sz)
        ts = tsectors.sector_table(tcfg).get(sz)
        hj = jham.build_sector_hamiltonian(jcfg, js, jb, hloc)
        ht = tham.build_sector_hamiltonian(tcfg, ts, tb, hloc)
        assert len(ts.blocks) > 1 and len(ht.mix) >= 2 * jcfg.nbath
        sj, aj, _ = jham.make_matvec_op(hj, jcfg)
        st, at, bt = tham.make_matvec_op(ht, tcfg, "cpu")
        kinds = {p.kind for m in tham.mix_entries(st)
                 for p in ((m.up, m.dw) if m.kind == "chain" else (m,))
                 if p is not None}
        # native: the Nbath pairing terms of each block pair in one
        # signed-gather entry; ozaki5x7: one Ozaki product per spin part
        assert kinds == ({"ozr", "ozl"} if prec != "native" else {"pmix"})
        assert len(tham.mix_entries(st)) == (len(ht.mix) if prec != "native"
                              else len(ht.mix) // jcfg.nbath)
        H = tham.assemble_dense(ht)
        for xi in rng.normal(size=(3, ts.dim)):
            yj = np.asarray(jham.flatten_blocks(jham.apply_op(
                sj, aj, jham.unflatten_blocks(jnp.asarray(xi), js))))
            yt = tham.flatten_blocks(tham.apply_op(
                st, at, tham.unflatten_blocks(torch.from_numpy(xi),
                                              bt))).numpy()
            scale = np.max(np.abs(yj))
            assert _dev(yj, yt, scale) <= 1e-12
            if prec == "native":
                assert _dev(H @ xi, yt, scale) <= 1e-12


def _oracle_sector_evals(cfg, bath, sz):
    """Dense spectrum of one superc sector from the Fock-space H of
    tests/reference_ed.py."""
    from dmft_ed_tpu.hamiltonian import single_particle_parts
    Tuu, Tdd, Tud, P = single_particle_parts(cfg, bath,
                                             np.zeros((1, 1, 1, 1)))
    states = ref.sector_states_superc(cfg.ns, sz)
    H = ref.build_full_H(cfg.ns, cfg.norb, Tuu, Tdd, Tud, P,
                         np.asarray(cfg.uloc), cfg.ust, cfg.jh, cfg.jx,
                         cfg.jp, cfg.hfmode, states)
    return np.linalg.eigvalsh(H)


def _projectors(slist):
    out = {}
    for s in slist:
        v = np.asarray(s.get_vector()).reshape(-1)
        out.setdefault(s.sector.index, []).append(v)
    return {k: np.array(v).T @ np.array(v).conj() for k, v in out.items()}


@pytest.mark.parametrize("method,ntot,twin", [
    ("arpack", 1, False), ("arpack", 6, True),
    ("lanczos", 1, True), ("lanczos", 6, False)],
    ids=["arpack-T0", "arpack-finiteT-twin", "lanczos-T0-twin",
         "lanczos-finiteT"])
def test_diagonalize_superc_vs_jax_and_oracle(method, ntot, twin):
    """The superc sector sweep: every Krylov sector takes the serial
    route (struct_mix), thick restart or plain Lanczos."""
    jcfg, tcfg = _cfgs(lanc_method=method, lanc_nstates_total=ntot,
                       ed_twin=twin, beta=10.0)
    jb, tb = _baths(jcfg, tcfg, 5)
    hloc = np.zeros((1, 1, 1, 1))
    sj, zj, stj = jdiag.diagonalize(jcfg, jb, hloc)
    st, zt, stt = tdiag.diagonalize(tcfg, tb, hloc, device="cpu")
    assert len(sj) == len(st) == ntot
    assert sorted(s.sector.index for s in sj) == \
        sorted(s.sector.index for s in st)
    ej = np.array([s.energy for s in sj])
    et = np.array([s.energy for s in st])
    assert _dev(ej, et) <= 1e-10
    assert abs(zj - zt) <= 1e-10 * zj
    assert stj.neigen_sector == stt.neigen_sector
    assert stj.lanc_nstates_total == stt.lanc_nstates_total
    # each kept energy is an eigenvalue of its sector's Fock-space H
    for s in st:
        exact = _oracle_sector_evals(jcfg, jb, s.sector.qn[1])
        assert np.min(np.abs(exact - s.energy)) <= 1e-10
    egs = min(_oracle_sector_evals(jcfg, jb, sz)[0]
              for sz in range(-jcfg.ns, jcfg.ns + 1))
    assert abs(st.emin - egs) <= 1e-10
    pj, pt = _projectors(sj), _projectors(st)
    assert pj.keys() == pt.keys()
    for k in pj:
        assert _dev(pj[k], pt[k]) <= 1e-8, k


def _solve_both(tmp_path, bath_type="normal", norb=1, **kw):
    res = {}
    for name, C, S, B, extra in (
            ("jax", jconfig, jsolver, jbath, {}),
            ("torch", tconfig, tsolver, tbath, {"device": "cpu"})):
        base = dict(norb=norb, nbath=3 if norb == 1 else 2, nspin=1,
                    ed_mode="superc", uloc=(-1.5,) * norb, beta=40.0,
                    lmats=40, lreal=20, deltasc=0.3, xmu=0.2,
                    lanc_dim_threshold=10, ed_verbose=0,
                    bath_type=bath_type)
        base.update(kw)
        cfg = C.EDConfig(**base).validate()
        b = B.Bath(cfg)
        rng = np.random.default_rng(32)
        b.e[:] = rng.uniform(-0.9, 0.9, b.e.shape)
        b.v[:] = rng.uniform(0.4, 0.7, b.v.shape)
        b.d[:] = rng.uniform(0.2, 0.4, b.d.shape)
        hloc = np.zeros((1, 1, norb, norb))
        if norb > 1:
            hloc[0, 0] = [[0.1, 0.05], [0.05, -0.1]]
        s = S.EDSolver(cfg, hloc, log=lambda m: None, **extra)
        d = tmp_path / name
        d.mkdir()
        os.chdir(d)
        res[name] = (s.solve(B.pack_bath(b)), b, hloc, s)
    os.chdir(tmp_path)
    return res


@pytest.mark.parametrize("bath_type,method", [("normal", "arpack"),
                                              ("normal", "lanczos"),
                                              ("hybrid", "arpack")])
def test_gf_sigma_superc_vs_jax(bath_type, method, tmp_path):
    """G, F, Σ, Σᴬ (and G0, F0) of one fixed-bath solve on both axes; the
    hybrid Norb=2 bath adds the mixed-orbital channels and the block
    Nambu inversion."""
    norb = 2 if bath_type == "hybrid" else 1
    res = _solve_both(tmp_path, bath_type, norb, lanc_method=method)
    (a, _, _, _), (t, _, _, ts) = res["jax"], res["torch"]
    assert abs(a.egs - t.egs) <= 1e-10
    for f in ("dens", "docc", "phisc"):
        assert _dev(getattr(a.observables, f),
                    getattr(t.observables, f)) <= 1e-10, f
    assert np.max(np.abs(t.observables.phisc)) > 0.01
    for f, tol in (("gmats", 1e-10), ("fmats", 1e-10), ("smats", 1e-10),
                   ("smats_an", 1e-10), ("g0mats", 1e-13),
                   ("f0mats", 1e-13), ("greal", 1e-6), ("freal", 1e-6),
                   ("sreal", 1e-6), ("sreal_an", 1e-6), ("g0real", 1e-13),
                   ("f0real", 1e-13)):
        x, y = getattr(a, f), getattr(t, f)
        assert x.shape == y.shape, f
        assert _dev(x, y, np.max(np.abs(x))) <= tol, f
    assert ts.get_self_matsubara() is t.smats_an
    assert ts.get_phisc() is t.observables.phisc
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "torch"))


def test_superc_u0_matches_bdg(tmp_path):
    """Free system: the Krylov G, F equal the port's analytic BdG G0, F0,
    and the Nambu Dyson gives Σ = Σᴬ = 0."""
    res = _solve_both(tmp_path, uloc=(0.0,), lanc_ngfiter=200)
    t, tb, hloc, _ = res["torch"]
    cfg = tconfig.EDConfig(norb=1, nbath=3, nspin=1, ed_mode="superc",
                           uloc=(0.0,), beta=40.0, lmats=40, lreal=20,
                           deltasc=0.3, xmu=0.2).validate()
    zm = torch.as_tensor(jgrids.z_mats(cfg))
    p = tfns.bath_params(tb, "cpu")
    g0 = tfns.g0and(cfg, zm, p, hloc).numpy()
    f0 = tfns.f0and(cfg, zm, p, hloc).numpy()
    np.testing.assert_allclose(t.gmats[0, 0, 0, 0], g0[0, 0, 0, 0],
                               atol=1e-7)
    np.testing.assert_allclose(t.fmats[0, 0, 0, 0], f0[0, 0, 0, 0],
                               atol=1e-7)
    assert np.max(np.abs(t.smats)) < 1e-6
    assert np.max(np.abs(t.smats_an)) < 1e-6


def test_gf_superc_stacked_route(tmp_path, monkeypatch):
    """At T=0 the three channels of each target sector (G, Ḡ, A) share
    one stacked chain, padded from 3 to 4 members; the padded member's
    result is dropped (6 channels in, 6 results out)."""
    jcfg, tcfg = _cfgs(lanc_method="lanczos")
    _, tb = _baths(jcfg, tcfg, 5)
    hloc = np.zeros((1, 1, 1, 1))
    slist, zeta, _ = tdiag.diagonalize(tcfg, tb, hloc, device="cpu")
    shapes = []
    stacked = tlanczos.lanczos_tridiag_op_stacked
    monkeypatch.setattr(tlanczos, "lanczos_tridiag_op_stacked",
                        lambda sp, bl, ar, V0, n: shapes.append(
                            tuple(V0.shape)) or stacked(sp, bl, ar, V0, n))
    from dmft_ed_tpu_torch.gf_superc import gf_superc_plan
    batch = tgfc.ResolventBatch(tcfg, tgfc.HamCache(tcfg, tb, hloc, "cpu"),
                                slist.emin, zeta, False)
    gf_superc_plan(tcfg, slist, batch)
    out = list(batch.run())
    assert len(slist) == 1
    assert len(out) == 6
    assert sorted(s[1] for s in shapes) == [4, 4]


def test_chi_pair_superc_vs_jax(tmp_path):
    """chi_pair in superc (chi.py has no mode branch) against JAX."""
    res = _solve_both(tmp_path, chipair_flag=True, lanc_method="lanczos")
    (a, *_), (t, *_) = res["jax"], res["torch"]
    for x, y in zip(a.chi_pair, t.chi_pair):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        assert _dev(x, y, np.max(np.abs(x))) <= 1e-10


def test_solver_refuses_only_nonsu2():
    """The solver takes every ed_mode now (nonsu2 was refused until it
    was ported); a device without a card still raises."""
    for mode, nspin in (("superc", 1), ("nonsu2", 2)):
        cfg = tconfig.EDConfig(norb=1, nbath=2, nspin=nspin,
                               ed_mode=mode).validate()
        s = tsolver.EDSolver(cfg, device="cpu")
        assert s.cfg.ed_mode == mode
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tsolver.EDSolver(cfg, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(210, 252, 252), (252, 252, 210)],
                         ids=["dw-rect", "up-rect"])
def test_kernel_superc_class_on_card(shape):
    """The CUDA kernel against its plain version at a superc pairing
    class of the Nbath=9 sector, C(10, n-1) x C(10, n) (run there with
    ``python -m pytest -m gpu tests/test_torch_superc.py``): bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from dmft_ed_tpu_torch import ozaki as tozaki
    from dmft_ed_tpu_torch.kernels import digit_matmul, digit_matmul_plain
    rng = np.random.default_rng(6)
    m, k, n = shape
    A = torch.from_numpy(rng.normal(size=(m, k))).cuda()
    B = torch.from_numpy(rng.normal(size=(k, n))).cuda()
    ad, sa = tozaki._left_digits(A, 5, 7)
    bd, sb = tozaki._right_digits(B, 5, 7)
    pairwise, kchunk = tozaki._schedule(k, 5, 7)
    n0 = digit_matmul.launches
    got = digit_matmul(ad, bd, sa.reshape(-1), sb.reshape(-1), 7, pairwise,
                       kchunk, k=k)
    ref_ = digit_matmul_plain(ad, bd, sa.reshape(-1), sb.reshape(-1), 7,
                              pairwise, kchunk, k=k)
    torch.cuda.synchronize()
    assert digit_matmul.launches == n0 + 1
    assert torch.equal(got, ref_)
