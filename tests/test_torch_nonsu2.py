"""Broken-SU(2) mode (``ed_mode="nonsu2"``) of the PyTorch port against
the JAX package on the CPU: the nonsu2 bath functions (normal bath with
the helicity W matrix, hybrid, replica), the multi-block sector operator
with its complex spin-flip mix terms, the sector sweep, G and Σ with every
spin off-diagonal, the observables, the nonsu2 fit, and an ``ozaki5x7``
solve. Inputs come from numpy seeds and go through both packages. (The Jz
basis and the replica fit are tests/test_torch_replica.py's.)

G convention: the port's G[s, s', a, b] is <<c_{a,s}; c†_{b,s'}>>, as G0
is; the JAX package's is its transpose (a fault of the JAX package,
ROADMAP.md §3), so G is held to the JAX package's G transposed, and Σ to
the JAX package's Dyson of that G.

Bounds, measured on these configs (Ns = 4: Norb=1 Nbath=3 normal, Norb=2
Nbath=2 hybrid, Norb=2 Nbath=1 replica):

* bath functions Δ, G0^-1, G0 on both axes: 1e-13 of max|f| (measured
  4.3e-17 to 7.0e-15);
* ``apply_op`` of multi-block N sectors (complex spin-flip mix terms in
  ``bmix`` entries): 1e-12 of max|Hv| against the JAX operator and the
  dense host H (measured 3.3e-16); the dense sector spectrum against the
  Fock-space H of ``tests/reference_ed.py``: 1e-10 (measured 9.8e-15);
* eigenvalues of the sweep, T=0 and finite T: 1e-10 against the JAX
  package and the oracle (measured 1.8e-15, 1.1e-14); projectors per
  sector 1e-8 (measured 2.3e-15);
* G, Σ on the Matsubara axis: 1e-9 of max|f| (measured 9.6e-14 and
  4.3e-13 at T=0, 3.0e-12 and 5.9e-11 at finite T); the diagonal G on
  the real axis, eps off the poles: 1e-6 (measured 1.0e-12 with 24-step
  chains); G0 1e-13 (measured 5.2e-15); observables (dens, docc, magx,
  magy, the excitonic order parameters, the density matrix) 1e-10
  (measured 6.2e-15); the printed Σ read back bitwise;
* G against a Lehmann sum over the full Fock space, every (s, s', a, b):
  1e-7 (measured 2.0e-14 at T=0, 4.5e-13 at finite T);
* U = 0: G equals the analytic G0 and Σ vanishes, 1e-10 (measured
  3.4e-14, 5.5e-14);
* one L-BFGS-B step of the nonsu2 fit: 1e-14 of the bath (measured
  2.2e-16 and 3.3e-16); the fit recovers Δ of a known bath within 1e-3
  (measured 5.3e-5);
* ``ozaki5x7``: nonsu2 operators are complex, so no Ozaki product runs
  (0 digit products counted) and the solve equals ``native`` bitwise.
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
import dmft_ed_tpu.fit as jfit
import dmft_ed_tpu.grids as jgrids
import dmft_ed_tpu.hamiltonian as jham
import dmft_ed_tpu.sectors as jsectors
import dmft_ed_tpu.solver as jsolver
import dmft_ed_tpu_torch.aux as taux
import dmft_ed_tpu_torch.bath as tbath
import dmft_ed_tpu_torch.bath_fns as tfns
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.diag as tdiag
import dmft_ed_tpu_torch.fit as tfit
import dmft_ed_tpu_torch.hamiltonian as tham
import dmft_ed_tpu_torch.ozaki as tozaki
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


def _kw(bath_type="normal", **kw):
    base = dict(norb=1, nbath=3, nspin=2, ed_mode="nonsu2", uloc=(1.4,),
                beta=40.0, lmats=40, lreal=20, xmu=0.15,
                lanc_dim_threshold=10, ed_verbose=0, bath_type=bath_type)
    if bath_type == "hybrid":
        base.update(norb=2, nbath=2, uloc=(1.4, 1.4), ust=0.7, jh=0.2)
    if bath_type == "replica":
        base.update(norb=2, nbath=1, uloc=(1.4, 1.4), ust=0.7)
    base.update(kw)
    return base


def _cfgs(bath_type="normal", **kw):
    k = _kw(bath_type, **kw)
    return (jconfig.EDConfig(**k).validate(),
            tconfig.EDConfig(**k).validate())


def _hloc(cfg, seed):
    """Complex local Hamiltonian with spin off-diagonals (Hermitian)."""
    rng = np.random.default_rng(seed)
    nso = 2 * cfg.norb
    a = rng.normal(size=(nso, nso)) + 1j * rng.normal(size=(nso, nso))
    h = 0.1 * (a + a.conj().T)
    return taux.so2nn(h, 2, cfg.norb)


def _baths(jcfg, tcfg, seed, hloc):
    """The same random bath for both packages."""
    rng = np.random.default_rng(seed)
    jb, tb = jbath.Bath(jcfg), tbath.Bath(tcfg)
    if jcfg.bath_type == "replica":
        mask = jbath.replica_mask(jcfg, hloc)
        jb.mask = tb.mask = mask
        nso = 2 * jcfg.norb
        for k in range(jcfg.nbath):
            a = rng.normal(size=(nso, nso)) + 1j * rng.normal(size=(nso, nso))
            h = taux.so2nn(0.3 * (a + a.conj().T), 2, jcfg.norb)
            jb.h[..., k] = h * (mask[..., 0] | mask[..., 1])
        jb.vr[:] = rng.uniform(0.4, 0.7, jb.vr.shape)
        tb.h[:], tb.vr[:] = jb.h, jb.vr
        return jb, tb
    jb.e[:] = rng.uniform(-1.0, 1.0, jb.e.shape)
    jb.v[:] = rng.uniform(0.3, 0.7, jb.v.shape)
    jb.u[:] = rng.uniform(0.1, 0.3, jb.u.shape)
    tb.e[:], tb.v[:], tb.u[:] = jb.e, jb.v, jb.u
    return jb, tb


@pytest.mark.parametrize("bath_type,para", [
    ("normal", False), ("normal", True), ("hybrid", False),
    ("replica", False)])
def test_bath_functions_nonsu2_vs_jax(bath_type, para):
    """Δ, G0^-1 and G0 in the full (spin x orbital) space: the helicity W
    matrix of normal and hybrid baths (ed_para shares v and u between the
    spins), the replica sum."""
    jcfg, tcfg = _cfgs(bath_type, ed_para=para, lmats=64)
    hloc = _hloc(jcfg, 7)
    jb, tb = _baths(jcfg, tcfg, 8, hloc)
    pj, pt = jfns.bath_params(jb), tfns.bath_params(tb, "cpu")
    for axis, x in (("mats", jgrids.z_mats(jcfg)),
                    ("real", jgrids.z_real(jcfg))):
        xt = torch.as_tensor(x)
        for fn in ("delta", "invg0", "g0and"):
            args = () if fn == "delta" else (hloc,)
            a = np.asarray(getattr(jfns, fn)(jcfg, jnp.asarray(x), pj, *args,
                                             axis=axis))
            b = getattr(tfns, fn)(tcfg, xt, pt, *args, axis=axis).numpy()
            assert a.shape == b.shape
            assert np.max(np.abs(a[0, 1])) > 0, (fn, axis)
            assert _dev(a, b, np.max(np.abs(a))) <= 1e-13, (fn, axis)


def _oracle_sector_evals(cfg, bath, hloc, n):
    """Dense spectrum of the nonsu2 N sector from the Fock-space H of
    tests/reference_ed.py."""
    Tuu, Tdd, Tud, P = jham.single_particle_parts(cfg, bath, hloc)
    H = ref.build_full_H(cfg.ns, cfg.norb, Tuu, Tdd, Tud, P,
                         np.asarray(cfg.uloc_arr[:cfg.norb]), cfg.ust,
                         cfg.jh, cfg.jx, cfg.jp, cfg.hfmode,
                         ref.sector_states_nonsu2(cfg.ns, n))
    return np.linalg.eigvalsh(H)


def _check_apply(jcfg, tcfg, js, ts, jb, tb, hloc, rng):
    hj = jham.build_sector_hamiltonian(jcfg, js, jb, hloc)
    ht = tham.build_sector_hamiltonian(tcfg, ts, tb, hloc)
    assert len(ts.blocks) > 1 and ht.mix
    assert np.issubdtype(ht.dtype, np.complexfloating)
    sj, aj, _ = jham.make_matvec_op(hj, jcfg)
    st, at, bt = tham.make_matvec_op(ht, tcfg, "cpu")
    assert {m.kind for m in tham.mix_entries(st)} == {"bmix"}
    H = tham.assemble_dense(ht)
    for _ in range(2):
        xi = rng.normal(size=ts.dim) + 1j * rng.normal(size=ts.dim)
        yj = np.asarray(jham.flatten_blocks(jham.apply_op(
            sj, aj, jham.unflatten_blocks(jnp.asarray(xi), js))))
        yt = tham.flatten_blocks(tham.apply_op(
            st, at, tham.unflatten_blocks(torch.from_numpy(xi), bt))).numpy()
        scale = np.max(np.abs(yj))
        assert _dev(yj, yt, scale) <= 1e-12
        assert _dev(H @ xi, yt, scale) <= 1e-12
    return H


@pytest.mark.parametrize("bath_type", ["normal", "replica"])
def test_apply_op_nonsu2_vs_jax_and_oracle(bath_type):
    """Plain N sectors: every (nup, ndw) block joined to its neighbours by
    complex spin-flip terms."""
    jcfg, tcfg = _cfgs(bath_type)
    hloc = _hloc(jcfg, 3)
    jb, tb = _baths(jcfg, tcfg, 4, hloc)
    rng = np.random.default_rng(5)
    for n in (3, 4):
        js = jsectors.sector_table(jcfg).get(n)
        ts = tsectors.sector_table(tcfg).get(n)
        H = _check_apply(jcfg, tcfg, js, ts, jb, tb, hloc, rng)
        assert _dev(np.linalg.eigvalsh(H),
                    _oracle_sector_evals(jcfg, jb, hloc, n)) <= 1e-10


def _projectors(slist):
    out = {}
    for s in slist:
        v = np.asarray(s.get_vector()).reshape(-1)
        out.setdefault(s.sector.index, []).append(v)
    return {k: np.array(v).T @ np.array(v).conj() for k, v in out.items()}


@pytest.mark.parametrize("method,ntot", [
    ("arpack", 1), ("lanczos", 1), ("arpack", 6)],
    ids=["arpack-T0", "lanczos-T0", "arpack-finiteT"])
def test_diagonalize_nonsu2_vs_jax_and_oracle(method, ntot):
    """The nonsu2 sweep: every Krylov sector is multi-block with complex
    mix terms, so it takes the serial route; the complex start vectors
    keep the JAX package's draw order."""
    jcfg, tcfg = _cfgs(lanc_method=method, lanc_nstates_total=ntot,
                       beta=10.0)
    hloc = _hloc(jcfg, 11)
    jb, tb = _baths(jcfg, tcfg, 12, hloc)
    sj, zj, stj = jdiag.diagonalize(jcfg, jb, hloc)
    st, zt, stt = tdiag.diagonalize(tcfg, tb, hloc, device="cpu")
    assert len(sj) == len(st) == ntot
    ej = np.array([s.energy for s in sj])
    et = np.array([s.energy for s in st])
    assert _dev(ej, et) <= 1e-10
    assert abs(zj - zt) <= 1e-10 * zj
    assert stj.neigen_sector == stt.neigen_sector
    assert stj.lanc_nstates_total == stt.lanc_nstates_total
    egs = min(_oracle_sector_evals(jcfg, jb, hloc, n)[0]
              for n in range(2 * jcfg.ns + 1))
    assert abs(st.emin - egs) <= 1e-10
    pj, pt = _projectors(sj), _projectors(st)
    assert pj.keys() == pt.keys()
    for k in pj:
        assert _dev(pj[k], pt[k]) <= 1e-8, k


def _solve_both(tmp_path, bath_type="normal", seed=21, **kw):
    res = {}
    for name, C, S, B, extra in (
            ("jax", jconfig, jsolver, jbath, {}),
            ("torch", tconfig, tsolver, tbath, {"device": "cpu"})):
        cfg = C.EDConfig(**_kw(bath_type, **kw)).validate()
        hloc = _hloc(cfg, seed)
        jb, tb = _baths(*_cfgs(bath_type, **kw), seed + 1, hloc)
        b = jb if name == "jax" else tb
        s = S.EDSolver(cfg, hloc, log=lambda m: None, **extra)
        d = tmp_path / name
        d.mkdir()
        os.chdir(d)
        res[name] = (s.solve(B.pack_bath(b)), b, hloc, s)
    os.chdir(tmp_path)
    return res


def transposed(G):
    """G[s, s', a, b] -> G[s', s, b, a]: the JAX package's nonsu2 G holds
    <<c_{b,s'}; c†_{a,s}>> where the port (and G0) hold <<c_{a,s};
    c†_{b,s'}>> (gf_nonsu2's docstring; ROADMAP.md §3)."""
    return np.ascontiguousarray(np.asarray(G).transpose(1, 0, 3, 2, 4))


def _jax_dyson(cfg, bath, hloc, G, axis):
    """Σ = G0^-1 - G^-1 of the JAX package's bath functions (the JAX
    package's build_sigma_nonsu2 on a given G)."""
    z = jgrids.z_mats(cfg) if axis == "mats" else jgrids.z_real(cfg)
    ig0 = np.asarray(jfns.invg0(cfg, jnp.asarray(z), jfns.bath_params(bath),
                                hloc, axis))
    nso, L = 2 * cfg.norb, len(z)
    g = G.transpose(4, 0, 2, 1, 3).reshape(L, nso, nso)
    i0 = ig0.transpose(4, 0, 2, 1, 3).reshape(L, nso, nso)
    S = (i0 - np.linalg.inv(g)).reshape(L, 2, cfg.norb, 2, cfg.norb)
    return S.transpose(1, 3, 2, 4, 0)


@pytest.mark.parametrize("bath_type,ntot", [("normal", 1), ("hybrid", 1),
                                            ("normal", 8)],
                         ids=["normal-T0", "hybrid-T0", "normal-finiteT"])
def test_gf_sigma_observables_nonsu2_vs_jax(bath_type, ntot, tmp_path):
    """G, Σ, G0 with every spin and orbital off-diagonal on both axes, the
    nonsu2 observables, and the same .ed files. G is held to the JAX
    package's G transposed, Σ to the Dyson of that G (the JAX package's
    own Σ inverts its transposed G). The GF chains stop at 24 steps: run
    to the sector's dim (56) the plain Lanczos chain loses orthogonality
    and its ghost poles, placed by rounding, part the two packages by 1e-2
    on the real axis (eps = 0.01) while the Matsubara axis stays within
    1e-14."""
    res = _solve_both(tmp_path, bath_type, lanc_nstates_total=ntot,
                      beta=10.0 if ntot > 1 else 40.0, lanc_ngfiter=24)
    (a, jb, hloc, js), (t, *_) = res["jax"], res["torch"]
    assert abs(a.egs - t.egs) <= 1e-10
    assert t.nstates == a.nstates == ntot
    for f in ("dens", "docc", "magz", "magx", "magy", "exct_s0", "exct_tz",
              "exct_tx", "exct_ty", "imp_density_matrix"):
        assert _dev(getattr(a.observables, f),
                    getattr(t.observables, f)) <= 1e-10, f
    assert np.max(np.abs(t.observables.magx)) > 1e-3
    ref_ = {"gmats": transposed(a.gmats), "greal": transposed(a.greal),
            "g0mats": a.g0mats, "g0real": a.g0real}
    ref_["smats"] = _jax_dyson(js.cfg, jb, hloc, ref_["gmats"], "mats")
    ref_["sreal"] = _jax_dyson(js.cfg, jb, hloc, ref_["greal"], "real")
    for f, tol in (("gmats", 1e-9), ("smats", 1e-9), ("g0mats", 1e-13),
                   ("g0real", 1e-13)):
        x, y = ref_[f], getattr(t, f)
        assert x.shape == y.shape, f
        assert np.max(np.abs(x[0, 1])) > 0, f
        assert _dev(x, y, np.max(np.abs(x))) <= tol, f
    # real axis: the diagonal components, whose chains start from the same
    # vectors in both packages; an off-diagonal component of the port
    # comes from the (a, s) + i (b, s') chains where the JAX package's
    # transposed one comes from (b, s') + i (a, s), and two truncated
    # chains from different vectors differ near the real axis
    for s in range(2):
        for o in range(t.greal.shape[2]):
            x, y = ref_["greal"][s, s, o, o], t.greal[s, s, o, o]
            assert _dev(x, y, np.max(np.abs(x))) <= 1e-6
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "torch"))
    os.chdir(tmp_path / "torch")
    smats, _ = res["torch"][3].read_sigma()
    from dmft_ed_tpu_torch.io import _orb_pairs
    for s1, s2 in ((0, 0), (0, 1), (1, 1)):     # the printed components
        for o1, o2 in _orb_pairs(res["torch"][3].cfg):
            assert _dev(smats[s1, s2, o1, o2], t.smats[s1, s2, o1, o2]) \
                <= 1e-15


def test_nonsu2_u0_matches_g0(tmp_path):
    """U = 0 with a complex Hloc and a spin-flipping bath: G equals the
    analytic G0 in every (s, s', a, b) component and Σ vanishes. The JAX
    package's G is G0's transpose there, so its Σ does not vanish."""
    res = _solve_both(tmp_path, "hybrid", uloc=(0.0, 0.0), ust=0.0, jh=0.0,
                      lanc_ngfiter=60)
    (a, *_), (t, *_) = res["jax"], res["torch"]
    assert _dev(t.gmats, t.g0mats) <= 1e-10
    assert np.max(np.abs(t.smats)) <= 1e-10
    assert _dev(transposed(a.gmats), a.g0mats) <= 1e-10
    assert np.max(np.abs(a.smats)) > 1e-2


def _lehmann_full(cfg, bath, hloc, z, beta, finite_t):
    """G^{ss'}_{ab}(z) over the full Fock space, every spin block
    (integer-state bit algebra of tests/reference_ed.py only)."""
    ns, norb = cfg.ns, cfg.norb
    Tuu, Tdd, Tud, P = jham.single_particle_parts(cfg, bath, hloc)
    states = list(range(4 ** ns))
    H = ref.build_full_H(ns, norb, Tuu, Tdd, Tud, P,
                         np.asarray(cfg.uloc_arr[:norb]), cfg.ust, cfg.jh,
                         cfg.jx, cfg.jp, cfg.hfmode, states)
    evals, U = np.linalg.eigh(H)
    w = np.exp(-beta * (evals - evals[0])) if finite_t \
        else (np.abs(evals - evals[0]) <= 1e-9).astype(float)
    cdg = {}
    for s in range(2):
        for a in range(norb):
            m = np.zeros((len(states), len(states)))
            for col, st in enumerate(states):
                r = ref.cdg_op(s * ns + a, st)
                if r is not None:
                    m[r[0], col] = r[1]
            cdg[s, a] = U.conj().T @ m @ U
    dE = evals[:, None] - evals[None, :]
    G = np.zeros((2, 2, norb, norb, len(z)), dtype=complex)
    for (s, a), A in cdg.items():
        for (s2, b), B in cdg.items():
            num = np.conj(A) * B * (w[None, :] + w[:, None])
            G[s, s2, a, b] = [np.sum(num / (zz - dE)) for zz in z]
    return G / w.sum()


@pytest.mark.parametrize("finite_t", [False, True], ids=["T0", "finiteT"])
def test_gf_nonsu2_vs_lehmann(finite_t, tmp_path):
    """Every (s, s', a, a) component of the port's G, the (1+i)
    reconstruction included, against the Lehmann sum."""
    kw = _kw(lmats=12, beta=5.0 if finite_t else 40.0,
             lanc_nstates_total=400 if finite_t else 1, cutoff=1e-12,
             lanc_nstates_sector=150 if finite_t else 6)
    tcfg = tconfig.EDConfig(**kw).validate()
    jcfg = jconfig.EDConfig(**kw).validate()
    hloc = _hloc(tcfg, 31)
    jb, tb = _baths(jcfg, tcfg, 32, hloc)
    os.chdir(tmp_path)
    r = tsolver.EDSolver(tcfg, hloc, device="cpu").solve(tbath.pack_bath(tb))
    Gex = _lehmann_full(jcfg, jb, hloc, jgrids.z_mats(jcfg), tcfg.beta,
                        finite_t)
    assert np.max(np.abs(Gex[0, 1] - transposed(Gex)[0, 1])) > 1e-3
    assert _dev(r.gmats, Gex) <= 1e-7


@pytest.mark.parametrize("bath_type", ["normal", "hybrid"])
def test_fit_nonsu2_step_vs_jax(bath_type, tmp_path, monkeypatch):
    """One L-BFGS-B step of the nonsu2 fit (e, v, u, every (s, s')
    component of the Weiss field, the Δ-target pre-conditioning)."""
    monkeypatch.chdir(tmp_path)
    jcfg, tcfg = _cfgs(bath_type, cg_niter=1, lmats=60, lfit=60)
    hloc = _hloc(jcfg, 41)
    jb, tb = _baths(jcfg, tcfg, 42, hloc)
    jb2, _ = _baths(jcfg, tcfg, 43, hloc)
    tgt = np.asarray(jfns.g0and(jcfg, jnp.asarray(jgrids.z_mats(jcfg)),
                                jfns.bath_params(jb2), hloc))
    a = jfit.chi2_fitgf(jcfg, tgt, jbath.pack_bath(jb), hloc, save=False)
    b = tfit.chi2_fitgf(tcfg, tgt, tbath.pack_bath(tb), hloc, save=False,
                        device="cpu")
    assert np.max(np.abs(a - jbath.pack_bath(jb))) > 1e-4
    assert _dev(a, b) <= 1e-14


def test_fit_nonsu2_recovery(tmp_path, monkeypatch):
    """The fit recovers Δ of a known nonsu2 bath from a perturbed start
    (tests/test_fit.py's pattern), spin off-diagonal included."""
    monkeypatch.chdir(tmp_path)
    kw = _kw(beta=20.0, lmats=200, lfit=200, cg_scheme="delta",
             cg_niter=800, cg_ftol=1e-12)
    tcfg = tconfig.EDConfig(**kw).validate()
    jcfg = jconfig.EDConfig(**kw).validate()
    hloc = _hloc(tcfg, 51)
    _, b_true = _baths(jcfg, tcfg, 52, hloc)
    x = torch.as_tensor(1j * np.pi / tcfg.beta
                        * (2 * np.arange(1, tcfg.lfit + 1) - 1))
    target = tfns.delta(tcfg, x, tfns.bath_params(b_true, "cpu")).numpy()
    b0 = tbath.Bath(tcfg)
    b0.e[:] = b_true.e * 0.8 + 0.05
    b0.v[:] = b_true.v * 0.7
    b0.u[:] = b_true.u * 1.3
    out = tfit.chi2_fitgf(tcfg, target, tbath.pack_bath(b0), hloc,
                          save=False, device="cpu")
    fit = tfns.delta(tcfg, x, tfns.bath_params(
        tbath.unpack_bath(tcfg, out), "cpu")).numpy()
    assert np.max(np.abs(target[0, 1])) > 1e-2
    assert _dev(fit, target) <= 1e-3


def test_ozaki5x7_nonsu2_solve_runs_no_digit_product(tmp_path, monkeypatch):
    """Under ozaki5x7 a nonsu2 operator with spin flips is complex, so it
    takes the exact f64 route: no Ozaki product (hence no digit-matmul
    launch on a card) and a solve bitwise equal to native."""
    calls = []
    for fn in ("sliced_matmul", "right_sliced_matmul", "fused_two_sided",
               "_left_digits", "_right_digits"):
        orig = getattr(tozaki, fn)
        monkeypatch.setattr(tozaki, fn, lambda *a, _f=orig, _n=fn, **k:
                            calls.append(_n) or _f(*a, **k))
    out = {}
    for prec in ("native", "ozaki5x7"):
        kw = _kw(matmul_precision=prec, lanc_method="lanczos")
        cfg = tconfig.EDConfig(**kw).validate()
        hloc = _hloc(cfg, 61)
        _, tb = _baths(*_cfgs(), 62, hloc)
        d = tmp_path / prec
        d.mkdir()
        os.chdir(d)
        out[prec] = tsolver.EDSolver(cfg, hloc, device="cpu").solve(
            tbath.pack_bath(tb))
    assert calls == []
    a, b = out["native"], out["ozaki5x7"]
    assert a.egs == b.egs
    assert np.array_equal(a.gmats, b.gmats)
    assert np.array_equal(a.smats, b.smats)


@pytest.mark.gpu
def test_graphed_matvec_on_card():
    """On a card the Krylov engines replay a multi-block matvec from a
    CUDA graph (lanczos._Graphed): bitwise the eager apply_op, for a flat
    vector and a batch, replayed more than once (run there with
    ``python -m pytest -m gpu tests/test_torch_nonsu2.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    import dmft_ed_tpu_torch.lanczos as tlanczos
    _, tcfg = _cfgs("hybrid")
    hloc = _hloc(tcfg, 71)
    _, tb = _baths(*_cfgs("hybrid"), 72, hloc)
    sec = tsectors.sector_table(tcfg).get(4)
    ham = tham.build_sector_hamiltonian(tcfg, sec, tb, hloc)
    spec, arrays, blocks = tham.make_matvec_op(ham, tcfg, "cuda")
    mv = tlanczos._op_matvec(spec, blocks, arrays)
    assert isinstance(mv, tlanczos._Graphed)
    g = torch.Generator(device="cuda").manual_seed(7)
    for shape in ((sec.dim,), (3, sec.dim)):
        for _ in range(2):
            x = torch.randn(shape, dtype=torch.complex128, device="cuda",
                            generator=g)
            eager = tham.flatten_blocks(tham.apply_op(
                spec, arrays, tham.unflatten_blocks(x, blocks)))
            assert torch.equal(mv(x), eager)
