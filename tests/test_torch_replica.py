"""Replica baths and the Jz basis in the PyTorch port against the JAX
package on the CPU: the replica fit (masked Re/Im of h per bath copy and
the real vr, Hermitian fill, in normal and nonsu2 mode), the bath density
matrix, a normal-mode replica solve, replica restart files through
``convert``, and the Jz basis (sub-selected blocks, the union of the Jz
spectra, a whole Jz solve against the plain one, the Jz twin masks and
the jz_max filter). Inputs come from numpy seeds and go through both
packages.

Bounds, measured on these configs (Norb=2 Nbath=2 replica in normal mode,
Norb=2 Nbath=1 in nonsu2, Norb=3 Nbath=1 t2g replica for the Jz basis):

* ``_herm_fill``: bitwise;
* one L-BFGS-B step of the replica fit: 1e-14 of the bath (measured
  2.2e-15 and 1.6e-15); a converged fit recovers Δ within 1e-3
  (tests/test_fit.py's bound; measured 5.3e-8 and 6.3e-7);
* normal-mode replica solve: G, Σ on the Matsubara axis 1e-9 of max|f|
  (measured 2.1e-13, 9.9e-13), the observables and the bath density
  matrix 1e-10 (measured 1.6e-15, 1.1e-15), its file 1e-11;
* restart files: the flat vector bitwise, the file byte-identical;
* ``apply_op`` of Jz sectors: 1e-12 of max|Hv| against the JAX operator
  and the dense host H (measured 3.2e-16);
* Jz against plain nonsu2: union of the Jz spectra per N 1e-9 (measured
  2.0e-14), the port's thick restart on each Jz sector against its dense
  spectrum 1e-9; egs, Z 1e-9, dens, docc 1e-8, G 1e-7 of a whole solve
  (the tests/test_jz_basis.py bounds; measured 1.8e-15, 3.6e-16,
  8.6e-14); the twin solve at finite T against the full scan the same;
* the jz_max filter: the same kept sectors and energies as the JAX
  package, 1e-10 (measured 0).
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
import dmft_ed_tpu_torch.convert as convert
import dmft_ed_tpu_torch.diag as tdiag
import dmft_ed_tpu_torch.fit as tfit
import dmft_ed_tpu_torch.hamiltonian as tham
import dmft_ed_tpu_torch.sectors as tsectors
import dmft_ed_tpu_torch.solver as tsolver


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


def _kw(mode="normal", **kw):
    base = dict(norb=2, nbath=2, nspin=1, bath_type="replica", ed_mode=mode,
                uloc=(1.5, 1.5), ust=0.7, beta=40.0, lmats=40, lreal=20,
                xmu=0.1, lanc_dim_threshold=10, ed_verbose=0)
    if mode == "nonsu2":
        base.update(nspin=2, nbath=1)
    base.update(kw)
    return base


def _cfgs(mode="normal", **kw):
    k = _kw(mode, **kw)
    return (jconfig.EDConfig(**k).validate(),
            tconfig.EDConfig(**k).validate())


def _hloc(cfg, seed):
    """Hermitian Hloc with complex orbital (and, in nonsu2, spin)
    off-diagonals; its sparsity pattern is the replica mask."""
    rng = np.random.default_rng(seed)
    nso = cfg.nspin * cfg.norb
    a = rng.normal(size=(nso, nso)) + 1j * rng.normal(size=(nso, nso))
    h = 0.1 * (a + a.conj().T)
    if cfg.nspin == 1:
        return h.reshape(1, 1, cfg.norb, cfg.norb)
    return taux.so2nn(h, 2, cfg.norb)


def _baths(jcfg, tcfg, seed, hloc):
    """The same random replica bath for both packages."""
    rng = np.random.default_rng(seed)
    mask = jbath.replica_mask(jcfg, hloc)
    jb, tb = jbath.Bath(jcfg), tbath.Bath(tcfg)
    jb.mask = tb.mask = mask
    nso = jcfg.nspin * jcfg.norb
    for k in range(jcfg.nbath):
        a = rng.normal(size=(nso, nso)) + 1j * rng.normal(size=(nso, nso))
        h = 0.3 * (a + a.conj().T)
        h = h.reshape(jcfg.nspin, jcfg.norb, jcfg.nspin, jcfg.norb
                      ).transpose(0, 2, 1, 3)
        jb.h[..., k] = h * (mask[..., 0] | mask[..., 1])
        jb.h[..., k] += np.einsum("st,ab->stab", np.eye(jcfg.nspin),
                                  np.eye(jcfg.norb)) * (k - 0.5)
    jb.vr[:] = rng.uniform(0.4, 0.7, jb.vr.shape)
    tb.h[:], tb.vr[:] = jb.h, jb.vr
    return jb, tb


@pytest.mark.parametrize("mode,para", [("normal", False), ("normal", True),
                                       ("nonsu2", False)])
def test_herm_fill_vs_jax(mode, para):
    jcfg, tcfg = _cfgs(mode, ed_para=para, nspin=2)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(2, 2, jcfg.norb, jcfg.norb, jcfg.nbath)) \
        + 1j * rng.normal(size=(2, 2, jcfg.norb, jcfg.norb, jcfg.nbath))
    a = np.asarray(jfit._herm_fill(jcfg, jnp.asarray(h)))
    b = tfit._herm_fill(tcfg, torch.as_tensor(h)).numpy()
    assert np.array_equal(a, b)


@pytest.mark.parametrize("mode", ["normal", "nonsu2"])
def test_replica_fit_step_vs_jax(mode, tmp_path, monkeypatch):
    """One L-BFGS-B step of the replica fit: the same masked parameters in
    the same order, the same gradient through the Hermitian fill."""
    monkeypatch.chdir(tmp_path)
    jcfg, tcfg = _cfgs(mode, cg_niter=1, lmats=60, lfit=60)
    hloc = _hloc(jcfg, 3)
    jb, tb = _baths(jcfg, tcfg, 4, hloc)
    jb2, _ = _baths(jcfg, tcfg, 5, hloc)
    tgt = np.asarray(jfns.g0and(jcfg, jnp.asarray(jgrids.z_mats(jcfg)),
                                jfns.bath_params(jb2), hloc))
    a = jfit.chi2_fitgf(jcfg, tgt, jbath.pack_bath(jb), hloc, mask=jb.mask,
                        save=False)
    b = tfit.chi2_fitgf(tcfg, tgt, tbath.pack_bath(tb), hloc, mask=tb.mask,
                        save=False, device="cpu")
    assert np.max(np.abs(a - jbath.pack_bath(jb))) > 1e-4
    assert _dev(a, b) <= 1e-14


@pytest.mark.parametrize("mode", ["normal", "nonsu2"])
def test_replica_fit_recovery(mode, tmp_path, monkeypatch):
    """The port's fit recovers Δ of a known replica bath from a perturbed
    start (tests/test_fit.py:92's pattern)."""
    monkeypatch.chdir(tmp_path)
    _, tcfg = _cfgs(mode, beta=20.0, lmats=200, lfit=200, cg_scheme="delta",
                    cg_niter=1500, cg_ftol=1e-12)
    jcfg, _ = _cfgs(mode)
    hloc = _hloc(tcfg, 6)
    _, b_true = _baths(jcfg, tcfg, 7, hloc)
    x = torch.as_tensor(1j * np.pi / tcfg.beta
                        * (2 * np.arange(1, tcfg.lfit + 1) - 1))
    target = tfns.delta(tcfg, x, tfns.bath_params(b_true, "cpu")).numpy()
    b0 = tbath.Bath(tcfg)
    b0.mask = b_true.mask
    b0.h[:] = b_true.h * 0.8
    b0.vr[:] = 0.5
    out = tfit.chi2_fitgf(tcfg, target, tbath.pack_bath(b0), hloc,
                          mask=b0.mask, save=False, device="cpu")
    fit = tfns.delta(tcfg, x, tfns.bath_params(
        tbath.unpack_bath(tcfg, out, b0.mask), "cpu")).numpy()
    assert _dev(fit, target) <= 1e-3


def test_replica_solve_and_bath_dm_vs_jax(tmp_path):
    """A normal-mode replica solve (orbital off-diagonals from the mask):
    G, Σ, the observables, the bath density matrix and its .ed file."""
    res = {}
    for name, C, S, B, extra in (
            ("jax", jconfig, jsolver, jbath, {}),
            ("torch", tconfig, tsolver, tbath, {"device": "cpu"})):
        cfg = C.EDConfig(**_kw(lanc_ngfiter=24)).validate()
        hloc = _hloc(cfg, 8)
        jb, tb = _baths(*_cfgs(), 9, hloc)
        s = S.EDSolver(cfg, hloc, log=lambda m: None, **extra)
        d = tmp_path / name
        d.mkdir()
        os.chdir(d)
        res[name] = (s.solve(B.pack_bath(jb if name == "jax" else tb)), s)
    (a, _), (t, ts) = res["jax"], res["torch"]
    assert abs(a.egs - t.egs) <= 1e-10
    for f in ("dens", "docc", "imp_density_matrix"):
        assert _dev(getattr(a.observables, f),
                    getattr(t.observables, f)) <= 1e-10, f
    for f in ("gmats", "smats"):
        x, y = getattr(a, f), getattr(t, f)
        assert np.max(np.abs(x[0, 0, 0, 1])) > 0, f
        assert _dev(x, y, np.max(np.abs(x))) <= 1e-9, f
    assert t.bath_dm.shape == (1, 1, 2, 2, 2)
    assert np.max(np.abs(t.bath_dm)) > 0.1
    assert _dev(a.bath_dm, t.bath_dm) <= 1e-10
    assert ts.get_bath_density_matrix() is t.bath_dm
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "torch"))
    fa = np.loadtxt(tmp_path / "jax" / "bath_density_matrix.ed")
    fb = np.loadtxt(tmp_path / "torch" / "bath_density_matrix.ed")
    assert _dev(fa, fb) <= 1e-11


@pytest.mark.parametrize("mode", ["normal", "nonsu2"])
def test_convert_replica_restart_roundtrip(mode, tmp_path):
    """A replica restart file the JAX package writes reads back through
    convert, with its mask, as the JAX package reads it; the port writes it
    back byte-identical; without the mask convert refuses."""
    jcfg, _ = _cfgs(mode)
    tcfg = convert.config_from_reference(jcfg)
    hloc = _hloc(jcfg, 10)
    jb, _ = _baths(jcfg, tcfg, 11, hloc)
    ref = tmp_path / "ref.restart"
    jbath.save_bath(jb, path=str(ref))
    flat = convert.read_bath_restart(tcfg, str(ref), mask=jb.mask)
    jread = jbath.Bath(jcfg)
    jread.mask = jb.mask
    jbath.load_bath(jread, str(ref))
    assert np.array_equal(flat, jbath.pack_bath(jread))
    out = tmp_path / "port.restart"
    convert.write_bath_restart(tcfg, flat, str(out), mask=jb.mask)
    assert out.read_bytes() == ref.read_bytes()
    with pytest.raises(ValueError):
        convert.read_bath_restart(tcfg, str(ref))


def _jz_problem(jz, lam=0.3, seed=101, **kw):
    """t2g + atomic SOC in the Jz-conserving form with a replica bath
    (tests/test_jz_basis.py's _jz_conserving_problem), for both
    packages."""
    base = dict(norb=3, nspin=2, nbath=1, uloc=(0.8, 0.8, 0.8), ust=0.4,
                jh=0.1, ed_mode="nonsu2", bath_type="replica", jz_basis=jz,
                xmu=0.1, lanc_dim_threshold=10, ed_verbose=0)
    base.update(kw)
    jcfg = jconfig.EDConfig(**base).validate()
    tcfg = tconfig.EDConfig(**base).validate()
    rng = np.random.default_rng(seed)
    ls = taux.atomic_soc_jz()
    hloc = lam * ls
    mask = jbath.replica_mask(jcfg, hloc + 1e-3 * np.einsum(
        "st,ab->stab", np.eye(2), np.eye(3)))
    jb, tb = jbath.Bath(jcfg), tbath.Bath(tcfg)
    jb.mask = tb.mask = mask
    eps = rng.normal() * 0.3
    jb.h[..., 0] = 0.7 * lam * ls
    for s in range(2):
        for a in range(3):
            jb.h[s, s, a, a, 0] += eps
    jb.vr[:] = 0.6
    tb.h[:], tb.vr[:] = jb.h, jb.vr
    return jcfg, tcfg, hloc, jb, tb


def _check_apply(jcfg, tcfg, js, ts, jb, tb, hloc, rng):
    """H·v of one sector: the port against the JAX operator and the dense
    host H, on complex vectors."""
    hj = jham.build_sector_hamiltonian(jcfg, js, jb, hloc)
    ht = tham.build_sector_hamiltonian(tcfg, ts, tb, hloc)
    assert len(ts.blocks) > 1 and ht.mix
    assert np.issubdtype(ht.dtype, np.complexfloating)
    sj, aj, _ = jham.make_matvec_op(hj, jcfg)
    st, at, bt = tham.make_matvec_op(ht, tcfg, "cpu")
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


def test_apply_op_jz_vs_jax():
    """Jz sectors: sub-selected (Lz-class) blocks, per-spin parts
    restricted and densified, spin flips between Lz classes."""
    jcfg, tcfg, hloc, jb, tb = _jz_problem(True)
    jt, tt = jsectors.sector_table(jcfg), tsectors.sector_table(tcfg)
    picks = [i for i, s in enumerate(tt.sectors)
             if s.qn[1] in (5, 6) and abs(s.qn[2]) <= 1 and s.dim > 60]
    assert len(picks) >= 3
    rng = np.random.default_rng(6)
    for i in picks:
        _check_apply(jcfg, tcfg, jt.sectors[i], tt.sectors[i], jb, tb, hloc,
                     rng)


def _lowest(tcfg, ham, k, rng):
    ev, _ = tdiag._solve_sector_lanczos(tcfg, ham, k, rng, "cpu")
    return np.sort(ev)


@pytest.mark.parametrize("n", [4, 6])
def test_jz_spectra_union_vs_plain(n):
    """Every Jz sector of N = n: the port's thick restart finds its lowest
    eigenvalues, and the union of the Jz spectra is the plain N sector's
    (tests/test_jz_basis.py's pattern)."""
    k = 4
    rng = np.random.default_rng(0)
    _, tcfg, hloc, _, tb = _jz_problem(True)
    evs = []
    for sec in tsectors.sector_table(tcfg).sectors:
        if sec.qn[1] != n:
            continue
        ham = tham.build_sector_hamiltonian(tcfg, sec, tb, hloc)
        dense = np.linalg.eigvalsh(tham.assemble_dense(ham))
        evs.append(dense)
        if sec.dim > tcfg.lanc_dim_threshold:
            krylov = _lowest(tcfg, ham, k, rng)
            assert abs(krylov[0] - dense[0]) <= 1e-9
            assert np.max(np.min(np.abs(krylov[:, None] - dense[None, :]),
                                 axis=1)) <= 1e-9
    _, pcfg, _, _, pb = _jz_problem(False)
    sec = tsectors.sector_table(pcfg).get(n)
    plain = np.linalg.eigvalsh(tham.assemble_dense(
        tham.build_sector_hamiltonian(pcfg, sec, pb, hloc)))
    assert _dev(np.sort(np.concatenate(evs)), plain) <= 1e-9


def test_jz_full_solve_matches_plain(tmp_path):
    """Spectrum, observables and G of the Jz-basis solve equal the plain
    nonsu2 solve of the same Jz-conserving problem (the port on both
    sides; tests/test_jz_basis.py holds the JAX package the same way)."""
    res = {}
    for jz in (False, True):
        _, tcfg, hloc, _, tb = _jz_problem(jz, lmats=12, lreal=8, beta=60.0,
                                           lanc_dim_threshold=200)
        d = tmp_path / str(jz)
        d.mkdir()
        os.chdir(d)
        r = tsolver.EDSolver(tcfg, hloc, device="cpu").solve(
            tbath.pack_bath(tb))
        res[jz] = r
    a, b = res[False], res[True]
    assert abs(a.egs - b.egs) <= 1e-9 and abs(a.zeta - b.zeta) <= 1e-9
    assert _dev(a.observables.dens, b.observables.dens) <= 1e-8
    assert _dev(a.observables.docc, b.observables.docc) <= 1e-8
    for s in range(2):
        for o in range(3):
            assert _dev(a.gmats[s, s, o, o], b.gmats[s, s, o, o]) <= 1e-7




def _ph_symmetric_problem(jz_twin):
    """U + U' + hybridization at xmu=0: particle-hole symmetric, the twin
    condition for nonsu2 (tests/test_jz_basis.py's problem)."""
    kw = dict(norb=3, nspin=2, nbath=1, uloc=(0.8, 0.8, 0.8), ust=0.4,
              ed_mode="nonsu2", bath_type="replica", jz_basis=True, xmu=0.0,
              ed_twin=jz_twin, lmats=10, lreal=6, beta=60.0,
              lanc_dim_threshold=200, ed_verbose=0)
    cfg = tconfig.EDConfig(**kw).validate()
    b = tbath.Bath(cfg)
    b.mask = tbath.replica_mask(cfg, np.einsum("st,ab->stab", np.eye(2),
                                               np.eye(3)))
    b.vr[:] = 0.6
    return cfg, np.zeros((2, 2, 3, 3), dtype=complex), b


def test_jz_twin_solve_matches_full_scan(tmp_path):
    """ed_twin in the Jz basis at finite T: the halved sweep (twin mask)
    and the kept states of twin sectors rebuilt by the Lz complement
    gather of eigenspace reproduce the full scan."""
    res = {}
    for tw in (False, True):
        cfg, hloc, b = _ph_symmetric_problem(tw)
        # 13 states close the ground state and the 12-fold first
        # multiplet above it (a count that cut it would let each sweep
        # keep other members)
        cfg = cfg.replace(beta=4.0, lanc_nstates_total=13,
                          lanc_nstates_sector=12, cutoff=1e-12)
        d = tmp_path / str(tw)
        d.mkdir()
        os.chdir(d)
        res[tw] = tsolver.EDSolver(cfg, hloc, device="cpu").solve(
            tbath.pack_bath(b))
    a, t = res[False], res[True]
    assert abs(a.egs - t.egs) <= 1e-9 and abs(a.zeta - t.zeta) <= 1e-9
    assert _dev(a.observables.dens, t.observables.dens) <= 1e-8
    assert _dev(a.observables.docc, t.observables.docc) <= 1e-8
    for s in range(2):
        for o in range(3):
            assert _dev(a.gmats[s, s, o, o], t.gmats[s, s, o, o]) <= 1e-7


def test_jz_max_filter_vs_jax():
    """jz_max drops the sectors with |2Jz| > 2 jz_max_value from the
    sweep: the same kept states as the JAX package."""
    jcfg, tcfg, hloc, jb, tb = _jz_problem(True, jz_max=True,
                                           jz_max_value=0.5,
                                           lanc_nstates_total=6, beta=5.0,
                                           lanc_dim_threshold=300)
    sj, zj, _ = jdiag.diagonalize(jcfg, jb, hloc)
    st, zt, _ = tdiag.diagonalize(tcfg, tb, hloc, device="cpu")
    assert all(abs(s.sector.qn[2]) <= 1 for s in st)
    assert sorted(s.sector.index for s in sj) == \
        sorted(s.sector.index for s in st)
    assert _dev([s.energy for s in sj], [s.energy for s in st]) <= 1e-10
    assert abs(zj - zt) <= 1e-10 * zj
