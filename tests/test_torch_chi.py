"""Susceptibilities of the PyTorch port (``chi.py`` and the chi flags of
``EDSolver``) against the JAX package and against the full-Fock Lehmann
oracle of tests/reference_ed.py (through the helpers of tests/test_chi.py),
and the repair of the JAX package's complex-operand Ozaki fault.

Bounds, measured on these configs:

* ``native``, against JAX: 1e-10 of max|chi| in tau, iv and w (measured
  3.1e-15 at norb 1, 3.6e-13 at norb 2); against the oracle: 1e-7, the
  bound tests/test_chi.py holds the JAX package to (measured 6.9e-14);
* the fault case, norb=2, Nbath=2, U=2, Ust=1, Jh=0.3, beta=50 with
  ``chidens_flag`` under ``ozaki5x7``: the off-diagonal chi_dens(0, 1)
  within 1e-6 of the port's own ``native`` result in tau, iv and w
  (measured 2.4e-8, 1.6e-9, 4.7e-9), where the JAX package's ozaki5x7
  result is 2.0 off in tau (its digits drop the imaginary part of the
  (n_a -/+ i n_b) channels); the diagonal entries within 1e-7 (measured
  2.0e-9 at most). Every chain here ends by exhaustion before 100 steps,
  so lanc_ngfiter=100 (the default is 200) changes no result and halves
  the time of the stacked scans. At T=0 these channels take the stacked
  route (one target-sector shape); at finite T (lanc_nstates_total=12,
  beta=2) the ragged route
  (measured 3.5e-10 in tau, 5.2e-11 in iv, 7.9e-9 in w off the diagonal;
  2.2e-9 at most on it). Twelve states close the 8-fold multiplet of the
  third level: a count that cuts a degenerate multiplet lets 1e-10
  rounding choose which of its states are kept.
"""

import numpy as np
import pytest
import torch

import dmft_ed_tpu.bath as jbath
import dmft_ed_tpu.chi as jchi
import dmft_ed_tpu.config as jconfig
import dmft_ed_tpu.diag as jdiag
import dmft_ed_tpu.solver as jsolver
import dmft_ed_tpu_torch.bath as tbath
import dmft_ed_tpu_torch.chi as tchi
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.diag as tdiag
import dmft_ed_tpu_torch.gf_common as tgf
import dmft_ed_tpu_torch.hamiltonian as tham
import dmft_ed_tpu_torch.solver as tsolver

import test_chi as oracle


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test. With several pytest-xdist workers on
    a few cores, torch's default threads over-subscribe them, and the many
    small ops of the CPU Ozaki products wait at thread barriers: the
    ragged fault case of test_torch_chi.py took 552 s in one of six
    workers against 19 s alone. The bounds stated above hold either way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BUILDERS = {"spin": "build_chi_spin", "dens": "build_chi_dens",
            "pair": "build_chi_pair", "dens_mix": "build_chi_dens_mix"}


def _both(norb, ragged, monkeypatch):
    """(jax cfg, bath, hloc) of tests/test_chi.py and the port's copy,
    diagonalized by each package."""
    monkeypatch.setenv("DMFT_ED_RAGGED", "1" if ragged else "0")
    jcfg, jb, hloc = oracle._setup() if norb == 1 \
        else oracle._two_orb_setup()
    tcfg = tconfig.EDConfig(**{f: getattr(jcfg, f) for f in (
        "norb", "nbath", "nspin", "uloc", "ust", "beta", "lmats", "lreal",
        "ltau", "wini", "wfin", "lanc_dim_threshold", "lanc_ngfiter")}
    ).validate()
    tb = tbath.Bath(tcfg)
    tb.e[:], tb.v[:] = jb.e, jb.v
    sj, zj, _ = jdiag.diagonalize(jcfg, jb, hloc)
    st, zt, _ = tdiag.diagonalize(tcfg, tb, hloc, device="cpu")
    return (jcfg, jb, sj, zj), (tcfg, tb, st, zt), hloc


@pytest.mark.parametrize("norb,ragged", [(1, True), (2, True), (2, False)])
def test_chi_builders_vs_jax(norb, ragged, monkeypatch):
    (jcfg, jb, sj, zj), (tcfg, tb, st, zt), hloc = _both(norb, ragged,
                                                         monkeypatch)
    kinds = ["spin", "dens", "pair"] + (["dens_mix"] if norb > 1 else [])
    for kind in kinds:
        ref = getattr(jchi, BUILDERS[kind])(jcfg, sj, zj, jb, hloc, False)
        got = getattr(tchi, BUILDERS[kind])(tcfg, st, zt, tb, hloc, False,
                                            device="cpu")
        for r, g in zip(ref, got):
            assert r.shape == g.shape, kind
            assert np.max(np.abs(r - g)) <= 1e-10 * np.max(np.abs(r)), kind


@pytest.mark.parametrize("which", ["spin", "dens", "pair"])
def test_chi_norb1_vs_oracle(which, monkeypatch):
    (jcfg, jb, _, _), (tcfg, tb, st, zt), hloc = _both(1, True, monkeypatch)
    got = getattr(tchi, BUILDERS[which])(tcfg, st, zt, tb, hloc, False,
                                         device="cpu")
    builder = {"spin": oracle._sz_builder, "dens": oracle._n_builder,
               "pair": oracle._pair_builder}[which]
    for g, e in zip(got, oracle._exact_chi(jcfg, jb, hloc, builder)):
        np.testing.assert_allclose(g[0, 0], e, atol=1e-7)


def test_chi_dens_norb2_vs_oracle(monkeypatch):
    """The off-diagonal density channels (raw tau / iv accumulation of the
    (n_a + n_b) and (n_a -/+ i n_b) channels) and chi_dens_mix against
    dense Lehmann sums, as tests/test_chi.py holds the JAX package."""
    (jcfg, jb, _, _), (tcfg, tb, st, zt), hloc = _both(2, True, monkeypatch)
    ct, ci, _ = tchi.build_chi_dens(tcfg, st, zt, tb, hloc, False,
                                    device="cpu")
    states, evals, U = oracle._dense_eig(jcfg, jb, hloc)
    ns = jcfg.ns
    gs = oracle._gs_multiplet(evals)
    dE = evals - evals[0]

    def nop(coeffs):
        occ = np.zeros(len(states), complex)
        for orb, cf in coeffs.items():
            occ += cf * np.array([((s >> orb) & 1) + ((s >> (ns + orb)) & 1)
                                  for s in states], float)
        return np.diag(occ)

    def amps2(O):
        w = np.zeros(len(evals))
        for k in gs:
            w += np.abs(U.conj().T @ (O @ U[:, k])) ** 2
        return w / len(gs)

    et = np.zeros(ct.shape[-1], complex)
    ei = np.zeros(ci.shape[-1], complex)
    for weights, isigns in [
            (amps2(nop({0: 1.0, 1: 1.0})), (1, -1)),
            (1j * amps2(nop({0: 1.0, 1: -1j})), (1,)),
            (1j * amps2(nop({0: 1.0, 1: 1j})), (-1,))]:
        t_, i_, _ = oracle._bose_kernels(jcfg, weights, dE, isigns)
        et, ei = et + t_, ei + i_
    np.testing.assert_allclose(ct[0, 1], et, atol=1e-7)
    np.testing.assert_allclose(ci[0, 1], ei, atol=1e-7)


FAULT = dict(norb=2, nbath=2, nspin=1, uloc=(2.0, 2.0), ust=1.0, jh=0.3,
             beta=50.0, chidens_flag=True, lmats=64, lreal=64, ltau=64,
             lanc_ngfiter=100, ed_verbose=0)


def _solve(C, S, extra, **kw):
    cfg = C.EDConfig(**dict(FAULT, **kw)).validate()
    s = S.EDSolver(cfg, np.zeros((1, 1, 2, 2)), log=lambda m: None, **extra)
    return s.solve(s.init_solver())


def _spy_ragged(monkeypatch):
    """Records (operator dtype, vector dtype, kind of the dw term) of every
    ragged stacked GF scan of the port."""
    seen = []
    orig = tgf.ResolventBatch._run_ragged_stack

    def spy(self, spec_p, blocks_p, sub, *a):
        # a single block: its dw side is the last spin part
        seen.append((tham.vector_dtype(spec_p),
                     {str(j[0].dtype) for e, _ in sub for j in e[4]},
                     tham.spin_parts(spec_p)[-1].kind))
        return orig(self, spec_p, blocks_p, sub, *a)
    monkeypatch.setattr(tgf.ResolventBatch, "_run_ragged_stack", spy)
    return seen


def test_complex_channels_under_ozaki_stacked(tmp_path, monkeypatch):
    """T=0: the two ground-state sectors share one shape, so the complex
    density channels run on the stacked route. The port's ozaki5x7 result
    is its native one; the JAX package's is 2.0 off."""
    monkeypatch.setenv("DMFT_ED_RAGGED", "1")
    seen = _spy_ragged(monkeypatch)
    nat = _solve(tconfig, tsolver, {"device": "cpu"},
                 matmul_precision="native")
    oz = _solve(tconfig, tsolver, {"device": "cpu"},
                matmul_precision="ozaki5x7")
    jz = _solve(jconfig, jsolver, {}, matmul_precision="ozaki5x7")
    assert not seen
    for a, b in zip(nat.chi_dens, oz.chi_dens):
        assert np.max(np.abs(a[0, 1] - b[0, 1])) <= 1e-6
        assert np.max(np.abs(a[0, 0] - b[0, 0])) <= 1e-7
    assert np.max(np.abs(jz.chi_dens[0][0, 1] - oz.chi_dens[0][0, 1])) > 1.0
    # the diagonal channels are real: there the packages agree
    assert np.max(np.abs(jz.chi_dens[0][0, 0] - oz.chi_dens[0][0, 0])) \
        <= 1e-7


def test_complex_channels_under_ozaki_ragged(tmp_path, monkeypatch):
    """Finite T: states of several sectors, and the complex density
    channels of two target-sector shapes merge into one ragged stack of
    real Ozaki operators against complex vectors."""
    monkeypatch.setenv("DMFT_ED_RAGGED", "1")
    seen = _spy_ragged(monkeypatch)
    kw = dict(lanc_nstates_total=12, beta=2.0)
    nat = _solve(tconfig, tsolver, {"device": "cpu"},
                 matmul_precision="native", **kw)
    oz = _solve(tconfig, tsolver, {"device": "cpu"},
                matmul_precision="ozaki5x7", **kw)
    assert ("float64", frozenset({"float64", "complex128"}), "ozl") in \
        {(a, frozenset(b), c) for a, b, c in seen}
    assert oz.nstates == nat.nstates > 1
    for a, b in zip(nat.chi_dens, oz.chi_dens):
        assert np.max(np.abs(a[0, 1] - b[0, 1])) <= 1e-6
        assert np.max(np.abs(a[0, 0] - b[0, 0])) <= 1e-7


def test_cli_reads_chi_flags_and_nstates(tmp_path, monkeypatch):
    """The hm_bethe CLI's input file carries CHISPIN_FLAG, CHIDENS_FLAG and
    LANC_NSTATES_TOTAL into the config: one finite-T iteration on the CPU
    with the package defaults (arpack) writes the susceptibility files."""
    from dmft_ed_tpu_torch.models import hm_bethe as tbethe
    monkeypatch.chdir(tmp_path)
    (tmp_path / "inputED.in").write_text(
        "NORB=1\nNBATH=3\nULOC=2.0\nBETA=10.0\nLMATS=64\nLREAL=64\n"
        "LTAU=64\nNLOOP=1\nED_VERBOSE=0\nCHISPIN_FLAG=T\nCHIDENS_FLAG=T\n"
        "LANC_NSTATES_TOTAL=4\nLANC_DIM_THRESHOLD=8\n")
    r = tbethe.main(["inputED.in", "DEVICE=cpu", "LE=100"])
    used = dict(line.split("=", 1) for line in
                (tmp_path / "used.inputED.in").read_text().splitlines())
    assert used["CHISPIN_FLAG"] == "T" and used["CHIDENS_FLAG"] == "T"
    assert used["LANC_NSTATES_TOTAL"] == "4"
    assert used["LANC_METHOD"] == "arpack"
    assert r.iterations == 1 and np.all(np.isfinite(r.docc))
    for name in ("spinChi_l11", "densChi_l11"):
        for axis in ("tau", "iw", "realw"):
            assert (tmp_path / f"{name}_{axis}.ed").stat().st_size > 0
    assert "    4 " in (tmp_path / "state_list.ed").read_text()
