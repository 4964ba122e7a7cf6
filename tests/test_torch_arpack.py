"""The thick-restart Lanczos (``lanc_method="arpack"``, the package
default) of the PyTorch port against the JAX package and against dense
``eigh``: the eigensolver alone, its stacked form over zero-embedded
operators, the sector sweep at T=0 and at finite T, and two iterations of
the Bethe loop with the package defaults. DMFT_ED_RAGGED=1 puts both
packages on their batched routes (the p2-bucket stacked restart).

Bounds, measured on these configs (Nbath=4-5, dims <= 100):

* eigenvalues of one sector (dim 100, k=6, ncv=23): within 1e-12 of JAX
  and of dense eigh with ``native`` products (measured 7.1e-15 and
  8.0e-15, 91 matvecs in both packages); with ``ozaki5x7`` within 1e-12
  of JAX (measured 1.4e-14: the same digits on the same vectors; both
  run to maxiter, 516 matvecs, since the residual test at 1e-12 sits
  below the digits' ~1e-10) and 1e-9 of dense eigh (measured 6.4e-11);
* Ritz vectors: compared as the projector onto the k computed states
  (states within a sector can be degenerate, so raw vectors may differ
  by a rotation), within 1e-9 (measured 2.0e-15 native, 1.4e-11
  ozaki5x7); residual |Hv - ev| 1e-8 (measured 7.9e-14, 4.9e-11);
* the stacked restart over zero-embedded operators against the
  per-sector solve of the port: eigenvalues 1e-12 (measured 7.1e-15),
  projectors 1e-9 (measured 2.4e-15), and exact zeros on the pad;
* the sweep: the same kept sectors (in energy order up to the swap of
  degenerate twins) and the same neigen_sector / lanc_nstates_total
  feedback as JAX, energies and zeta within 1e-12 (measured 8.0e-15 and
  6.4e-15); at finite T the eighth kept state sits 3.5e-2 below the
  ninth, so no ulp can change which states are kept;
* the two-iteration loop (U=3): docc of iteration 1 within 1e-9
  (measured 2e-16), iteration 2 within 1e-6 (measured 1.7e-9) and the
  fitted bath within 1e-3 (measured 2.4e-5). At U=2 the port's fit stops
  early (chi^2 1.1e-5 after 9 L-BFGS-B steps, where the JAX package's
  reaches 4.7e-7 in 22) on inputs 2e-15 apart: the fit's stopping rule,
  not the solve, parts the packages there.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dmft_ed_tpu.bath as jbath
import dmft_ed_tpu.config as jconfig
import dmft_ed_tpu.diag as jdiag
import dmft_ed_tpu.hamiltonian as jham
import dmft_ed_tpu.lanczos as jlanczos
import dmft_ed_tpu.models.hm_bethe as jbethe
import dmft_ed_tpu.sectors as jsectors
import dmft_ed_tpu.solver as jsolver
import dmft_ed_tpu_torch.bath as tbath
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.diag as tdiag
import dmft_ed_tpu_torch.hamiltonian as tham
import dmft_ed_tpu_torch.lanczos as tlanczos
import dmft_ed_tpu_torch.models.hm_bethe as tbethe
import dmft_ed_tpu_torch.sectors as tsectors
import dmft_ed_tpu_torch.solver as tsolver


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


@pytest.fixture(autouse=True)
def _batched_routes(monkeypatch):
    monkeypatch.setenv("DMFT_ED_RAGGED", "1")


def _cfgs(**kw):
    base = dict(norb=1, nbath=4, nspin=1, uloc=(2.0,), xmu=0.1,
                ed_verbose=0)
    base.update(kw)
    return (jconfig.EDConfig(**base).validate(),
            tconfig.EDConfig(**base).validate())


def _baths(jcfg, tcfg, seed):
    rng = np.random.default_rng(seed)
    jb, tb = jbath.Bath(jcfg), tbath.Bath(tcfg)
    jb.e[:] = rng.uniform(-1.0, 1.0, jb.e.shape)
    jb.v[:] = rng.uniform(0.3, 0.7, jb.v.shape)
    tb.e[:], tb.v[:] = jb.e, jb.v
    return jb, tb


def _hams(prec, qns, seed=7):
    jcfg, tcfg = _cfgs(matmul_precision=prec)
    jb, tb = _baths(jcfg, tcfg, seed)
    hloc = np.zeros((1, 1, 1, 1))
    out = []
    for qn in qns:
        js = jsectors.sector_table(jcfg).get(*qn)
        ts = tsectors.sector_table(tcfg).get(*qn)
        out.append((jham.build_sector_hamiltonian(jcfg, js, jb, hloc),
                    tham.build_sector_hamiltonian(tcfg, ts, tb, hloc)))
    return jcfg, tcfg, out


def _v0(tcfg, dim, seed):
    return tdiag._draw_v0(tcfg, False, dim, np.random.default_rng(seed),
                          "cpu")


def _projector(vecs):
    V = np.asarray(vecs)
    return V.T @ V.conj()


@pytest.mark.parametrize("prec", ["native", "ozaki5x7"])
def test_eigs_lanczos_op_vs_jax_and_eigh(prec):
    jcfg, tcfg, ((hj, ht),) = _hams(prec, [(2, 2)])
    v0 = _v0(tcfg, ht.sector.dim, 11)
    k, ncv = 6, 23
    ej, vj, nj = jlanczos.eigs_lanczos_op(
        *_jop(hj, jcfg), jnp.asarray(v0.numpy()), k, ncv, maxiter=512)
    spec, arrays, blocks = tham.make_matvec_op(ht, tcfg, "cpu")
    et, vt, nt = tlanczos.eigs_lanczos_op(spec, blocks, arrays, v0, k, ncv,
                                          maxiter=512)
    exact = np.linalg.eigvalsh(tham.assemble_dense(ht))[:k]
    assert nj == nt
    assert np.max(np.abs(np.asarray(ej) - et)) <= 1e-12
    assert np.max(np.abs(et - exact)) <= (1e-12 if prec == "native" else 1e-9)
    assert np.max(np.abs(_projector(vj) - _projector(vt.numpy()))) <= 1e-9
    H = tham.assemble_dense(ht)
    V = vt.numpy()
    assert np.max(np.abs(V @ H - et[:, None] * V)) <= 1e-8


def _jop(hj, jcfg):
    spec, arrays, blocks = jham.make_matvec_op(hj, jcfg)
    return spec, blocks, arrays


def test_eigs_lanczos_callable_vs_eigh():
    """The callable-matvec form on a dense Hermitian matrix, complex."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(60, 60)) + 1j * rng.normal(size=(60, 60))
    H = torch.as_tensor(A + A.conj().T)
    v0 = torch.as_tensor(rng.normal(size=60) + 1j * rng.normal(size=60))
    e, V, _ = tlanczos.eigs_lanczos(lambda x: H @ x, v0, 4, 16)
    exact, U = np.linalg.eigh(H.numpy())
    assert np.max(np.abs(e - exact[:4])) <= 1e-10
    assert np.max(np.abs(_projector(V.numpy()) - _projector(U[:, :4].T))) \
        <= 1e-8


def test_stacked_padded_restart_vs_per_sector():
    """eigs_lanczos_op_stacked over sectors of three shapes zero-embedded
    in one 10x10 block: each member's spectrum and states are those of
    its own per-sector solve, and the pad stays exactly zero."""
    qns = [(1, 2), (2, 1), (2, 2)]
    _, tcfg, hams = _hams("native", qns)
    hts = [h for _, h in hams]
    ddw = max(h.sector.blocks[0].ddw for h in hts)
    dup = max(h.sector.blocks[0].dup for h in hts)
    nu = max(h.hup[0].rows.size for h in hts)
    nd = max(h.hdw[0].rows.size for h in hts)
    ops, v0s, per = [], [], []
    V0 = torch.zeros((len(hts), ddw * dup), dtype=torch.float64)
    for s, h in enumerate(hts):
        sp, ar, bl = tham.make_padded_matvec_op(h, tcfg, ddw, dup, nu, nd,
                                                "cpu")
        ops.append(ar)
        b = h.sector.blocks[0]
        v0 = _v0(tcfg, h.sector.dim, 20 + s)
        V0[s].view(ddw, dup)[:b.ddw, :b.dup] = v0.reshape(b.ddw, b.dup)
        spec, arrays, blocks = tham.make_matvec_op(h, tcfg, "cpu")
        per.append(tlanczos.eigs_lanczos_op(spec, blocks, arrays, v0, 6, 23,
                                            maxiter=512))
    stacked = tuple(torch.stack([o[i] for o in ops])
                    for i in range(len(ops[0])))
    evals, evecs, _ = tlanczos.eigs_lanczos_op_stacked(
        sp, bl, stacked, V0, 6, 23, maxiter=512)
    for s, h in enumerate(hts):
        b = h.sector.blocks[0]
        e_ref, v_ref, _ = per[s]
        k = len(e_ref)
        assert np.max(np.abs(evals[s, :k] - e_ref)) <= 1e-12
        assert np.all(np.isinf(evals[s, k:]))
        vec = evecs[s].reshape(-1, ddw, dup)
        assert torch.count_nonzero(vec[:, b.ddw:, :]) == 0
        assert torch.count_nonzero(vec[:, :, b.dup:]) == 0
        inner = vec[:, :b.ddw, :b.dup].reshape(len(vec), -1).numpy()
        assert np.max(np.abs(_projector(inner)
                             - _projector(v_ref.numpy()))) <= 1e-9


def test_stacked_restart_refuses_a_mesh():
    """The stacked restart takes a parallel.Mesh (its sites-sharded form is
    held in tests/test_torch_parallel.py) and refuses anything else."""
    with pytest.raises(TypeError, match="parallel.Mesh"):
        tlanczos.eigs_lanczos_op_stacked((), (), (), torch.zeros(1, 4), 1, 3,
                                         mesh=object())


@pytest.mark.parametrize("ntot,beta", [(1, 50.0), (8, 20.0)],
                         ids=["T=0", "finite-T"])
def test_diagonalize_arpack_vs_jax(ntot, beta, monkeypatch):
    """The sector sweep on the thick restart (serial and p2-bucket
    stacked), at T=0 and at finite T with lanc_nstates_total=8."""
    jcfg, tcfg = _cfgs(nbath=5, beta=beta, lanc_dim_threshold=8,
                       lanc_nstates_total=ntot)
    jb, tb = _baths(jcfg, tcfg, 5)
    hloc = np.zeros((1, 1, 1, 1))
    calls = []
    stacked = tlanczos.eigs_lanczos_op_stacked
    monkeypatch.setattr(tlanczos, "eigs_lanczos_op_stacked",
                        lambda *a, **k: calls.append(a[3].shape[0])
                        or stacked(*a, **k))
    sj, zj, stj = jdiag.diagonalize(jcfg, jb, hloc)
    st, zt, stt = tdiag.diagonalize(tcfg, tb, hloc, device="cpu")
    assert calls and all(n >= 2 for n in calls)
    # degenerate twins (nup, ndw) / (ndw, nup) may swap places in the
    # energy order: compare the kept sectors as a multiset
    assert sorted(s.sector.index for s in sj) == \
        sorted(s.sector.index for s in st)
    assert np.max(np.abs(np.array([s.energy for s in sj])
                         - np.array([s.energy for s in st]))) <= 1e-12
    assert abs(zj - zt) <= 1e-12
    assert stj.neigen_sector == stt.neigen_sector
    assert stj.lanc_nstates_total == stt.lanc_nstates_total
    if ntot > 1:
        assert len(st) == ntot
        # the kept list ends well clear of the next level
        assert stt.lanc_nstates_total == ntot + 2


def test_hm_bethe_defaults_two_iterations(tmp_path, monkeypatch):
    """Two Bethe-loop iterations with the package defaults (arpack,
    native) in both packages."""
    out = {}
    for name, C, S, H, extra in (
            ("jax", jconfig, jsolver, jbethe, {}),
            ("torch", tconfig, tsolver, tbethe, {"device": "cpu"})):
        cfg = C.EDConfig(norb=1, nbath=4, nspin=1, uloc=(3.0,), beta=50.0,
                         lmats=256, lreal=32, lanc_dim_threshold=8,
                         ed_verbose=0, nloop=2, dmft_error=1e-15).validate()
        assert cfg.lanc_method == "arpack"
        assert cfg.matmul_precision == "native"
        solver = S.EDSolver(cfg, np.zeros((1, 1, 1, 1)), log=lambda m: None,
                            **extra)
        docc = []

        def log(msg, solver=solver, docc=docc):
            if msg.startswith("--- DMFT loop") and solver.result is not None:
                docc.append(solver.result.observables.docc.copy())

        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        r = H.run(cfg, le=300, wmixing=0.5, solver=solver, log=log)
        docc.append(r.docc.copy())
        out[name] = (r, docc)
    (a, da), (t, dt) = out["jax"], out["torch"]
    assert a.iterations == t.iterations == 2
    assert np.max(np.abs(da[0] - dt[0])) <= 1e-9
    assert np.max(np.abs(da[1] - dt[1])) <= 1e-6
    assert np.max(np.abs(a.bath - t.bath)) <= 1e-3
    assert np.all((t.docc > 0) & (t.docc < 0.25))
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "torch"))
