"""``dtype="float32"`` in the port against the JAX package's float32 on the
CPU: the operator (float32 diagonal and operators, complex64 for complex
ones, no Ozaki digits), the plain-Lanczos and thick-restart sector solves,
the batched sweeps (the lockstep plain-Lanczos engine and the stacked
restart, DMFT_ED_RAGGED=1), a complex (nonsu2) sweep, whose start vectors
are complex128 in both packages so its Krylov vectors promote, one
hm_bethe iteration, and an ``ozaki5x7`` config under float32, which runs
plain float32 products and launches no digit product.

Both packages sum their float32 dot products in different orders, so they
agree only to float32's precision. Bounds, measured on these configs:

* the operator: 1e-6 of max|H v| (measured 0: the same float32
  products);
* sector and sweep ground energies: 1e-5 relative, the JAX package's own
  float32 tolerance (diag.py:211) (measured: plain Lanczos 5.1e-7 for the
  sector, 8.5e-8 for the lockstep sweep; the thick restart 0; nonsu2
  9.7e-16, its complex128 vectors);
* the float32 solves against the port's float64 ones: 1e-5 relative in egs
  (measured 5.3e-7);
* one hm_bethe iteration: egs 1e-5 relative (measured 9.0e-7), dens and
  docc 1e-4 (measured 9.1e-6 and 1.6e-6: the fit and the GF chains carry
  float32's differences up).
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
import dmft_ed_tpu.hamiltonian as jham
import dmft_ed_tpu.models.hm_bethe as jbethe
import dmft_ed_tpu.sectors as jsec
import dmft_ed_tpu_torch.bath as tbath
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.diag as tdiag
import dmft_ed_tpu_torch.hamiltonian as tham
import dmft_ed_tpu_torch.models.hm_bethe as tbethe
import dmft_ed_tpu_torch.sectors as tsec

TOL_EGS = 1e-5
TOL_OP = 1e-6
TOL_OBS = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread and one BLAS thread per test (see
    tests/test_torch_nano.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)

PKGS = (("jax", jconfig, jbath, jdiag, {}),
        ("torch", tconfig, tbath, tdiag, {"device": "cpu"}))


def _kw(**extra):
    kw = dict(norb=1, nbath=5, nspin=1, uloc=(2.0,), beta=50.0, lmats=64,
              lreal=16, lanc_dim_threshold=50, ed_verbose=0,
              dtype="float32")
    kw.update(extra)
    return kw


def _in_dir(path, fn):
    os.makedirs(path)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _bath(B, cfg):
    b = B.init_bath(cfg, np.zeros((cfg.nspin, cfg.nspin, cfg.norb,
                                   cfg.norb)))
    if b.u is not None:
        b.u[:] = 0.1
    return b


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1.0)


def test_operator_float32():
    """H v with the float32 operator: the same dtypes as the JAX package
    (float32 diagonal and dense operators) and values within float32."""
    out = {}
    for name, C, B, _, ex in PKGS:
        cfg = C.EDConfig(**_kw()).validate()
        S = jsec if name == "jax" else tsec
        sec = S.sector_table(cfg).get(3, 3)
        ham = (jham if name == "jax" else tham).build_sector_hamiltonian(
            cfg, sec, _bath(B, cfg), np.zeros((1, 1, 1, 1)))
        x = np.random.default_rng(3).normal(size=sec.dim).astype(np.float32)
        blk = sec.blocks[0]
        if name == "jax":
            import jax.numpy as jnp
            spec, arrays, _ = jham.make_matvec_op(ham, cfg)
            y = jham.apply_op(spec, arrays, (jnp.asarray(
                x.reshape(blk.ddw, blk.dup)),))[0]
            dts = {str(a.dtype) for a in arrays}
        else:
            spec, arrays, _ = tham.make_matvec_op(ham, cfg, "cpu")
            y = tham.apply_op(spec, arrays, (torch.as_tensor(
                x.reshape(blk.ddw, blk.dup)),))[0]
            dts = {str(a.dtype).replace("torch.", "") for a in arrays}
        out[name] = (np.asarray(y), spec[-1] if name == "jax"
                     else tham.vector_dtype(spec), dts)
    (yj, vj, dj), (yt, vt, dt) = out["jax"], out["torch"]
    assert vj == vt == "float32"
    assert yt.dtype == yj.dtype == np.float32
    assert dj == dt == {"float32"}
    assert np.max(np.abs(yt - yj)) <= TOL_OP * np.max(np.abs(yj))


@pytest.mark.parametrize("method", ["lanczos", "arpack"])
def test_sector_solve_float32(method, tmp_path):
    """One sector's plain-Lanczos (two-pass) or thick-restart solve in
    float32: egs against the JAX package's float32 and the port's float64,
    the ground state float32."""
    res = {}
    for name, C, B, D, ex in PKGS:
        for dt in ("float32", "float64"):
            cfg = C.EDConfig(**_kw(lanc_method=method, dtype=dt)).validate()
            S = jsec if name == "jax" else tsec
            H = jham if name == "jax" else tham
            sec = S.sector_table(cfg).get(3, 3)
            ham = H.build_sector_hamiltonian(cfg, sec, _bath(B, cfg),
                                             np.zeros((1, 1, 1, 1)))
            rng = np.random.default_rng(11)
            ev, vec = D._solve_sector_lanczos(cfg, ham, 2, rng, **ex)
            res[name, dt] = (float(ev[0]), str(vec.dtype))
    assert res["torch", "float32"][1].endswith("float32")
    assert res["jax", "float32"][1].endswith("float32")
    assert _rel(res["torch", "float32"][0], res["jax", "float32"][0]) \
        <= TOL_EGS
    assert _rel(res["torch", "float32"][0], res["torch", "float64"][0]) \
        <= TOL_EGS


@pytest.mark.parametrize("method", ["lanczos", "arpack"])
def test_sweep_float32(method, tmp_path, monkeypatch):
    """The whole sweep on the batched routes (the lockstep plain-Lanczos
    engine, or the stacked thick restart over zero-embedded operators)."""
    monkeypatch.setenv("DMFT_ED_RAGGED", "1")
    out = {}
    for name, C, B, D, ex in PKGS:
        cfg = C.EDConfig(**_kw(lanc_method=method)).validate()
        sl, z, _ = _in_dir(str(tmp_path / name), lambda: D.diagonalize(
            cfg, _bath(B, cfg), np.zeros((1, 1, 1, 1)), **ex))
        out[name] = (sl.emin, len(sl))
    assert out["torch"][1] == out["jax"][1]
    assert _rel(out["torch"][0], out["jax"][0]) <= TOL_EGS


def test_nonsu2_complex_float32(tmp_path):
    """A complex (nonsu2, spin-mixing) sweep in float32: complex64
    operators, the complex128 start vector promoting the Krylov vectors to
    complex128 in both packages; egs within float32."""
    kw = _kw(norb=1, nbath=3, nspin=2, uloc=(1.5,), ed_mode="nonsu2",
             lanc_dim_threshold=16)
    hloc = np.zeros((2, 2, 1, 1))
    hloc[0, 1, 0, 0] = hloc[1, 0, 0, 0] = 0.2
    out = {}
    for name, C, B, D, ex in PKGS:
        cfg = C.EDConfig(**kw).validate()
        b = _bath(B, cfg)
        sl, _, _ = _in_dir(str(tmp_path / name), lambda: D.diagonalize(
            cfg, b, hloc, **ex))
        H = jham if name == "jax" else tham
        S = jsec if name == "jax" else tsec
        sec = max(S.sector_table(cfg).sectors, key=lambda s: s.dim)
        spec = (H.make_matvec_op(H.build_sector_hamiltonian(
            cfg, sec, b, hloc), cfg, **ex))[0]
        vdt = {str(np.asarray(s.vector).dtype if name == "jax"
                   else s.vector.dtype).replace("torch.", "")
               for s in sl}
        out[name] = (sl.emin, spec[-1] if name == "jax"
                     else tham.vector_dtype(spec), vdt)
    assert out["jax"][1] == out["torch"][1] == "complex64"
    assert out["jax"][2] == out["torch"][2] == {"complex128"}
    assert _rel(out["torch"][0], out["jax"][0]) <= TOL_EGS


def test_hm_bethe_float32(tmp_path, monkeypatch):
    """One hm_bethe iteration (the sweep, the GF chains, the fit) in
    float32."""
    monkeypatch.setenv("DMFT_ED_RAGGED", "1")
    out = {}
    for name, C, mod, ex in (("jax", jconfig, jbethe, {}),
                             ("torch", tconfig, tbethe, {"device": "cpu"})):
        cfg = C.EDConfig(**_kw(nbath=4, lanc_method="lanczos",
                               lanc_dim_threshold=8, nloop=1,
                               lmats=256)).validate()
        out[name] = _in_dir(str(tmp_path / name), lambda: mod.run(
            cfg, le=200, log=lambda *a, **k: None, **ex))
    j, t = out["jax"], out["torch"]
    assert _rel(t.egs, j.egs) <= TOL_EGS
    np.testing.assert_allclose(t.dens, j.dens, atol=TOL_OBS)
    np.testing.assert_allclose(t.docc, j.docc, atol=TOL_OBS)


def test_ozaki_config_float32_runs_plain(tmp_path, monkeypatch):
    """matmul_precision="ozaki5x7" under float32 encodes no Ozaki digits
    and calls no digit product: the sweep equals the native float32 one."""
    from dmft_ed_tpu_torch import ozaki

    def refuse(*a, **k):
        raise AssertionError("a digit product ran under float32")
    monkeypatch.setattr(ozaki, "digit_matmul", refuse)
    cfgs = {p: tconfig.EDConfig(**_kw(matmul_precision=p)).validate()
            for p in ("native", "ozaki5x7")}
    sec = tsec.sector_table(cfgs["native"]).get(3, 3)
    ham = tham.build_sector_hamiltonian(cfgs["native"], sec,
                                        _bath(tbath, cfgs["native"]),
                                        np.zeros((1, 1, 1, 1)))
    specs = {p: tham.make_matvec_op(ham, c, "cpu")[0]
             for p, c in cfgs.items()}
    assert specs["native"] == specs["ozaki5x7"]
    assert not tham.op_kinds(specs["ozaki5x7"]) & {"ozl", "ozr", "ozf"}
    egs = {p: _in_dir(str(tmp_path / p), lambda: tdiag.diagonalize(
        c, _bath(tbath, c), np.zeros((1, 1, 1, 1)), device="cpu")[0].emin)
        for p, c in cfgs.items()}
    assert egs["native"] == egs["ozaki5x7"]
