"""The JAX package's two slow Ozaki tests, on the port (slow;
``tests/run_slow.sh`` or ``python -m pytest tests/test_torch_slow_ozaki.py
-m slow``): tests/test_ozaki.py:91 ``test_pairwise_fallback_natural_k``
and :107 ``test_ozaki_dmft_physics_impact``, with their configs and
bounds, on the CPU (the kernel's plain version) and, marked ``gpu``, on
the card (``python -m pytest -m "slow and gpu" <file>`` there).

The card's case of the natural-K test reaches the kernel's pairwise
(``__dp4a``) route at K = 400,000 and 120,000 because ``ozaki._schedule``
picks it there, not because a test lowers the int32 limit (as
tests/test_torch_ozaki.py and chip_smoke.py's phase 2 do): one launch per
product, bitwise equal to the plain version on the same digit stacks. The
card's physics case launches the kernel inside every ozaki6 solve.

The file imports neither jax nor the JAX package; one torch and one BLAS
thread per test.
"""

import contextlib
import os
import tempfile

import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (the OpenBLAS that threadpoolctl limits)
import torch
try:
    from threadpoolctl import threadpool_limits
except ImportError:           # without it the BLAS pools keep their size
    def threadpool_limits(limits=None):
        return contextlib.nullcontext()

from dmft_ed_tpu_torch import ozaki
from dmft_ed_tpu_torch.bath import Bath, pack_bath
from dmft_ed_tpu_torch.config import EDConfig
from dmft_ed_tpu_torch.kernels import digit_matmul, digit_matmul_plain

DEVICES = ["cpu", pytest.param("cuda", marks=[
    pytest.mark.gpu, pytest.mark.skipif(not torch.cuda.is_available(),
                                        reason="needs a CUDA card")])]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("ns,bits,K", [(6, 6, 400_000), (5, 7, 120_000)])
def test_pairwise_fallback_natural_k(ns, bits, K, device):
    """K past the _cat_safe bound engages the fallback with the real
    int32 limit; adversarial values hit the max digit magnitude 2^{bits-1}
    on the two leading digits (the case where an int32 group accumulation
    could wrap): r = 1/2 - 2^{-bits-1} slices to digits (D, -D, 0, ...)."""
    rng = np.random.default_rng(6)
    assert not ozaki._cat_safe(K, ns, bits)
    v = 0.5 - 2.0 ** (-bits - 1)
    A = np.where(rng.random((4, K)) < 0.5, v, -v)
    B = np.where(rng.random((K, 4)) < 0.5, v, -v)
    exact = A @ B
    At = torch.as_tensor(A, device=device)
    Bt = torch.as_tensor(B, device=device)
    n0 = digit_matmul.launches
    got = ozaki.matmul(At, Bt, ns, bits).cpu().numpy()
    assert np.max(np.abs(got - exact)) / np.max(np.abs(exact)) < 1e-9
    if device == "cuda":
        # the schedule's own choice, launched once, as the plain version
        pairwise, kchunk = ozaki._schedule(K, ns, bits)
        assert pairwise and kchunk == K    # K is below the int32 chunk
        assert digit_matmul.launches == n0 + 1
        ad, sa = ozaki._left_digits(At, ns, bits)
        bd, sb = ozaki._right_digits(Bt, ns, bits)
        plain = digit_matmul_plain(ad, bd, sa.reshape(-1), sb.reshape(-1),
                                   bits, pairwise, kchunk, k=K)
        assert np.array_equal(got, plain.cpu().numpy())


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_ozaki_dmft_physics_impact(device):
    """matmul_precision='ozaki6' must not change the physics — the
    correctness bar the reference sets with CPU BLAS dgemm (VERDICT round
    1, item 6). Two comparisons against the exact-f64 matvec, with the
    Lanczos thresholds forced low so the ozaki path carries both the
    spectrum and the GF Krylov chains:

    (1) one full ed_solve at a FIXED bath: docc/egs/G(iw) to ~1e-9;
    (2) one full DMFT iteration (solve + Gloc + Weiss + chi2 fit + solve
        map applied once): docc to ~1e-10, Sigma(iw1) to ~1e-8.

    Longer trajectories CANNOT be compared at this precision — measured on
    this config, the Nbath=4 chi^2 valley is ~1e-3 flat in Delta(iw), so
    any perturbation (ozaki rounding, a different Lanczos seed) walks the
    fit to a different but equivalent bath within ~2 iterations; the
    per-application ozaki effect measured here (1e-13 on docc) is 10
    orders below that discretization floor."""
    from dmft_ed_tpu_torch.solver import EDSolver
    from dmft_ed_tpu_torch.models import hm_bethe

    def mkcfg(prec, **kw):
        return EDConfig(norb=1, nbath=4, nspin=1, uloc=(2.0,), beta=50.0,
                        lmats=256, lreal=32, lanc_dim_threshold=8,
                        dense_matmul_threshold=4096, matmul_precision=prec,
                        ed_verbose=0, **kw).validate()

    # --- (1) fixed-bath solve
    results, launches = {}, {}
    for prec in ("ozaki6", "native"):
        cfg = mkcfg(prec)
        hloc = np.zeros((1, 1, 1, 1))
        s = EDSolver(cfg, hloc, log=lambda m: None, device=device)
        b = Bath(cfg)
        b.e[:] = np.array([-0.9, -0.2, 0.2, 0.9])
        b.v[:] = np.array([0.4, 0.5, 0.5, 0.4])
        cwd = os.getcwd()
        n0 = digit_matmul.launches
        with tempfile.TemporaryDirectory() as d:
            os.chdir(d)
            try:
                results[prec] = s.solve(pack_bath(b))
            finally:
                os.chdir(cwd)
        launches[prec] = digit_matmul.launches - n0
    r_oz, r_f64 = results["ozaki6"], results["native"]
    np.testing.assert_allclose(r_oz.egs, r_f64.egs, atol=1e-9)
    np.testing.assert_allclose(r_oz.observables.docc, r_f64.observables.docc,
                               atol=1e-9)
    np.testing.assert_allclose(r_oz.gmats, r_f64.gmats, atol=1e-8)

    # --- (2) one application of the full DMFT map
    traj = {}
    for prec in ("ozaki6", "native"):
        cfg = mkcfg(prec, nloop=1, dmft_error=1e-15)
        cwd = os.getcwd()
        n0 = digit_matmul.launches
        with tempfile.TemporaryDirectory() as d:
            os.chdir(d)
            try:
                traj[prec] = hm_bethe.run(cfg, le=300, wmixing=0.5,
                                          device=device)
            finally:
                os.chdir(cwd)
        launches[prec, "loop"] = digit_matmul.launches - n0
    t_oz, t_f64 = traj["ozaki6"], traj["native"]
    assert t_oz.iterations == t_f64.iterations == 1
    np.testing.assert_allclose(t_oz.docc, t_f64.docc, atol=1e-10)
    np.testing.assert_allclose(t_oz.smats[0, 0, 0, 0, 0],
                               t_f64.smats[0, 0, 0, 0, 0], atol=1e-8)
    if device == "cuda":       # the ozaki6 route ran through the kernel
        assert launches["ozaki6"] > 0 and launches["ozaki6", "loop"] > 0
        assert launches["native"] == launches["native", "loop"] == 0
