"""The backend-parity contract on the card's route (slow, needs a card:
``python -m pytest -m "slow and gpu" tests/test_torch_slow_bethe.py``).

tests/test_torch_backend_parity.py runs tests/test_dmft_bethe.py:46's
loop on the CPU's default route. Here the same loop (Nbath=6, beta=100,
plain Lanczos, driven to dmft_error=1e-7 in at most 80 iterations) runs on
``device="cuda"``, where ``device.ragged_batching`` puts it on the batched
route (the whole-sweep lockstep diag and the stacked GF chains), under
``native`` and ``ozaki5x7`` (the kernel inside every sector product). It
is held to the same contract (PERF_NOTES.md:143-168): docc within 2e-3,
dens 1e-3, Z 2e-3, Egs 0.1 and every loop's error below 5e-6; the card's
ozaki5x7 fixed point against its native one, and its native one against
the JAX package's CPU fixed point, embedded below as the constants that
``python3 chip_reference.py --case backend_parity`` prints (so this file
imports neither jax nor the JAX package).
"""

import contextlib

import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (the OpenBLAS that threadpoolctl limits)
import torch
try:
    from threadpoolctl import threadpool_limits
except ImportError:           # without it the BLAS pools keep their size
    def threadpool_limits(limits=None):
        return contextlib.nullcontext()

from dmft_ed_tpu_torch.config import EDConfig
from dmft_ed_tpu_torch.device import ragged_batching
from dmft_ed_tpu_torch.kernels import digit_matmul
from dmft_ed_tpu_torch.models import hm_bethe

# tests/test_torch_backend_parity.py's CFG and RUN
CFG = dict(norb=1, nbath=6, nspin=1, uloc=(2.0,), beta=100.0, lmats=512,
           lreal=64, lfit=512, nloop=80, dmft_error=1e-7, ed_verbose=0,
           lanc_method="lanczos", lanc_niter=256, lanc_ngfiter=200,
           lanc_dim_threshold=32)
RUN = dict(le=300, wmixing=0.5)
# chip_reference.py --case backend_parity: the JAX package's native fixed
# point on its default CPU route (80 iterations, error 4.44e-6)
JAX_FIXED_POINT = (np.array([0.08231027421129389]),
                   np.array([0.9999284455677391]),
                   -5.166432775023027, 0.2602736393845727)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _fixed_point(r, beta):
    z = 1.0 / (1.0 - r.smats[0, 0, 0, 0, 0].imag / (np.pi / beta))
    return r.docc.copy(), r.dens.copy(), r.egs, z


def _diffs(label, a, b):
    print(f"{label}: |d docc| {np.max(np.abs(b[0] - a[0])):.3e} (2e-3), "
          f"|d dens| {np.max(np.abs(b[1] - a[1])):.3e} (1e-3), "
          f"|d egs| {abs(b[2] - a[2]):.3e} (0.1), "
          f"|d Z| {abs(b[3] - a[3]):.3e} (2e-3)", flush=True)


def _hold(a, b):
    np.testing.assert_allclose(b[0], a[0], atol=2e-3)      # docc
    np.testing.assert_allclose(b[1], a[1], atol=1e-3)      # dens
    assert abs(b[2] - a[2]) < 0.1, (a[2], b[2])            # Egs (loose)
    assert abs(b[3] - a[3]) < 2e-3, (a[3], b[3])           # Z


@pytest.mark.slow
@pytest.mark.gpu
def test_card_backend_parity(tmp_path, monkeypatch):
    """Both loops run and every compared quantity is printed (run with
    ``-s``) before the checks, so one run shows the whole contract."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert ragged_batching(torch.device("cuda"))
    runs, res, launches = {}, {}, {}
    for prec in ("native", "ozaki5x7"):
        (tmp_path / prec).mkdir()
        monkeypatch.chdir(tmp_path / prec)
        cfg = EDConfig(**CFG, matmul_precision=prec).validate()
        n0 = digit_matmul.launches
        r = hm_bethe.run(cfg, log=lambda *a, **k: None, device="cuda", **RUN)
        launches[prec] = digit_matmul.launches - n0
        runs[prec], res[prec] = r, _fixed_point(r, CFG["beta"])
        # error.err's first line is iteration 2's error
        tail = np.loadtxt("error.err", ndmin=2)[38:79, 1]
        print(f"{prec}: {r.iterations} iterations, error {r.error:.3e} "
              f"(5e-6), docc {r.docc[0]!r}, dens {r.dens[0]!r}, "
              f"egs {r.egs!r}, Z {res[prec][3]!r}, {launches[prec]} kernel "
              f"launches; iterations 40-{r.iterations}: median error "
              f"{np.median(tail):.3e}, share above 5e-6 "
              f"{np.mean(tail > 5e-6):.3f}", flush=True)
    _diffs("ozaki5x7 against native", res["native"], res["ozaki5x7"])
    _diffs("native against the JAX fixed point", JAX_FIXED_POINT,
           res["native"])
    assert launches["native"] == 0 and launches["ozaki5x7"] > 0
    for prec, r in runs.items():
        assert r.error < 5e-6, f"{prec}: err={r.error}"
    _hold(res["native"], res["ozaki5x7"])
    _hold(JAX_FIXED_POINT, res["native"])
