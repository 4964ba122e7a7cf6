"""The backend-parity contract on the port (slow; run with
``tests/run_slow.sh`` or ``python -m pytest
tests/test_torch_backend_parity.py -m slow``): the counterpart of
tests/test_dmft_bethe.py::test_backend_parity_ozaki_vs_native.

The Bethe loop at Nbath=6, beta=100, plain Lanczos, driven to
dmft_error=1e-7, on the CPU with both packages' default CPU routes (the
per-sector Krylov engines, as the JAX test runs): the port's ``ozaki5x7``
fixed point (its Ozaki products through the kernel's plain version, which
is bitwise equal to the kernel) against the port's ``native`` one, and
the port's native fixed point against the JAX package's, each held to the
contract of PERF_NOTES.md:143-168: docc within 2e-3, dens within 1e-3, Z
within 2e-3, Egs within 0.1 (it tracks the bath fit's micro-state), and
every loop's error below 5e-6. About 17,000 matvecs per ozaki5x7
iteration, two tiny Ozaki products each at ~1 ms of host work: the
ozaki5x7 loop takes most of the test's ~31 minutes.
"""

import contextlib

import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads the OpenBLAS of jax's LAPACK calls)
import torch
try:
    from threadpoolctl import threadpool_limits
except ImportError:           # without it the BLAS pools keep their size
    def threadpool_limits(limits=None):
        return contextlib.nullcontext()

from dmft_ed_tpu.config import EDConfig as JEDConfig
from dmft_ed_tpu.models import hm_bethe as jhm_bethe
from dmft_ed_tpu_torch.config import EDConfig
from dmft_ed_tpu_torch.models import hm_bethe

CFG = dict(norb=1, nbath=6, nspin=1, uloc=(2.0,), beta=100.0, lmats=512,
           lreal=64, lfit=512, nloop=80, dmft_error=1e-7, ed_verbose=0,
           lanc_method="lanczos", lanc_niter=256, lanc_ngfiter=200,
           lanc_dim_threshold=32)
RUN = dict(le=300, wmixing=0.5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread and one BLAS thread (see
    tests/test_torch_nano.py): the products here are 35x35 at most."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _fixed_point(r, beta):
    assert r.error < 5e-6, f"err={r.error}"
    z = 1.0 / (1.0 - r.smats[0, 0, 0, 0, 0].imag / (np.pi / beta))
    return r.docc.copy(), r.dens.copy(), r.egs, z


def _hold(a, b):
    np.testing.assert_allclose(b[0], a[0], atol=2e-3)      # docc
    np.testing.assert_allclose(b[1], a[1], atol=1e-3)      # dens
    assert abs(b[2] - a[2]) < 0.1, (a[2], b[2])            # Egs (loose)
    assert abs(b[3] - a[3]) < 2e-3, (a[3], b[3])           # Z


@pytest.mark.slow
def test_port_backend_parity(tmp_path, monkeypatch):
    res = {}
    for prec in ("native", "ozaki5x7"):
        monkeypatch.chdir(tmp_path)
        (tmp_path / prec).mkdir()
        monkeypatch.chdir(tmp_path / prec)
        cfg = EDConfig(**CFG, matmul_precision=prec).validate()
        res[prec] = _fixed_point(hm_bethe.run(
            cfg, log=lambda *a, **k: None, device="cpu", **RUN), cfg.beta)
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    cfg = JEDConfig(**CFG, matmul_precision="native").validate()
    jax_native = _fixed_point(jhm_bethe.run(cfg, log=lambda *a, **k: None,
                                            **RUN), cfg.beta)
    _hold(res["native"], res["ozaki5x7"])
    _hold(jax_native, res["native"])
