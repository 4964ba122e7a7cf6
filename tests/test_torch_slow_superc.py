"""The JAX package's slow superconducting lattice tests, on the port (slow;
``tests/run_slow.sh`` or ``python -m pytest
tests/test_torch_slow_superc.py -m slow``).

Each test keeps the config, the loop depth and the assertions of the JAX
test it ports, line for line, and runs only the port: on the CPU
(``device="cpu"``) and, marked ``gpu``, on the card (``device="cuda"``,
the batched route; ``python -m pytest -m "slow and gpu" <file>`` there).
The anomalous joint fit has a flat valley, so two iterations cannot tell
the two packages apart (tests/test_torch_drivers_superc_lattice.py); the
physics at convergence can:

* tests/test_dmft_ahm.py:88 ``test_ahm_square_sc_phase``;
* tests/test_dmft_ahm.py:146 ``test_ahm_stack_u_heterostructure``;
* tests/test_dmft_ahm.py:168 ``test_ahm_stripe_u_modulated_sc``;
* tests/test_dmft_ahm.py:188 ``test_haldane_sc_sublattice_symmetry``;
* tests/test_models.py:102 ``test_ahm_disorder_pair_localization``;
* tests/test_new_drivers.py:205 ``test_nano_sc_flake``.

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

from dmft_ed_tpu_torch.config import EDConfig

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


@contextlib.contextmanager
def scratch_dir():
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            yield
        finally:
            os.chdir(cwd)


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_ahm_square_sc_phase(tmp_path, monkeypatch, device):
    """ed_ahm_square: attractive U on the square lattice at half filling
    orders superconductingly."""
    monkeypatch.chdir(tmp_path)
    from dmft_ed_tpu_torch.models import ahm_square
    cfg = EDConfig(norb=1, nbath=4, nspin=1, uloc=(-2.0,), ed_mode="superc",
                   deltasc=0.1, beta=80.0, lmats=200, lreal=40, lfit=200,
                   nloop=20, dmft_error=1e-4, ed_verbose=0,
                   lanc_dim_threshold=2048).validate()
    r = ahm_square.run(cfg, nk=16, ts=0.25, wmixing=0.5, phsym=True,
                       log=lambda m: None, device=device)
    assert r.error < 1e-3
    np.testing.assert_allclose(r.dens, [1.0], atol=5e-3)
    assert r.phisc[0] > 0.05


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_ahm_stack_u_heterostructure(tmp_path, monkeypatch, device):
    """ed_ahm_stackU: two-layer U heterostructure — the strong-|U| layer
    orders more strongly; the junction coupling alpha_join flows through
    the stack Bloch Hamiltonian."""
    monkeypatch.chdir(tmp_path)
    from dmft_ed_tpu_torch.models import ahm_stripe
    cfg = EDConfig(norb=1, nbath=3, nspin=1, uloc=(-3.0,), ed_mode="superc",
                   deltasc=0.1, beta=60.0, lmats=150, lreal=30, lfit=150,
                   nloop=12, dmft_error=1e-3, ed_verbose=0,
                   lanc_dim_threshold=2048).validate()
    r = ahm_stripe.run_stack(cfg, nlayers=2, n_umin=1, nk=6, nkz=4,
                             ts=0.25, t_perp=0.4, alpha_join=0.8,
                             u_min=-1.5, u_max=-3.0, wmixing=0.5,
                             log=lambda m: None, device=device)
    assert r.error < 1e-2
    np.testing.assert_allclose(r.dens, 1.0, atol=0.03)
    # layer 0 has U=-1.5, layer 1 has U=-3: stronger pairing on layer 1
    assert r.phisc[1] > r.phisc[0] > 0.0
    assert r.docc[1] > r.docc[0]


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_ahm_stripe_u_modulated_sc(tmp_path, monkeypatch, device):
    """ed_ahm_stripe: the strong-U stripe orders more strongly than the
    weak-U stripe; per-site U flows through the batched site sweep."""
    monkeypatch.chdir(tmp_path)
    from dmft_ed_tpu_torch.models import ahm_stripe
    cfg = EDConfig(norb=1, nbath=3, nspin=1, uloc=(-3.0,), ed_mode="superc",
                   deltasc=0.1, beta=60.0, lmats=150, lreal=30, lfit=150,
                   nloop=12, dmft_error=1e-3, ed_verbose=0,
                   lanc_dim_threshold=2048).validate()
    r = ahm_stripe.run(cfg, lx=2, ly=1, nk=8, ts=0.25, wmixing=0.5,
                       log=lambda m: None, device=device)
    assert r.error < 1e-2
    # exact ph symmetry pins n=1; tolerance set by the nbath=3 fit quality
    np.testing.assert_allclose(r.dens, 1.0, atol=0.03)
    # site 0 has U=-3, site 1 has U=-1.5: stronger pairing on site 0
    assert r.phisc[0] > r.phisc[1] > 0.0
    assert r.docc[0] > r.docc[1]


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_haldane_sc_sublattice_symmetry(tmp_path, monkeypatch, device):
    """ed_haldane_sc: attractive U on the honeycomb lattice; with mass=0
    the two sublattices are equivalent and both order."""
    monkeypatch.chdir(tmp_path)
    from dmft_ed_tpu_torch.models import haldane_sc
    cfg = EDConfig(norb=1, nbath=3, nspin=1, uloc=(-2.5,), ed_mode="superc",
                   deltasc=0.1, beta=60.0, lmats=150, lreal=30, lfit=150,
                   nloop=12, dmft_error=1e-3, ed_verbose=0,
                   lanc_dim_threshold=2048).validate()
    r = haldane_sc.run(cfg, nk=9, t1=0.5, wmixing=0.5, log=lambda m: None,
                       device=device)
    assert r.error < 1e-2
    np.testing.assert_allclose(r.dens, 1.0, atol=0.02)
    # Dirac semimetal at half filling: condensate is small but finite
    assert np.all(r.phisc > 0.005)
    np.testing.assert_allclose(r.phisc[0], r.phisc[1], atol=1e-4)


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_ahm_disorder_pair_localization(tmp_path, monkeypatch, device):
    monkeypatch.chdir(tmp_path)
    from dmft_ed_tpu_torch.models import ahm_disorder
    from dmft_ed_tpu_torch.models.nano import square_flake_hij
    cfg = EDConfig(norb=1, nbath=3, nspin=1, uloc=(-2.0,), ed_mode="superc",
                   deltasc=0.1, beta=60.0, lmats=120, lreal=30, lfit=120,
                   nloop=8, dmft_error=1e-3, ed_verbose=0,
                   lanc_dim_threshold=2048).validate()
    hij, _ = square_flake_hij(2, 2, t=0.25)
    rng = np.random.default_rng(7)
    eps = rng.uniform(-0.3, 0.3, 4)
    r = ahm_disorder.run(cfg, hij, eps, wmixing=0.5, log=lambda m: None,
                         device=device)
    assert r.error < 1e-2
    # attractive-U + hfmode at mu=0: pair occupation is marginal, disorder
    # localizes pairs on the lowest-eps sites (negative-U centers)
    assert 0.0 < r.dens.sum() < 8.0
    assert r.dens.max() > 1.5 and r.dens.min() < 0.5
    assert np.all(np.isfinite(r.phisc))


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_nano_sc_flake(device):
    """2x2 attractive-U flake through the superc real-space loop
    (ed_nano_sc.f90): all four corner sites are symmetry equivalent
    (1 ineq solve), uniform phi > 0 on every site at half filling."""
    from dmft_ed_tpu_torch.models import nano
    cfg = EDConfig(norb=1, nbath=2, nspin=1, ed_mode="superc",
                   uloc=(-3.0,), beta=20.0, lmats=96, lreal=32, nloop=4,
                   dmft_error=1e-15, ed_verbose=0).validate()
    hij, lat2ineq = nano.square_flake_hij(2, 2, t=1.0)
    with scratch_dir():
        r = nano.run_sc(cfg, hij, lat2ineq=lat2ineq, device=device)
    assert r.iterations == 4
    np.testing.assert_allclose(r.dens, 1.0, atol=1e-3)
    assert np.all(r.phisc > 0.05)
    assert np.ptp(r.phisc) < 1e-12     # equivalent sites share the solve
