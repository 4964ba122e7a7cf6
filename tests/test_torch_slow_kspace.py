"""The slow k-space, multiband, spin-orbit and nano tests of the JAX
package, on the port (slow; ``tests/run_slow.sh`` or ``python -m pytest
tests/test_torch_slow_kspace.py -m slow``).

Each test keeps the config, the loop depth and the assertions of the JAX
test it ports and runs only the port: on the CPU (``device="cpu"``) and,
marked ``gpu``, on the card (``device="cuda"``, the batched route):

* tests/test_multiband_dos.py:87 ``test_hm_2bands_bethe_wratio`` and :102
  ``test_hm_multiband_square_loop``;
* tests/test_kspace_models.py:51 ``test_graphene_dmft_smoke``;
* tests/test_bhz_edge_afm.py:33 ``test_bhz_edge_afm_neel``;
* tests/test_nano_isoc_sq.py:54 ``test_nano_isoc_sq_dmft``;
* tests/test_soc.py:23 ``test_soc_replica_dmft_runs``;
* tests/test_twisted_blg.py:130 ``test_twisted_blg_dmft_smoke``.

The file imports neither jax nor the JAX package; one torch and one BLAS
thread per test.
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
def test_hm_2bands_bethe_wratio(tmp_path, monkeypatch, device):
    """Wratio=2 interacting loop: both orbitals half filled at ph
    symmetry; the wider band is less correlated (larger docc)."""
    monkeypatch.chdir(tmp_path)
    from dmft_ed_tpu_torch.models import hm_2bands_bethe
    cfg = EDConfig(norb=2, nbath=2, nspin=1, uloc=(1.6, 1.6), beta=50.0,
                   lmats=150, lreal=30, lfit=150, nloop=20, dmft_error=5e-4,
                   ed_verbose=0, lanc_dim_threshold=2048).validate()
    r = hm_2bands_bethe.run(cfg, wratio=2.0, sc_method=2, phsym=True,
                            log=lambda m: None, device=device)
    np.testing.assert_allclose(r.dens, [1.0, 1.0], atol=5e-3)
    assert r.docc[1] > r.docc[0] + 0.005


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_hm_multiband_square_loop(tmp_path, monkeypatch, device):
    """2 degenerate square bands (hybrid bath): converges to half filling
    with equal orbital densities (ed_hm_2b_square.f90 class)."""
    monkeypatch.chdir(tmp_path)
    from dmft_ed_tpu_torch.models import hm_multiband
    cfg = EDConfig(norb=2, nbath=2, nspin=1, uloc=(1.5, 1.5),
                   bath_type="hybrid", beta=50.0, lmats=120, lreal=30,
                   lfit=120, nloop=15, dmft_error=1e-3, ed_verbose=0,
                   lanc_dim_threshold=2048).validate()
    r = hm_multiband.run(cfg, model="2b_square", nk=10, ts=0.5,
                         log=lambda m: None, device=device)
    assert r.converged
    np.testing.assert_allclose(r.dens, [1.0, 1.0], atol=1e-2)
    np.testing.assert_allclose(r.dens[0], r.dens[1], atol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_graphene_dmft_smoke(tmp_path, monkeypatch, device):
    monkeypatch.chdir(tmp_path)
    from dmft_ed_tpu_torch.models import kspace
    cfg = EDConfig(norb=2, nspin=1, nbath=2, uloc=(1.5, 1.5),
                   bath_type="hybrid", beta=60.0, lmats=120, lreal=30,
                   lfit=120, nloop=8, dmft_error=1e-3, ed_verbose=0,
                   lanc_dim_threshold=1024).validate()
    hk = kspace.hk_graphene(nk=8, t=1.0)
    r = kspace.run_kspace(cfg, hk, wmixing=0.5, log=lambda m: None,
                          device=device)
    assert np.all(np.isfinite(r.dens))
    # half filling by sublattice symmetry
    np.testing.assert_allclose(r.dens.sum(), 2.0, atol=0.15)  # coarse 8x8 k-grid


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_bhz_edge_afm_neel(tmp_path, monkeypatch, device):
    """Interacting stripe with Néel seed: AFM order develops on the A-site
    impurities. Adjacent diagonal layers' A sites belong to the SAME Néel
    sublattice (the B partner within each cell carries the flipped
    moment), so the A moments share a sign
    (ed_bhz_2d_edge_afm.f90:158-210)."""
    monkeypatch.chdir(tmp_path)
    from dmft_ed_tpu_torch.models.bhz_edge_afm import run
    cfg = EDConfig(norb=2, nspin=2, nbath=2, uloc=(8.0, 8.0), ust=4.0,
                   beta=50.0, lmats=120, lreal=30, lfit=120, nloop=12,
                   dmft_error=1e-3, sb_field=0.5, ed_verbose=0,
                   lanc_dim_threshold=1500).validate()
    r = run(cfg, ly=3, nkx=8, mh=1.0, llambda=0.3, wmixing=0.7,
            lysym=True, neelsym=True, log=lambda m: None, device=device)
    assert np.all(np.isfinite(r.dens))
    m = r.magz.sum(axis=1)            # per-ineq total moment
    assert np.abs(m).min() > 0.5      # Néel order developed on all layers
    assert m[0] * m[1] > 0            # same Néel sublattice
    np.testing.assert_allclose(r.dens.sum(axis=1), 2.0, atol=1e-2)


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_nano_isoc_sq_dmft(tmp_path, monkeypatch, device):
    """Interacting 3x3 isoc torus (one inequivalent site): chi0 with the
    converged Sigma is suppressed vs the bare one; Chern marker finite."""
    monkeypatch.chdir(tmp_path)
    from dmft_ed_tpu_torch.models.nano_isoc_sq import (
        square_torus_isoc_hij, post_chi0, run)
    cfg = EDConfig(norb=1, nspin=2, nbath=3, uloc=(2.0,), beta=30.0,
                   lmats=128, lreal=30, lfit=128, nloop=10, dmft_error=1e-3,
                   ed_verbose=0, lanc_dim_threshold=1024).validate()
    r = run(cfg, nx=3, t=1.0, lam=0.2, chern=True, log=lambda m: None,
            device=device)
    assert r.dmft.converged
    assert np.all(np.isfinite(r.chi0))
    assert r.chern is not None and np.all(np.isfinite(r.chern))
    # interactions suppress the bubble vs self_zero
    hij, l2i, pos = square_torus_isoc_hij(3, 1.0, 0.2)
    smats_lat = r.dmft.smats_ineq[l2i]
    chi0_bare, _ = post_chi0(cfg, hij, smats_lat, pos, self_zero=True,
                             write=False, device=device)
    assert r.chi0[0].max() < chi0_bare[0].max()


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_soc_replica_dmft_runs(tmp_path, monkeypatch, device):
    monkeypatch.chdir(tmp_path)
    from dmft_ed_tpu_torch.models import soc
    cfg = EDConfig(norb=3, nspin=2, nbath=1, uloc=(1.0, 1.0, 1.0), ust=0.5,
                   ed_mode="nonsu2", bath_type="replica", beta=50.0,
                   lmats=100, lreal=30, lfit=100, nloop=5, dmft_error=1e-3,
                   ed_verbose=0, lanc_dim_threshold=400,
                   lanc_nstates_sector=2, cg_niter=200).validate()
    r = soc.run(cfg, nk=4, t=0.5, soc=0.25, wmixing=0.5, log=lambda m: None,
                device=device)
    assert np.all(np.isfinite(r.dens))
    assert r.error < 0.2
    # SOC splits the t2g manifold: orbital densities are not all equal
    assert np.ptp(r.dens) > 0.05
    # spin-off-diagonal self-energy components are generated
    assert np.max(np.abs(r.smats[0, 1])) > 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_twisted_blg_dmft_smoke(tmp_path, monkeypatch, device):
    """28-site moiré DMFT loop (cross-site batched sweep): finite
    observables, global half filling at ph-symmetric U."""
    monkeypatch.chdir(tmp_path)
    from dmft_ed_tpu_torch.models import twisted_blg as tb
    cfg = EDConfig(norb=1, nbath=2, nspin=1, uloc=(2.0,), beta=20.0,
                   lmats=80, lreal=20, lfit=80, nloop=4, dmft_error=1e-2,
                   ed_verbose=0, lanc_dim_threshold=512).validate()
    r = tb.run(cfg, m0=1, r=1, nk=2, wmixing=0.7, log=lambda m: None,
               device=device)
    assert np.all(np.isfinite(r.dens)) and np.all(np.isfinite(r.docc))
    assert r.dens.shape == (28,)
    # ph-symmetric interacting bilayer: total filling = Nlat
    assert abs(r.dens.mean() - 1.0) < 0.05
