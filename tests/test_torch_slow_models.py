"""The slow physics tests of tests/test_models.py, on the port (slow;
``tests/run_slow.sh`` or ``python -m pytest tests/test_torch_slow_models.py
-m slow``).

Each test keeps the config, the loop depth and the assertions of the JAX
test it ports and runs only the port: on the CPU (``device="cpu"``) and,
marked ``gpu``, on the card (``device="cuda"``, the batched route):

* :19 ``test_two_band_hund_hybrid``; :53 ``test_square_flake_realspace``;
* :72 ``test_afm_bethe_neel_state``; :86 ``test_slab_layer_resolved``;
* :150 ``test_tblg_dmft_valley_symmetry``; :180
  ``test_bhz_3d_band_insulator``; :194 ``test_graphene_afm_neel``;
* :224 ``test_material_driver_matches_bhz``; :259
  ``test_bhz_edge_layer_resolved_dmft``; :274 ``test_nano_isoc_hexagon``.

(tests/test_models.py:102, the superconducting ``ahm_disorder`` loop, is
in tests/test_torch_slow_superc.py.) The file imports neither jax nor the
JAX package; one torch and one BLAS thread per test.
"""

import contextlib
import os

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
from dmft_ed_tpu_torch.models import hm_bethe, bhz_2d, hm_square_lattice

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


@pytest.fixture
def rundir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_two_band_hund_hybrid(rundir, device):
    # nbath=4 shared levels: with 3, the orbital-orthogonality constraint of
    # the hybrid bath leaves orbital 2 a SINGLE level, which cannot sit at a
    # ph-symmetric position — dens[1] is then off half filling by ~2e-2 at
    # the true chi^2 minimum. 4 levels give each orbital a +/- pair.
    cfg = EDConfig(norb=2, nbath=4, nspin=1, uloc=(2.0, 2.0), ust=1.0,
                   jh=0.25, jx=0.25, jp=0.25, bath_type="hybrid", beta=100.0,
                   lmats=200, lreal=40, lfit=200, nloop=45, dmft_error=1e-4,
                   ed_verbose=0, lanc_dim_threshold=2048).validate()
    r = hm_bethe.run(cfg, le=200, wbethe=np.array([1.0, 0.8]), wmixing=0.4,
                     log=lambda m: None, device=device)
    assert r.error < 5e-3, r.error
    np.testing.assert_allclose(r.dens, [1.0, 1.0], atol=0.01)
    # the narrower band is the more correlated one
    assert r.docc[1] < r.docc[0] < 0.15


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_square_flake_realspace(rundir, device):
    cfg = EDConfig(norb=1, nbath=3, nspin=1, uloc=(2.0,), beta=100.0,
                   lmats=150, lreal=30, lfit=150, nloop=12, dmft_error=1e-4,
                   ed_verbose=0, lanc_dim_threshold=1024).validate()
    r = hm_square_lattice.run(cfg, lx=3, ly=3, ts=0.5, wmixing=0.5,
                              log=lambda m: None, device=device)
    assert r.error < 0.05
    # site-symmetry classes: corners(4) / edges(4) / center identical
    d = r.dens
    corners = [0, 2, 6, 8]
    edges = [1, 3, 5, 7]
    for grp in (corners, edges):
        np.testing.assert_allclose(d[grp], d[grp[0]], atol=1e-6)
    np.testing.assert_allclose(d.mean(), 1.0, atol=0.05)
    # docc well inside the correlated-metal range on every site
    assert np.all((r.docc > 0.02) & (r.docc < 0.25))


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_afm_bethe_neel_state(rundir, device):
    from dmft_ed_tpu_torch.models import hm_bethe_afm
    cfg = EDConfig(norb=1, nbath=4, nspin=2, uloc=(4.0,), beta=100.0,
                   sb_field=0.1, lmats=250, lreal=40, lfit=250, nloop=30,
                   dmft_error=1e-4, ed_verbose=0,
                   lanc_dim_threshold=4096).validate()
    r = hm_bethe_afm.run(cfg, wband=1.0, wmixing=0.6, log=lambda m: None,
                         device=device)
    assert r.error < 1e-3
    np.testing.assert_allclose(r.dens, [1.0], atol=1e-3)
    # deep AFM at U=4D: large staggered magnetization
    assert abs(r.magz[0]) > 0.8


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_slab_layer_resolved(rundir, device):
    from dmft_ed_tpu_torch.models import hm_slab
    cfg = EDConfig(norb=1, nbath=3, nspin=1, uloc=(2.0,), beta=80.0,
                   lmats=150, lreal=30, lfit=150, nloop=12, dmft_error=1e-3,
                   ed_verbose=0, lanc_dim_threshold=1024).validate()
    r = hm_slab.run(cfg, nlayers=4, nk=10, t=0.25, t_perp=0.25,
                    wmixing=0.5, log=lambda m: None, device=device)
    assert r.error < 1e-2
    np.testing.assert_allclose(r.dens, 1.0, atol=1e-3)
    # mirror symmetry + surface layers more correlated than bulk
    assert abs(r.docc[0] - r.docc[3]) < 1e-8
    assert abs(r.docc[1] - r.docc[2]) < 1e-8
    assert r.docc[0] < r.docc[1]


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_tblg_dmft_valley_symmetry(rundir, device):
    """4-site tBLG loop: densities respect the valley degeneracy
    (site i and site i+2 are time-reversal partners on a symmetric grid)."""
    from dmft_ed_tpu_torch.models import tblg
    idx, t = tblg.synthetic_hopping(rng=3)
    # meV-scale bandwidth: pick U of the same order
    cfg = EDConfig(norb=1, nbath=3, nspin=1, uloc=(2.0,), beta=30.0,
                   lmats=120, lreal=30, lfit=120, nloop=8, dmft_error=1e-3,
                   ed_verbose=0, lanc_dim_threshold=1024).validate()
    r = tblg.run(cfg, idx, t, nk=6, wmixing=0.6, log=lambda m: None,
                 device=device)
    assert r.error < 5e-2
    assert np.all(np.isfinite(r.dens)) and np.all(np.isfinite(r.docc))
    np.testing.assert_allclose(r.dens[0], r.dens[2], atol=5e-3)
    np.testing.assert_allclose(r.dens[1], r.dens[3], atol=5e-3)


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_bhz_3d_band_insulator(rundir, device):
    from dmft_ed_tpu_torch.models import bhz_3d
    cfg = EDConfig(norb=2, nspin=2, nbath=2, uloc=(1.0, 1.0), ust=0.5,
                   beta=100.0, lmats=150, lreal=40, lfit=150, nloop=15,
                   dmft_error=1e-4, ed_verbose=0,
                   lanc_dim_threshold=1200).validate()
    r = bhz_3d.run(cfg, nk=6, mh=2.0, llambda=0.3, wmixing=0.5,
                   log=lambda m: None, device=device)
    assert r.error < 1e-3, r.error
    np.testing.assert_allclose(r.dens.sum(), 2.0, atol=0.02)
    assert r.dens[1] - r.dens[0] > 0.5


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_graphene_afm_neel(rundir, device):
    """ed_graphene_afm: honeycomb Neel order — staggered magnetization
    with exact sublattice antisymmetry at large U."""
    from dmft_ed_tpu_torch.models import kspace_afm
    cfg = EDConfig(norb=1, nbath=4, nspin=2, uloc=(4.0,), beta=100.0,
                   sb_field=0.1, lmats=200, lreal=30, lfit=200, nloop=25,
                   dmft_error=1e-3, ed_verbose=0,
                   lanc_dim_threshold=4096).validate()
    r = kspace_afm.run_graphene(cfg, nk=9, t=0.5, wmixing=0.6,
                                log=lambda m: None, device=device)
    assert r.error < 1e-2
    np.testing.assert_allclose(r.dens, 1.0, atol=1e-2)
    m = r.magz[:, 0]
    assert abs(m[0]) > 0.5
    np.testing.assert_allclose(m[0], -m[1], atol=1e-2)


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_material_driver_matches_bhz(rundir, device):
    """ed_STO-class flow: the hkfile-driven driver reproduces the analytic
    BHZ driver's converged observables from the same H(k)."""
    from dmft_ed_tpu_torch.models import material
    hk, _ = bhz_2d.build_hk_grid(8, mh=1.0, llambda=0.3)
    ks = np.linspace(-np.pi, np.pi, 8, endpoint=False)
    kpts = np.array([[kx, ky, 0.0] for kx in ks for ky in ks])
    material.write_hk_w90("hkfile.in", hk, kpts, nd=4)
    cfg = EDConfig(norb=2, nspin=2, nbath=2, uloc=(1.0, 1.0), ust=0.5,
                   beta=100.0, lmats=150, lreal=40, lfit=150, nloop=15,
                   dmft_error=1e-4, ed_verbose=0,
                   lanc_dim_threshold=1200).validate()
    r1 = material.run(cfg, "hkfile.in", log=lambda m: None, device=device)
    r2 = bhz_2d.run(cfg, nk=8, mh=1.0, llambda=0.3, log=lambda m: None,
                    device=device)
    assert r1.converged
    np.testing.assert_allclose(r1.dens, r2.dens, atol=1e-3)


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_bhz_edge_layer_resolved_dmft(rundir, device):
    from dmft_ed_tpu_torch.models import bhz_edge
    cfg = EDConfig(norb=2, nspin=2, nbath=2, uloc=(1.0, 1.0), ust=0.5,
                   beta=100.0, lmats=150, lreal=40, lfit=150, nloop=12,
                   dmft_error=1e-3, ed_verbose=0,
                   lanc_dim_threshold=1200).validate()
    r = bhz_edge.run(cfg, ly=4, nkx=10, mh=1.0, llambda=0.3, wmixing=0.5,
                     log=lambda m: None, device=device)
    assert r.error < 1e-2
    # total filling 2 per layer; edge layer differs from bulk layer
    np.testing.assert_allclose(r.dens.sum(axis=1), 2.0, atol=0.05)
    assert abs(r.dens[0, 0] - r.dens[1, 0]) > 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_nano_isoc_hexagon(rundir, device):
    """ed_nano_isoc class: intrinsic-SOC hexagon flake (complex
    spin-diagonal Hij) through the real-space DMFT loop — time-reversal
    symmetric, half filled, one symmetry class."""
    from dmft_ed_tpu_torch.models import nano
    cfg = EDConfig(norb=1, nbath=3, nspin=2, uloc=(2.0,), beta=60.0,
                   lmats=150, lreal=30, lfit=150, nloop=12, dmft_error=1e-3,
                   ed_verbose=0, lanc_dim_threshold=4096).validate()
    hij, lat2ineq = nano.hexagon_isoc_hij(t=0.5, lam=0.15)
    np.testing.assert_allclose(hij, hij.conj().T, atol=1e-14)
    r = nano.run(cfg, hij, lat2ineq, wmixing=0.5, log=lambda m: None,
                 device=device)
    assert r.error < 1e-2
    np.testing.assert_allclose(r.dens, 1.0, atol=0.01)
    # TRS: the spin-resolved GFs coincide (no magnetization)
    np.testing.assert_allclose(r.smats_ineq[:, 0, 0], r.smats_ineq[:, 1, 1],
                               atol=2e-4)  # fit-level noise; TRS exact
    # ed_nano_xy observable: TRS forbids any spin polarization — the
    # magXY.ed texture vanishes (fit-level tolerance)
    assert r.mag_xy.shape == (1, 3)
    np.testing.assert_allclose(r.mag_xy, 0.0, atol=1e-3)
    assert os.path.exists("magXY.ed")
