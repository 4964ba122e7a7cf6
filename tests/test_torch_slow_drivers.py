"""The slow DMFT-loop tests of tests/test_new_drivers.py, on the port
(slow; ``tests/run_slow.sh`` or ``python -m pytest
tests/test_torch_slow_drivers.py -m slow``).

Each test keeps the config, the loop depth and the assertions of the JAX
test it ports and runs only the port: on the CPU (``device="cpu"``) and,
marked ``gpu``, on the card (``device="cuda"``, the batched route):

* :132 ``test_ahm_2bands_orbital_symmetry``; :155
  ``test_bhz_afm2_staggered_magnetization``; :170 ``test_wsm_slab_dmft_runs``;
* :185 ``test_blg_aa_ab_dmft``; :263 ``test_soc_ineq_crystal_field_split``;
* :308 ``test_nano_adiabatic_gate_sweep_and_enforce``.

(tests/test_new_drivers.py:205, the superconducting flake, is in
tests/test_torch_slow_superc.py.) The file imports neither jax nor the
JAX package; one torch and one BLAS thread per test.
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
def test_ahm_2bands_orbital_symmetry(device):
    """alpha=1: the two bands are identical — per-orbital docc and phi
    must coincide; alpha=2: the wider band pairs more weakly (smaller
    |phi|) at fixed U (ed_ahm_2bands_bethe.f90 physics)."""
    from dmft_ed_tpu_torch.models import ahm_2bands
    kw = dict(norb=2, nbath=2, nspin=1, ed_mode="superc",
              uloc=(-2.0, -2.0), beta=20.0, lmats=128, lreal=32, nloop=6,
              dmft_error=1e-15, ed_verbose=0)
    with scratch_dir():
        r1 = ahm_2bands.run(EDConfig(**kw).validate(), alpha=1.0, le=200,
                            device=device)
    # orbital symmetry holds to the bath-fit degeneracy floor (the chi^2
    # valley is ~1e-3 flat — see test_ozaki_dmft_physics_impact), not to
    # machine precision: the two orbitals' Krylov chains use different
    # random seeds and the fit walks the flat valley independently
    np.testing.assert_allclose(r1.docc[0], r1.docc[1], atol=1e-3)
    np.testing.assert_allclose(r1.phisc[0], r1.phisc[1], atol=1e-3)
    assert abs(r1.phisc[0]) > 0.05     # superconducting solution
    with scratch_dir():
        r2 = ahm_2bands.run(EDConfig(**kw).validate(), alpha=2.0, le=200,
                            device=device)
    assert abs(r2.phisc[1]) < abs(r2.phisc[0])


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_bhz_afm2_staggered_magnetization(device):
    """Néel-seeded BHZ afm2 cell: the two sublattices carry opposite
    magnetization of equal magnitude (ed_bhz_2d_afm2.f90)."""
    from dmft_ed_tpu_torch.models import bhz_afm
    cfg = EDConfig(norb=2, nbath=1, nspin=2, uloc=(6.0, 6.0), ust=0.0,
                   beta=20.0, lmats=128, lreal=32, nloop=5, sb_field=0.2,
                   dmft_error=1e-15, ed_verbose=0).validate()
    with scratch_dir():
        r = bhz_afm.run(cfg, cell="afm2", nk=8, mh=1.0, llambda=0.3,
                        device=device)
    m = r.magz
    np.testing.assert_allclose(m[0], -m[1], atol=1e-4)
    assert np.max(np.abs(m)) > 0.1     # ordered solution survived the seed


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_wsm_slab_dmft_runs(device):
    """2-layer WSM slab: mirror-equivalent layers, PH-symmetric density at
    xmu=0 (the model is bipartite-PH symmetric at bz!=0 too)."""
    from dmft_ed_tpu_torch.models import wsm_slab
    cfg = EDConfig(norb=2, nbath=1, nspin=2, uloc=(1.0, 1.0), beta=20.0,
                   lmats=96, lreal=32, nloop=3, dmft_error=1e-15,
                   ed_verbose=0).validate()
    with scratch_dir():
        r = wsm_slab.run(cfg, ly=2, nk=6, mh=2.0, llambda=1.0, bz=0.1,
                         device=device)
    assert r.iterations == 3
    assert r.smats_ineq.shape[0] == 1          # lrsym: 1 ineq of 2 layers
    np.testing.assert_allclose(np.sum(r.dens, axis=1), 2.0, atol=5e-3)


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_blg_aa_ab_dmft(device):
    """AA at half filling: all 4 sublattice sites equivalent (dens=1,
    equal docc). AB: dimer (B1/A2) and uncoordinated (A1/B2) sites carry
    different docc."""
    from dmft_ed_tpu_torch.models import blg
    kw = dict(norb=1, nbath=3, nspin=1, uloc=(2.0,), beta=20.0, lmats=96,
              lreal=32, nloop=4, dmft_error=1e-15, ed_verbose=0)
    with scratch_dir():
        r_aa = blg.run(EDConfig(**kw).validate(), stacking="AA", nk=8,
                       t0=0.3, device=device)
    np.testing.assert_allclose(r_aa.dens[:, 0], 1.0, atol=3e-4)
    with scratch_dir():
        r_ab = blg.run(EDConfig(**kw).validate(), stacking="AB", nk=8,
                       t0=0.3, device=device)
    np.testing.assert_allclose(r_ab.dens[:, 0], 1.0, atol=3e-4)
    # dimer vs uncoordinated sites differ
    assert abs(r_ab.docc[0, 0] - r_ab.docc[1, 0]) > 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_soc_ineq_crystal_field_split(device):
    """ed_SOC_ineq: two t2g+SOC sites with different crystal-field shifts
    carry different densities; per-site SOC operators come out of the
    lattice getter (ED_IO/get_imp_SOC_op.f90 lattice variant)."""
    from dmft_ed_tpu_torch.models import soc_ineq
    cfg = EDConfig(norb=3, nspin=2, nbath=1, uloc=(1.0, 1.0, 1.0),
                   ed_mode="nonsu2", bath_type="replica", beta=20.0,
                   lmats=96, lreal=32, nloop=2, dmft_error=1e-15,
                   ed_verbose=0).validate()
    with scratch_dir():
        r = soc_ineq.run(cfg, nlat=2, nk=4, soc=0.25, shifts=[0.0, 0.6],
                         tperp=0.1, device=device)
        ops = r.solver.get_quantum_soc_operators()
    assert r.iterations == 2
    n0, n1 = r.dens.sum(axis=1)
    assert n0 > n1 + 0.01            # shifted site holds fewer electrons
    assert len(ops) == 2
    # SOC partially polarizes L.S on each site; finite and equal-sign
    assert all(abs(o["LS"].real) > 1e-3 for o in ops)


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_nano_adiabatic_gate_sweep_and_enforce(device):
    """Adiabatic gate drive (ed_nano_adiabatic.f90): the site density
    follows the instantaneous gate potential monotonically, each step
    warm-started. enforce_map (ed_nano_enforce_ineq_symm.f90) pins
    Sigma of site 1 to site 0, making the Weiss fields identical."""
    from dmft_ed_tpu_torch.models import nano
    cfg = EDConfig(norb=1, nbath=2, nspin=1, uloc=(1.5,), beta=20.0,
                   lmats=96, lreal=32, nloop=3, dmft_error=1e-15,
                   ed_verbose=0).validate()

    def hij_of_t(t):
        h = np.array([[0.0, -1.0], [-1.0, 0.0]])
        return h + np.diag([t, 0.0])       # gate ramp on site 0

    with scratch_dir():
        rs = nano.run_adiabatic(cfg, hij_of_t, [0.0, 0.5, 1.0],
                                lat2ineq=[0, 1], device=device)
    n0 = [r.dens[0] for r in rs]
    assert n0[0] > n0[1] > n0[2]           # gate empties the driven site
    np.testing.assert_allclose(rs[0].dens[0], rs[0].dens[1], atol=1e-3)
    # enforce_map: pin Sigma_1 := Sigma_0 on an asymmetric dimer
    with scratch_dir():
        r = nano.run(cfg, hij_of_t(0.4), lat2ineq=[0, 1],
                     enforce_map=[((0, 0, 0), (1, 0, 0))], device=device)
    np.testing.assert_allclose(r.smats_ineq[0, 0, 0, 0, 0],
                               r.smats_ineq[1, 0, 0, 0, 0], atol=1e-12)
