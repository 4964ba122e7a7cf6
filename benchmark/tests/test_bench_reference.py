"""The plain references against the port on the CPU at a small size: the
same sector matrix in the same basis, the same impurity solve and Weiss
field. The references import nothing of the port; this test does."""

import numpy as np
import pytest

from benchmark.reference import hm_bethe_nb6 as ref
from benchmark.reference.fock import Sector
from benchmark.reference.impurity_nb13 import SectorOperator

from dmft_ed_tpu_torch.bath import Bath
from dmft_ed_tpu_torch.config import EDConfig
from dmft_ed_tpu_torch.hamiltonian import (assemble_dense,
                                           build_sector_hamiltonian)
from dmft_ed_tpu_torch.sectors import sector_table

E3 = np.array([-0.7, 0.15, 0.9])
V3 = np.array([0.45, 0.3, 0.62])


def _port_sector(nup, ndw, e=E3, v=V3, u=2.0):
    cfg = EDConfig(norb=1, nspin=1, nbath=len(e), uloc=(u,), beta=100.0,
                   lmats=200, lreal=200).validate()
    bath = Bath(cfg)
    bath.e[:] = e[None, None, :]
    bath.v[:] = v[None, None, :]
    sec = sector_table(cfg).get(nup, ndw)
    return cfg, assemble_dense(build_sector_hamiltonian(
        cfg, sec, bath, np.zeros((1, 1, 1, 1))))


@pytest.mark.parametrize("nup,ndw", [(2, 2), (1, 3), (3, 2), (0, 4)])
def test_sector_matrix(nup, ndw):
    _, h = _port_sector(nup, ndw)
    assert np.max(np.abs(Sector(E3, V3, 2.0, nup, ndw).dense() - h)) \
        < 1e-14


def test_sector_operator_eigenvalue():
    _, h = _port_sector(2, 2)
    op = SectorOperator(E3, V3, 2.0, 2, 2, "cpu")
    e0 = op.lowest_eigenvalue(np.random.default_rng(1))
    assert abs(e0 - np.linalg.eigvalsh(h)[0]) < 1e-12
    w, q = np.linalg.eigh(h)
    import torch
    assert op.residual(torch.as_tensor(q[:, 0]), w[0]) < 1e-12


def test_impurity_solve_against_port():
    """One port solve (EDSolver, the defaults) at Nbath=3 against the
    reference's full diagonalization and Lehmann sum."""
    from dmft_ed_tpu_torch.bath import pack_bath
    from dmft_ed_tpu_torch.solver import EDSolver
    cfg = EDConfig(norb=1, nspin=1, nbath=3, uloc=(2.0,), beta=1000.0,
                   lmats=400, lreal=400, ed_verbose=0).validate()
    b = Bath(cfg)
    b.e[:] = E3[None, None, :]
    b.v[:] = V3[None, None, :]
    flat = pack_bath(b)
    r = EDSolver(cfg, np.zeros((1, 1, 1, 1)), device="cpu").solve(flat)
    e, v = ref.split_bath(flat, 3)
    o = ref.impurity_solve(e, v, 2.0, 1000.0, 400)
    z = 1j * ref.matsubara(1000.0, 400)
    sig = ref.self_energy(z, e, v, o["g"])
    assert abs(r.egs - o["egs"]) < 1e-12
    g = r.gmats[0, 0, 0, 0]
    assert np.max(np.abs(g - o["g"])) < 1e-9 * np.max(np.abs(o["g"]))
    s = r.smats[0, 0, 0, 0]
    assert np.max(np.abs(s - sig)) < 1e-7 * np.max(np.abs(sig))
    assert abs(r.observables.dens[0] - o["dens"]) < 1e-10
    assert abs(r.observables.docc[0] - o["docc"]) < 1e-10


def test_weiss_and_chi2_against_port():
    from dmft_ed_tpu_torch.lattice import bethe_bands, gloc_dos, \
        self_consistency
    cfg = EDConfig(norb=1, nspin=1, nbath=3, beta=1000.0, lmats=300,
                   lreal=300).validate()
    z = 1j * ref.matsubara(1000.0, 300)
    sig = 0.3 / z - 0.05j
    eb, db, h0 = bethe_bands(1, 1.0, 500)
    g = gloc_dos(cfg, eb, db, h0, np.broadcast_to(sig, (1, 1, 1, 1, 300)))
    w = self_consistency(cfg, g, np.broadcast_to(sig, (1, 1, 1, 1, 300)),
                         np.zeros((1, 1, 1, 1)), diag_only=True)
    mine = ref.weiss_field(z, sig, 1.0, 500)
    assert np.max(np.abs(w[0, 0, 0, 0] - mine)) < 1e-13
    x = np.concatenate([E3, V3])
    f, grad = ref.chi2(x, z, mine, grad=True)
    step = 1e-7
    for i in range(x.size):
        d = np.zeros_like(x)
        d[i] = step
        num = (ref.chi2(x + d, z, mine) - ref.chi2(x - d, z, mine)) / (2 * step)
        assert abs(num - grad[i]) < 1e-6 * max(1.0, abs(grad[i]))
