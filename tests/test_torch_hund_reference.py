"""The port's two-orbital Hund-Kanamori impurity with a hybrid bath against
the benchmark's plain reference (``benchmark/reference/hund2_nb12.py``,
loaded by its path; its own Fock basis, the spin exchange and pair
hopping applied as operators to the sector's full words): the dense
sector matrix, the matvec, the thick-restart ground state, the sector
without J_x and J_p, and the ``hamiltonian.mix`` span and counter that
the matvec records under a profiler. Norb=2, Nbath=4 and 6, the (3,3),
(4,2) and (4,4) sectors; one torch and one BLAS thread."""

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import scipy.linalg  # noqa: F401  (loads the BLAS that threadpoolctl limits)

import dmft_ed_tpu_torch.bath as tbath
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.diag as tdiag
import dmft_ed_tpu_torch.hamiltonian as tham
import dmft_ed_tpu_torch.lanczos as tlanczos
import dmft_ed_tpu_torch.sectors as tsectors
from dmft_ed_tpu_torch import timer

from reference_ed import build_full_H, sector_states_normal

try:
    from threadpoolctl import threadpool_limits
except ImportError:                          # pragma: no cover
    from contextlib import nullcontext

    def threadpool_limits(limits=None):
        return nullcontext()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U, UST, JH = (2.0, 2.0), 1.5, 0.25
CASES = [(nbath, sec) for nbath in (4, 6)
         for sec in ((3, 3), (4, 2), (4, 4))]
# Entries of H and of H·x (x of unit normals) are sums of at most ~30
# terms of size <= 5 taken in another order by each side: their f64
# rounding stays near 1e-14, so 1e-12 leaves two orders of room and still
# sees any wrong coefficient, sign or index.
ENTRY_TOL = 1e-12
# The thick restart stops at a residual of ~1e-12; the eigenvalue's error
# is second order in it, and the reference's Lanczos settles to 1e-15
# relative of |egs| ~ 8: 1e-11 leaves room for the Ritz values' rounding.
EGS_TOL = 1e-11


def _reference():
    spec = importlib.util.spec_from_file_location(
        "benchmark.reference.hund2_nb12",
        os.path.join(ROOT, "benchmark", "reference", "hund2_nb12.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


@pytest.fixture(autouse=True)
def _one_thread_clean_store():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    timer.reset()
    with threadpool_limits(limits=1):
        yield
    timer.reset()
    torch.set_num_threads(n)


def _bath(nbath):
    return (np.linspace(-1.0, 1.0, nbath),
            np.random.default_rng(nbath).uniform(0.3, 0.7, (2, nbath)))


def _port(nbath, sec, jx=0.25, jp=0.25, norb=2):
    """The port's sector Hamiltonian and operator, built as ``diag``
    builds them."""
    e, v = _bath(nbath)
    cfg = tconfig.EDConfig(norb=norb, nspin=1, bath_type="hybrid",
                           nbath=nbath, uloc=U[:norb], ust=UST, jh=JH,
                           jx=jx, jp=jp, beta=100.0).validate()
    bath = tbath.Bath(cfg)
    bath.e[0, 0, :] = e
    bath.v[0, :, :] = v[:norb]
    s = tsectors.sector_table(cfg).get(*sec)
    ham = tham.build_sector_hamiltonian(cfg, s, bath,
                                        np.zeros((1, 1, norb, norb)))
    return cfg, s, ham, tham.make_matvec_op(ham, cfg, "cpu")


def _ref(nbath, sec, jx=0.25, jp=0.25):
    e, v = _bath(nbath)
    return REF.SectorOperator(e, v, U, UST, JH, jx, jp, *sec, "cpu")


def _apply(op, x):
    spec, arrays, blocks = op
    return tham.flatten_blocks(tham.apply_op(
        spec, arrays, tham.unflatten_blocks(x, blocks)))


@pytest.mark.parametrize("nbath,sec", CASES)
def test_dense_sector_matrix(nbath, sec):
    """assemble_dense equals the reference's dense operator entrywise,
    with four mix terms in both."""
    _, _, ham, _ = _port(nbath, sec)
    ref = _ref(nbath, sec)
    assert len(ham.mix) == 4 and len(ref.gathers) == 4
    assert np.abs(tham.assemble_dense(ham) - ref.dense()).max() \
        <= ENTRY_TOL


@pytest.mark.parametrize("nbath,sec", CASES)
def test_matvec(nbath, sec):
    """apply_op (the mix terms as one signed-gather "pmix" entry) equals
    the reference's matvec (the mix terms as signed gathers) on seeded
    random vectors."""
    _, s, _, op = _port(nbath, sec)
    assert [m.kind for m in tham.mix_entries(op[0])] == ["pmix"]
    ref = _ref(nbath, sec)
    rng = np.random.default_rng(sum(sec) + nbath)
    for _ in range(3):
        x = torch.as_tensor(rng.standard_normal(s.dim))
        assert (_apply(op, x) - ref.matvec(x)).abs().max().item() \
            <= ENTRY_TOL


@pytest.mark.parametrize("nbath,sec", CASES)
def test_ground_state(nbath, sec):
    """eigs_lanczos_op's egs equals the reference's lowest eigenvalue, and
    its vector's residual under the reference's operator is small."""
    cfg, s, _, (spec, arrays, blocks) = _port(nbath, sec)
    v0 = tdiag._draw_v0(cfg, False, s.dim, np.random.default_rng(3), "cpu")
    evals, evecs, n = tlanczos.eigs_lanczos_op(
        spec, blocks, arrays, v0, 1, tdiag._ncv(cfg, s.dim, 1),
        maxiter=cfg.lanc_niter, tol=cfg.lanc_tolerance)
    assert n < cfg.lanc_niter
    ref = _ref(nbath, sec)
    e0 = ref.lowest_eigenvalue(np.random.default_rng(0))
    assert abs(float(evals[0]) - e0) <= EGS_TOL
    assert ref.residual(evecs[0], float(evals[0])) <= 1e-9
    if s.dim <= 400:
        assert abs(np.linalg.eigvalsh(ref.dense())[0] - e0) <= EGS_TOL


@pytest.mark.parametrize("sec", [(3, 3), (4, 4)])
def test_without_jx_and_jp_the_mix_terms_vanish(sec):
    """With J_x = J_p = 0 neither side has a mix term, and the two
    matrices still agree."""
    _, _, ham, op = _port(4, sec, jx=0.0, jp=0.0)
    ref = _ref(4, sec, jx=0.0, jp=0.0)
    assert ham.mix == [] and tham.mix_entries(op[0]) == () \
        and ref.gathers == []
    assert np.abs(tham.assemble_dense(ham) - ref.dense()).max() \
        <= ENTRY_TOL


@pytest.mark.parametrize("sec", [(3, 3), (4, 2)])
def test_hartree_constant_is_upstreams(sec):
    """The reference's constant is upstream's: its dense operator equals
    the literal transcription of dmft-ed's Hamiltonian terms
    (tests/reference_ed.py) in the same basis, four-fermion terms
    included."""
    nbath = 4
    e, v = _bath(nbath)
    ns = 2 + nbath
    t = REF.one_body(e, v)
    lit = build_full_H(ns, 2, t, t, np.zeros((ns, ns)), np.zeros(ns),
                       np.asarray(U), UST, JH, 0.25, 0.25, True,
                       sector_states_normal(ns, *sec))
    ref = _ref(nbath, sec)
    assert np.abs(lit.imag).max() == 0.0
    assert np.abs(lit.real - ref.dense()).max() <= ENTRY_TOL


def _traced_matvecs(op, x, n):
    with profile(activities=[ProfilerActivity.CPU]):
        ys = [_apply(op, x) for _ in range(n)]
    return ys


def test_mix_span():
    """Under a CPU profiler the Hund operator records one
    ``hamiltonian.mix`` span per matvec and counts its four signed-gather
    terms in ``hamiltonian.mix_gather_terms``, with the same result
    bitwise as without the profiler; a single-band operator records
    none."""
    _, s, _, op = _port(4, (3, 3))
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(s.dim))
    off = _apply(op, x)
    assert timer.totals() == {}
    ys = _traced_matvecs(op, x, 3)
    tot = timer.totals()
    assert tot["hamiltonian.mix"]["spans"] == 3
    assert tot["hamiltonian.mix"]["device_s"] is None
    assert set(tot) == {"hamiltonian.mix", "hamiltonian.mix_gather_terms"}
    assert tot["hamiltonian.mix_gather_terms"]["count"] == 12
    assert all(torch.equal(y, off) for y in ys)
    timer.reset()
    _, s1, _, op1 = _port(4, (3, 3), norb=1)
    assert tham.mix_entries(op1[0]) == ()
    _traced_matvecs(op1, torch.ones(s1.dim, dtype=torch.float64), 2)
    assert timer.totals() == {}
