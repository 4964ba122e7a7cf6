"""The k-space lattice drivers of the PyTorch port against the JAX package
on the CPU: the Bloch builders of ``models.kspace_afm``, ``hm_slab``,
``bhz_afm``, ``bhz_edge``, ``bhz_edge_afm`` and ``wsm_slab``, two
iterations of each driver's loop (the graphene Néel pair, a 4-layer
Hubbard slab with its mirror classes, the BHZ afm2 supercell, the BHZ
strip, the AFM strip with lysym and neelsym, the Weyl slab with lrsym),
the drivers' command lines with ``DEVICE=cpu`` and that every new entry
point asks for a card by default. Six JAX DMFT loops run here.

Every loop runs its fits to a tight stop (cg_ftol 1e-12), as in
tests/test_torch_drivers_kspace.py. Bounds, measured on these configs (the
CPU, one thread):

* the builders: bitwise;
* every loop's first solve (before any fit), per site: egs, dens, docc
  1e-10, Σ 1e-10 of its max (measured at most 5.3e-15 and 6.3e-12);
* after two iterations: dens, docc 1e-6, Σ 1e-5 of its max, the baths
  1e-4 (measured at most 7.6e-8, 2.5e-8, 9.2e-7, 5.2e-5: hm_slab and
  the graphene pair; the BHZ loops stay within 5e-8 of each other).
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

import dmft_ed_tpu.config as jconfig
import dmft_ed_tpu.lattice_solver as jls
import dmft_ed_tpu.models.bhz_afm as jafm
import dmft_ed_tpu.models.bhz_edge as jedge
import dmft_ed_tpu.models.bhz_edge_afm as jeafm
import dmft_ed_tpu.models.hm_slab as jslab
import dmft_ed_tpu.models.kspace_afm as jkafm
import dmft_ed_tpu.models.wsm_slab as jwsm
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.lattice_solver as tls
import dmft_ed_tpu_torch.models.bhz_afm as tafm
import dmft_ed_tpu_torch.models.bhz_edge as tedge
import dmft_ed_tpu_torch.models.bhz_edge_afm as teafm
import dmft_ed_tpu_torch.models.hm_slab as tslab
import dmft_ed_tpu_torch.models.kspace_afm as tkafm
import dmft_ed_tpu_torch.models.wsm_slab as twsm


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread and one BLAS thread per test (see
    tests/test_torch_nano.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.max(np.abs(x - y))) / max(float(np.max(np.abs(x))),
                                              1e-300)


def _dev(x, y):
    return float(np.max(np.abs(np.asarray(x) - np.asarray(y))))


def _in(path, fn):
    path.mkdir()
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


# ----------------------------------------------------------------------
# Bloch builders

def _rand_hk(seed, n, nk):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, n, nk)) + 1j * rng.normal(size=(n, n, nk))
    return h + h.conj().transpose(1, 0, 2)


_BUILDERS = {
    "kspace_afm.expand_spin": lambda m: m.expand_spin(_rand_hk(3, 2, 5), 2),
    "hm_slab.slab_hk": lambda m: m.slab_hk(5, 4, 0.3, 0.2),
    "bhz_afm.bhz_hops_2d": lambda m: m.bhz_hops_2d(1.2, 0.4),
    "bhz_afm.bhz_hops_3d": lambda m: m.bhz_hops_3d(1.2, 0.4, 0.8),
    "bhz_afm.supercell_hk[afm2]": lambda m: m.supercell_hk(
        *m.bhz_hops_2d(1.0, 0.3), *m._CELLS["afm2"], 4),
    "bhz_afm.supercell_hk[afm4]": lambda m: m.supercell_hk(
        *m.bhz_hops_2d(1.0, 0.3), *m._CELLS["afm4"], 3),
    "bhz_afm.supercell_hk[afm8]": lambda m: m.supercell_hk(
        *m.bhz_hops_3d(1.0, 0.3, 0.7), *m._CELLS["afm8"], 2),
    "bhz_edge.bhz_strip_hk": lambda m: m.bhz_strip_hk(6, 3, 1.1, 0.35, 0.1),
    "bhz_edge.strip_hk_from_bulk": lambda m: m.strip_hk_from_bulk(
        lambda kx, ky: np.array([[np.cos(kx) + np.cos(2 * ky), 0.1],
                                 [0.1, np.sin(ky)]], dtype=complex),
        5, 4, 2, 8),
    "bhz_edge_afm.bhz_afm_strip_hk": lambda m: m.bhz_afm_strip_hk(
        6, 3, 1.1, 0.35, 0.9),
    "bhz_edge_afm._spin_flip_sigma": lambda m: m._spin_flip_sigma(
        _rand_hk(5, 2, 6).reshape(2, 2, 1, 1, 6)),
    "wsm_slab.wsm_slab_hk": lambda m: m.wsm_slab_hk(4, 3, 1.0, 2.0, 1.0,
                                                     0.1, 0.2, 0.05),
}
_PAIRS = {"kspace_afm": (jkafm, tkafm), "hm_slab": (jslab, tslab),
          "bhz_afm": (jafm, tafm), "bhz_edge": (jedge, tedge),
          "bhz_edge_afm": (jeafm, teafm), "wsm_slab": (jwsm, twsm)}


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(_BUILDERS))
def test_builders_bitwise(name):
    j, t = _PAIRS[name.split(".")[0]]
    _same(_BUILDERS[name](j), _BUILDERS[name](t))


# ----------------------------------------------------------------------
# the loops

def _record_solves(monkeypatch):
    """{"jax": [...], "torch": [...]}: per LatticeEDSolver.solve of either
    package, the sites' egs, dens, docc, Σ and the baths."""
    seen = {"jax": [], "torch": []}
    for key, mod in (("jax", jls), ("torch", tls)):
        orig = mod.LatticeEDSolver.solve

        def solve(self, baths, batched=True, _orig=orig, _out=seen[key]):
            out = _orig(self, baths, batched=batched)
            _out.append((np.array([r.egs for r in out]),
                         np.stack([r.observables.dens for r in out]),
                         np.stack([r.observables.docc for r in out]),
                         np.stack([r.smats for r in out]), np.array(baths)))
            return out
        monkeypatch.setattr(mod.LatticeEDSolver, "solve", solve)
    return seen


LOOP = dict(beta=50.0, lmats=100, lreal=20, lfit=100, nloop=2,
            dmft_error=1e-12, ed_verbose=0, cg_ftol=1e-12, cg_niter=3000)
BHZ = dict(LOOP, norb=2, nspin=2, nbath=1, uloc=(2.0, 2.0), ust=1.0,
           jh=0.5)

# name: (config, run() keywords)
_LOOPS = {
    "kspace_afm": (dict(LOOP, norb=1, nspin=2, nbath=2, uloc=(3.0,)),
                   dict(nk=5, t=0.5)),
    "hm_slab": (dict(LOOP, norb=1, nspin=1, nbath=3, uloc=(2.0,)),
                dict(nlayers=4, nk=5)),
    "bhz_afm": (BHZ, dict(cell="afm2", nk=4)),
    "bhz_edge": (BHZ, dict(ly=4, nkx=6)),
    "bhz_edge_afm": (BHZ, dict(ly=3, nkx=6)),
    "wsm_slab": (BHZ, dict(ly=4, nk=4)),
}


def _entry(mod, name):
    return mod.run_graphene if name == "kspace_afm" else mod.run


@pytest.mark.parametrize("name", sorted(_LOOPS))
def test_loop_two_iterations(name, tmp_path, monkeypatch):
    """Two iterations of each driver, both packages on the same config:
    the first solve exactly, the second after one joint fit; the smats,
    dens and baths of the result."""
    seen = _record_solves(monkeypatch)
    kw, run_kw = _LOOPS[name]
    jmod, tmod = _PAIRS[name]
    a = _in(tmp_path / "jax", lambda: _entry(jmod, name)(
        jconfig.EDConfig(**kw).validate(), log=lambda *x, **k: None,
        **run_kw))
    b = _in(tmp_path / "torch", lambda: _entry(tmod, name)(
        tconfig.EDConfig(**kw).validate(), log=lambda *x, **k: None,
        device="cpu", **run_kw))
    assert a.iterations == b.iterations == 2
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "torch"))
    (ej, dj, oj, sj, bj), (et, dt, ot, st, bt) = (seen["jax"][0],
                                                  seen["torch"][0])
    assert np.array_equal(bj, bt)
    assert _dev(ej, et) <= 1e-10
    assert _dev(dj, dt) <= 1e-10 and _dev(oj, ot) <= 1e-10
    assert _rel(sj, st) <= 1e-10
    assert _dev(a.dens, b.dens) <= 1e-6
    (_, dj, oj, _, _), (_, dt, ot, _, _) = seen["jax"][1], seen["torch"][1]
    assert _dev(dj, dt) <= 1e-6 and _dev(oj, ot) <= 1e-6
    assert _rel(a.smats_ineq, b.smats_ineq) <= 1e-5
    assert _dev(a.baths, b.baths) <= 1e-4
    assert np.all(np.isfinite(b.smats_ineq))


def test_afm_order_survives(tmp_path, monkeypatch):
    """The graphene Néel pair at U=3 on the port alone: the seeded
    sublattices keep opposite moments after two iterations, and the
    result's magz is the solver's."""
    monkeypatch.chdir(tmp_path)
    kw, run_kw = _LOOPS["kspace_afm"]
    r = tkafm.run_graphene(tconfig.EDConfig(**kw).validate(),
                           log=lambda *x, **k: None, device="cpu", **run_kw)
    m = r.magz[:, 0]
    assert m[0] * m[1] < 0 and abs(m[0] + m[1]) <= 1e-6 * abs(m[0])


# ----------------------------------------------------------------------
# command lines and the default device

_CLI = {
    "kspace_afm": (tkafm, ["NSPIN=2", "ULOC=3.0", "NK=3", "TS=0.5"]),
    "hm_slab": (tslab, ["NLAYERS=3", "NK=3"]),
    "bhz_afm": (tafm, ["CELL=afm2", "NK=2", "NBATH=1"]),
    "bhz_edge": (tedge, ["LY=2", "NKX=3", "NBATH=1"]),
    "bhz_edge_afm": (teafm, ["NSPIN=2", "NORB=2", "NBATH=1", "LY=3",
                             "NK=3", "LYSYM=T", "NEELSYM=F"]),
    "wsm_slab": (twsm, ["LY=2", "NK=2", "NBATH=1", "BZ=0.2"]),
}


@pytest.mark.parametrize("name", sorted(_CLI))
def test_driver_cli_on_cpu(name, tmp_path, monkeypatch):
    """``python -m dmft_ed_tpu_torch.models.<driver> DEVICE=cpu ...``: the
    command line reaches the loop on the CPU (one iteration, small)."""
    monkeypatch.chdir(tmp_path)
    argv = ["inputED.in", "DEVICE=cpu", "NLOOP=1", "NBATH=2", "LMATS=40",
            "LREAL=10", "LFIT=40", "ED_VERBOSE=0", "CG_NITER=20",
            "BETA=20.0"]
    mod, extra = _CLI[name]
    r = mod.main(argv + extra)
    assert r.iterations == 1 and np.all(np.isfinite(r.dens))


def _tiny(**kw):
    return tconfig.EDConfig(**dict(dict(norb=1, nbath=1, lmats=8, lreal=4,
                                        nloop=1, ed_verbose=0), **kw))


_ENTRY = {
    "kspace_afm.run_graphene": lambda: tkafm.run_graphene(_tiny(nspin=2),
                                                          nk=2),
    "kspace_afm.run_square_afm2": lambda: tkafm.run_square_afm2(
        _tiny(nspin=2), nk=2),
    "hm_slab.run": lambda: tslab.run(_tiny(), nlayers=2, nk=2),
    "bhz_afm.run": lambda: tafm.run(_tiny(norb=2, nspin=2), nk=2),
    "bhz_edge.run": lambda: tedge.run(_tiny(norb=2, nspin=2), ly=2, nkx=2),
    "bhz_edge_afm.run": lambda: teafm.run(_tiny(norb=2, nspin=2), ly=3,
                                          nkx=2),
    "wsm_slab.run": lambda: twsm.run(_tiny(norb=2, nspin=2), ly=2, nk=2),
}


@pytest.mark.parametrize("name", sorted(_ENTRY))
def test_entry_points_need_a_card_by_default(name, tmp_path, monkeypatch):
    """Every new entry point runs on cuda unless asked for the CPU, and
    raises without a card instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _ENTRY[name]()


@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_wrong_shape_raises(name):
    """Where the JAX driver asserts its Nspin and Norb, the port raises
    ValueError (before it asks for a device)."""
    mod = _PAIRS[name][1]
    cfg = tconfig.EDConfig(norb=3, nspin=1, nbath=1, lmats=8, lreal=4,
                           nloop=1)
    with pytest.raises(ValueError, match="Nspin|Norb"):
        _entry(mod, name)(cfg, nk=2) if name in ("kspace_afm", "bhz_afm") \
            else mod.run(cfg)
