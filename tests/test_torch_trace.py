"""The port's spans and counters (timer.py): they record only under a
running torch.profiler and change no result; under it a thick-restart
solve (an Nbath=5 sector, 400 states) records one root per solve, one
``hamiltonian.apply_op`` span and one ``lanczos.matvecs`` count per matvec,
one ``lanczos.reorth`` span per step, the restart's host transfers, and
properly nested host intervals inside the profiler's window on
time.time_ns; the Ozaki products record their digit extraction; a
``Timers`` stage opens a span of its name. The ``gpu`` case holds the
device time of a graphed matvec on the card."""

import time

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

try:
    from threadpoolctl import threadpool_limits
except ImportError:                          # pragma: no cover
    from contextlib import nullcontext

    def threadpool_limits(limits=None):
        return nullcontext()


@pytest.fixture(autouse=True)
def _one_thread_clean_store():
    """One torch and one BLAS thread per test; an empty store before and
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    timer.reset()
    with threadpool_limits(limits=1):
        yield
    timer.reset()
    torch.set_num_threads(n)


def _operator(prec, fused=False, device="cpu", nbath=5, sector=(3, 3)):
    cfg = tconfig.EDConfig(norb=1, nbath=nbath, nspin=1, uloc=(2.0,),
                           xmu=0.1, ed_verbose=0,
                           matmul_precision=prec).validate()
    rng = np.random.default_rng(5)
    bath = tbath.Bath(cfg)
    bath.e[:] = rng.uniform(-1.0, 1.0, bath.e.shape)
    bath.v[:] = rng.uniform(0.3, 0.7, bath.v.shape)
    sec = tsectors.sector_table(cfg).get(*sector)
    ham = tham.build_sector_hamiltonian(cfg, sec, bath, np.zeros((1, 1, 1, 1)))
    spec, arrays, blocks = tham.make_matvec_op(ham, cfg, device, fused=fused)
    v0 = tdiag._draw_v0(cfg, False, sec.dim, np.random.default_rng(11),
                        device)
    return cfg, sec, (spec, blocks, arrays), v0


def _solve(prec, fused=False, maxiter=120):
    cfg, sec, op, v0 = _operator(prec, fused)
    return tlanczos.eigs_lanczos_op(*op, v0, 1, tdiag._ncv(cfg, sec.dim, 1),
                                    maxiter=maxiter, tol=cfg.lanc_tolerance)


def _traced(fn):
    """fn() under a CPU profiler; (result, window start, window end) on
    time.time_ns."""
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        out = fn()
        t1 = time.time_ns()
    return out, t0, t1


@pytest.mark.parametrize("prec", ["native", "ozaki5x7"])
def test_off_records_nothing_and_on_changes_nothing(prec):
    """Without a profiler the solve records nothing; under one its
    results are bitwise those of the untraced solve."""
    e0, v0, n0 = _solve(prec)
    assert timer.STORE.spans == [] and timer.STORE.counts == {}
    assert timer.totals() == {}
    (e1, v1, n1), _, _ = _traced(lambda: _solve(prec))
    assert timer.STORE.spans and n1 == n0
    assert np.array_equal(e0, e1) and torch.equal(v0, v1)


@pytest.mark.parametrize("prec", ["native", "ozaki5x7"])
def test_counts_and_tree(prec):
    """One root per solve; apply_op spans = lanczos.matvecs = the returned
    matvec count = reorth spans; four host transfers per restart and three
    at the end; every span's host interval inside its parent's, all inside
    the profiler's window; no device time on the CPU."""
    (_, _, niter), t0, t1 = _traced(lambda: _solve(prec))
    spans = timer.STORE.spans
    assert [s.name for s in spans if s.parent < 0] == ["lanczos.eigs_lanczos"]
    assert timer.roots("lanczos.eigs_lanczos", t0, t1) == {0}
    tot = timer.totals("lanczos.eigs_lanczos", t0, t1)
    assert tot == timer.totals()
    assert tot["hamiltonian.apply_op"]["spans"] \
        == tot["lanczos.matvecs"]["count"] == niter
    assert tot["lanczos.reorth"]["spans"] == niter
    expansions = tot["lanczos.rayleigh_ritz"]["spans"]
    assert expansions >= 2
    assert tot["lanczos.host_transfers"]["count"] == 4 * expansions - 1
    assert tot["lanczos.restart"]["spans"] == 2 * (expansions - 1) + 1
    assert all(v.get("device_s") is None for v in tot.values())
    for i, s in enumerate(spans):
        assert s.root == 0 and t0 <= s.t0 <= s.t1 <= t1
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.parent < i and p.t0 <= s.t0 and s.t1 <= p.t1
    assert {spans[s.parent].name for s in spans
            if s.name == "hamiltonian.apply_op"} == {"lanczos.eigs_lanczos"}
    assert timer.STORE.open == []
    assert timer.intervals("lanczos.eigs_lanczos", t0, t1) \
        == [(s.name, s.t0, s.t1) for s in spans]


@pytest.mark.parametrize("fused,per_matvec", [(False, 2), (True, 1)])
def test_ozaki_split_spans(fused, per_matvec):
    """The plain digit_matmul route extracts the vector's digits twice per
    matvec (its up and dw products), the fused product once; each split
    span inside the matvec's span, and no other Ozaki span."""
    (_, _, n), t0, t1 = _traced(lambda: _solve("ozaki5x7", fused,
                                                maxiter=40))
    tot = timer.totals("lanczos.eigs_lanczos", t0, t1)
    assert tot["hamiltonian.apply_op"]["spans"] == n
    assert tot["ozaki.split"]["spans"] == per_matvec * n
    spans = timer.STORE.spans
    ozaki = [s for s in spans if s.name.startswith("ozaki.")]
    assert {s.name for s in ozaki} == {"ozaki.split"}
    assert {spans[s.parent].name for s in ozaki} == {"hamiltonian.apply_op"}


def test_selection_by_root_and_window():
    """Two traced solves: a window around either makes ``roots``,
    ``totals`` and ``intervals`` take that solve's spans and counts alone;
    without a selection they take both."""
    (_, _, n1), t0, t1 = _traced(lambda: _solve("native", maxiter=40))
    (_, _, n2), t2, t3 = _traced(lambda: _solve("native", maxiter=40))
    (r1,), (r2,) = (timer.roots("lanczos.eigs_lanczos", t0, t1),
                    timer.roots("lanczos.eigs_lanczos", t2, t3))
    assert r1 < r2 and timer.roots("lanczos.eigs_lanczos", t1, t2) == set()
    for (a, b), n in (((t0, t1), n1), ((t2, t3), n2)):
        tot = timer.totals("lanczos.eigs_lanczos", a, b)
        assert tot["lanczos.matvecs"]["count"] == n
        assert tot["lanczos.eigs_lanczos"]["spans"] == 1
        got = timer.intervals("lanczos.eigs_lanczos", a, b)
        assert got[0][0] == "lanczos.eigs_lanczos"
        assert all(a <= s0 <= s1 <= b for _, s0, s1 in got)
    assert timer.totals()["lanczos.matvecs"]["count"] == n1 + n2
    assert len(timer.intervals()) == len(timer.STORE.spans) == len(
        timer.intervals("lanczos.eigs_lanczos", t0, t1)) + len(
        timer.intervals("lanczos.eigs_lanczos", t2, t3))


def test_timers_stage_opens_a_span():
    """A Timers stage accumulates its seconds with or without a profiler
    and, under one, opens a span of its name that parents the spans and
    counts inside it."""
    tm = timer.Timers()
    with tm("diag.thick_restart"):
        timer.count("lanczos.matvecs")
    assert tm.counts["diag.thick_restart"] == 1 and timer.STORE.spans == []

    def stage():
        with tm("diag.thick_restart"):
            with timer.span("lanczos.reorth"):
                timer.count("lanczos.matvecs", 3)
        timer.count("lanczos.matvecs")
    _, t0, t1 = _traced(stage)
    assert tm.counts["diag.thick_restart"] == 2
    assert tm.acc["diag.thick_restart"] > 0
    outer, inner = timer.STORE.spans
    assert (outer.name, outer.parent, inner.parent) \
        == ("diag.thick_restart", -1, 0)
    assert timer.totals()["lanczos.matvecs"] == {"count": 4}
    under = timer.totals("diag.thick_restart", t0, t1)
    assert under["lanczos.matvecs"] == {"count": 3}
    assert under["diag.thick_restart"]["spans"] == 1
    assert timer.totals("lanczos.eigs_lanczos") == {}


@pytest.mark.gpu
def test_device_time_on_card():
    """On the card (``python -m pytest -m gpu tests/test_torch_trace.py``)
    the recorder is on under a CUDA-only profiler, a matvec's span holds
    device time read after the synchronise, a graphed matvec records its
    span and count around the replay, a span opened while the graph is
    captured records no event, and the events read are taken again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device events need one")
    _, _, op, v0 = _operator("native", device="cuda")

    def double(x):
        with timer.span("inside", x):
            return 2.0 * x
    graphed = tlanczos._Graphed(double)
    with profile(activities=[ProfilerActivity.CUDA]):
        assert timer.recording()
        mv = tlanczos._op_matvec(*op)
        y = mv(mv(v0))
        z = graphed(graphed(y))
        torch.cuda.synchronize()
    assert not timer.recording()
    tot = timer.totals()
    assert tot["hamiltonian.apply_op"]["spans"] == 4
    assert tot["lanczos.matvecs"]["count"] == 4
    assert all(s.device_s() > 0 for s in timer.STORE.spans
               if s.name == "hamiltonian.apply_op")
    warm, captured = [s for s in timer.STORE.spans if s.name == "inside"]
    assert warm.device_s() is not None and captured.device_s() is None
    assert torch.equal(z, 4.0 * y)
    # the events read go back to the pool, and the next spans take theirs
    # from it: a root and the matvec under it, two events each
    pooled = len(timer._POOL)
    assert pooled == 2 * 5
    with profile(activities=[ProfilerActivity.CUDA]):
        with timer.span("root", v0):
            mv(v0)
        torch.cuda.synchronize()
    assert len(timer._POOL) == pooled - 4
    assert timer.totals("root")["hamiltonian.apply_op"]["device_s"] > 0
    assert len(timer._POOL) == pooled
