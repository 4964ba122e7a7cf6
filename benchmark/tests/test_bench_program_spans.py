"""The readers of the program's spans and counters (``program_spans`` and
the metrics ``matvec_ms.gs``, ``ozaki_split_ms.gs``, ``reorth_ms.gs``,
``restart_idle_ms.gs``, ``host_transfers_per_solve.gs``) on a synthetic
recorder (a stand-in for the recorder's by-name helpers) and trace, and
on the recorder's store of a real small solve; each reads nothing on the
CPU, with an empty store, outside the traced window and where the
program has no recorder."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness, program_spans
from benchmark.trace import Trace
from dmft_ed_tpu_torch import timer

NEW = {"matvec_ms.gs": "sector matvec (hamiltonian.apply_op)",
       "ozaki_split_ms.gs": "sector matvec (hamiltonian.apply_op)",
       "reorth_ms.gs": "thick restart (lanczos.eigs_lanczos_op)",
       "restart_idle_ms.gs": "thick restart (lanczos.eigs_lanczos_op)",
       "host_transfers_per_solve.gs":
           "thick restart (lanczos.eigs_lanczos_op)"}
T0 = 10 ** 18          # the traced window on time.time_ns, ns
MS = 10 ** 6


class _Recorder:
    """A stand-in for the program's recorder: its by-name helpers
    (``totals``, ``intervals``) over solves given as spans (name, host
    start and end in ms after T0, device ms or None; the first is the
    root) and counters, selected by root name and window as the
    recorder's ``roots`` selects them."""

    def __init__(self):
        self.solves = []

    def _under(self, root, t0_ns, t1_ns):
        return [(sp, c) for sp, c in self.solves if sp[0][0] == root
                and t0_ns <= T0 + sp[0][1] * MS
                and T0 + sp[0][2] * MS <= t1_ns]

    def totals(self, root, t0_ns, t1_ns):
        out = {}
        for spans, counts in self._under(root, t0_ns, t1_ns):
            for name, a, b, dev in spans:
                acc = out.setdefault(name, {"spans": 0, "host_s": 0.0,
                                            "device_s": None})
                acc["spans"] += 1
                acc["host_s"] += (b - a) / 1e3
                if dev is not None:
                    acc["device_s"] = (acc["device_s"] or 0.0) + dev / 1e3
            for name, n in counts.items():
                out.setdefault(name, {"count": 0})["count"] += n
        return out

    def intervals(self, root, t0_ns, t1_ns):
        return [(name, T0 + int(a * MS), T0 + int(b * MS))
                for spans, _ in self._under(root, t0_ns, t1_ns)
                for name, a, b, _ in spans]


@pytest.fixture
def rec(monkeypatch):
    r = _Recorder()
    monkeypatch.setattr(program_spans, "_recorder", lambda: r)
    return r


@pytest.fixture(autouse=True)
def _clean_store():
    timer.reset()
    yield
    timer.reset()


def _solve(rec, t0_ms=0.0, split=True):
    """One solve: two matvecs (3 ms of device time each, one Ozaki split
    of 2 ms inside each), two reorth steps (1 ms each), one Rayleigh-Ritz
    and one restart span; 7 host transfers, 2 matvecs counted."""
    spans = [("lanczos.eigs_lanczos", t0_ms + 1, t0_ms + 40, None)]
    for k in range(2):
        base = t0_ms + 2 + 10 * k
        spans.append(("hamiltonian.apply_op", base, base + 4, 3.0))
        if split:
            spans.append(("ozaki.split", base + 0.5, base + 2, 2.0))
        spans.append(("lanczos.reorth", base + 4, base + 6, 1.0))
    spans += [("lanczos.rayleigh_ritz", t0_ms + 22, t0_ms + 30, 0.5),
              ("lanczos.restart", t0_ms + 30, t0_ms + 38, 0.25)]
    rec.solves.append((spans, {"lanczos.host_transfers": 7,
                               "lanczos.matvecs": 2}))


def _trace(ops_ms, window_ms=50.0):
    """A Trace of device operations [(start, end)] in ms after T0."""
    tr = Trace.__new__(Trace)
    tr.t0_ns, tr.t1_ns = T0, T0 + int(window_ms * MS)
    tr.window_s = window_ms / 1e3
    tr.spans = [("lanczos.eigs_lanczos_op", T0, tr.t1_ns)]
    tr.ops = [("k", T0 + int(a * MS), int((b - a) * MS)) for a, b in ops_ms]
    return tr


def _ctx(trace, kind="NVIDIA H100 80GB HBM3"):
    return harness.Context("solve", 1.0, 1.0, 1, 1, kind, {}, trace, 1)


# device busy 2-16 ms and 31-39 ms: the gap 16-31 has its middle (23.5)
# in the Rayleigh-Ritz span, the gap 39-45 its middle (42) outside every
# program span; a 1 ms gap at 7-8 (middle 7.5) falls in a reorth span
OPS = [(2.0, 7.0), (8.0, 16.0), (31.0, 39.0), (45.0, 46.0)]


def _read(name, ctx):
    return harness.load_metric(name).read(ctx)


def test_readers_on_a_synthetic_store(rec):
    """Each reader's reading of one solve; the matvec readers divide by
    the counter ``lanczos.matvecs``."""
    _solve(rec)
    ctx = _ctx(_trace(OPS))
    assert _read("matvec_ms.gs", ctx) == pytest.approx(3.0)
    assert _read("ozaki_split_ms.gs", ctx) == pytest.approx(2.0)
    assert _read("reorth_ms.gs", ctx) == pytest.approx(1.0)
    assert _read("host_transfers_per_solve.gs", ctx) == 7
    assert _read("restart_idle_ms.gs", ctx) == pytest.approx(15.0)
    idle, solves = program_spans.idle_by_span(ctx)
    assert solves == 1
    assert idle == pytest.approx({"lanczos.reorth": 1e-3,
                                  "lanczos.rayleigh_ritz": 15e-3,
                                  "outside the benchmark's spans": 6e-3})
    rec.solves[0][1]["lanczos.matvecs"] = 4
    assert _read("matvec_ms.gs", ctx) == pytest.approx(1.5)
    assert _read("ozaki_split_ms.gs", ctx) == pytest.approx(1.0)


def test_readers_divide_by_the_traced_solves(rec):
    """Two solves in the window: every reading per solve or per span is
    the one solve's; a third solve after the window is not read."""
    _solve(rec, 0.0)
    _solve(rec, 50.0)
    _solve(rec, 200.0)
    ops = [(2.0, 7.0), (8.0, 16.0), (31.0, 39.0),
           (52.0, 66.0), (81.0, 89.0)]
    ctx = _ctx(_trace(ops, window_ms=100.0))
    assert _read("matvec_ms.gs", ctx) == pytest.approx(3.0)
    assert _read("host_transfers_per_solve.gs", ctx) == 7
    # gaps 16-31 and 66-81, each in a Rayleigh-Ritz span
    assert _read("restart_idle_ms.gs", ctx) == pytest.approx(15.0)


@pytest.mark.parametrize("name", sorted(NEW))
@pytest.mark.parametrize("case", ["cpu", "untraced", "empty", "outside",
                                  "no_recorder"])
def test_readers_read_nothing(name, case, rec, monkeypatch):
    """None on the CPU, without a trace, with an empty store, with the
    solve outside the traced window, and where the program has no
    recorder (a parent that predates it)."""
    if case != "empty":
        _solve(rec, 200.0 if case == "outside" else 0.0)
    ctx = _ctx(None if case == "untraced" else _trace(OPS),
               kind="cpu" if case == "cpu" else "NVIDIA H100 80GB HBM3")
    if case == "no_recorder":
        monkeypatch.setattr(program_spans, "_recorder", lambda: None)
    assert _read(name, ctx) is None


def test_native_solve_has_no_split(rec):
    """Without Ozaki products the split reader reads nothing while the
    others read the solve."""
    _solve(rec, split=False)
    ctx = _ctx(_trace(OPS))
    assert _read("ozaki_split_ms.gs", ctx) is None
    assert _read("matvec_ms.gs", ctx) == pytest.approx(3.0)


def test_readers_on_a_real_solve():
    """The store of a small thick-restart solve run under a CPU profiler:
    the counter reader reads 4 transfers per restart and 3 at the end;
    the device-time readers read nothing (CPU tensors carry no events)."""
    from dmft_ed_tpu_torch.lanczos import eigs_lanczos
    rng = np.random.default_rng(1)
    A = rng.normal(size=(80, 80))
    H = torch.as_tensor(A + A.T)
    v0 = torch.as_tensor(rng.normal(size=80))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        eigs_lanczos(lambda x: H @ x, v0, 1, 8, maxiter=40, tol=1e-14)
        t1 = time.time_ns()
    tr = Trace.__new__(Trace)
    tr.t0_ns, tr.t1_ns, tr.window_s = t0, t1, (t1 - t0) / 1e9
    tr.spans, tr.ops = [], []
    ctx = _ctx(tr)
    expansions = timer.totals()["lanczos.rayleigh_ritz"]["spans"]
    assert expansions >= 2
    assert _read("host_transfers_per_solve.gs", ctx) == 4 * expansions - 1
    for name in ("matvec_ms.gs", "reorth_ms.gs", "ozaki_split_ms.gs"):
        assert _read(name, ctx) is None


def test_new_entries_in_the_benchmark():
    """The five metrics are in BENCHMARK.json under their layers,
    move gs_solve_s in the nb13 cells, and load by name (the contract's
    rules on every entry are test_bench_spec's)."""
    spec = harness.load_spec()
    got = {m["name"]: m for m in spec["per_layer"] if m["name"] in NEW}
    assert set(got) == set(NEW)
    for name, m in got.items():
        assert m["layer"] == NEW[name] and m["moves"] == "gs_solve_s"
        assert m["source"] == ("program_counter" if "transfers" in name
                               else "program_span")
        assert set(m["workloads"]) <= {"impurity_nb13.gs",
                                       "impurity_nb13.gs_ozaki5x7"}
        assert callable(harness.load_metric(name).read)
    assert got["ozaki_split_ms.gs"]["workloads"] == \
        ["impurity_nb13.gs_ozaki5x7"]
