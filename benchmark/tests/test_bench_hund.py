"""The two-orbital Hund cell (``hund2_nb12.gs_hund``) on the CPU at a small
size of its own (Nbath=6, the (4,4) sector; ``small.py`` keeps the other
cells'): its result line, the float32 control and three planted faults
failing ``correct``, the mix terms' byte count and readers
(``mix_ms.gs``, ``mix_roofline.gs``) on a synthetic store, and the new
files' imports. The ``gpu`` case plants the dropped mix terms at the
cell's own size on the card."""

import json
import os
from math import comb

import numpy as np
import pytest

import dmft_ed_tpu_torch.lanczos as lanczos
from benchmark import harness, program_spans
from benchmark.roofline_mix import mix_bytes

from .test_bench_imports import FORBIDDEN, _imports
from .test_bench_program_spans import OPS, _Recorder, _trace

WORKLOAD = "hund2_nb12.gs_hund"
NBATH = 6
SMALL = {"nbath": NBATH, "sector": [4, 4],
         "bath_e": list(np.linspace(-1.0, 1.0, NBATH)),
         "bath_v": np.random.default_rng(0).uniform(
             0.3, 0.7, (2, NBATH)).tolist()}
SEED = 2 ** 31 + 977
CARD = "NVIDIA H100 80GB HBM3"


def run(trace=False, seed=SEED, seconds=0.2, variant=None, device="cpu",
        small=True):
    return harness.run_cell(harness.load_spec(), WORKLOAD, seed, seconds,
                            trace, device,
                            config_overrides=SMALL if small else None,
                            variant=variant)


def _false(**kw):
    res = run(**kw)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1
    return res


def _cell_module():
    return harness.load_module("cells", "gs_multiorb")


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace, capsys):
    res = run(trace=trace)
    harness.emit(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    spec = harness.load_spec()
    group = spec["per_layer"] if trace else spec["end_to_end"]
    allowed = {m["name"] for m in group if harness.applies(m, WORKLOAD)}
    assert set(line["metrics"]) <= allowed
    if trace:
        assert {"mix_ms.gs", "mix_roofline.gs", "solve_mfu.gs"} <= allowed
    else:
        assert allowed - set(line["metrics"]) <= {"peak_mem_gib"}
    assert err.strip().splitlines()[-3] == "correct True"


def test_control_float32_fails():
    _false(variant="float32")


def test_mix_terms_dropped(monkeypatch):
    """The port's operator without its mix entries (spin exchange and pair
    hopping left out)."""
    mod = _cell_module()
    orig = mod.make_matvec_op

    def dropped(*a, **k):
        spec, arrays, blocks = orig(*a, **k)
        assert len(spec[4]) == 1
        return spec[:4] + ((),) + spec[5:], arrays, blocks
    monkeypatch.setattr(mod, "make_matvec_op", dropped)
    res = _false()
    assert res["checks"]["egs_gap"]["value"] > 1e-3


def test_half_the_vector_left_out(monkeypatch):
    """A matvec that zeroes the second half of the vector's rows and
    scales the rest to keep its norm."""
    orig = lanczos._op_matvec

    def half(*a, **k):
        mv = orig(*a, **k)

        def f(x):
            y = x.clone()
            y[..., x.shape[-1] // 2:] = 0
            return mv(y) * np.sqrt(2.0)
        return f
    monkeypatch.setattr(lanczos, "_op_matvec", half)
    _false()


def test_energy_shifted(monkeypatch):
    """The ground-state energy altered by one part in a million."""
    orig = lanczos.eigs_lanczos

    def bent(*a, **k):
        evals, evecs, n = orig(*a, **k)
        return evals * (1 + 1e-6), evecs, n
    monkeypatch.setattr(lanczos, "eigs_lanczos", bent)
    res = _false()
    assert res["checks"]["egs_gap"]["value"] > \
        res["checks"]["egs_gap"]["limit"]


def test_mix_bytes_from_the_reference():
    """The four terms of the (n, n) sector each read and write
    C(Nbath, n-1)^2 entries, on disjoint sets (each needs another
    occupation of the two orbitals): 8 x 2 x 4 x C(Nbath, n-1)^2 bytes."""
    ref = harness.load_module("reference", "hund2_nb12")
    op = ref.SectorOperator(SMALL["bath_e"], SMALL["bath_v"], (2.0, 2.0),
                            1.5, 0.25, 0.25, 0.25, 4, 4, "cpu")
    assert mix_bytes(op.gathers, op.dim) == 8 * 2 * 4 * comb(NBATH, 3) ** 2


def _solve(rec):
    """One solve: two matvecs of 3 ms device time, each with a 2 ms
    ``hamiltonian.mix`` span inside, 2 matvecs counted."""
    spans = [("lanczos.eigs_lanczos", 1, 40, None)]
    for k in range(2):
        base = 2 + 10 * k
        spans += [("hamiltonian.apply_op", base, base + 4, 3.0),
                  ("hamiltonian.mix", base + 0.5, base + 3, 2.0)]
    rec.solves.append((spans, {"lanczos.matvecs": 2}))


def _ctx(trace, kind=CARD, nbytes=6_700_000):
    return harness.Context("solve", 1.0, 1.0, 1, 1, kind,
                           {"mix_bytes": nbytes}, trace, 1)


@pytest.fixture
def rec(monkeypatch):
    r = _Recorder()
    monkeypatch.setattr(program_spans, "_recorder", lambda: r)
    return r


def test_mix_readers_on_a_synthetic_store(rec):
    """mix_ms.gs: 4 ms of mix spans over 2 matvecs; mix_roofline.gs: 2
    spans x 6.7 MB at 3.35 TB/s (2 µs each) over 4 ms, 0.1%."""
    _solve(rec)
    ctx = _ctx(_trace(OPS))
    assert harness.load_metric("mix_ms.gs").read(ctx) == pytest.approx(2.0)
    assert harness.load_metric("mix_roofline.gs").read(ctx) == \
        pytest.approx(0.1)


@pytest.mark.parametrize("name", ["mix_ms.gs", "mix_roofline.gs"])
@pytest.mark.parametrize("case", ["cpu", "untraced", "empty", "no_mix",
                                  "no_recorder"])
def test_mix_readers_read_nothing(name, case, rec, monkeypatch):
    """None on the CPU, without a trace, with an empty store, for a solve
    without mix spans (a single-band operator, or a program that lacks
    the span) and where the program has no recorder."""
    if case == "no_mix":
        rec.solves.append(([("lanczos.eigs_lanczos", 1, 40, None),
                            ("hamiltonian.apply_op", 2, 6, 3.0)],
                           {"lanczos.matvecs": 1}))
    elif case != "empty":
        _solve(rec)
    if case == "no_recorder":
        monkeypatch.setattr(program_spans, "_recorder", lambda: None)
    ctx = _ctx(None if case == "untraced" else _trace(OPS),
               kind="cpu" if case == "cpu" else CARD)
    assert harness.load_metric(name).read(ctx) is None


def test_new_files_import_nothing_forbidden():
    """The reference imports neither package; the cell, the readers and
    the byte count import no JAX (test_bench_imports' checks over every
    file the harness reaches cover them too)."""
    b = harness.BENCH
    for top, full in _imports(os.path.join(b, "reference", "hund2_nb12.py")):
        assert top not in FORBIDDEN | {"dmft_ed_tpu_torch"}, full
    for rel in ("cells/gs_multiorb.py", "roofline_mix.py",
                "metrics/mix_ms.gs.py", "metrics/mix_roofline.gs.py"):
        for top, full in _imports(os.path.join(b, rel)):
            assert top not in FORBIDDEN, (rel, full)


@pytest.mark.gpu
def test_mix_terms_dropped_on_card(card, monkeypatch):
    """At the cell's own size on the card: a sound run is correct, and the
    operator without its mix entries is not."""
    assert run(device=card, seconds=1.0, small=False)["correct"] is True
    mod = _cell_module()
    orig = mod.make_matvec_op

    def dropped(*a, **k):
        spec, arrays, blocks = orig(*a, **k)
        return spec[:4] + ((),) + spec[5:], arrays, blocks
    monkeypatch.setattr(mod, "make_matvec_op", dropped)
    res = run(device=card, seconds=1.0, small=False)
    print(json.dumps(res["checks"]))
    assert res["correct"] is False and res["failed"] >= 1


def test_unit_is_a_pass_over_the_pool(monkeypatch):
    """The warm-up and a traced unit solve the pool's first vector alone,
    whatever the seed; a window unit solves every start vector of the pool
    once, in the seed's order, and counts them."""
    cls = _cell_module().GsMultiorbCell
    orig, seen = cls._solve, []

    def spy(self, k):
        seen.append((self.spans.on, k))
        return orig(self, k)
    monkeypatch.setattr(cls, "_solve", spy)
    res = run(trace=True, seconds=0.0)
    pool = harness.load_module("cells", "gs").visit_order(
        harness.load_json(f"{harness.BENCH}/traffic/gs_hund.json"), SEED)
    assert res["attempted"] == len(pool) == 4
    assert seen == [(False, 0)] + [(False, k) for k in pool] + [(True, 0)]
