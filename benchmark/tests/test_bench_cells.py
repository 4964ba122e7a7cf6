"""Every cell runs end to end on the CPU at a small size and prints the
result line that the contract asks for (``breakdown`` only when traced)."""

import json

import numpy as np
import pytest

from benchmark import harness

from .small import SIZES, run

SPEC = harness.load_spec(held=True)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_result_line(workload, trace, capsys):
    res = run(workload, trace=trace)
    harness.emit(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(line["device"])
    group = SPEC["per_layer"] if trace else SPEC["end_to_end"]
    allowed = {m["name"] for m in group if harness.applies(m, workload)}
    assert set(line["metrics"]) <= allowed
    if not trace:
        # the CPU has no peak memory; the card reports every one
        assert allowed - set(line["metrics"]) <= {"peak_mem_gib"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert ("busy_s" in line["device"]) == trace
    tail = err.strip().splitlines()[-len(line["checks"]) - 1:]
    assert tail[0] == "correct True"
    assert [t.split()[1] for t in tail[1:]] == list(line["checks"])


def test_seed_orders_the_same_work():
    """The same seed gives the same order; another seed visits the same
    pool of inputs in another order."""
    visit_order = harness.load_module("cells", "gs").visit_order
    t = harness.load_json(f"{harness.BENCH}/traffic/gs.json")
    a, b = visit_order(t, 2 ** 31 + 5), visit_order(t, 2 ** 31 + 5)
    c = visit_order(t, 2 ** 31 + 9)
    assert a == b and sorted(a) == sorted(c) == list(range(len(a)))
    assert any(visit_order(t, 2 ** 31 + k) != a for k in range(6, 12))


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_traced_unit_is_fixed(workload, monkeypatch):
    """The traced unit runs the pool's first input whatever the seed, so
    its per-layer readings do not depend on how many units the window
    held."""
    gs = "gs" in workload
    mod = harness.load_module("cells", "gs" if gs else "loop")
    cls = mod.GsCell if gs else mod.LoopCell
    name = "_solve" if gs else "_episode"
    orig, seen = getattr(cls, name), []

    def spy(self, *a, **k):
        if self.spans.on:
            seen.append(a[0] if gs else int(a[0][0]))
        return orig(self, *a, **k)
    monkeypatch.setattr(cls, name, spy)
    for seed in (2 ** 31 + 3, 2 ** 31 + 4):
        run(workload, trace=True, seed=seed)
    first = 0 if gs else \
        int(np.random.default_rng(int(harness.load_json(
            f"{harness.BENCH}/traffic/loop.json")["pool_seed"]))
            .integers(0, 2 ** 31 - 1024))
    assert seen and all(s == first for s in seen)


def test_traffic_sets_precision_and_dtype():
    """A traffic mix sets the dtype and the products of its cell, so a new
    mix (a float32 cell) is a data file alone."""
    import torch
    from .small import GS
    spec = harness.load_spec(held=True)
    c = harness.by_name(spec["configs"], "impurity_nb13")
    config = dict(harness.load_json(f"{harness.ROOT}/{c['file']}"),
                  **GS["c"])
    traffic = dict(harness.load_json(f"{harness.BENCH}/traffic/gs.json"),
                   dtype="float32")
    mod = harness.load_module("cells", traffic["cell"])
    ref = harness.load_module("reference", "impurity_nb13")
    cell = mod.build(config, traffic, 5, "cpu", ref)
    assert cell.vdtype == torch.float32 and cell.precision == "native"
    traffic = dict(traffic, dtype="float64", matmul_precision="ozaki5x7")
    cell = mod.build(config, traffic, 5, "cpu", ref)
    assert cell.vdtype == torch.float64 and cell.precision == "ozaki5x7"
