"""BENCHMARK.json against the benchmark's contract, and every
configuration, traffic mix, limit file, reference and metric reader found
by its name."""

import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = harness.load_spec()
SPECS = {"benchmark": SPEC, "with_held": harness.load_spec(held=True)}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert all(_line(w) for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    full = 2 + 14 * 24
    assert full * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("which", sorted(SPECS))
@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries(group, which):
    """BENCHMARK.json, and BENCHMARK.json with the held cells' entries
    added back, meet the contract's rules for entries."""
    entries = SPECS[which][group]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e and group in ("configs", "workloads", "per_layer"):
                assert _line(e[text]), (e["name"], text)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


@pytest.mark.parametrize("which", sorted(SPECS))
def test_metrics_rules(which):
    spec = SPECS[which]
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in spec["workloads"]]
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert harness.applies(e2e[m["moves"]], cell), m["name"]
    for cell in cells:
        mine = [n for n, m in e2e.items() if harness.applies(m, cell)]
        assert "setup_s" in mine and len(mine) >= 2, cell
        assert any(harness.applies(m, cell) for m in spec["per_layer"])
    layers = {}
    for m in spec["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("which", sorted(SPECS))
def test_cells_and_configs(which):
    spec = SPECS[which]
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4) and _line(w["why"])
    for c in spec["configs"]:
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  SPECS["with_held"]["workloads"]])
def test_found_by_name(cell):
    """Each cell's configuration file, reference, traffic mix and the
    window's loop it names, limits and metric readers load by name
    alone."""
    spec = SPECS["with_held"]
    w = harness.by_name(spec["workloads"], cell)
    c = harness.by_name(spec["configs"], w["config"])
    with open(os.path.join(harness.ROOT, c["file"])) as fh:
        assert isinstance(json.load(fh), dict)
    assert harness.load_module("reference", w["config"]) is not None
    traffic = harness.load_json(os.path.join(harness.BENCH, "traffic",
                                             w["traffic"] + ".json"))
    assert "trace_units" in traffic
    assert callable(harness.load_module("cells", traffic["cell"]).build)
    limits = harness.load_json(os.path.join(harness.BENCH, "limits",
                                            cell + ".json"))
    assert all(isinstance(v, (int, float)) for v in limits.values())
    for m in spec["end_to_end"] + spec["per_layer"]:
        if harness.applies(m, cell):
            assert callable(harness.load_metric(m["name"]).read)


def test_split_metric_names_share_one_reader():
    """A quantity split by the end-to-end metric it moves keeps one reader;
    a name with a file of its own keeps its own."""
    assert harness.load_metric("device_idle.loop") is \
        harness.load_metric("device_idle.gs") is \
        harness.load_metric("device_idle")
    assert harness.load_metric("diag_s.loop") is not \
        harness.load_metric("bath_fit_s.loop")
