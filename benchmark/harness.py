"""Running one cell: set-up, the measured window, the traced units, the
metrics and the comparison with the plain reference.

The traffic mix names the window's loop: ``cells/<traffic["cell"]>.py``,
whose ``build(config, traffic, seed, device, reference, variant)`` makes
the cell from the configuration's file, the traffic's parameters, the
seed and the configuration's plain reference (``reference/<config>.py``).
A cell object offers:

- ``unit_kind``: what one unit of work is ("iteration", "solve");
- ``warm()``: the set-up's warm-up, every shape the window uses;
- ``unit() -> int``: one unit of timed work, ended by a synchronise; it
  returns the units completed (an episode of three DMFT iterations
  returns 3);
- ``spans``: a ``trace.Spans`` around its calls into each layer, on while
  the traced units run;
- ``records() -> dict``: what the program reported (stage seconds,
  matvec counts) for the metric readers;
- ``release()``: frees the program's device state;
- ``check(limits, rng) -> (numbers, failed)``: the compared numbers of the
  window's units (worst over them), each against its limit, and how many
  units failed.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "dmft_ed_tpu")


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


GROUPS = ("configs", "workloads", "end_to_end", "per_layer")


def load_spec(held: bool = False) -> dict:
    """BENCHMARK.json; with `held`, also the entries of each cell held out
    of it (``held/<cell>.json``: the entries a later PR adds back), for
    the tests and the limits' readings. The benchmark's runs take
    BENCHMARK.json alone."""
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    if held:
        d = os.path.join(BENCH, "held")
        for name in sorted(os.listdir(d)):
            if name.endswith(".json"):
                extra = load_json(os.path.join(d, name))
                for g in GROUPS:
                    spec[g] = spec[g] + extra.get(g, [])
    return spec


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (the names may hold
    dots, so the file is loaded by its path)."""
    path = os.path.join(BENCH, kind, name + ".py")
    modname = f"benchmark.{kind}._{name.replace('.', '_')}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def by_name(entries, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules() -> list:
    """Top-level module names in sys.modules that the benchmark's process
    must not hold (compared whole: ``dmft_ed_tpu_torch`` is allowed)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def card_line() -> str:
    """``name, power.limit`` of the first card as nvidia-smi gives it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Context:
    """What the metric readers read."""
    unit_kind: str
    setup_s: float
    window_s: float
    units: int
    peak_bytes: Optional[int]
    device_kind: str
    records: dict
    trace: object = None           # trace.Trace of the traced units
    traced_units: int = 0


def load_metric(name: str):
    """The reader of metric `name`: ``metrics/<name>.py``, or, for a
    quantity split by the cells' end-to-end metrics (``device_idle.loop``,
    ``device_idle.gs``), the quantity's one reader ``metrics/<quantity>.py``
    where the split name has no file of its own."""
    if not os.path.exists(os.path.join(BENCH, "metrics", name + ".py")) \
            and "." in name:
        name = name.rsplit(".", 1)[0]
    return load_module("metrics", name)


def _quiet():
    """Keep the program's own prints off standard output, whose last
    line is the result."""
    return contextlib.redirect_stdout(io.StringIO())


def run_cell(spec: dict, workload_name: str, seed: int, seconds: float,
             trace: bool, device="cuda", t0: Optional[float] = None,
             config_overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None,
             variant: Optional[str] = None) -> dict:
    """One run of one cell; returns the result line as a dict. `device`
    "cpu" serves the tests only (no device metric is read there);
    `variant` "float32" puts the program's float32 path in its place (the
    control)."""
    import torch
    t0 = time.perf_counter() if t0 is None else t0
    wl = by_name(spec["workloads"], workload_name)
    centry = by_name(spec["configs"], wl["config"])
    config = dict(load_json(os.path.join(ROOT, centry["file"])),
                  **(config_overrides or {}))
    traffic = dict(load_json(os.path.join(BENCH, "traffic",
                                          wl["traffic"] + ".json")),
                   **(traffic_overrides or {}))
    limits = load_json(os.path.join(BENCH, "limits", wl["name"] + ".json"))
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("the benchmark measures on a card; torch sees "
                           "none (no CPU fallback)")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    cells = load_module("cells", traffic["cell"])
    reference = load_module("reference", wl["config"])
    t_build = time.perf_counter()
    with _quiet():
        cell = cells.build(config, traffic, seed, dev, reference, variant)
        sync(dev)
        t_warm = time.perf_counter()
        cell.warm()
    sync(dev)
    t_start = time.perf_counter()
    setup_s = t_start - t0
    parts = {"imports_s": t_build - t0, "build_s": t_warm - t_build,
             "warm_s": t_start - t_warm}
    units, call_s = 0, []
    with _quiet():
        while True:
            t_unit = time.perf_counter()
            units += cell.unit()
            call_s.append(time.perf_counter() - t_unit)
            if time.perf_counter() - t_start >= seconds:
                break
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    tr, traced = None, 0
    if trace:
        tr, traced = _traced(cell, int(traffic.get("trace_units", 1)), dev)
    ctx = Context(cell.unit_kind, setup_s, window_s, units, peak, kind,
                  cell.records(), tr, traced)
    metrics = _read_metrics(spec, wl["name"], ctx, trace)
    cell.release()
    rng = np.random.default_rng([seed % 2 ** 63, 1])
    numbers, failed = cell.check(limits, rng)
    correct = all(math.isfinite(v) and v <= lim
                  for v, lim in numbers.values())
    res = dict(correct=bool(correct), attempted=int(units),
               failed=int(failed), metrics=metrics)
    res["device"] = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                     "count": wl["chips"], "memory_peak_bytes": peak}
    if trace:
        res["device"]["busy_s"] = tr.busy_s() if tr is not None else None
        res["device"]["window_s"] = tr.window_s if tr is not None else None
        if tr is not None:
            res["breakdown"] = {"device_ops": tr.device_ops(),
                                "idle_gaps": tr.idle_gaps()}
            res["device_classes"] = tr.device_classes()
            res["trace_clock_offsets_ms"] = tr.clock_offsets_ms()
    res["card"] = card_line() if on_card else "cpu"
    res["window"] = {"seconds": window_s, "units": units,
                     "unit": cell.unit_kind, "traced_units": traced,
                     "call_s": call_s}
    res["setup_parts"] = parts
    res["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in numbers.items()}
    return res


def _traced(cell, n: int, dev):
    """Run `n` more units under torch.profiler (CUDA activity alone) with
    the cell's host spans on; (Trace, units). On the CPU the units run
    without a profiler and no trace is read."""
    from .trace import Trace
    done = 0
    cell.spans.on = True
    with _quiet():
        if dev.type != "cuda":
            for _ in range(n):
                done += cell.unit()
            cell.spans.on = False
            return None, done
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time_ns()
            for _ in range(n):
                done += cell.unit()
            t1 = time.time_ns()
    cell.spans.on = False
    return Trace(prof, cell.spans.items, t0, t1), done


def _read_metrics(spec, workload: str, ctx: Context, trace: bool) -> dict:
    """{name: {"value", "unit"}} of the cell's end-to-end metrics (trace
    off) or per-layer metrics (trace on); a per-layer reader that finds
    nothing to read leaves its metric out."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    out = {}
    for m in group:
        if not applies(m, workload):
            continue
        value = load_metric(m["name"]).read(ctx)
        if value is None:
            if not trace and ctx.device_kind != "cpu":
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def emit(res: dict) -> None:
    """Print the verdict and then each compared number beside its limit
    as the last lines of standard error, and the result as the last line
    of standard output."""
    print(f"correct {res['correct']}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
