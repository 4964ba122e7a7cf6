"""No module that ``python3 -m benchmark.run`` reaches imports jax, jaxlib,
flax or the JAX package (top-level names compared whole: the port's
``dmft_ed_tpu_torch`` begins with ``dmft_ed_tpu``), nor the port's
``benches``; the references import nothing of either package."""

import ast
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "dmft_ed_tpu"}


def _imports(path):
    """(top-level name, full name) of every import in a file; relative
    imports resolve inside the benchmark package."""
    rel = os.path.relpath(path, harness.ROOT)
    pkg = os.path.dirname(rel).replace(os.sep, ".")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")
                base = base[:len(base) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            out.append(mod)
            out += [f"{mod}.{a.name}" for a in node.names]
    return [(m.split(".")[0], m) for m in out]


def _reached():
    """Every benchmark file run.py reaches: its imports within the package
    and the files the harness loads by name."""
    files = [os.path.join(harness.BENCH, "run.py")]
    for kind in ("cells", "metrics", "reference"):
        d = os.path.join(harness.BENCH, kind)
        files += [os.path.join(d, f) for f in sorted(os.listdir(d))
                  if f.endswith(".py")]
    seen, todo = set(), list(files)
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for top, full in _imports(f):
            if top != "benchmark":
                continue
            cand = os.path.join(harness.ROOT, *full.split("."))
            for p in (cand + ".py", os.path.join(cand, "__init__.py")):
                if os.path.exists(p):
                    todo.append(p)
    return sorted(seen)


def test_no_jax_by_ast():
    files = _reached()
    assert any(f.endswith(os.path.join("cells", "loop.py")) for f in files)
    for f in files:
        for top, full in _imports(f):
            assert top not in FORBIDDEN, (f, full)
            assert not full.startswith("dmft_ed_tpu_torch.benches"), (f, full)


def test_references_stand_alone():
    d = os.path.join(harness.BENCH, "reference")
    for name in os.listdir(d):
        if name.endswith(".py"):
            for top, full in _imports(os.path.join(d, name)):
                assert top not in FORBIDDEN | {"dmft_ed_tpu_torch"}, \
                    (name, full)


def test_no_jax_in_process():
    """Importing run.py and every file it loads by name, the port's
    modules with them, leaves no forbidden module in sys.modules."""
    code = ("import sys; from benchmark import harness, run\n"
            "spec = harness.load_spec(held=True)\n"
            "for w in spec['workloads']:\n"
            "    t = harness.load_json(f\"{harness.BENCH}/traffic/\"\n"
            "                          f\"{w['traffic']}.json\")\n"
            "    harness.load_module('cells', t['cell'])\n"
            "    harness.load_module('reference', w['config'])\n"
            "for m in spec['end_to_end'] + spec['per_layer']:\n"
            "    harness.load_metric(m['name'])\n"
            "import dmft_ed_tpu_torch.kernels, dmft_ed_tpu_torch.models\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
