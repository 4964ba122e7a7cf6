"""Device-time profile of the port's row-sharded Lanczos recurrence — the
counterpart of the repo root's ``bench_trace.py``.

Runs the production sharded recurrence (``bench_scaling.run_mesh``'s
path: ``parallel.hxv.sharded_sector_op`` and
``lanczos.lanczos_tridiag_op(mesh=)``) on ``--ranks`` ranks over
``bench.py``'s sector at ``--nbath`` under ``--precision``, once to warm
up and once under ``torch.profiler``, and splits rank 0's device time
into classes: the digit kernel, GEMM, reductions (the dots and norms),
collectives (NCCL kernels; under gloo the host copies that carry them),
elementwise, other. It also reports rank 0's host seconds inside the
all-gathers. On the CPU the classes split the ATen operators' self time.

    python -m dmft_ed_tpu_torch.benches.bench_trace [--nbath 11]
        [--niter 20] [--ranks 2]

prints the card line and one JSON object. It writes nothing into the
repository.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from . import card_line, sync
from ..device import resolve

# (class, name fragments), tested in order on the lower-cased event name
CLASSES = (
    ("digit_kernel", ("digit_matmul",)),
    ("collective", ("nccl", "gloo", "all_gather", "allgather", "all_reduce",
                    "allreduce", "c10d", "memcpy")),
    ("gemm", ("gemm", "aten::mm", "aten::addmm", "aten::bmm",
              "aten::matmul", "cutlass", "xmma")),
    ("reduction", ("reduce", "aten::sum", "norm", "aten::dot")),
    ("elementwise", ("elementwise", "aten::mul", "aten::add", "aten::sub",
                     "aten::div", "aten::where", "aten::sqrt",
                     "aten::copy_", "aten::fill_", "aten::zero_")),
)


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def split(prof, on_card: bool) -> dict:
    """{event name: self microseconds}: the device events on the card (the
    kernels and copies), the ATen operators' host time on the CPU."""
    from torch.autograd import DeviceType
    ops = {}
    for evt in prof.key_averages():
        if on_card and evt.device_type == DeviceType.CUDA:
            us = evt.self_device_time_total
        elif not on_card and evt.key.startswith(("aten::", "c10d")):
            us = evt.self_cpu_time_total
        else:
            continue
        if us > 0:
            ops[evt.key] = ops.get(evt.key, 0.0) + float(us)
    return ops


def rank_main(nbath, prec, niter, device, shared):
    """One rank: the warm-up, then the profiled recurrence; rank 0's
    returns the split, the wall seconds and the host seconds inside the
    all-gathers."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from .bench_scaling import rank_mesh, sharded_problem
    from ..lanczos import lanczos_tridiag_op
    mesh = rank_mesh(device, shared)
    dev = mesh.device
    sec, _, spec, arrays, blocks, _, v0 = sharded_problem(nbath, prec, mesh)
    gather_s = [0.0, 0]
    all_gather = mesh.all_gather

    def timed_gather(*a, **k):
        t0 = time.perf_counter()
        out = all_gather(*a, **k)
        sync(dev)
        gather_s[0] += time.perf_counter() - t0
        gather_s[1] += 1
        return out

    def f():
        out = lanczos_tridiag_op(spec, blocks, arrays, v0, niter, mesh)
        sync(dev)
        return out

    f()
    on_card = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    mesh.all_gather = timed_gather
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        f()
    wall = time.perf_counter() - t0
    mesh.all_gather = all_gather
    if dist.get_rank() != 0:
        return None
    return dict(ops=split(prof, on_card), wall_s=wall, dim=int(sec.dim),
                gather_host_s=gather_s[0], gathers=gather_s[1])


def trace(device, nbath: int = 11, prec: str = "native", niter: int = 20,
          ranks: int = 2) -> dict:
    """The JSON object of the module docstring."""
    from .bench_scaling import run_group
    with tempfile.TemporaryDirectory() as work:
        res, backend, shared = run_group(
            "dmft_ed_tpu_torch.benches.bench_trace:rank_main", ranks,
            device, dict(nbath=nbath, prec=prec, niter=niter),
            os.path.join(work, "ranks"))
    r0 = res[0]
    ops = r0["ops"]
    total = sum(ops.values())
    by_class = {}
    for name, us in ops.items():
        c = classify(name)
        by_class[c] = by_class.get(c, 0.0) + us
    order = sorted(by_class.items(), key=lambda kv: -kv[1])
    return {
        "ranks": ranks, "backend": backend, "shared_card": shared,
        "sector_dim": r0["dim"], "precision": prec, "niter": niter,
        "wall_s": r0["wall_s"],
        "time_source": ("device time of the card's kernels and copies"
                        if resolve(device).type == "cuda"
                        else "self time of the ATen operators on the CPU"),
        "op_time_total_ms": total / 1e3,
        "per_class_ms": {k: v / 1e3 for k, v in order},
        "per_class_frac": {k: v / total for k, v in order} if total else {},
        "top_ops_ms": {k[:80]: v / 1e3 for k, v in sorted(
            ops.items(), key=lambda kv: -kv[1])[:15]},
        "rank0_host_s_in_all_gathers": r0["gather_host_s"],
        "rank0_all_gathers": r0["gathers"],
        "note": ("ranks share one device over gloo: the collectives are "
                 "host copies, not a multi-GPU link" if backend == "gloo"
                 else "one card per rank, NCCL"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dmft_ed_tpu_torch.benches."
                                 "bench_trace",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nbath", type=int, default=11)
    ap.add_argument("--precision", default="native")
    ap.add_argument("--niter", type=int, default=20)
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    card = card_line(dev)
    print(card, flush=True)
    out = trace(dev, args.nbath, args.precision, args.niter, args.ranks)
    print(json.dumps(dict(out, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
