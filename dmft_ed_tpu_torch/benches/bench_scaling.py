"""Row-sharded H·v scaling of the port — the counterpart of the repo
root's ``bench_scaling.py`` (BASELINE's north star: >= 70% scaling
efficiency of the sector H·v on 2+ devices).

Times the production sharded recurrence, the path
``diag._solve_sector_lanczos`` takes above ``shard_dim_threshold``: this
rank's local operator (``parallel.hxv.sharded_sector_op``), the start
vector's rows (``shard_flat``) and ``lanczos.lanczos_tridiag_op(mesh=)``,
whose matvec all-gathers the vector's blocks and whose dots are
all-reduced over the rows. The problem is ``bench.py``'s sector at
``--nbath`` (13: 11,778,624 states) under ``--precision`` (ozaki5x7).

Rank groups of 1, 2, 4, ... ranks up to ``--ranks`` start through
``parallel.spawn.run_ranks`` (one process per rank). Where each rank has a
card of its own the group runs NCCL; where ranks share a card (more ranks
than cards) or on the CPU it runs gloo, whose collectives go through host
copies, and the lines say so: their ``scaling_efficiency`` is then not a
multi-GPU number (the root script's virtual-mesh caveat).

    python -m dmft_ed_tpu_torch.benches.bench_scaling [--ranks 2]

prints the card line, one JSON line per rank count (seconds per step,
nnz/s, overhead and efficiency against one rank, the alphas' and betas'
largest difference from one rank, one sharded matvec against its
all-gather alone) and a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from . import card_line, device_name, peak_gib, reset_peak, sync, timed
from .bench import build_hamiltonian as build
from ..device import resolve
from ..kernels import KERNELS, reset_launches

RANK_TIMEOUT = 900.0


def rank_mesh(device, shared: bool):
    """In a rank process (``parallel.spawn``): this rank's device (cuda:0
    for every rank when they share the card, cuda:rank otherwise) and
    the rows mesh over the whole group."""
    import torch.distributed as dist
    from ..parallel import make_mesh
    dev = resolve(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0 if shared else dist.get_rank())
        torch.cuda.set_device(dev)
    return make_mesh(device=dev)


def sharded_problem(nbath: int, prec: str, mesh):
    """(sector, ham, spec, arrays, blocks, padded sector, v0): bench.py's
    problem as this rank's local operator (``sharded_sector_op``) and the
    rows of a seeded start vector (``shard_flat``)."""
    from ..parallel.hxv import shard_flat, sharded_sector_op
    cfg, sec, ham = build(nbath, "float64", prec)
    spec, arrays, blocks, sec_p = sharded_sector_op(ham, cfg, mesh)
    v0 = np.random.default_rng(1).normal(size=sec.dim)
    v0 = shard_flat(v0 / np.linalg.norm(v0), sec, sec_p, mesh,
                    getattr(torch, spec[-1]))
    return sec, ham, spec, arrays, blocks, sec_p, v0


def run_mesh(problem, mesh, niter: int = 20, repeats: int = 3,
             matvecs: int = 5):
    """This rank's share of the sharded recurrence: one warm-up, the best
    of `repeats` timed runs of `niter` steps, the alphas and betas; one
    sharded matvec and its all-gather alone, each timed over `matvecs`
    calls (host clock between synchronisations)."""
    from ..hamiltonian import apply_op, unflatten_blocks
    from ..lanczos import lanczos_tridiag_op
    from ..parallel.hxv import row_gather
    sec, ham, spec, arrays, blocks, sec_p, v0 = problem
    dev = mesh.device

    def f():
        return lanczos_tridiag_op(spec, blocks, arrays, v0, niter, mesh)

    (al, be, _), _ = timed(f, dev)
    best = min(timed(f, dev)[1] for _ in range(repeats))
    x = unflatten_blocks(v0, blocks)
    gather = row_gather(mesh)

    def per_call(fn):
        return timed(lambda: [fn() for _ in range(matvecs)], dev)[1] \
            / matvecs

    mv_s = per_call(lambda: apply_op(spec, arrays, x, gather))
    gather_s = per_call(lambda: gather(x[0])) if gather else 0.0
    full = sec_p.blocks[0]
    return {"s_per_iter": best / niter,
            "alphas": al.cpu().double().numpy().tolist(),
            "betas": be.cpu().double().numpy().tolist(),
            "matvec_ms": 1e3 * mv_s, "gather_ms": 1e3 * gather_s,
            "gather_mb": v0.element_size() * full.ddw * full.dup / 1e6
            if gather else 0.0,
            "local_block": list(blocks[0]),
            "dim": int(sec.dim), "nnz": int(ham.nnz_estimate())}


def rank_main(nbath, prec, niter, repeats, device, shared):
    """One rank of a group: ``run_mesh`` on ``rank_mesh``; returns its
    record with the kernels' launches and its peak memory."""
    import torch.distributed as dist
    mesh = rank_mesh(device, shared)
    problem = sharded_problem(nbath, prec, mesh)
    reset_launches()
    reset_peak(mesh.device)
    out = run_mesh(problem, mesh, niter, repeats)
    sync(mesh.device)
    out.update(launches={n: fn.launches for n, fn in KERNELS.items()},
               peak_gib=peak_gib(mesh.device), rank=dist.get_rank())
    return out


def run_group(target: str, n: int, device, kwargs: dict, workdir: str):
    """(every rank's return value, backend, shared): ``target`` on an
    n-rank group, NCCL where each rank has a card of its own, gloo where
    the ranks share one card or run on the CPU; ``kwargs`` gain the
    device type and ``shared``."""
    from ..parallel.spawn import run_ranks
    dev = resolve(device)
    shared = dev.type == "cuda" and n > torch.cuda.device_count()
    backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    res = run_ranks(target, n, dict(kwargs, device=dev.type, shared=shared),
                    workdir, RANK_TIMEOUT, backend=backend)
    return res, backend, shared


def group(n: int, device, nbath: int, prec: str, niter: int, repeats: int,
          workdir: str):
    """Rank 0's record of an n-rank group, with its backend and whether
    its ranks share one card."""
    res, backend, shared = run_group(
        "dmft_ed_tpu_torch.benches.bench_scaling:rank_main", n, device,
        dict(nbath=nbath, prec=prec, niter=niter, repeats=repeats),
        os.path.join(workdir, f"ranks{n}"))
    rec = res[0]
    rec.update(backend=backend, shared_card=shared, ranks=n,
               launches_all_ranks={k: sum(r["launches"][k] for r in res)
                                   for k in rec["launches"]})
    return rec


def scaling(device, nbath: int = 13, prec: str = "ozaki5x7",
            niter: int = 20, repeats: int = 3, max_ranks: int = 1):
    """Rank 0's record of each group of 1, 2, 4, ... <= max_ranks ranks,
    with nnz/s, the overhead and efficiency against one rank and the
    largest difference of its alphas and betas from one rank's (relative
    to the largest beta)."""
    results = []
    with tempfile.TemporaryDirectory() as work:
        for n in (2 ** i for i in range(max_ranks.bit_length())):
            rec = group(n, device, nbath, prec, niter, repeats, work)
            ref = results[0] if results else rec
            t1 = ref["s_per_iter"]
            rec.update(
                nnz_per_s=rec["nnz"] / rec["s_per_iter"],
                overhead_vs_1rank=rec["s_per_iter"] / t1,
                scaling_efficiency=t1 / (rec["s_per_iter"] * n),
                max_rel_diff_vs_1rank=float(np.max(np.abs(
                    np.r_[rec["alphas"], rec["betas"]]
                    - np.r_[ref["alphas"], ref["betas"]]))
                    / np.max(np.abs(ref["betas"]))))
            results.append(rec)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dmft_ed_tpu_torch.benches."
                                 "bench_scaling",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nbath", type=int, default=13)
    ap.add_argument("--precision", default="ozaki5x7")
    ap.add_argument("--niter", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--ranks", type=int, default=None,
                    help="the largest group (default: the cards, or 1 on "
                    "the CPU)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    card = card_line(dev)
    print(card, flush=True)
    top = args.ranks or (torch.cuda.device_count() if dev.type == "cuda"
                         else 1)
    results = scaling(dev, args.nbath, args.precision, args.niter,
                      args.repeats, top)
    for rec in results:
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("alphas", "betas")}), flush=True)
    last = results[-1]
    shared = dev.type == "cpu" or any(r["shared_card"] for r in results)
    detail = {"sector_dim": last["dim"], "precision": args.precision,
              "ranks": [r["ranks"] for r in results],
              "backend": last["backend"], "device": device_name(dev),
              "card": card}
    if shared:
        line = {"metric": "distributed_HxV_sharding_overhead_shared_"
                          + ("card" if dev.type == "cuda" else "cpu"),
                "value": last["overhead_vs_1rank"],
                "unit": "t_Nranks/t_1rank (ranks share one device)",
                "vs_baseline": (1.0 / last["overhead_vs_1rank"]) / 0.70,
                "detail": dict(detail, note=(
                    "the ranks share one device over gloo (host copies): "
                    "scaling_efficiency here is not a multi-GPU number"))}
    else:
        line = {"metric": "distributed_HxV_scaling_efficiency",
                "value": last["scaling_efficiency"],
                "unit": "fraction_vs_1rank",
                "vs_baseline": last["scaling_efficiency"] / 0.70,
                "detail": detail}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
