"""Start a group of rank processes on this host and collect what each
returns — for the tests and the card's smoke run, which drive the mesh
from one program. (A user runs the ranks under ``torchrun`` instead.)

    results = run_ranks("path/to/file.py:fn", world=2, kwargs={...},
                        workdir=tmp, timeout=120)

(or a module's function, ``"package.module:fn"``);
starts `world` processes of ``python -m dmft_ed_tpu_torch.parallel.spawn``;
rank r joins a process group (``init_process_group`` with the given
backend, a ``FileStore`` under `workdir` and a timeout), changes into
``workdir/shared``, one directory for every rank, as ``torchrun`` started
in one directory gives (a rank function that needs a directory of its
own makes it), calls ``fn(**kwargs)`` and pickles its return value.
The parent waits for every rank at most `timeout` seconds, kills any left
and raises if one failed; the ranks' output goes to
``workdir/rank<r>.log``. A rank imports torch, the port and the target's
file, nothing else.
"""

from __future__ import annotations

import datetime
import importlib.util
import os
import pickle
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load(target: str):
    path, fn = target.rsplit(":", 1)
    if not path.endswith(".py"):
        return getattr(importlib.import_module(path), fn)
    spec = importlib.util.spec_from_file_location(
        "_rank_target_" + os.path.splitext(os.path.basename(path))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, fn)


def run_ranks(target: str, world: int, kwargs: dict, workdir: str,
              timeout: float, backend: str = "gloo",
              threads: int = 1) -> list:
    """Run ``target`` ("file.py:function" or "package.module:function")
    on `world` ranks; returns the ranks' return values in rank order."""
    os.makedirs(workdir, exist_ok=True)
    job = os.path.join(workdir, "job.pkl")
    path, fn = target.rsplit(":", 1)
    if path.endswith(".py"):
        path = os.path.abspath(path)
    with open(job, "wb") as fh:
        pickle.dump(dict(target=f"{path}:{fn}",
                         world=world, kwargs=kwargs, backend=backend,
                         store=os.path.join(workdir, "store"),
                         timeout=timeout, threads=threads), fh)
    penv = dict(os.environ)
    penv.update(OMP_NUM_THREADS=str(threads), MKL_NUM_THREADS=str(threads),
                OPENBLAS_NUM_THREADS=str(threads),
                PYTHONPATH=os.pathsep.join(
                    [_REPO] + [p for p in [penv.get("PYTHONPATH")] if p]))
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dmft_ed_tpu_torch.parallel.spawn", job,
             str(r)], stdout=log, stderr=subprocess.STDOUT, env=penv,
            cwd=_REPO))
    t_end = time.time() + timeout
    failed = []
    try:
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, t_end - time.time()))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} timed out after {timeout:g} s")
                continue
            if rc != 0:
                failed.append(f"rank {r} exited with {rc}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for log in logs:
            log.close()
    if failed:
        tails = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.log")) as fh:
                tails.append(f"--- rank {r}:\n" + fh.read()[-3000:])
        raise RuntimeError("; ".join(failed) + "\n" + "\n".join(tails))
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.out.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _rank_main(job_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist
    with open(job_path, "rb") as fh:
        job = pickle.load(fh)
    torch.set_num_threads(job["threads"])
    workdir = os.path.dirname(job_path)
    dist.init_process_group(
        job["backend"], store=dist.FileStore(job["store"], job["world"]),
        rank=rank, world_size=job["world"],
        timeout=datetime.timedelta(seconds=job["timeout"]))
    try:
        fn = _load(job["target"])
        here = os.path.join(workdir, "shared")
        os.makedirs(here, exist_ok=True)
        os.chdir(here)
        res = fn(**job["kwargs"])
        with open(os.path.join(workdir, f"rank{rank}.out.pkl"), "wb") as fh:
            pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
