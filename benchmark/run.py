"""Run one cell of the port's benchmark once, on the card:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Exits 2 without printing a result where
torch sees no card or fewer cards than the cell asks for, and 3 where the
process holds jax, jaxlib, flax or the JAX package once the window has
closed. The program's build caches stay inside the checkout.
"""

import time

PROCESS_T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(_ROOT, "bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
# one process with few host threads: steadier runs
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "4"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from . import harness
    spec = harness.load_spec()
    wl = harness.by_name(spec["workloads"], args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"benchmark: the cell needs {wl['chips']} card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    res = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", PROCESS_T0)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    harness.emit(res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
