"""Readings for the limits that decide ``correct``: a cell's compared
numbers from sound runs of the program on many seeds, and from its
control (the program's float32 path in its place), in one process; a
cell held out of BENCHMARK.json (``held/``) runs too:

    python3 -m benchmark.control --workload <name> --seeds 1 2 3 \
        [--variant float32] [--seconds 1]

Each seed is one run of the cell (set-up, a short window of at least one
unit, the comparison); one JSON line per run. The benchmark's own runs
never run the control.
"""

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant", choices=("float32",), default=None)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--precision", default=None,
                    help="another matmul_precision for the traffic (the "
                         "reading of a lower-precision route of the "
                         "program)")
    args = ap.parse_args(argv)
    import torch
    from . import harness
    if not torch.cuda.is_available():
        print("control: needs a card", file=sys.stderr)
        return 2
    spec = harness.load_spec(held=True)
    for seed in args.seeds:
        res = harness.run_cell(
            spec, args.workload, seed, args.seconds, False, "cuda",
            variant=args.variant,
            traffic_overrides={"matmul_precision": args.precision}
            if args.precision else None)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "variant": args.variant or args.precision
                          or "program",
                          "correct": res["correct"],
                          "units": res["attempted"],
                          "checks": {k: c["value"] for k, c in
                                     res["checks"].items()},
                          "metrics": res["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
