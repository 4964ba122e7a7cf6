#!/usr/bin/env python3
"""Where the time of one lockstep Lanczos step goes on the card.

Builds the whole-sweep operator of the main path (the Nbath=11 Bethe
config of ``chip_smoke.py``, every Krylov-class sector on the initial
bath) and times ``sweep_plain.sweep_tridiag`` steps:

* host wall seconds per step, with the card synchronised;
* device time per kernel name from ``torch.profiler`` over as many steps
  again, their sum, and the share of the unprofiled wall time the card
  was busy;
* the digit-matmul kernel's launches per step;
* the digit extraction of one 924-class dw right operand (C [924, 4096]):
  ``ozaki._right_digits``, which writes each digit transposed into the
  K-major stack, against the same extraction of the pre-transposed
  operand written straight (``_left_digits`` of C^T), so that the
  difference is the cost of the transposed writes.

Run on a machine with one CUDA card: ``python3 profile_port.py [--steps N]
[--precision ozaki5x7|native]``. Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--precision", default="ozaki5x7")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import MAIN_CFG, build_kernels
    from dmft_ed_tpu_torch.benches import card_line
    from dmft_ed_tpu_torch.bath import init_bath
    from dmft_ed_tpu_torch.config import EDConfig
    from dmft_ed_tpu_torch.hamiltonian import build_sector_hamiltonian
    from dmft_ed_tpu_torch.kernels import digit_matmul
    from dmft_ed_tpu_torch.sectors import sector_table
    from dmft_ed_tpu_torch.sweep_plain import make_sweep_op, sweep_tridiag

    card = card_line("cuda")
    print(f"card: {card}")
    build_kernels()
    dev = torch.device("cuda", 0)
    cfg = EDConfig(**dict(MAIN_CFG,
                          matmul_precision=args.precision)).validate()
    hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    bath = init_bath(cfg, hloc)
    secs = [s for s in sector_table(cfg).sectors
            if s.dim > cfg.lanc_dim_threshold]
    hams = [build_sector_hamiltonian(cfg, s, bath, hloc) for s in secs]
    spec, arrays = make_sweep_op(cfg, hams, dev)
    rng = np.random.default_rng(0)
    V0 = []
    for s in secs:
        v = torch.as_tensor(rng.normal(size=s.dim), device=dev)
        blk = s.blocks[0]
        V0.append((v / torch.linalg.vector_norm(v)).reshape(blk.ddw,
                                                              blk.dup))
    V0 = tuple(V0)
    sweep_tridiag(spec, arrays, 2, V0)                 # warm-up
    torch.cuda.synchronize()

    n0 = digit_matmul.launches
    t0 = time.time()
    sweep_tridiag(spec, arrays, args.steps, V0)
    torch.cuda.synchronize()
    wall = (time.time() - t0) / args.steps
    launches = (digit_matmul.launches - n0) / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        sweep_tridiag(spec, arrays, args.steps, V0)
        torch.cuda.synchronize()
        wall_prof = (time.time() - t0) / args.steps
    # device-side events only (kernels, copies): the CPU ops that launch
    # them carry the same time again
    rows = [(e.self_device_time_total / 1e3 / args.steps,
             e.count / args.steps, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{len(secs)} sectors, total dim {sum(s.dim for s in secs)}, "
          f"precision {args.precision}")
    print(f"wall {1e3 * wall:.3f} ms/step ({1e3 * wall_prof:.3f} under the "
          f"profiler); device busy {busy:.3f} ms/step; digit_matmul "
          f"launches {launches:g}/step")
    for ms, cnt, key in rows[:12]:
        print(f"  {ms:9.3f} ms/step  {cnt:8.1f} calls/step  {key[:90]}")
    kern = sum(r[0] for r in rows if "digit_matmul" in r[2])

    from chip_smoke import time_ms
    from dmft_ed_tpu_torch import ozaki
    nsl, bits = ozaki.parse_precision("ozaki5x7")
    C = torch.randn(924, 4096, dtype=torch.float64, device=dev)
    Ct = C.T.contiguous()
    t_right = time_ms(lambda: ozaki._right_digits(C, nsl, bits), 20)
    t_left = time_ms(lambda: ozaki._left_digits(Ct, nsl, bits), 20)
    print(f"digit extraction of a 924x4096 right operand: {t_right:.4f} ms "
          f"written transposed, {t_left:.4f} ms written straight from its "
          "transpose")
    print(json.dumps({
        "card": card, "precision": args.precision, "steps": args.steps,
        "sectors": len(secs), "wall_ms_per_step": 1e3 * wall,
        "wall_ms_per_step_profiled": 1e3 * wall_prof,
        "device_busy_ms_per_step": busy,
        # kernel durations barely change under the profiler; its host
        # overhead does, so the share is taken against the plain wall time
        "device_busy_share": busy / (1e3 * wall),
        "digit_matmul_ms_per_step": kern,
        "digit_matmul_launches_per_step": launches,
        "right_digits_transposed_ms": t_right,
        "left_digits_straight_ms": t_left,
        "top": [{"ms_per_step": r[0], "calls_per_step": r[1],
                 "name": r[2][:120]} for r in rows[:12]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
