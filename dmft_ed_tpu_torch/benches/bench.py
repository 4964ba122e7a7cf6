"""Headline benchmark of the port: the factorized sector H·v inside the
plain-Lanczos three-term recurrence, on the card — the counterpart of the
repo root's ``bench.py`` (BASELINE.json's metric "SpMV nnz/s per chip;
Lanczos iters/sec").

The problem is ``bench.py``'s: Norb=1, U=2, beta=100, a bath of
``nbath`` levels at ``linspace(-1, 1)`` with hybridizations drawn from
``default_rng(0)`` in [0.3, 0.7], and its half-filled (Ns/2, Ns/2)
sector; at the default Nbath=13 (Ns=14) that is one 3432x3432 block,
11,778,624 states, an ed_nano-class sector. The per-spin operators are
dense up to 8192 (``dense_matmul_threshold``), so one matvec is the
diagonal plus two 3432x3432 products: f64 GEMMs under ``native``, the
Ozaki int8 digit kernel (``csrc/digit_matmul.cu``) under ``ozaki5x7``,
f32 GEMMs under ``float32``.

Throughput is *effective CSR nonzeros per second*: the nonzeros the
reference's stored-CSR SpMV would touch for the sector
(``SectorHamiltonian.nnz_estimate``) over the time of one Lanczos step.
``vs_baseline`` divides by 2e9 nnz/s, ``bench.py``'s estimate for the
Fortran code's MPI CSR SpMV on a full CPU node (the reference publishes no
numbers); it is an estimate for a CPU node, not a measurement of any
device.

    python -m dmft_ed_tpu_torch.benches.bench [--device cpu] [--nbath 13]

prints the card line, then one JSON line (metric
``sector_HxV_effective_nnz_per_s_f64``, with every precision's run under
``detail.runs``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import card_line, device_name, peak_gib, reset_peak, timed
from ..bath import Bath
from ..config import EDConfig
from ..device import resolve
from ..hamiltonian import (build_sector_hamiltonian, make_matvec_op,
                           vector_dtype)
from ..kernels import KERNELS
from ..lanczos import _op_matvec, _pdot_pair, _real_dtype, eigs_lanczos_op
from ..sectors import sector_table

CPU_NODE_CSR_BASELINE = 2.0e9  # nnz/s; see the module docstring
PRECISIONS = {"ozaki5x7": ("float64", "ozaki5x7"),
              "native": ("float64", "native"),
              "float32": ("float32", "native")}


def build_hamiltonian(nbath: int, dtype: str = "float64",
                      matmul_precision: str = "native"):
    """(cfg, sector, ham) of ``bench.py``'s problem, built on the host."""
    cfg = EDConfig(norb=1, nbath=nbath, nspin=1, uloc=(2.0,), beta=100.0,
                   dtype=dtype, matmul_precision=matmul_precision,
                   dense_matmul_threshold=8192).validate()
    rng = np.random.default_rng(0)
    bath = Bath(cfg)
    bath.e[:] = np.linspace(-1, 1, nbath)[None, None, :]
    bath.v[:] = rng.uniform(0.3, 0.7, size=bath.v.shape)
    sec = sector_table(cfg).get(cfg.ns // 2, cfg.ns // 2)
    return cfg, sec, build_sector_hamiltonian(cfg, sec, bath,
                                              np.zeros((1, 1, 1, 1)))


def build_problem(nbath: int, dtype: str = "float64",
                  matmul_precision: str = "native", device="cuda"):
    """(cfg, sector, ham, spec, arrays, blocks, matvec) of ``bench.py``'s
    problem; matvec maps a flat sector vector to H times it (the port's
    ``lanczos._op_matvec``: a CUDA graph where the port graphs)."""
    cfg, sec, ham = build_hamiltonian(nbath, dtype, matmul_precision)
    spec, arrays, blocks = make_matvec_op(ham, cfg, resolve(device))
    return cfg, sec, ham, spec, arrays, blocks, _op_matvec(spec, blocks,
                                                           arrays)


def start_vector(sec, dtype, device):
    """``bench.run``'s v0: default_rng(1) normals in the block layout,
    cast to `dtype`, normalized in it; flat."""
    blk = sec.blocks[0]
    v0 = np.random.default_rng(1).normal(size=(blk.ddw, blk.dup))
    v0 = torch.as_tensor(v0, device=resolve(device)).to(dtype).reshape(-1)
    return v0 / torch.linalg.vector_norm(v0)


def lanczos_loop(matvec, v0, niter: int):
    """``bench.py``'s three-term recurrence: (v_niter, alphas [niter],
    betas [niter]) in v0's dtype, no reorthogonalization, no breakdown
    test beyond a zero beta."""
    v_prev = torch.zeros_like(v0)
    v = v0
    b_prev = torch.zeros((), dtype=_real_dtype(v0.dtype), device=v0.device)
    one = torch.ones_like(b_prev)
    alphas, betas = [], []
    for _ in range(niter):
        w = matvec(v)
        a = _pdot_pair(v, w)
        w = w - a * v - b_prev * v_prev
        b = torch.sqrt(_pdot_pair(w, w))
        v_prev, v = v, w / torch.where(b > 0, b, one)
        b_prev = b
        alphas.append(a)
        betas.append(b)
    return v, torch.stack(alphas), torch.stack(betas)


def _launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


def run(nbath: int = 13, dtype: str = "float64", niter: int = 30,
        repeats: int = 3, matmul_precision: str = "native", device="cuda"):
    """One warm-up of ``niter`` Lanczos steps, then the best of
    ``repeats`` timed runs (host clock between synchronisations). Returns
    the sector's dim and nnz, the alphas and betas, Lanczos iterations/s,
    nnz/s, seconds per step, the kernels' launches over every run and
    the peak device memory."""
    if repeats < 1:
        raise ValueError("run: repeats must be >= 1")
    dev = resolve(device)
    reset_peak(dev)
    before = _launches()
    cfg, sec, ham, spec, arrays, blocks, matvec = build_problem(
        nbath, dtype, matmul_precision, dev)
    vdt = getattr(torch, vector_dtype(spec))
    v0 = start_vector(sec, vdt, dev)
    (vf, al, be), warm = timed(lambda: lanczos_loop(matvec, v0, niter), dev)
    best = min(timed(lambda: lanczos_loop(matvec, v0, niter), dev)[1]
               for _ in range(repeats))
    nnz = ham.nnz_estimate()
    per_iter = best / niter
    return {
        "dim": int(sec.dim),
        "nnz": int(nnz),
        "dtype": dtype,
        "matmul_precision": matmul_precision,
        "niter": niter,
        "alphas": al.cpu().double().numpy().tolist(),
        "betas": be.cpu().double().numpy().tolist(),
        "finite": bool(torch.isfinite(vf).all()),
        "warmup_s": warm,
        "s_per_step": per_iter,
        "lanczos_iters_per_s": 1.0 / per_iter,
        "nnz_per_s": nnz / per_iter,
        "launches": {k: v - before[k] for k, v in _launches().items()},
        "peak_gib": peak_gib(dev),
        "device": device_name(dev),
    }


def ground_state(nbath: int = 13, matmul_precision: str = "native",
                 device="cuda"):
    """The sector's ground-state energy by the port's thick restart
    (``lanczos.eigs_lanczos_op``: one eigenpair, the basis size, step
    limit and tolerance of ``diag``'s rule for this config) from
    ``run``'s start vector. Returns egs, the matvecs, the seconds, the
    kernels' launches and the peak device memory."""
    from ..diag import _ncv
    dev = resolve(device)
    reset_peak(dev)
    before = _launches()
    cfg, sec, ham, spec, arrays, blocks, _ = build_problem(
        nbath, "float64", matmul_precision, dev)
    v0 = start_vector(sec, torch.float64, dev)
    ncv = _ncv(cfg, sec.dim, 1)
    (evals, evecs, niter), secs = timed(lambda: eigs_lanczos_op(
        spec, blocks, arrays, v0, 1, ncv, maxiter=min(sec.dim, cfg.lanc_niter),
        tol=cfg.lanc_tolerance), dev)
    return {"egs": float(evals[0]), "ncv": ncv, "matvecs": int(niter),
            "seconds": secs, "finite": bool(torch.isfinite(evecs).all()),
            "launches": {k: v - before[k] for k, v in _launches().items()},
            "peak_gib": peak_gib(dev), "matmul_precision": matmul_precision}


def headline(res: dict, card: str) -> dict:
    """``bench.py``'s JSON line from the runs of every precision."""
    oz, nat, f32 = res["ozaki5x7"], res["native"], res["float32"]
    value = oz["nnz_per_s"]
    return {
        "metric": "sector_HxV_effective_nnz_per_s_f64",
        "value": value,
        "unit": "nnz/s",
        "vs_baseline": value / CPU_NODE_CSR_BASELINE,
        "detail": {
            "precision_mode": "ozaki5x7 (int8 digit products on the "
                              "tensor cores, ~1e-10 rel)",
            "sector_dim": oz["dim"],
            "csr_equivalent_nnz": oz["nnz"],
            "lanczos_iters_per_s": oz["lanczos_iters_per_s"],
            "nnz_per_s_f64_emulated": nat["nnz_per_s"],
            "nnz_per_s_f32": f32["nnz_per_s"],
            "lanczos_iters_per_s_f32": f32["lanczos_iters_per_s"],
            "device": oz["device"],
            "lanczos_iters_per_s_native": nat["lanczos_iters_per_s"],
            "digit_matmul_launches_ozaki5x7":
                oz["launches"]["digit_matmul"],
            "card": card,
            "runs": {k: {f: v for f, v in r.items()
                         if f not in ("alphas", "betas")}
                     for k, r in res.items()},
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dmft_ed_tpu_torch.benches."
                                 "bench", description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nbath", type=int, default=13)
    ap.add_argument("--niter", type=int, default=30)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    card = card_line(dev)
    print(card, flush=True)
    res = {name: run(args.nbath, dtype, args.niter, args.repeats, prec, dev)
           for name, (dtype, prec) in PRECISIONS.items()}
    print(json.dumps(headline(res, card)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
