"""Peaks of the card and the work that a sector's H·v needs.

The least time of one H·v is fixed by the work that the cell's precision
defines, not by the code that carries it out:

- ``native``: the two dense per-spin products of the block-Kronecker
  operator ``H V = D * V + H_dw V + V H_up^T`` in float64, each
  ``2 M N K`` operations on the float64 tensor cores; or the bytes of the
  operator and of the vectors read and written once, where that takes
  longer.
- ``ozaki<P>x<B>``: each product as ``P (P + 1) / 2`` int8 digit products
  of ``2 M N K`` operations on the int8 tensor cores (the digit pairs
  whose exponents sum to at most ``P + 1``); or the bytes that the
  product moves at least (the float64 vector operand read once, its ``P``
  int8 digit planes written and read once, the operator's ``P`` digit
  planes, split once at set-up, read once, and the float64 result written
  once), where that takes longer.

The peaks are NVIDIA's data sheet for the H100 SXM part at its 700 W
limit (dense rates, without sparsity).
"""

from __future__ import annotations

import re

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f64_tensor_flops": 67e12,
                              "int8_tensor_ops": 1979e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> dict:
    """The peak table of the card named `kind` (KeyError where unknown:
    no share is reported against a guessed peak)."""
    return PEAKS[kind]


def ozaki_digits(precision: str):
    """(P, B) of an ``ozaki<P>x<B>`` precision (B = 7 for ``ozaki<P>``)."""
    m = re.fullmatch(r"ozaki(\d+)(?:x(\d+))?", precision)
    if m is None:
        raise ValueError(f"not an Ozaki precision: {precision!r}")
    return int(m.group(1)), int(m.group(2) or 7)


def gemm_f64(m: int, n: int, k: int):
    """(operations, bytes) of one float64 product [m,k] @ [k,n]."""
    return 2.0 * m * n * k, 8.0 * (m * k + k * n + m * n)


def digit_product(m: int, n: int, k: int, p: int):
    """(int8 operations, bytes) of one Ozaki product of an operator
    [m,k], split into p digit planes at set-up, and a float64 vector
    operand [k,n] split at each call: p (p + 1) / 2 digit products; the
    vector read, its planes written and read, the operator's planes read
    and the float64 result written, each once."""
    ops = 2.0 * m * n * k * (p * (p + 1) // 2)
    nbytes = 8.0 * k * n + 2.0 * p * k * n + p * m * k + 8.0 * m * n
    return ops, nbytes


def digit_kernel_bound_s(m: int, n: int, k: int, p: int, kind: str) -> float:
    """Least time of the digit kernel alone on one product: its int8
    operations, or its own bytes (both digit stacks read once, the float64
    result written once) where that is larger."""
    pk = peaks(kind)
    ops = 2.0 * m * n * k * (p * (p + 1) // 2)
    nbytes = p * (m * k + k * n) + 8.0 * m * n
    return max(ops / pk["int8_tensor_ops"], nbytes / pk["hbm_bytes_per_s"])


def matvec_bound_s(ddw: int, dup: int, precision: str, kind: str) -> float:
    """Least time of one H·v of a one-block sector [ddw, dup] with dense
    per-spin operators: H_dw [ddw, ddw] @ V and V @ H_up^T [dup, dup]."""
    pk = peaks(kind)
    shapes = ((ddw, dup, ddw), (ddw, dup, dup))
    if precision == "native":
        ops = sum(gemm_f64(*s)[0] for s in shapes)
        nbytes = 8.0 * (ddw * ddw + dup * dup + 3 * ddw * dup)
        return max(ops / pk["f64_tensor_flops"],
                   nbytes / pk["hbm_bytes_per_s"])
    p, _ = ozaki_digits(precision)
    work = [digit_product(*s, p) for s in shapes]
    return max(sum(w[0] for w in work) / pk["int8_tensor_ops"],
               sum(w[1] for w in work) / pk["hbm_bytes_per_s"])
