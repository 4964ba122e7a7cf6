"""High-precision matrix multiplication from int8 digit products (Ozaki
scheme), PyTorch port of ``dmft_ed_tpu/ozaki.py``.

Each f64 operand is scaled per row (left) or per column (right) into
[-1/2, 1/2] and sliced into P digits of B bits, every digit an int8:

    A = diag(sa) · Σ_p 2^{-B(p+1)} A_p ,   B = Σ_q 2^{-B(q+1)} B_q · diag(sb)
    A·B = diag(sa) [ Σ_{p+q<P} 2^{-B(p+q+2)} (A_p·B_q) ] diag(sb)

The digit products accumulate exactly in int32 and combine through a
TwoSum f32 pair; that engine is the CUDA kernel ``kernels.digit_matmul``
(plain PyTorch on CPU tensors). "ozaki6" = (P, B) = (6, 6), "ozaki5x7" =
(5, 7): both ~1e-10 relative, 21 vs 15 digit-pair products.

Digit extraction is ``kernels.digit_split``: a CUDA kernel on a card, one
pass over the operand; on the CPU its plain version ``_digits_list``,
elementwise torch with f32 bit fields (``.view(torch.int32)``). Both are
bit-identical to the reference: native f32 arithmetic, exact casts, IEEE
exponent fields, round-half-to-even.

Schedules (``_schedule``): the concatenated one sums each group
Σ_{p+q=s} A_p·B_q in int32 while P·k·D² < 2^31 (``_cat_safe``); past that
each (p, q) product — chunked along k at 2^31/D² — enters the pair alone.

Layout. The kernel feeds both stacks to the int8 tensor cores, which take
8-bit operands only K-major, through TMA, which needs 16-byte row strides.
So both stacks here are K-major with the contraction axis zero-padded to
Kp = ``kpad(k)``, a multiple of 16: [P, m, Kp] (left) and [P, n, Kp]
(right, the transpose of the reference's [P, k, n]), digit 0 first. The
zero columns add exact zeros to every product. The right stack is written
transposed straight into its buffer. ``slice_digits`` keeps the
reference's layout.

Under a running ``torch.profiler`` (timer.py) the products with a per-call
operand record an ``ozaki.split`` span around that operand's digit
extraction.
"""

from __future__ import annotations

import torch

from . import timer
from .kernels import digit_matmul, digit_split
from .kernels.digit_matmul import kpad  # noqa: F401  (re-exported)
from .kernels.digit_split import _BITS, _digits_list

_INT32_LIM = 2.0 ** 31


def parse_precision(s: str):
    """matmul_precision string -> (nslices, bits).

    "ozaki6" -> (6, 6); "ozaki5x7" -> (5, 7). bits must be ≤ 7."""
    part = s[5:] or "6"
    if "x" in part:
        n, b = part.split("x")
        nslices, bits = int(n), int(b)
    else:
        nslices, bits = int(part), _BITS
    if not (1 <= bits <= 7):
        raise ValueError(f"ozaki digit width must be 1..7, got {bits} ({s})")
    return nslices, bits


def slice_digits(A, nslices: int, axis: int, bits: int = _BITS):
    """(digits [nslices, ...] int8, scales) with
    A ≈ scales·Σ_p 2^{-bits(p+1)}·D_p; axis is the non-contraction axis."""
    digits, scales = _digits_list(
        A, nslices, scale_axis=1 - axis if A.dim() == 2 else None, bits=bits)
    return torch.stack(digits), scales


def _cat_safe(k: int, nslices: int, bits: int = _BITS) -> bool:
    """Worst-case exactness of the concatenated int32 group sums (every
    digit ≤ D = 2^{bits-1}+1; group s = P-1 sums P·k products ≤ D²)."""
    dmax = (1 << (bits - 1)) + 1
    return nslices * k * dmax * dmax < _INT32_LIM


def _schedule(k: int, nslices: int, bits: int):
    """(pairwise, kchunk) for contraction length k: the concatenated
    schedule while _cat_safe holds, else per-(p, q) products chunked at
    kmax = 2^31/D² - 1 so no single int32 sum can wrap."""
    if _cat_safe(k, nslices, bits):
        return False, max(k, 1)
    dmax = (1 << (bits - 1)) + 1
    kmax = int(_INT32_LIM // (dmax * dmax)) - 1
    return True, min(max(k, 1), kmax)


def _right_digits(B, nslices: int, bits: int):
    """Right operand B [k, n]: (digits [P, n, Kp] K-major, zero past k;
    column scales [1, n]), digit p of B transposed into buf[p, :, :k]."""
    return digit_split(B, nslices, bits, right=True)


def _left_digits(A, nslices: int, bits: int):
    """Left operand A [m, k]: (digits [P, m, Kp] K-major, zero past k;
    row scales [m, 1])."""
    return digit_split(A, nslices, bits)


def matmul(A, B, nslices: int = 6, bits: int = _BITS):
    """A @ B in near-f64 precision via int8 digit products (A [m, k] f64,
    B [k, n] f64)."""
    k = A.shape[1]
    ad, sa = _left_digits(A, nslices, bits)
    bd, sb = _right_digits(B, nslices, bits)
    pairwise, kchunk = _schedule(k, nslices, bits)
    return digit_matmul(ad, bd, sa.reshape(-1), sb.reshape(-1), bits,
                        pairwise, kchunk, k=k)


def _pow2_ceil_f64(r):
    """2^ceil(log2(r)) for r > 0 f64, exactly, from the IEEE bit fields
    (frexp: r = m·2^e, m in [0.5, 1); an exact power of two has m = 0.5)."""
    m, e = torch.frexp(r)
    c = e.to(torch.int64) - (m == 0.5).to(torch.int64)
    return ((torch.clamp(c, -1022, 1023) + 1023) << 52).view(torch.float64)


def fused_lambda(Hdw, HupT, V):
    """λ of fused_two_sided, a 0-d f64 tensor on V's device: the power of
    two 2^ceil(log2(max|H| / max|V|)) that brings the Krylov operand to the
    Hamiltonian blocks' magnitude (1 where either maximum is 0)."""
    mh = torch.maximum(Hdw.abs().amax(), HupT.abs().amax())
    mv = V.abs().amax()
    one = torch.ones((), dtype=torch.float64, device=V.device)
    ratio = torch.where(mv > 0, torch.where(mh > 0, mh, one) / mv, one)
    return _pow2_ceil_f64(ratio)


def fused_two_sided(Hdw, HupT, V, nslices: int, bits: int = _BITS):
    """Hdw @ V + V @ HupT as ONE concatenated Ozaki product:

        [Hdw | λV] @ [λV ; HupT] = λ (Hdw @ V + V @ HupT)

    over the doubled contraction axis k = ddw + dup, through the
    digit-matmul kernel once (the reference's opt-in
    ``device.ozaki_fused``). λ (``fused_lambda``) is a power of two
    computed on the device, so the merge changes only the digit
    decomposition, not the represented product; the result's row scales
    carry the 1/λ. (The JAX package computes λ with exp2/log2, which XLA
    rounds on the CPU, so its λ is not always a power of two.)

    Hdw [ddw, ddw] f64; HupT [dup, dup] f64 (already transposed — the
    matvec applies V @ HupT); V [ddw, dup] f64."""
    with timer.span("ozaki.split", V):
        lam = fused_lambda(Hdw, HupT, V)
        Vl = lam * V
        L = torch.cat([Hdw, Vl], dim=1)             # [ddw, ddw + dup]
        R = torch.cat([Vl, HupT], dim=0)            # [ddw + dup, dup]
        ad, sa = _left_digits(L, nslices, bits)
        bd, sb = _right_digits(R, nslices, bits)
    k = L.shape[1]
    pairwise, kchunk = _schedule(k, nslices, bits)
    return digit_matmul(ad, bd, (sa / lam).reshape(-1), sb.reshape(-1), bits,
                        pairwise, kchunk, k=k)


class SlicedMatrix:
    """A pre-sliced constant LEFT operand A of A @ B (the per-spin
    Hamiltonian blocks, reused across hundreds of Lanczos iterations).

    digits: [P, m, Kp] int8 K-major, digit 0 first; scales: [m, 1]."""

    def __init__(self, A, nslices: int = 6, bits: int = _BITS):
        self.nslices = nslices
        self.bits = bits
        self.shape = tuple(A.shape)
        self.digits, self.scales = _left_digits(A, nslices, bits)

    def __matmul__(self, B):
        return sliced_matmul(self.digits, self.scales, B, self.nslices,
                             self.bits)


def sliced_matmul(Ad, sa, B, nslices: int, bits: int = _BITS):
    """(pre-sliced A) @ B: Ad [P, m, Kp] digits, sa [m, 1] row scales;
    B [k, n] is sliced per column on the fly."""
    k = B.shape[0]
    with timer.span("ozaki.split", B):
        bd, sb = _right_digits(B, nslices, bits)
    pairwise, kchunk = _schedule(k, nslices, bits)
    return digit_matmul(Ad, bd, sa.reshape(-1), sb.reshape(-1), bits,
                        pairwise, kchunk, k=k)


class SlicedRightOperand:
    """Pre-sliced constant RIGHT operand A [k, n] of B @ A, scaled per
    column.

    digits: [P, n, Kp] int8 K-major, digit 0 first; scales: [1, n]."""

    def __init__(self, A, nslices: int = 6, bits: int = _BITS):
        self.nslices = nslices
        self.bits = bits
        self.shape = tuple(A.shape)
        self.digits, self.scales = _right_digits(A, nslices, bits)

    def __rmatmul__(self, B):
        return right_sliced_matmul(B, self.digits, self.scales, self.nslices,
                                   self.bits)


def right_sliced_matmul(B, Ad, sa, nslices: int, bits: int = _BITS):
    """B @ (pre-sliced A): Ad [P, n, Kp] digits, sa [1, n] column scales;
    B [m, k] is sliced per row on the fly. Scaled row first, then column,
    as the reference multiplies (· sb · sa)."""
    k = B.shape[1]
    with timer.span("ozaki.split", B):
        bdig, sb = _left_digits(B, nslices, bits)
    pairwise, kchunk = _schedule(k, nslices, bits)
    return digit_matmul(bdig, Ad, sb.reshape(-1), sa.reshape(-1), bits,
                        pairwise, kchunk, k=k)
