"""Ozaki digit extraction: the CUDA kernel's wrapper and its plain version.

Replaces no TPU kernel: the JAX package slices its operands with plain
``jnp`` (``dmft_ed_tpu/ozaki.py`` ``_digits_list``). Given an f64 operand,
both versions return its int8 digit stack, K-major and zero-padded as
``kernels.digit_matmul`` reads it, and its f64 power-of-two scales:

* left (``right=False``): A [m, k] scaled per row -> digits [P, m, Kp],
  scales [m, 1];
* right (``right=True``): A [k, n] scaled per column -> digits [P, n, Kp]
  (A's digits transposed), scales [1, n];

with Kp = ``kpad(k)``. The plain version is ``_digits_list``: elementwise
torch with f32 bit fields (``.view(torch.int32)``), bit-identical to the
JAX package (native f32 arithmetic, exact casts, IEEE exponent fields,
round-half-to-even). The kernel (``csrc/digit_split.cu``) does the same
arithmetic in one pass over the operand and is bit-identical to it.

Bound on the card: memory, the f64 operand read once and the P int8 planes
written once (see the source note for the design). The wrapper launches
the kernel for a CUDA tensor (or raises), takes the plain version only for
a tensor on the CPU, reads no device value and uploads nothing.
``digit_split.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .digit_matmul import kpad

_NAME = "digit_split"
_BITS = 6              # default digit width ("ozakiN" == N slices of 6 bits)


def _lib():
    lib = _build.load(_NAME)
    fn = lib.digit_split_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        lib.digit_split_strips.argtypes = [ctypes.c_int]
        lib.digit_split_strips.restype = ctypes.c_int
    return lib


def _pow2_f32(e):
    """2^e as exact f32 from the exponent bit field (e int32, clipped to
    the normal range)."""
    eb = torch.clamp(e + 127, 1, 254).to(torch.int32) << 23
    return eb.view(torch.float32)


def _ceil_log2_f32(m):
    """ceil(log2(m)) for m >= 0 f32, exactly, from the IEEE bit fields."""
    b = m.view(torch.int32)
    expo = ((b >> 23) & 0xFF) - 127
    frac = b & 0x7FFFFF
    return expo + (frac != 0).to(torch.int32)


def _two_sum_f32(a, b):
    """Knuth TwoSum: s + err == a + b exactly."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def _digits_list(A, nslices: int, scale_axis, bits: int = _BITS, out=None):
    """Digit slices of A (list of int8 tensors in A's layout) and the f64
    power-of-two scales, constant along `scale_axis` (0: per-column
    scales, 1: per-row scales, None: one scale). With `out` (an int8
    [nslices, ...] view in A's layout) digit p is written into out[p]
    instead, and the list is empty."""
    a32 = A.to(torch.float32)
    if scale_axis is None:
        m = a32.abs().amax().reshape((1,) * A.dim())
    else:
        m = a32.abs().amax(dim=scale_axis, keepdim=True)
    E = _ceil_log2_f32(m) + 1
    inv = _pow2_f32(-E)
    u1 = a32 * inv
    S64 = _pow2_f32(E).to(torch.float64)
    u2 = (A - u1.to(torch.float64) * S64).to(torch.float32) * inv
    stepB = torch.tensor(2.0 ** bits, dtype=torch.float32, device=A.device)
    t, c = u1, u2
    digits = []
    for p in range(nslices):
        y = t * stepB
        cB = c * stepB
        s, e2 = _two_sum_f32(y, cB)
        q = torch.round(s)
        d = s - q
        t, c = _two_sum_f32(d, e2)
        q = torch.clamp(q, -127.0, 127.0)
        if out is None:
            digits.append(q.to(torch.int8))
        else:
            out[p].copy_(q)          # exact: q is an integer in [-127, 127]
    return digits, S64


def _kmajor_buffer(nslices: int, rows: int, k: int, device):
    """[P, rows, kpad(k)] int8 with the pad columns zeroed."""
    buf = torch.empty((nslices, rows, kpad(k)), dtype=torch.int8,
                      device=device)
    if buf.shape[2] > k:
        buf[:, :, k:].zero_()
    return buf


def digit_split_plain(A, nslices: int, bits: int, right: bool = False):
    """Plain PyTorch version: ``_digits_list`` written into the zero-padded
    K-major buffer (the right operand's digits transposed, digit by
    digit)."""
    if right:
        k, n = A.shape
        buf = _kmajor_buffer(nslices, n, k, A.device)
        _, s = _digits_list(A, nslices, scale_axis=0, bits=bits,
                            out=buf[:, :, :k].transpose(1, 2))
    else:
        m, k = A.shape
        buf = _kmajor_buffer(nslices, m, k, A.device)
        _, s = _digits_list(A, nslices, scale_axis=1, bits=bits,
                            out=buf[:, :, :k])
    return buf, s


def _check(A, nslices: int, bits: int):
    """The operand and arguments the kernel takes, on any device; raises
    ValueError on anything else."""
    if A.dim() != 2 or A.dtype != torch.float64:
        raise ValueError(f"digit_split: the operand must be a 2-D float64 "
                         f"tensor, got {A.dtype} of shape {tuple(A.shape)}")
    if not 1 <= nslices <= 7 or not 1 <= bits <= 7:
        raise ValueError(f"digit_split: P={nslices}, bits={bits} outside "
                         "1..7")


def digit_split(A, nslices: int, bits: int = _BITS, right: bool = False):
    """(digits [P, rows, Kp] int8, scales) of the f64 operand A: the left
    operand A [rows, k] with scales [rows, 1], or with `right` the right
    operand A [k, rows] with scales [1, rows]; Kp = kpad(k), zero past k."""
    _check(A, nslices, bits)
    if A.device.type == "cpu":
        return digit_split_plain(A, nslices, bits, right)
    if A.device.type != "cuda":
        raise ValueError(f"digit_split: unsupported device {A.device}")
    k, rows = A.shape if right else A.shape[::-1]
    if k == 0:
        raise ValueError("digit_split: the kernel takes k >= 1")
    out = torch.empty((nslices, rows, kpad(k)), dtype=torch.int8,
                      device=A.device)
    scales = torch.empty((1, rows) if right else (rows, 1),
                         dtype=torch.float64, device=A.device)
    if rows == 0:
        return out, scales
    lib = _lib()
    # the right operand's column maxima per strip of rows (uint32 bits)
    partial = None if not right else torch.empty(
        (lib.digit_split_strips(k), rows), dtype=torch.int32, device=A.device)
    s0, s1 = A.stride()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.digit_split_launch(
            A.data_ptr(), s0, s1, rows, k, out.shape[2], nslices, int(bits),
            int(bool(right)), out.data_ptr(), scales.data_ptr(),
            None if partial is None else partial.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"digit_split kernel launch failed: cudaError_t "
                           f"{err}")
    digit_split.launches += 1
    return out, scales


digit_split.launches = 0
