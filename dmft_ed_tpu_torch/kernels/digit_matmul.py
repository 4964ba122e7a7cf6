"""Ozaki int8 digit matmul: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``dmft_ed_tpu/pallas_kernels.py``
``_digit_matmul_kernel`` (``digit_matmul_tiles`` / ``matmul_fused``), whose
sum the JAX package computes with the XLA composition of ``ozaki.py``
(``_cat_groups`` / ``_pairwise`` + ``_group_combine``). Given the int8 digit
stacks of a row-scaled left operand and a column-scaled right operand,

    out = ((f64(hi) + f64(lo)) * rs[:, None]) * cs[None, :]

with (hi, lo) the TwoSum f32 pair of Σ_s 2^{-bits(s+2)} g_s over exact
int32 digit products (see ``csrc/digit_matmul.cu`` for the schedule and
epilogue, which both versions here follow step for step).

Layout: both stacks K-major, ad [P, M, Kp] and bd [P, N, Kp], with the
contraction axis padded to Kp, a multiple of 16 (``kpad``); ``k`` is
the true contraction length. Both versions, on both schedules, contract
over the first k columns alone (the pad's contents never enter), and the
pairwise chunks fall on k.

Bound on the card: operation-bound at the main path's shapes
(2·P(P+1)/2·M·N·k int8 operations against the int8 peak; the bytes are the
digit stacks read once and the f64 output written once). Design: TMA tiles
into a ring of shared-memory stages and ``wgmma`` s8 on the tensor cores
for the concatenated schedule; the pairwise schedule keeps a ``__dp4a``
route — see the source note.

The wrapper launches the kernel for a CUDA tensor (or raises) and takes the
plain version only for a tensor that lies on the CPU. ``digit_matmul.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_NAME = "digit_matmul"
K_ALIGN = 16          # Kp must be a multiple of this (16-byte TMA strides)
TILE_M = 128          # CTA tile rows of the tensor-core route (dp4a: 64)
_GRID_Y_MAX = 65535


def kpad(k: int) -> int:
    """Contraction length of the K-major digit stacks: k rounded up to a
    multiple of K_ALIGN, at least K_ALIGN."""
    return -(-max(k, 1) // K_ALIGN) * K_ALIGN


def _lib():
    lib = _build.load(_NAME)
    fn = lib.digit_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _combine(hi, lo, g, sc):
    """One exact int32 term g into the TwoSum f32 pair at scale sc
    (ozaki._group_combine, same operations in the same order)."""
    ghi = g.to(torch.float32)
    glo = (g - ghi.to(torch.int32)).to(torch.float32)
    x = ghi * sc
    t = hi + x
    bp = t - hi
    err = (hi - (t - bp)) + (x - bp)
    return t, lo + err + glo * sc


def digit_matmul_plain(ad, bd, rs, cs, bits: int, pairwise: bool = False,
                       kchunk: int | None = None, k: int | None = None):
    """Plain PyTorch version: the same schedule and epilogue, with the
    digit products as f64 matmuls (exact: every partial sum stays below
    2^31, far inside f64's 2^53) cast back to int32. ad [P, M, Kp],
    bd [P, N, Kp]; only the first k (default Kp) columns enter, and the
    pairwise chunks fall on k as in ``ozaki._pairwise``."""
    P, M, _ = ad.shape
    N = bd.shape[1]
    K = ad.shape[2] if k is None else k
    kchunk = K if kchunk is None else kchunk
    A = ad[:, :, :K].to(torch.float64)
    B = bd[:, :, :K].to(torch.float64)
    hi = torch.zeros((M, N), dtype=torch.float32, device=ad.device)
    lo = torch.zeros_like(hi)
    for s in range(P):
        sc = torch.tensor(2.0 ** (-bits * (s + 2)), dtype=torch.float32,
                          device=ad.device)
        g = None
        for p in range(s + 1):
            for c0 in range(0, K, kchunk) if K else [0]:
                c1 = min(K, c0 + kchunk)
                prod = A[p][:, c0:c1] @ B[s - p][:, c0:c1].T
                if pairwise:
                    hi, lo = _combine(hi, lo, prod.to(torch.int32), sc)
                else:
                    g = prod if g is None else g + prod
        if not pairwise:
            hi, lo = _combine(hi, lo, g.to(torch.int32), sc)
    out = hi.to(torch.float64) + lo.to(torch.float64)
    return out * rs[:, None] * cs[None, :]


def _check(ad, bd, rs, cs, bits, k, kchunk):
    """The layout and arguments the kernel takes, on any device: returns
    (P, M, N, Kp, K, kchunk); raises ValueError on anything else."""
    if ad.dim() != 3 or bd.dim() != 3:
        raise ValueError("digit_matmul: digit stacks must be [P, rows, Kp]")
    P, M, Kp = ad.shape
    if bd.shape[0] != P or bd.shape[2] != Kp:
        raise ValueError(f"digit_matmul: digit stacks {tuple(ad.shape)} and "
                         f"{tuple(bd.shape)} do not contract (both must be "
                         "K-major [P, rows, Kp])")
    N = bd.shape[1]
    K = Kp if k is None else int(k)
    if Kp % K_ALIGN or Kp == 0:
        raise ValueError(f"digit_matmul: Kp={Kp} is not a positive multiple "
                         f"of {K_ALIGN} (pad with kpad)")
    if not 0 <= K <= Kp:
        raise ValueError(f"digit_matmul: k={K} outside 0..Kp={Kp}")
    for t, dt, shape, nm in ((ad, torch.int8, None, "ad"),
                             (bd, torch.int8, None, "bd"),
                             (rs, torch.float64, (M,), "rs"),
                             (cs, torch.float64, (N,), "cs")):
        if t.device != ad.device or t.dtype != dt or not t.is_contiguous() \
                or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"digit_matmul: {nm} must be a contiguous "
                             f"{dt} tensor on {ad.device}"
                             + (f" of shape {shape}" if shape else ""))
    if not 1 <= P <= 7 or not 1 <= bits <= 7:
        raise ValueError(f"digit_matmul: P={P}, bits={bits} outside 1..7")
    kchunk = max(K, 1) if kchunk is None else int(kchunk)
    if kchunk < 1:
        raise ValueError("digit_matmul: kchunk must be >= 1")
    return P, M, N, Kp, K, kchunk


def digit_matmul(ad, bd, rs, cs, bits: int, pairwise: bool = False,
                 kchunk: int | None = None, k: int | None = None):
    """ad [P, M, Kp] int8 and bd [P, N, Kp] int8, both K-major (digit 0
    first, Kp a multiple of 16; only the first k <= Kp columns enter),
    rs [M] and cs [N] float64 -> out [M, N] float64.
    pairwise/kchunk select the schedule (ozaki._schedule decides it from
    the exactness bound)."""
    P, M, N, Kp, K, kchunk = _check(ad, bd, rs, cs, bits, k, kchunk)
    if ad.device.type == "cpu":
        return digit_matmul_plain(ad, bd, rs, cs, bits, pairwise, kchunk, K)
    if ad.device.type != "cuda":
        raise ValueError(f"digit_matmul: unsupported device {ad.device}")
    if K == 0:
        raise ValueError("digit_matmul: the kernel takes k >= 1")
    for t, nm in ((ad, "ad"), (bd, "bd")):
        if t.data_ptr() % 16:
            raise ValueError(f"digit_matmul: {nm} is not 16-byte aligned "
                             "(TMA reads it)")
    if -(-M // (64 if pairwise else TILE_M)) > _GRID_Y_MAX:
        raise ValueError(f"digit_matmul: M={M} exceeds the launch grid")
    out = torch.empty((M, N), dtype=torch.float64, device=ad.device)
    if M == 0 or N == 0:
        return out
    fn = _lib().digit_matmul_launch
    with torch.cuda.device(ad.device):
        stream = torch.cuda.current_stream(ad.device).cuda_stream
        err = fn(ad.data_ptr(), bd.data_ptr(), rs.data_ptr(), cs.data_ptr(),
                 out.data_ptr(), P, M, N, Kp, K, int(bits), kchunk,
                 int(bool(pairwise)), stream)
    if err != 0:
        raise RuntimeError(f"digit_matmul kernel launch failed: error {err} "
                           "(below 1000 a cudaError_t, else 1000 + the "
                           "CUresult of cuTensorMapEncodeTiled)")
    digit_matmul.launches += 1
    return out


digit_matmul.launches = 0
