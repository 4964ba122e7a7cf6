"""The mix terms of one block pair as a signed gather: the CUDA kernel's
wrapper and its plain version.

Replaces no TPU kernel: the JAX package applies the mix terms (spin
exchange, pair hopping, superc pairing) as dense or COO ``jnp`` products
(``dmft_ed_tpu/hamiltonian.py`` ``apply_op``). Where every spin part of a
(src, dst) pair's terms is a signed partial permutation (at most one ±1
in every row and column: a hop operator c†_a c_b, or c_l, c†_l),
``hamiltonian.make_matvec_op`` encodes the pair as a "pmix" entry of
per-term tables, [L, ddw] for the dw side and [L, dup] for the up side:

* ``dsrc``, ``usrc`` (int32): the source row of each destination row, the
  source column of each destination column, or -1;
* ``dwt``: the dw sign times the term's coefficient (exact); ``usg``: the
  up sign (±1); both of the vector's real dtype;
* ``rows`` (int32 [R]): the destination rows that some term writes.

Both versions compute, for every leading index and every (r in rows, c),
``acc = Σ_l (dwt[l, r] · usg[l, c]) · V[dsrc[l, r], usrc[l, c]]`` over the
terms with both sources, in term order, and add it to ``Y[r, c]`` in
place, leaving every entry no term reaches untouched. Each product rounds
once before the add, as the dense product followed by the add to Y does,
so where at most one term reaches an entry the result is bitwise the dense
"bmix" path's.

Bound on the card: memory. At the Hund operator's (7,7) sector (3432 x
3432, four terms of 853,776 entries) the distinct entries of V read and
of Y written are 54.6 MB, 16.3 µs at 3.35 TB/s; the kernel
(``csrc/mix_gather.cu``) also reads the Y entries it writes. One thread
owns one column of a 128-column tile and walks 4 compact rows, the
column's table entries in registers (see the source note). The wrapper
launches the kernel for CUDA tensors (or raises), takes the plain version
only for tensors on the CPU, and reads no device value; ``mix_gather.launches``
counts the kernel's launches. The library builds at its first launch, so
an operator without such terms never builds or loads it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_NAME = "mix_gather"


def _lib():
    lib = _build.load(_NAME)
    fn = lib.mix_gather_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int] + [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def mix_gather_plain(v, y, dsrc, dwt, usrc, usg, rows):
    """Plain PyTorch version: per term, the gathered V[..., rows' sources,
    columns' sources] times the signed coefficients, accumulated in term
    order where both sources exist; then added to y's rows in place.
    Returns y."""
    ds = dsrc[:, rows].long()                        # [L, R]
    w = dwt[:, rows]
    us = usrc.long()
    acc = hit = None
    for l in range(ds.shape[0]):
        ok = (ds[l] >= 0)[:, None] & (us[l] >= 0)[None, :]
        g = v[..., ds[l].clamp(min=0)[:, None], us[l].clamp(min=0)[None, :]]
        p = (w[l][:, None] * usg[l][None, :]) * g
        if acc is None:
            acc, hit = torch.where(ok, p, torch.zeros_like(p)), ok
        else:
            acc = torch.where(ok, torch.where(hit, acc + p, p), acc)
            hit = hit | ok
    if acc is None:
        return y
    rl = rows.long()
    cur = y[..., rl, :]
    y[..., rl, :] = torch.where(hit, cur + acc, cur)
    return y


def _check(v, y, dsrc, dwt, usrc, usg, rows):
    """The operands the kernel takes, on any device; raises ValueError on
    anything else."""
    L, ddw = dsrc.shape
    dup = usrc.shape[1]
    if v.dtype not in (torch.float64, torch.float32) or y.dtype != v.dtype \
            or dwt.dtype != v.dtype or usg.dtype != v.dtype:
        raise ValueError(f"mix_gather: v, y, dwt and usg must share one "
                         f"real dtype, got {v.dtype}, {y.dtype}, "
                         f"{dwt.dtype}, {usg.dtype}")
    if dsrc.dtype != torch.int32 or usrc.dtype != torch.int32 \
            or rows.dtype != torch.int32:
        raise ValueError("mix_gather: dsrc, usrc and rows must be int32")
    if tuple(dwt.shape) != (L, ddw) or tuple(usrc.shape) != (L, dup) \
            or tuple(usg.shape) != (L, dup) or rows.dim() != 1 \
            or y.shape[-2:] != (ddw, dup) or v.dim() != y.dim() \
            or v.shape[:-2] != y.shape[:-2]:
        raise ValueError(
            f"mix_gather: shapes v {tuple(v.shape)}, y {tuple(y.shape)}, "
            f"tables [{L}, {ddw}] / [{L}, {dup}], rows {tuple(rows.shape)}")
    if v.untyped_storage().data_ptr() == y.untyped_storage().data_ptr():
        raise ValueError("mix_gather: v and y share one storage")


def mix_gather(v, y, dsrc, dwt, usrc, usg, rows):
    """y[..., r, c] += Σ_l (dwt[l, r] usg[l, c]) v[..., dsrc[l, r],
    usrc[l, c]] over `rows` (see the module note), in place; returns y
    (on the card, a contiguous copy of a non-contiguous y)."""
    _check(v, y, dsrc, dwt, usrc, usg, rows)
    if v.device.type == "cpu":
        return mix_gather_plain(v, y, dsrc, dwt, usrc, usg, rows)
    if v.device.type != "cuda":
        raise ValueError(f"mix_gather: unsupported device {v.device}")
    ms, ks = v.shape[-2:]
    ddw, dup = y.shape[-2:]
    if v.stride(-1) != 1:
        v = v.contiguous()
    v3 = v.reshape((-1, ms, ks))
    if not y.is_contiguous():
        y = y.contiguous()
    y3 = y.view((-1, ddw, dup))
    nb, R, L = y3.shape[0], rows.shape[0], dsrc.shape[0]
    if nb == 0 or R == 0 or L == 0 or dup == 0:
        return y
    lib = _lib()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.mix_gather_launch(
            v3.data_ptr(), v3.stride(0), v3.stride(1), y3.data_ptr(),
            y3.stride(0), y3.stride(1), nb, dsrc.data_ptr(), dwt.data_ptr(),
            usrc.data_ptr(), usg.data_ptr(), rows.data_ptr(), R, L, ddw, dup,
            int(v.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"mix_gather kernel launch failed: cudaError_t "
                           f"{err}")
    mix_gather.launches += 1
    return y


mix_gather.launches = 0
