"""The Ozaki digit extraction of the PyTorch port (``kernels.digit_split``).

``ozaki._left_digits`` / ``_right_digits`` go through the wrapper: on a CPU
tensor it takes its plain version (``_digits_list`` written into the
zero-padded K-major buffer), on a CUDA tensor it launches the kernel of
``csrc/digit_split.cu``. Held here on the CPU: the wrapper equals the
digit list of ``_digits_list`` (digits, scales, zero pad) in both layouts,
at k that is not a multiple of 16 and on operands built to hit the
arithmetic's edges, also through ``hamiltonian._ozaki_left`` /
``_ozaki_right`` with leading batch dimensions; it launches nothing on the
CPU and refuses other devices and operands. The ``gpu`` tests hold the
kernel bitwise against the plain version on the card (run there with
``python -m pytest -m gpu tests/test_torch_digit_split.py``).
"""

import numpy as np
import pytest
import torch

from dmft_ed_tpu_torch import hamiltonian, ozaki
from dmft_ed_tpu_torch.kernels import (digit_matmul_plain, digit_split,
                                       digit_split_plain)
from dmft_ed_tpu_torch.kernels.digit_split import _digits_list

SCHEMES = [(5, 7), (6, 6)]


def _groups(seed, g, k, bits):
    """[g, k] f64: row i is the i-th scale group (a row of a left operand,
    a column of a right one). Mixed signs and scales, and groups built for
    the arithmetic's edges where they fit: an all-zero group and an
    all-zero contraction index; a maximum whose f32 cast rounds up to a
    power of two; values on exact .5 ties of the first and second digit;
    values that are f32 subnormals after scaling (and f64 values that
    vanish in f32); a maximum near the f32 limit, where the scale's
    exponent clamps; an f32-subnormal maximum."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(g, k)) * np.exp(rng.normal(size=(g, 1)) * 2)
    half = 2.0 ** (bits - 1)
    edges = [
        np.zeros(k),
        np.r_[4.0 * (1 - 2.0 ** -30), 0.5 * (1 - 2.0 ** -30),
              rng.uniform(-2, 2, size=k)],
        np.r_[1.0, [(s * (q + 0.5)) / half for q in range(3, 40, 7)
                    for s in (1, -1)],
              [(q + (r + 0.5) / 2 ** bits) / half for q in (5, -9)
               for r in (3, -4)], rng.uniform(-1, 1, size=k)],
        np.r_[2.0 ** 100, 2.0 ** -30 * rng.normal(size=4), 1e-50,
              -3 * 2.0 ** -36, rng.normal(size=k)],
        np.r_[1.5 * 2.0 ** 127, -2.0 ** 120, rng.normal(size=k) * 1e30],
        np.r_[1e-40, -3e-41, rng.normal(size=k) * 1e-42],
    ]
    for i, e in enumerate(edges[:g]):
        G[i] = e[:k]
    if k > 2 and g > 1:
        G[:, 1] = 0.0
    return G


def _operand(seed, rows, k, bits, right):
    """The left operand [rows, k] or the right operand [k, rows]."""
    G = _groups(seed, rows, k, bits)
    return torch.from_numpy(np.ascontiguousarray(G.T if right else G))


def _list_path(X, nsl, bits, right):
    """The expected stack from ``_digits_list``'s digit list: K-major,
    zero-padded to kpad(k)."""
    digits, scales = _digits_list(X, nsl, 0 if right else 1, bits)
    D = torch.stack(digits)                    # [P, rows, k] or [P, k, rows]
    if right:
        D = D.transpose(1, 2)
    k = D.shape[2]
    buf = torch.zeros(D.shape[:2] + (ozaki.kpad(k),), dtype=torch.int8)
    buf[:, :, :k] = D
    return buf, scales


@pytest.mark.parametrize("right", [False, True], ids=["left", "right"])
@pytest.mark.parametrize("nsl,bits", SCHEMES)
@pytest.mark.parametrize("rows,k", [(9, 1), (11, 17), (7, 53), (6, 210)])
def test_wrapper_equals_digits_list(rows, k, nsl, bits, right):
    X = _operand(rows * k, rows, k, bits, right)
    want_d, want_s = _list_path(X, nsl, bits, right)
    split = ozaki._right_digits if right else ozaki._left_digits
    n0 = digit_split.launches
    got_d, got_s = split(X, nsl, bits)
    assert digit_split.launches == n0
    assert got_d.dtype == torch.int8 and got_d.is_contiguous()
    assert got_d.shape == (nsl, rows, ozaki.kpad(k))
    assert got_s.shape == ((1, rows) if right else (rows, 1))
    assert torch.equal(got_d, want_d)
    assert torch.equal(got_s, want_s)
    assert not got_d[:, :, k:].any()
    assert got_d.abs().max() <= 127


def test_batched_products_through_hamiltonian():
    """``_ozaki_left`` (O @ v) and ``_ozaki_right`` (v @ O^T) with two
    leading batch dimensions fold them into the vector operand's columns
    or rows; every batch member's product equals the plain kernel on the
    list path's digits of that member."""
    nsl, bits, m, k = 5, 7, 13, 17
    O = _operand(1, m, k, bits, False)
    dg, sc = ozaki._left_digits(O, nsl, bits)
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.normal(size=(2, 3, k, 19)))
    got = hamiltonian._ozaki_left(dg, sc, v, nsl, bits)
    assert got.shape == (2, 3, m, 19)
    for idx in np.ndindex(2, 3):
        bd, sb = _list_path(v[idx], nsl, bits, True)
        want = digit_matmul_plain(dg, bd, sc.reshape(-1), sb.reshape(-1),
                                  bits, k=k)
        assert torch.equal(got[idx], want)
    # w @ O^T: O^T [k, m] pre-sliced as the right operand, per column
    dgr, scr = ozaki._right_digits(O.T.contiguous(), nsl, bits)
    w = torch.from_numpy(rng.normal(size=(2, 3, 11, k)))
    got = hamiltonian._ozaki_right(dgr, scr, w, nsl, bits)
    assert got.shape == (2, 3, 11, m)
    for idx in np.ndindex(2, 3):
        ad, sa = _list_path(w[idx], nsl, bits, False)
        want = digit_matmul_plain(ad, dgr, sa.reshape(-1), scr.reshape(-1),
                                  bits, k=k)
        assert torch.equal(got[idx], want)


def test_wrapper_refuses():
    """On a CPU tensor the wrapper launches nothing; a device that is
    neither CPU nor CUDA, a non-f64 or non-matrix operand and P or bits
    outside 1..7 are refused."""
    X = _operand(3, 12, 20, 7, False)
    n0 = digit_split.launches
    d, s = digit_split(X, 5, 7)
    dp, sp = digit_split_plain(X, 5, 7)
    assert torch.equal(d, dp) and torch.equal(s, sp)
    assert digit_split.launches == n0
    for bad in (lambda: digit_split(X.to("meta"), 5, 7),
                lambda: digit_split(X.to("meta"), 5, 7, right=True),
                lambda: digit_split(X.float(), 5, 7),
                lambda: digit_split(X[0], 5, 7),
                lambda: digit_split(X, 8, 7),
                lambda: digit_split(X, 5, 0)):
        with pytest.raises(ValueError):
            bad()
    assert digit_split.launches == n0


# (rows, k): the Nbath=13 3432 class, the 924 class (a square operator and
# the dw product's 924 x 4096 panel), the superc 252 / 210 pairing
# classes, k = 1 and k = 17
CARD_SHAPES = [(3432, 3432), (924, 924), (4096, 924), (210, 252), (252, 210),
               (1000, 1), (300, 17)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("right", [False, True], ids=["left", "right"])
@pytest.mark.parametrize("nsl,bits", SCHEMES)
@pytest.mark.parametrize("rows,k", CARD_SHAPES)
def test_kernel_bitwise_on_card(rows, k, nsl, bits, right):
    """The kernel against the plain version on the card and on the CPU,
    bitwise: digits, zero pad and scales; one launch per call."""
    dev = _card()
    X = _operand(rows + k, rows, k, bits, right)
    Xd = X.to(dev)
    n0 = digit_split.launches
    got_d, got_s = digit_split(Xd, nsl, bits, right)
    assert digit_split.launches == n0 + 1
    ref_d, ref_s = digit_split_plain(Xd, nsl, bits, right)
    torch.cuda.synchronize()
    assert torch.equal(got_d, ref_d) and torch.equal(got_s, ref_s)
    cpu_d, cpu_s = digit_split_plain(X, nsl, bits, right)
    assert torch.equal(got_d.cpu(), cpu_d) and torch.equal(got_s.cpu(), cpu_s)


@pytest.mark.gpu
@pytest.mark.parametrize("right", [False, True], ids=["left", "right"])
def test_kernel_strided_operands_on_card(right):
    """Operands the Krylov engines hand over as views: a transposed
    matrix and the real and imaginary parts of a complex one (stride 2),
    bitwise the plain version on a contiguous copy."""
    dev = _card()
    rng = np.random.default_rng(5)
    Z = torch.from_numpy(rng.normal(size=(300, 517))
                         + 1j * rng.normal(size=(300, 517))).to(dev)
    for X in (Z.real.T, Z.real, Z.imag):
        got = digit_split(X, 5, 7, right)
        ref = digit_split_plain(X.contiguous(), 5, 7, right)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
