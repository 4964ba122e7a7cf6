"""Ozaki int8 digit products of the PyTorch port against the JAX package.

On CPU tensors ``kernels.digit_matmul`` takes its plain PyTorch version,
which follows the CUDA kernel's schedule and TwoSum epilogue step for step.
Measured here: digits, scales and every product are bitwise equal to the
JAX ``ozaki`` module (the int32 group sums are exact in both, and the f32
epilogue runs the same IEEE operations in the same order); the stated bound
is 1e-13 * max|out|. Against exact f64 the truncation class is 1e-9
relative (tests/test_ozaki.py). The Pallas kernel rounds each int32 product
to f32 and sums in another order, so it is held to 1e-9
(tests/test_pallas_kernels.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dmft_ed_tpu import ozaki as jozaki
from dmft_ed_tpu import pallas_kernels as pk
from dmft_ed_tpu_torch import ozaki as tozaki
from dmft_ed_tpu_torch.kernels import digit_matmul, digit_matmul_plain

SCHEMES = [(5, 7), (6, 6)]


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, k)) * np.exp(rng.normal(size=(m, 1)) * 2)
    B = rng.normal(size=(k, n)) * np.exp(rng.normal(size=(1, n)) * 2)
    return A, B


@pytest.mark.parametrize("nsl,bits", SCHEMES + [(4, 6), (3, 5)])
def test_digits_bitwise(nsl, bits):
    A, _ = _operands(0, 37, 53, 1)
    A[3, :] = 0.0                       # an all-zero row
    A[5, 7] = 2.0 ** -30                # tiny next to its row's max
    for axis in (0, 1, None):
        dj, sj = jozaki._digits_list(jnp.asarray(A), nsl, axis, bits)
        dt, st = tozaki._digits_list(torch.from_numpy(A), nsl, axis, bits)
        assert len(dj) == len(dt) == nsl
        for x, y in zip(dj, dt):
            assert y.dtype == torch.int8
            assert np.array_equal(np.asarray(x), y.numpy())
        assert np.array_equal(np.asarray(sj), st.numpy())
    dj, sj = jozaki.slice_digits(jnp.asarray(A), nsl, 0, bits)
    dt, st = tozaki.slice_digits(torch.from_numpy(A), nsl, 0, bits)
    assert np.array_equal(np.asarray(dj), dt.numpy())
    assert np.array_equal(np.asarray(sj), st.numpy())


def test_parse_precision():
    for s in ("ozaki", "ozaki6", "ozaki5x7", "ozaki4x5"):
        assert tozaki.parse_precision(s) == jozaki.parse_precision(s)
    with pytest.raises(ValueError):
        tozaki.parse_precision("ozaki5x8")


def _products(nsl, bits, A, B):
    """(jax, torch) results of matmul, sliced_matmul and
    right_sliced_matmul on the same operands."""
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    Aj, Bj = jnp.asarray(A), jnp.asarray(B)
    out = {}
    out["matmul"] = (jozaki.matmul(Aj, Bj, nsl, bits),
                     tozaki.matmul(At, Bt, nsl, bits))
    lj, lt = jozaki.SlicedMatrix(A, nsl, bits), \
        tozaki.SlicedMatrix(At, nsl, bits)
    out["sliced"] = (jozaki.sliced_matmul(lj.digits, lj.scales, Bj, nsl,
                                          bits),
                     tozaki.sliced_matmul(lt.digits, lt.scales, Bt, nsl,
                                          bits))
    rj, rt = jozaki.SlicedRightOperand(B, nsl, bits), \
        tozaki.SlicedRightOperand(Bt, nsl, bits)
    out["right"] = (jozaki.right_sliced_matmul(Aj, rj.digits, rj.scales, nsl,
                                               bits),
                    tozaki.right_sliced_matmul(At, rt.digits, rt.scales, nsl,
                                               bits))
    out["operators"] = (lj @ Bj, lt @ Bt)
    out["operators_r"] = (Aj @ rj, At @ rt)
    return {k: (np.asarray(a), b.numpy()) for k, (a, b) in out.items()}


@pytest.mark.parametrize("nsl,bits", SCHEMES)
@pytest.mark.parametrize("shape", [(37, 53, 29), (64, 200, 3)])
def test_products_vs_jax(nsl, bits, shape):
    A, B = _operands(1, *shape)
    exact = A @ B
    for name, (ref, got) in _products(nsl, bits, A, B).items():
        scale = np.max(np.abs(ref))
        assert np.max(np.abs(got - ref)) <= 1e-13 * scale, name
        assert np.max(np.abs(got - exact)) / np.max(np.abs(exact)) < 1e-9, \
            name


@pytest.mark.parametrize("nsl,bits", SCHEMES)
def test_products_bitwise(nsl, bits):
    """The match with the JAX composition is exact, not only within the
    bound."""
    A, B = _operands(2, 41, 77, 23)
    for name, (ref, got) in _products(nsl, bits, A, B).items():
        assert np.array_equal(got, ref), name


@pytest.mark.parametrize("shape", [(256, 300, 256), (300, 128, 500)])
def test_vs_pallas_interpret(shape):
    """B = 6 against the Pallas kernel run by its interpreter."""
    A, B = _operands(0, *shape)
    exact = A @ B
    scale = np.max(np.abs(exact))
    pal = np.asarray(pk.matmul_fused(jnp.asarray(A), jnp.asarray(B), 6,
                                     tm=128, tn=128, interpret=True))
    got = tozaki.matmul(torch.from_numpy(A), torch.from_numpy(B), 6,
                        6).numpy()
    assert np.max(np.abs(got - pal)) / scale < 1e-9
    assert np.max(np.abs(got - exact)) / scale < 1e-9


@pytest.mark.parametrize("nsl,bits", SCHEMES)
def test_pairwise_schedule(nsl, bits, monkeypatch):
    """A lowered int32 limit forces the pairwise schedule with a chunked
    contraction axis (as tests/test_ozaki.py does for the JAX package); the
    port still matches the JAX fallback bitwise and exact f64 to 1e-9."""
    A, B = _operands(5, 31, 97, 29)
    exact = A @ B
    dmax = (1 << (bits - 1)) + 1
    lim = dmax * dmax * 40.0            # kmax = 39: three chunks of k = 97
    monkeypatch.setattr(jozaki, "_INT32_LIM", lim)
    monkeypatch.setattr(tozaki, "_INT32_LIM", lim)
    pairwise, kchunk = tozaki._schedule(97, nsl, bits)
    assert pairwise and kchunk == 39
    # unique shape: no jit cache compiled with the real limit
    ref = np.asarray(jozaki.matmul(jnp.asarray(A), jnp.asarray(B), nsl, bits))
    got = tozaki.matmul(torch.from_numpy(A), torch.from_numpy(B), nsl,
                        bits).numpy()
    assert np.array_equal(got, ref)
    assert np.max(np.abs(got - exact)) / np.max(np.abs(exact)) < 1e-9


def test_schedule_matches_cat_safe():
    for nsl, bits in SCHEMES:
        for k in (1, 924, 100_000, 400_000):
            pairwise, kchunk = tozaki._schedule(k, nsl, bits)
            assert pairwise == (not jozaki._cat_safe(k, nsl, bits))
            dmax = (1 << (bits - 1)) + 1
            assert kchunk <= max(k, 1)
            assert kchunk * dmax * dmax < 2 ** 31


def test_wrapper_checks_and_counts():
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing; a device that is neither CPU nor CUDA is refused."""
    A, B = _operands(3, 12, 20, 9)
    ad, sa = tozaki._left_digits(torch.from_numpy(A), 5, 7)
    bd, sb = tozaki._right_digits(torch.from_numpy(B), 5, 7)
    n0 = digit_matmul.launches
    out = digit_matmul(ad, bd, sa.reshape(-1), sb.reshape(-1), 7)
    ref = digit_matmul_plain(ad, bd, sa.reshape(-1), sb.reshape(-1), 7)
    assert torch.equal(out, ref)
    assert digit_matmul.launches == n0
    with pytest.raises(ValueError):
        digit_matmul(ad.to("meta"), bd.to("meta"), sa.reshape(-1),
                     sb.reshape(-1), 7)


# the per-spin dimensions C(12, n) of the Nbath=11 main path, as the dw
# (K x K times K x n) and the up (m x K times K x K) product families
K_CLASSES = (1, 12, 66, 220, 495, 792)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,forced", [((924, 924, 600), False),
                                          ((300, 129, 501), False),
                                          ((300, 129, 501), True)]
                         + [((k, k, 1000), False) for k in K_CLASSES]
                         + [((1000, k, k), False) for k in K_CLASSES])
def test_kernel_vs_plain_on_card(shape, forced, monkeypatch):
    """The CUDA kernel against its plain version on the card, bitwise
    (run there with ``python -m pytest -m gpu tests/test_torch_ozaki.py``):
    the tensor-core route at every K class of the main path and a ragged
    shape, the dp4a route on the forced pairwise schedule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    A, B = _operands(4, *shape)
    At, Bt = torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda()
    ad, sa = tozaki._left_digits(At, 5, 7)
    bd, sb = tozaki._right_digits(Bt, 5, 7)
    if forced:
        monkeypatch.setattr(tozaki, "_INT32_LIM", 1024.0 * 40)
    pairwise, kchunk = tozaki._schedule(shape[1], 5, 7)
    assert pairwise == forced
    n0 = digit_matmul.launches
    got = digit_matmul(ad, bd, sa.reshape(-1), sb.reshape(-1), 7, pairwise,
                       kchunk, k=shape[1])
    ref = digit_matmul_plain(ad, bd, sa.reshape(-1), sb.reshape(-1), 7,
                             pairwise, kchunk, k=shape[1])
    torch.cuda.synchronize()
    assert digit_matmul.launches == n0 + 1
    assert torch.equal(got, ref)
