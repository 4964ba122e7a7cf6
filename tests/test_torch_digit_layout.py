"""K-major, zero-padded Ozaki digit stacks of the PyTorch port against the
JAX package.

The port's kernel reads both digit stacks K-major with the contraction
axis padded to Kp, a multiple of 16: left [P, m, Kp], right [P, n, Kp]
(the transpose of the reference's [P, k, n]). Held here on the CPU, where
the wrapper takes its plain version:

* both stacks carry the reference's digits, with zero pad columns;
* the products over the new layout (``matmul``, ``sliced_matmul``,
  ``right_sliced_matmul``) are bitwise equal to the JAX ``ozaki`` module
  at every per-spin dimension of the Nbath=11 main path, K = C(12, n),
  for both schemes, and at a ragged shape: the pad adds exact zeros to
  exact int32 sums, and the f32 epilogue is unchanged;
* the pairwise schedule forced with kchunk = 39 stays bitwise equal,
  also where k is a multiple of the chunk and Kp > k (the chunks fall on
  the true k, not on Kp);
* the wrapper refuses a stack whose Kp is not a multiple of 16 and a
  non-contiguous stack;
* only the first k columns enter, on both schedules: nonzero pad columns
  change no bit.

The kernel itself is held against the plain version at the same K classes
on the card (``tests/test_torch_ozaki.py::test_kernel_vs_plain_on_card``),
and with nonzero pad columns here (``test_pad_never_enters_on_card``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dmft_ed_tpu import ozaki as jozaki
from dmft_ed_tpu_torch import ozaki as tozaki
from dmft_ed_tpu_torch.kernels import digit_matmul, digit_matmul_plain

SCHEMES = [(5, 7), (6, 6)]
K_CLASSES = [1, 12, 66, 220, 495, 792, 924]     # C(12, n), n = 0..6


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, k)) * np.exp(rng.normal(size=(m, 1)) * 2)
    B = rng.normal(size=(k, n)) * np.exp(rng.normal(size=(1, n)) * 2)
    return A, B


@pytest.mark.parametrize("k", K_CLASSES + [16, 129])
def test_stacks_kmajor_padded(k):
    nsl, bits = 5, 7
    A, B = _operands(10, 9, k, 7)
    kp = tozaki.kpad(k)
    assert kp % 16 == 0 and k <= kp < k + 16
    ad, sa = tozaki._left_digits(torch.from_numpy(A), nsl, bits)
    bd, sb = tozaki._right_digits(torch.from_numpy(B), nsl, bits)
    assert ad.shape == (nsl, 9, kp) and bd.shape == (nsl, 7, kp)
    assert ad.dtype == bd.dtype == torch.int8
    assert ad.is_contiguous() and bd.is_contiguous()
    assert not ad[:, :, k:].any() and not bd[:, :, k:].any()
    # the digits and scales themselves are the reference's
    dj, sj = jozaki.slice_digits(jnp.asarray(A), nsl, 0, bits)
    assert np.array_equal(np.asarray(dj), ad[:, :, :k].numpy())
    assert np.array_equal(np.asarray(sj), sa.numpy())
    dj, sj = jozaki.slice_digits(jnp.asarray(B), nsl, 1, bits)
    assert np.array_equal(np.asarray(dj),
                          bd[:, :, :k].transpose(1, 2).numpy())
    assert np.array_equal(np.asarray(sj), sb.numpy())


def _all_products(nsl, bits, A, B):
    """(jax, torch) results of matmul, sliced_matmul and
    right_sliced_matmul on the same operands."""
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    Aj, Bj = jnp.asarray(A), jnp.asarray(B)
    lj, lt = jozaki.SlicedMatrix(A, nsl, bits), \
        tozaki.SlicedMatrix(At, nsl, bits)
    rj, rt = jozaki.SlicedRightOperand(B, nsl, bits), \
        tozaki.SlicedRightOperand(Bt, nsl, bits)
    out = {
        "matmul": (jozaki.matmul(Aj, Bj, nsl, bits),
                   tozaki.matmul(At, Bt, nsl, bits)),
        "sliced": (jozaki.sliced_matmul(lj.digits, lj.scales, Bj, nsl, bits),
                   tozaki.sliced_matmul(lt.digits, lt.scales, Bt, nsl,
                                        bits)),
        "right": (jozaki.right_sliced_matmul(Aj, rj.digits, rj.scales, nsl,
                                             bits),
                  tozaki.right_sliced_matmul(At, rt.digits, rt.scales, nsl,
                                             bits)),
    }
    return {k: (np.asarray(a), b.numpy()) for k, (a, b) in out.items()}


@pytest.mark.parametrize("nsl,bits", SCHEMES)
@pytest.mark.parametrize("shape", [(5, k, 6) for k in K_CLASSES]
                         + [(37, 129, 29)])
def test_products_bitwise_vs_jax(nsl, bits, shape):
    """Bitwise against JAX; against exact f64 within 1e-9 of |A|·|B|
    elementwise, the truncation class of both schemes."""
    A, B = _operands(11, *shape)
    exact = A @ B
    mag = np.abs(A) @ np.abs(B)
    for name, (ref, got) in _all_products(nsl, bits, A, B).items():
        assert np.array_equal(got, ref), name
        assert np.all(np.abs(got - exact) <= 1e-9 * mag), name


@pytest.mark.parametrize("k", [97, 117, 124])
def test_pairwise_kchunk39_bitwise(k, monkeypatch):
    """kchunk = 39 (a lowered int32 limit, as tests/test_ozaki.py forces
    it): 97 leaves a short last chunk, 117 = 3 x 39 ends on a chunk
    boundary below Kp = 128, 124 ends inside the pad's 16-byte group."""
    nsl, bits = 5, 7
    A, B = _operands(12, 23, k, 19)
    dmax = (1 << (bits - 1)) + 1
    lim = dmax * dmax * 40.0
    monkeypatch.setattr(jozaki, "_INT32_LIM", lim)
    monkeypatch.setattr(tozaki, "_INT32_LIM", lim)
    assert tozaki._schedule(k, nsl, bits) == (True, 39)
    for name, (ref, got) in _all_products(nsl, bits, A, B).items():
        assert np.array_equal(got, ref), name


def _stacks(k=20):
    A, B = _operands(13, 12, k, 9)
    ad, sa = tozaki._left_digits(torch.from_numpy(A), 5, 7)
    bd, sb = tozaki._right_digits(torch.from_numpy(B), 5, 7)
    return ad, bd, sa.reshape(-1), sb.reshape(-1)


@pytest.mark.parametrize("fault", ["kp_not_16", "k_above_kp",
                                   "noncontiguous_left",
                                   "noncontiguous_right", "k_major_mismatch"])
def test_wrapper_refuses_layout(fault):
    ad, bd, rs, cs = _stacks()
    k = 20
    if fault == "kp_not_16":
        ad, bd = ad[:, :, :24].contiguous(), bd[:, :, :24].contiguous()
    elif fault == "k_above_kp":
        k = 33
    elif fault == "noncontiguous_left":
        ad = torch.zeros((5, 32, 12), dtype=torch.int8).transpose(1, 2)
    elif fault == "noncontiguous_right":
        bd = torch.zeros((5, 32, 9), dtype=torch.int8).transpose(1, 2)
    else:                       # the reference's N-major right stack
        bd = bd[:, :, :k].transpose(1, 2).contiguous()
    n0 = digit_matmul.launches
    with pytest.raises(ValueError):
        digit_matmul(ad, bd, rs, cs, 7, k=k)
    assert digit_matmul.launches == n0


def test_plain_true_k_matches_padded():
    """The plain version over the true k and over all of Kp agree on the
    concatenated schedule (the pad columns are zero)."""
    ad, bd, rs, cs = _stacks()
    a = digit_matmul_plain(ad, bd, rs, cs, 7, k=20)
    b = digit_matmul_plain(ad, bd, rs, cs, 7)
    assert torch.equal(a, b)


def _dirty(t, k, v):
    t = t.clone()
    t[:, :, k:] = v
    return t


@pytest.mark.parametrize("pairwise,kchunk", [(False, None), (True, 7)])
def test_pad_never_enters(pairwise, kchunk):
    ad, bd, rs, cs = _stacks()
    ref = digit_matmul(ad, bd, rs, cs, 7, pairwise, kchunk, k=20)
    got = digit_matmul(_dirty(ad, 20, 37), _dirty(bd, 20, -37), rs, cs, 7,
                       pairwise, kchunk, k=20)
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("pairwise,kchunk", [(False, None), (True, 39)])
@pytest.mark.parametrize("k", [129, 924])
def test_pad_never_enters_on_card(k, pairwise, kchunk):
    """The kernel with nonzero pad columns against the plain version on
    clean stacks, bitwise (run there with ``python -m pytest -m gpu
    tests/test_torch_digit_layout.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    A, B = _operands(14, 300, k, 501)
    ad, sa = tozaki._left_digits(torch.from_numpy(A).cuda(), 5, 7)
    bd, sb = tozaki._right_digits(torch.from_numpy(B).cuda(), 5, 7)
    rs, cs = sa.reshape(-1), sb.reshape(-1)
    got = digit_matmul(_dirty(ad, k, 37), _dirty(bd, k, -37), rs, cs, 7,
                       pairwise, kchunk, k=k)
    ref = digit_matmul_plain(ad, bd, rs, cs, 7, pairwise, kchunk, k=k)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
