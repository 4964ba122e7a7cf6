"""Zero-embedded (ragged) operators, the ragged Green's-function route and
the fused two-orientation Ozaki product of the PyTorch port, against the
JAX package on the same operators and vectors (numpy seeds).

Bounds, measured on these configs (Nbath=4, dims <= 100):

* ``make_padded_matvec_op``: every array equal to JAX's (Ozaki digit
  stacks after the layout change: the port's are K-major [P, rows, Kp]),
  the same kinds; the product equal to the unpadded operator's on the
  embedded block within 1e-13 of max|Hv| (measured 0 for every kind) and
  exactly zero on the pad; against JAX's padded product 1e-12 (measured
  3.3e-17 dense, 0 Ozaki and COO);
* digit stacks of operands with zero rows or columns: finite scales and
  zero digits there, in both packages, and equal;
* ``ResolventBatch`` through ``_run_ragged`` (COO operators, which the
  sweep engine declines): poles within 1e-10 and weights within 1e-12 of
  JAX over 16-step chains (measured 4.4e-15 and 5.3e-14);
* a real ``ozl``/``ozr`` (or ``ozf``) operator on a complex vector: within
  1e-9 of the f64 product relative to its largest entry (measured
  7.2e-11, 1.3e-10 fused);
* ``fused_two_sided``: bitwise equal to JAX where JAX's λ is exact (λ = 1);
  at a Krylov-like operand with λ = 2^6, JAX's λ is XLA's exp2 of 6,
  63.99999999999998 on the CPU, so the packages digit slightly different
  operands: held within the digits' truncation class, 1e-9 relative
  (measured 4.6e-16 here, since no digit crossed), and the port within
  1e-9 of the f64 product (measured 1.8e-10).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dmft_ed_tpu.bath as jbath
import dmft_ed_tpu.config as jconfig
import dmft_ed_tpu.device as jdevice
import dmft_ed_tpu.gf_common as jgf
import dmft_ed_tpu.hamiltonian as jham
import dmft_ed_tpu.ozaki as jozaki
import dmft_ed_tpu.sectors as jsectors
import dmft_ed_tpu_torch.bath as tbath
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.gf_common as tgf
import dmft_ed_tpu_torch.hamiltonian as tham
import dmft_ed_tpu_torch.lanczos as tlanczos
import dmft_ed_tpu_torch.ozaki as tozaki
import dmft_ed_tpu_torch.sectors as tsectors
from dmft_ed_tpu_torch.kernels import digit_matmul_plain


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test. With several pytest-xdist workers on
    a few cores, torch's default threads over-subscribe them, and the many
    small ops of the CPU Ozaki products wait at thread barriers: the
    ragged fault case of test_torch_chi.py took 552 s in one of six
    workers against 19 s alone. The bounds stated above hold either way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KINDS = {"dense": dict(matmul_precision="native"),
         "ozaki": dict(matmul_precision="ozaki5x7"),
         "coo": dict(matmul_precision="native", dense_matmul_threshold=4)}


def _setup(seed=4, **kw):
    base = dict(norb=1, nbath=4, nspin=1, uloc=(2.0,), xmu=0.1,
                ed_verbose=0)
    base.update(kw)
    jcfg = jconfig.EDConfig(**base).validate()
    tcfg = tconfig.EDConfig(**base).validate()
    rng = np.random.default_rng(seed)
    jb, tb = jbath.Bath(jcfg), tbath.Bath(tcfg)
    jb.e[:] = rng.uniform(-1.0, 1.0, jb.e.shape)
    jb.v[:] = rng.uniform(0.3, 0.7, jb.v.shape)
    tb.e[:], tb.v[:] = jb.e, jb.v
    return jcfg, tcfg, jb, tb, np.zeros((1, 1, 1, 1))


def _hams(jcfg, tcfg, jb, tb, hloc, qn):
    js = jsectors.sector_table(jcfg).get(*qn)
    ts = tsectors.sector_table(tcfg).get(*qn)
    return (jham.build_sector_hamiltonian(jcfg, js, jb, hloc),
            tham.build_sector_hamiltonian(tcfg, ts, tb, hloc))


def _as_jax_layout(kind, arr, k):
    """A port array in the JAX package's layout: Ozaki digit stacks
    [P, rows, Kp] -> [rows, P*k] ascending (left) or [P*k, n] descending
    (right); everything else as is."""
    a = arr.numpy()
    if kind == "ozl" and a.ndim == 3:
        return a[:, :, :k].transpose(1, 0, 2).reshape(a.shape[1], -1)
    if kind == "ozr" and a.ndim == 3:
        return np.concatenate([d[:, :k].T for d in a[::-1]], axis=0)
    return a


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_padded_matvec_op_vs_jax(kind):
    jcfg, tcfg, jb, tb, hloc = _setup(**KINDS[kind])
    hj, ht = _hams(jcfg, tcfg, jb, tb, hloc, (1, 2))      # block (10, 5)
    b = ht.sector.blocks[0]
    pad = (10, 10, ht.hup[0].rows.size + 3, ht.hdw[0].rows.size + 2)
    sj, aj, bj = jham.make_padded_matvec_op(hj, jcfg, *pad)
    st, at, bt = tham.make_padded_matvec_op(ht, tcfg, *pad, device="cpu")
    assert bj == bt == ((10, 10),)
    want = {"dense": "dense", "ozaki": "oz", "coo": "coo"}[kind]
    for kj, kt in ((sj[2][0], st[2][0]), (sj[3][0], st[3][0])):
        assert kj[0] == kt[0] and kt[0].startswith(want)
        if kt[0].startswith("oz"):
            assert kj[1:3] == kt[1:3]                  # nslices, bits
        first = 3 if kt[0].startswith("oz") else 1
        for ij, it in zip(kj[first:], kt[first:]):
            got = _as_jax_layout(kt[0], at[it], 10)
            ref = np.asarray(aj[ij])
            assert got.shape == ref.shape and np.array_equal(got, ref)
    assert np.array_equal(np.asarray(aj[sj[1][0]]), at[st[1][0]].numpy())
    # the product: the unpadded operator's on the block, zero on the pad
    rng = np.random.default_rng(9)
    x = rng.normal(size=(b.ddw, b.dup))
    xp = np.zeros((10, 10))
    xp[:b.ddw, :b.dup] = x
    yp = tham.apply_op(st, at, (torch.from_numpy(xp),))[0].numpy()
    su, au, _ = tham.make_matvec_op(ht, tcfg, "cpu")
    yu = tham.apply_op(su, au, (torch.from_numpy(x),))[0].numpy()
    scale = np.max(np.abs(yu))
    assert np.max(np.abs(yp[:b.ddw, :b.dup] - yu)) <= 1e-13 * scale
    assert not np.any(yp[b.ddw:, :]) and not np.any(yp[:, b.dup:])
    yj = np.asarray(jham.apply_op(sj, aj, (jnp.asarray(xp),))[0])
    assert np.max(np.abs(yj - yp)) <= 1e-12 * scale


def test_zero_rows_give_finite_scales_and_zero_digits():
    """A zero-embedded operand's pad rows (left) and columns (right) have
    a clamped exponent: finite power-of-two scales, all-zero digits — in
    both packages, with equal digits and scales (a NaN scale there would
    poison the whole stacked bucket)."""
    rng = np.random.default_rng(2)
    A = np.zeros((12, 12))
    A[:7, :7] = rng.normal(size=(7, 7))
    for nsl, bits in ((5, 7), (6, 6)):
        dj, sj = jozaki.slice_digits(jnp.asarray(A), nsl, 0, bits)
        ad, sa = tozaki._left_digits(torch.from_numpy(A), nsl, bits)
        assert torch.isfinite(sa).all() and np.all(np.isfinite(sj))
        assert not ad[:, 7:, :].any()
        assert np.array_equal(np.asarray(dj), ad[:, :, :12].numpy())
        assert np.array_equal(np.asarray(sj), sa.numpy())
        dj, sj = jozaki.slice_digits(jnp.asarray(A), nsl, 1, bits)
        bd, sb = tozaki._right_digits(torch.from_numpy(A), nsl, bits)
        assert torch.isfinite(sb).all() and np.all(np.isfinite(sj))
        assert not bd[:, 7:, :].any()
        assert np.array_equal(np.asarray(dj),
                              bd[:, :, :12].transpose(1, 2).numpy())
        assert np.array_equal(np.asarray(sj), sb.numpy())
        # and the product through the wrapper stays exact on the block
        B = np.zeros((12, 9))
        B[:7] = rng.normal(size=(7, 9))
        got = tozaki.matmul(torch.from_numpy(A), torch.from_numpy(B), nsl,
                            bits).numpy()
        assert np.all(np.isfinite(got)) and not np.any(got[7:])
        assert np.max(np.abs(got - A @ B)) <= 1e-9 * np.max(np.abs(A @ B))


def test_resolvent_batch_ragged_vs_jax(monkeypatch):
    """Channels in sectors of three shapes of one p2 class, with COO
    operators (dense_matmul_threshold=4: the sweep engine declines them),
    run as one ragged stacked scan in both packages."""
    monkeypatch.setenv("DMFT_ED_RAGGED", "1")
    jcfg, tcfg, jb, tb, hloc = _setup(dense_matmul_threshold=4,
                                      lanc_ngfiter=16)
    ran = []
    orig = tgf.ResolventBatch._run_ragged_stack
    monkeypatch.setattr(tgf.ResolventBatch, "_run_ragged_stack",
                        lambda self, *a: ran.append(len(a[2]))
                        or orig(self, *a))
    jtab, ttab = jsectors.sector_table(jcfg), tsectors.sector_table(tcfg)
    jbatch = jgf.ResolventBatch(jcfg, jgf.HamCache(jcfg, jb, hloc), -3.0,
                                1.0, False)
    tbatch = tgf.ResolventBatch(tcfg, tgf.HamCache(tcfg, tb, hloc, "cpu"),
                                -3.0, 1.0, False)
    rng = np.random.default_rng(5)
    n = 0
    for qn, nch in (((1, 2), 2), ((2, 1), 1), ((1, 3), 2)):
        for _ in range(nch):
            v = rng.normal(size=jtab.get(*qn).dim)
            jbatch.add(jtab.get(*qn), v, -2.5, {"id": n})
            tbatch.add(ttab.get(*qn), v, -2.5, {"id": n})
            n += 1
    rj = {m["id"]: (w, p) for m, w, p in jbatch.run()}
    rt = {m["id"]: (w, p) for m, w, p in tbatch.run()}
    assert ran == [3]
    assert sorted(rj) == sorted(rt) == list(range(n))
    for i in range(n):
        (wj, pj), (wt, pt) = rj[i], rt[i]
        assert pj.shape == pt.shape == (16,)
        assert np.max(np.abs(pj - pt)) <= 1e-10
        assert np.max(np.abs(wj - wt)) <= 1e-12


@pytest.mark.parametrize("fused", [False, True])
def test_real_ozaki_operator_on_complex_vector(fused, monkeypatch):
    """ozl + ozr (or the fused ozf) of a real sector operator applied to a
    complex vector: the real and the imaginary part go through separately,
    so the result is the f64 complex product (the JAX package casts the
    vector to real here and drops its imaginary part)."""
    monkeypatch.setenv("DMFT_ED_OZAKI_FUSED", "1" if fused else "0")
    jcfg, tcfg, jb, tb, hloc = _setup(**KINDS["ozaki"])
    _, ht = _hams(jcfg, tcfg, jb, tb, hloc, (2, 2))
    spec, arrays, blocks = tham.make_matvec_op(ht, tcfg, "cpu")
    kinds = tuple(p.kind for p in tham.spin_parts(spec))
    assert kinds == (("ozf", "ozf") if fused else ("ozr", "ozl"))
    rng = np.random.default_rng(6)
    dim = ht.sector.dim
    x = rng.normal(size=(2, dim)) + 1j * rng.normal(size=(2, dim))
    y = tham.flatten_blocks(tham.apply_op(spec, arrays, tham.unflatten_blocks(
        torch.from_numpy(x), blocks))).numpy()
    exact = x @ tham.assemble_dense(ht).T
    assert np.max(np.abs(y - exact)) <= 1e-9 * np.max(np.abs(exact))


def _fused_operands(seed, ddw, dup, vscale):
    rng = np.random.default_rng(seed)
    H = rng.uniform(-1, 1, (ddw, ddw))
    Hu = rng.uniform(-1, 1, (dup, dup))
    V = rng.normal(size=(ddw, dup))
    return H, Hu, V * vscale / np.max(np.abs(V))


@pytest.mark.parametrize("bits", [(5, 7), (6, 6)])
def test_fused_two_sided_bitwise_vs_jax(bits):
    """λ = 1 (max|V| = max|H| / 0.75): JAX's exp2/log2 give exactly 1, so
    both packages digit the same operands: bitwise equal."""
    nsl, b = bits
    H, Hu, V = _fused_operands(1, 20, 30, 1.0)
    V *= max(np.max(np.abs(H)), np.max(np.abs(Hu))) / 0.75
    mh = max(np.max(np.abs(H)), np.max(np.abs(Hu)))
    lam_j = float(jnp.exp2(jnp.ceil(jnp.log2(mh / np.max(np.abs(V))))))
    assert lam_j == 1.0
    Ht, Hut, Vt = (torch.from_numpy(a) for a in (H, Hu.T, V))
    assert float(tozaki.fused_lambda(Ht, Hut, Vt)) == 1.0
    got = tozaki.fused_two_sided(Ht, Hut, Vt, nsl, b).numpy()
    ref = np.asarray(jozaki.fused_two_sided(jnp.asarray(H), jnp.asarray(
        Hu.T), jnp.asarray(V), nsl, b))
    assert np.array_equal(got, ref)


def test_fused_two_sided_krylov_operand_vs_jax():
    """A Krylov-like operand, max|H|/max|V| ~ 50, so λ = 2^6: the port's λ
    is that power of two exactly (from the exponent bits, on the device);
    JAX's is XLA's exp2, which misses 2^6 on the CPU. So the packages
    digit slightly different operands and agree to the truncation class,
    and the port is within it of the f64 product."""
    H, Hu, V = _fused_operands(2, 20, 30, 1.0 / 50)
    mh = max(np.max(np.abs(H)), np.max(np.abs(Hu)))
    lam_j = float(jnp.exp2(jnp.ceil(jnp.log2(mh / np.max(np.abs(V))))))
    assert lam_j != 64.0 and abs(lam_j / 64.0 - 1) < 1e-14
    Ht, Hut, Vt = (torch.from_numpy(a) for a in (H, Hu.T, V))
    lam = tozaki.fused_lambda(Ht, Hut, Vt)
    assert float(torch.frexp(lam).mantissa) == 0.5 and float(lam) == 64.0
    got = tozaki.fused_two_sided(Ht, Hut, Vt, 5, 7).numpy()
    ref = np.asarray(jozaki.fused_two_sided(jnp.asarray(H), jnp.asarray(
        Hu.T), jnp.asarray(V), 5, 7))
    exact = H @ V + V @ Hu.T
    scale = np.max(np.abs(exact))
    assert np.max(np.abs(got - ref)) <= 1e-9 * scale
    assert np.max(np.abs(got - exact)) <= 1e-9 * scale


def test_fused_lambda_edge_cases():
    """Exact powers of two (where XLA's log2 can round up and double λ),
    zero operands and extreme ratios."""
    t = lambda *a: torch.tensor(a, dtype=torch.float64)
    H = torch.ones((3, 3), dtype=torch.float64)
    for vmax, lam in ((0.25, 4.0), (0.3, 4.0), (1.0, 1.0), (2.0, 0.5),
                      (3.0, 0.5), (2.0 ** -40, 2.0 ** 40)):
        V = torch.full((3, 2), vmax, dtype=torch.float64)
        assert float(tozaki.fused_lambda(H, H, V)) == lam, vmax
    assert float(tozaki.fused_lambda(H, H, torch.zeros(3, 2,
                                                       dtype=torch.float64))) \
        == 1.0
    assert float(tozaki.fused_lambda(0 * H, 0 * H, t(0.5, 0.25)[None])) == 2.0


def test_fused_matvec_op_vs_jax(monkeypatch):
    """DMFT_ED_OZAKI_FUSED=1 encodes the ozf kind in both packages, with
    the same raw f64 matrices (unpadded and padded), and the products
    agree to the truncation class."""
    monkeypatch.setenv("DMFT_ED_OZAKI_FUSED", "1")
    jdevice.ozaki_fused.cache_clear()
    try:
        jcfg, tcfg, jb, tb, hloc = _setup(**KINDS["ozaki"])
        hj, ht = _hams(jcfg, tcfg, jb, tb, hloc, (1, 2))
        for pad in (None, (10, 10, 0, 0)):
            if pad is None:
                sj, aj, _ = jham.make_matvec_op(hj, jcfg)
                st, at, bt = tham.make_matvec_op(ht, tcfg, "cpu")
            else:
                sj, aj, _ = jham.make_padded_matvec_op(hj, jcfg, *pad)
                st, at, bt = tham.make_padded_matvec_op(ht, tcfg, *pad,
                                                        device="cpu")
            assert sj[3][0][:3] == st[3][0][:3] == ("ozf", 5, 7)
            assert sj[2][0] == st[2][0] == ("ozf",)
            for ij, it in zip(sj[3][0][3:], st[3][0][3:]):
                assert np.array_equal(np.asarray(aj[ij]), at[it].numpy())
            ddw, dup = bt[0]
            x = np.random.default_rng(3).normal(size=(ddw, dup))
            if pad is not None:
                x[ht.sector.blocks[0].ddw:] = 0
                x[:, ht.sector.blocks[0].dup:] = 0
            yt = tham.apply_op(st, at, (torch.from_numpy(x),))[0].numpy()
            yj = np.asarray(jham.apply_op(sj, aj, (jnp.asarray(x),))[0])
            assert np.max(np.abs(yt - yj)) <= 1e-9 * np.max(np.abs(yj))
    finally:
        jdevice.ozaki_fused.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_padded_stacked_ozaki_on_card(fused, monkeypatch):
    """On the card (run there with ``python -m pytest -m gpu
    tests/test_torch_ragged.py``): the stacked zero-embedded Ozaki matvec
    (ozl/ozr, or the fused ozf) through the kernel is bitwise equal to the
    same matvec with the kernel's plain version in its place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    monkeypatch.setenv("DMFT_ED_OZAKI_FUSED", "1" if fused else "0")
    dev = torch.device("cuda", 0)
    tcfg = tconfig.EDConfig(norb=1, nbath=7, nspin=1, uloc=(2.0,),
                            matmul_precision="ozaki5x7").validate()
    tb = tbath.Bath(tcfg)
    rng = np.random.default_rng(8)
    tb.e[:] = rng.uniform(-1.0, 1.0, tb.e.shape)
    tb.v[:] = rng.uniform(0.3, 0.7, tb.v.shape)
    tab = tsectors.sector_table(tcfg)
    secs = [tab.get(3, 4), tab.get(4, 3), tab.get(4, 4)]     # 56x70, 70x70
    hams = [tham.build_sector_hamiltonian(tcfg, s, tb, np.zeros((1, 1, 1, 1)))
            for s in secs]
    nu = max(h.hup[0].rows.size for h in hams)
    nd = max(h.hdw[0].rows.size for h in hams)
    ops = [tham.make_padded_matvec_op(h, tcfg, 70, 70, nu, nd, device=dev)
           for h in hams]
    spec, blocks = ops[0][0], ops[0][2]
    assert all(o[0] == spec for o in ops)
    stacked = tuple(torch.stack([o[1][i] for o in ops])
                    for i in range(len(ops[0][1])))
    V = torch.zeros((len(secs), 3, 70 * 70), dtype=torch.float64, device=dev)
    for s, sec in enumerate(secs):
        b = sec.blocks[0]
        V[s, :].view(3, 70, 70)[:, :b.ddw, :b.dup] = torch.randn(
            3, b.ddw, b.dup, dtype=torch.float64, device=dev)

    def run():
        return tlanczos.lanczos_tridiag_op_stacked(spec, blocks, stacked,
                                                   V / V.norm(dim=-1,
                                                              keepdim=True),
                                                   4)

    from dmft_ed_tpu_torch.kernels import digit_matmul
    n0 = digit_matmul.launches
    got = run()
    assert digit_matmul.launches > n0
    monkeypatch.setattr(tozaki, "digit_matmul", digit_matmul_plain)
    ref = run()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    H = torch.as_tensor(hams[2].hdw[0].to_dense(), device=dev)
    Hu = torch.as_tensor(hams[2].hup[0].to_dense().T.copy(), device=dev)
    x = V[2, 0].view(70, 70)
    monkeypatch.setattr(tozaki, "digit_matmul", digit_matmul)
    a = tozaki.fused_two_sided(H, Hu, x, 5, 7)
    monkeypatch.setattr(tozaki, "digit_matmul", digit_matmul_plain)
    b = tozaki.fused_two_sided(H, Hu, x, 5, 7)
    assert torch.equal(a, b)
