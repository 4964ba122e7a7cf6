"""Sector matvec of the PyTorch port against the JAX package: ``apply_op``
(dense, Ozaki-digit, COO and mix-term kinds) and the whole-sweep
collection matvec of ``sweep_plain``, on the same operators and vectors
(numpy seeds), within 1e-12 relative to max|H v|."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dmft_ed_tpu.bath as jbath
import dmft_ed_tpu.config as jconfig
import dmft_ed_tpu.hamiltonian as jham
import dmft_ed_tpu.sectors as jsectors
import dmft_ed_tpu.sweep_plain as jsweep
import dmft_ed_tpu_torch.bath as tbath
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.hamiltonian as tham
import dmft_ed_tpu_torch.sectors as tsectors
import dmft_ed_tpu_torch.sweep_plain as tsweep

TOL = 1e-12

MODELS = {
    "norb1": dict(norb=1, nbath=4, nspin=1, uloc=(2.0,)),
    "norb2": dict(norb=2, nbath=2, nspin=1, uloc=(2.0, 1.5), ust=1.0,
                  jh=0.25),
    "norb2_mix": dict(norb=2, nbath=2, nspin=1, uloc=(2.0, 1.5), ust=1.0,
                      jh=0.25, jx=0.25, jp=0.25),
}


def _setup(model, prec, seed, **extra):
    kw = dict(MODELS[model], matmul_precision=prec, **extra)
    jcfg = jconfig.EDConfig(**kw).validate()
    tcfg = tconfig.EDConfig(**kw).validate()
    rng = np.random.default_rng(seed)
    jb = jbath.Bath(jcfg)
    jb.e[:] = rng.uniform(-1.0, 1.0, jb.e.shape)
    jb.v[:] = rng.uniform(0.3, 0.7, jb.v.shape)
    tb = tbath.Bath(tcfg)
    tb.e[:] = jb.e
    tb.v[:] = jb.v
    hloc = np.zeros((1, 1, jcfg.norb, jcfg.norb))
    hloc[0, 0] = np.diag(rng.uniform(-0.2, 0.2, jcfg.norb))
    return jcfg, tcfg, jb, tb, hloc, rng


def _largest(table, n=1):
    return sorted(table.sectors, key=lambda s: -s.dim)[:n]


def _apply_both(jcfg, tcfg, jb, tb, hloc, rng, sec_index):
    jsec = jsectors.sector_table(jcfg).sectors[sec_index]
    tsec = tsectors.sector_table(tcfg).sectors[sec_index]
    hj = jham.build_sector_hamiltonian(jcfg, jsec, jb, hloc)
    ht = tham.build_sector_hamiltonian(tcfg, tsec, tb, hloc)
    x = rng.normal(size=(3, jsec.dim))
    sj, aj, _ = jham.make_matvec_op(hj, jcfg)
    st, at, bt = tham.make_matvec_op(ht, tcfg, "cpu")
    ys = []
    for xi in x:
        yj = np.asarray(jham.flatten_blocks(jham.apply_op(
            sj, aj, jham.unflatten_blocks(jnp.asarray(xi), jsec))))
        yt = tham.flatten_blocks(tham.apply_op(
            st, at, tham.unflatten_blocks(torch.from_numpy(xi), bt))).numpy()
        ys.append((yj, yt))
    # leading batch dims: all three vectors through one call
    yb = tham.flatten_blocks(tham.apply_op(
        st, at, tham.unflatten_blocks(torch.from_numpy(x), bt))).numpy()
    return hj, st, ys, yb


@pytest.mark.parametrize("prec", ["native", "ozaki5x7"])
@pytest.mark.parametrize("model", ["norb1", "norb2", "norb2_mix"])
def test_apply_op_vs_jax(model, prec):
    jcfg, tcfg, jb, tb, hloc, rng = _setup(model, prec, 1)
    for sec in _largest(jsectors.sector_table(jcfg), 2):
        hj, spec, ys, yb = _apply_both(jcfg, tcfg, jb, tb, hloc, rng,
                                       sec.index)
        kinds = {p.kind for p in tham.spin_parts(spec)}
        assert kinds == ({"ozr", "ozl"} if prec != "native" else {"dense"})
        assert bool(tham.mix_entries(spec)) == (model == "norb2_mix")
        for i, (yj, yt) in enumerate(ys):
            scale = np.max(np.abs(yj))
            assert np.max(np.abs(yt - yj)) <= TOL * scale
            # batched call: the same products, vector by vector
            assert np.max(np.abs(yb[i] - yt)) <= TOL * scale


@pytest.mark.parametrize("model", ["norb1", "norb2_mix"])
def test_apply_op_coo_class_vs_jax(model):
    """Per-spin dims above a lowered dense_matmul_threshold take the COO
    kind (gather + index_add_)."""
    jcfg, tcfg, jb, tb, hloc, rng = _setup(model, "native", 2,
                                           dense_matmul_threshold=4)
    sec = _largest(jsectors.sector_table(jcfg))[0]
    _, spec, ys, yb = _apply_both(jcfg, tcfg, jb, tb, hloc, rng, sec.index)
    assert "coo" in {p.kind for p in tham.spin_parts(spec)}
    for i, (yj, yt) in enumerate(ys):
        scale = np.max(np.abs(yj))
        assert np.max(np.abs(yt - yj)) <= TOL * scale
        assert np.max(np.abs(yb[i] - yt)) <= TOL * scale


def test_apply_op_matches_dense():
    """apply_op against the assembled dense H (host f64)."""
    jcfg, tcfg, jb, tb, hloc, rng = _setup("norb2_mix", "native", 3)
    sec = _largest(tsectors.sector_table(tcfg))[0]
    ht = tham.build_sector_hamiltonian(tcfg, sec, tb, hloc)
    spec, arrays, blocks = tham.make_matvec_op(ht, tcfg, "cpu")
    x = rng.normal(size=sec.dim)
    y = tham.flatten_blocks(tham.apply_op(
        spec, arrays, tham.unflatten_blocks(torch.from_numpy(x), blocks)))
    ref = tham.assemble_dense(ht) @ x
    assert np.max(np.abs(y.numpy() - ref)) <= TOL * np.max(np.abs(ref))


HUND = dict(norb=2, nbath=3, nspin=1, bath_type="hybrid", uloc=(2.0, 2.0),
            ust=1.5, jh=0.25, jx=0.25, jp=0.25)

# one case per term kind of hamiltonian.py: (the kind the accessor must
# report, the model, cfg fields, make_matvec_op's fused, whether every mix
# term is refused as a signed permutation, the padded form)
KIND_CASES = {
    "none": ("none", "norb1", dict(dense_matmul_threshold=1), None, False,
             False),
    "dense": ("dense", "norb1", {}, None, False, False),
    "dense-float32": ("dense", "norb1", dict(dtype="float32"), None, False,
                      False),
    "ozl/ozr": ("ozl", "norb1", dict(matmul_precision="ozaki5x7"), False,
                False, False),
    "ozf": ("ozf", "norb1", dict(matmul_precision="ozaki5x7"), True, False,
            False),
    "coo": ("coo", "norb1", dict(dense_matmul_threshold=4), None, False,
            False),
    "pmix": ("pmix", "hund", {}, None, False, False),
    "pmix-float32": ("pmix", "hund", dict(dtype="float32"), None, False,
                     False),
    "bmix": ("bmix", "hund", {}, None, True, False),
    "chain": ("chain", "hund", dict(dense_matmul_threshold=4), None, True,
              False),
    "chain-ozaki": ("chain", "hund", dict(matmul_precision="ozaki5x7"),
                    False, False, False),
    "padded": ("coo", "norb1", dict(dense_matmul_threshold=8), None, False,
               True),
}


@pytest.mark.parametrize("case", sorted(KIND_CASES))
def test_apply_op_of_each_kind(case, monkeypatch):
    """Each term kind (hamiltonian.py's records) against the assembled
    dense H: apply_op on a vector and a batch of two within 1e-12 of
    max|H x| in float64, 1e-5 in float32 and 1e-9 where Ozaki digits
    enter (their truncation class; measured ~1e-10); op_kinds reports
    the kind."""
    kind, model, extra, fused, refuse, padded = KIND_CASES[case]
    if model == "hund":
        cfg = tconfig.EDConfig(**HUND, **extra).validate()
        b = tbath.Bath(cfg)
        b.e[0, :, :] = np.linspace(-1.0, 1.0, 3)
        b.v[0, :, :] = np.random.default_rng(3).uniform(0.3, 0.7, (2, 3))
        sec = tsectors.sector_table(cfg).get(3, 3)
        hloc = np.zeros((1, 1, 2, 2))
    else:
        extra = dict(extra)
        _, cfg, _, b, hloc, _ = _setup(
            "norb1", extra.pop("matmul_precision", "native"), 7, **extra)
        if kind == "none":          # no hopping: both spin parts empty
            b.v[:] = 0.0
        sec = tsectors.sector_table(cfg).get(2, 3)
    ham = tham.build_sector_hamiltonian(cfg, sec, b, hloc)
    if refuse:
        monkeypatch.setattr(tham, "_signed_perm", lambda coo: False)
    if padded:
        blk = sec.blocks[0]
        ddw, dup = blk.ddw + 3, blk.dup + 2
        spec, arrays, blocks = tham.make_padded_matvec_op(
            ham, cfg, ddw, dup, ham.hup[0].rows.size + 2,
            ham.hdw[0].rows.size + 1, device="cpu")
        assert blocks == ((ddw, dup),) and max(ddw, dup) > 8
    else:
        spec, arrays, blocks = tham.make_matvec_op(ham, cfg, "cpu",
                                                   fused=fused)
    assert kind in tham.op_kinds(spec)
    if kind == "ozl":
        assert "ozr" in tham.op_kinds(spec)
    vdt = getattr(torch, tham.vector_dtype(spec))
    H = tham.assemble_dense(ham)
    tol = 1e-5 if cfg.dtype == "float32" else 1e-9 \
        if cfg.matmul_precision != "native" else TOL
    rng = np.random.default_rng(5)
    for lead in ((), (2,)):
        x = rng.standard_normal(lead + (sec.dim,))
        if padded:
            xp = np.zeros(lead + blocks[0])
            xp[..., :blk.ddw, :blk.dup] = x.reshape(lead + (blk.ddw, blk.dup))
            y = tham.apply_op(spec, arrays, (torch.as_tensor(xp).to(vdt),))[0]
            assert not y[..., blk.ddw:, :].any()
            assert not y[..., blk.dup:].any()
            y = y[..., :blk.ddw, :blk.dup].reshape(lead + (-1,))
        else:
            y = tham.flatten_blocks(tham.apply_op(spec, arrays,
                                                  tham.unflatten_blocks(
                torch.as_tensor(x).to(vdt), blocks)))
        want = x @ H.T
        err = np.abs(y.double().numpy() - want).max()
        assert err <= tol * np.abs(want).max()


@pytest.mark.parametrize("prec", ["native", "ozaki5x7"])
@pytest.mark.parametrize("model", ["norb1", "norb2"])
def test_sweep_matvec_vs_jax(model, prec):
    """The collection matvec over every sector with dim > 1 (the lockstep
    diag's operand set), and its on-device diagonal rebuild."""
    jcfg, tcfg, jb, tb, hloc, rng = _setup(model, prec, 4)
    jt, tt = jsectors.sector_table(jcfg), tsectors.sector_table(tcfg)
    idx = [s.index for s in jt.sectors if s.dim > 1]
    hj = [jham.build_sector_hamiltonian(jcfg, jt.sectors[i], jb, hloc)
          for i in idx]
    ht = [tham.build_sector_hamiltonian(tcfg, tt.sectors[i], tb, hloc)
          for i in idx]
    assert jsweep.sweep_supported(jcfg, hj) and \
        tsweep.sweep_supported(tcfg, ht)
    spec_j, arr_j = jsweep.make_sweep_op(jcfg, hj)
    spec_t, arr_t = tsweep.make_sweep_op(tcfg, ht, "cpu")
    assert spec_t[0] == spec_j[0] and spec_t[5:7] == spec_j[5:7]
    Vs = [rng.normal(size=(h.sector.blocks[0].ddw, h.sector.blocks[0].dup))
          for h in hj]
    prep_j, mv_j = jsweep._sweep_applier(spec_j)
    prep_t, mv_t = tsweep._sweep_applier(spec_t)
    Dj, Dt = prep_j(arr_j), prep_t(arr_t)
    for a, b, h in zip(Dj, Dt, ht):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert np.array_equal(b.numpy(), h.diag[0])
    Yj = mv_j(arr_j, Dj, tuple(jnp.asarray(v) for v in Vs))
    Yt = mv_t(arr_t, Dt, [torch.from_numpy(v) for v in Vs])
    scale = max(np.max(np.abs(np.asarray(y))) for y in Yj)
    for a, b in zip(Yj, Yt):
        assert np.max(np.abs(np.asarray(a) - b.numpy())) <= TOL * scale
