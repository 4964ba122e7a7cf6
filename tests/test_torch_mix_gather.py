"""The mix terms as signed gathers (``kernels.mix_gather``, kind "pmix").

``hamiltonian.make_matvec_op`` encodes the mix terms of a (src, dst) block
pair as per-term gather tables where every spin part is a signed partial
permutation and the vector is real (no Ozaki route); the dense "bmix"
stacks it replaces are what the same encoder builds where that test fails
(here: with ``_signed_perm`` patched to refuse every term). Held on the
CPU, where the wrapper takes its plain version:

* apply_op with "pmix" equals apply_op with "bmix" bitwise (at most one
  term reaches an entry in every case here), and the dense sector matrix
  to 1e-12: the Hund operator at small Nbath in several sectors, float64
  and float32, a superc multi-block operator (Nbath pairing terms per
  pair), with leading batch dimensions;
* a term whose spin part is the identity (None) joins its pair's entry;
* the row-sharded local operator (``parallel.hxv.local_operator``) on
  two ranks equals its "bmix" twin bitwise and the unsharded operator's
  rows to 1e-14;
* the plain version against a term-by-term loop where several terms reach
  one entry (order of the sum);
* the mix terms of an operator above dense_matmul_threshold go "pmix"
  too, bitwise the per-term COO chains;
* terms that are no signed partial permutation, complex vectors and the
  Ozaki route keep their encodings; no dense stack is built for "pmix";
* the counter ``hamiltonian.mix_gather_terms`` under a profiler.

The Jz basis is nonsu2 and complex, so it keeps "bmix" (the complex case
below). The ``gpu`` tests hold the kernel bitwise against the plain
version and the dense path on the Hund cell's full (7,7) operator, a graph
replay against eager apply_op on a superc operator, and the launch count
on the thick restart (run on a card with ``python -m pytest -m gpu
tests/test_torch_mix_gather.py``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dmft_ed_tpu_torch.hamiltonian as tham
import dmft_ed_tpu_torch.lanczos as tlanczos
from dmft_ed_tpu_torch import timer
from dmft_ed_tpu_torch.bath import Bath
from dmft_ed_tpu_torch.config import EDConfig
from dmft_ed_tpu_torch.kernels import mix_gather, mix_gather_plain
from dmft_ed_tpu_torch.parallel.hxv import (local_operator, pad_rows_ham)
from dmft_ed_tpu_torch.sectors import sector_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hund(nbath, sector, dtype="float64", **kw):
    cfg = EDConfig(norb=2, nspin=1, bath_type="hybrid", nbath=nbath,
                   uloc=(2.0, 2.0), ust=1.5, jh=0.25, jx=0.25, jp=0.25,
                   beta=100.0, xmu=0.0, dtype=dtype, **kw).validate()
    b = Bath(cfg)
    rng = np.random.default_rng(nbath)
    b.e[0, :, :] = np.linspace(-1.0, 1.0, nbath)
    b.v[0, :, :] = rng.uniform(0.3, 0.7, (2, nbath))
    sec = sector_table(cfg).get(*sector)
    return cfg, sec, tham.build_sector_hamiltonian(
        cfg, sec, b, np.zeros((1, 1, 2, 2)))


def _superc(sz, nbath=3):
    cfg = EDConfig(norb=1, nbath=nbath, nspin=1, ed_mode="superc",
                   uloc=(-1.5,), beta=40.0, deltasc=0.3, xmu=0.2,
                   lanc_dim_threshold=10, ed_verbose=0).validate()
    b = Bath(cfg)
    rng = np.random.default_rng(3)
    b.e[:] = rng.uniform(-1.0, 1.0, b.e.shape)
    b.v[:] = rng.uniform(0.3, 0.7, b.v.shape)
    b.d[:] = rng.uniform(0.1, 0.4, b.d.shape)
    sec = sector_table(cfg).get(sz)
    return cfg, sec, tham.build_sector_hamiltonian(
        cfg, sec, b, np.zeros((1, 1, 1, 1)))


def _dense_op(monkeypatch, ham, cfg, device="cpu"):
    """The same operator with every mix term refused as a permutation:
    the dense "bmix" encoding."""
    with monkeypatch.context() as m:
        m.setattr(tham, "_signed_perm", lambda coo: False)
        return tham.make_matvec_op(ham, cfg, device)


def _apply(op, x):
    spec, arrays, blocks = op
    return tham.flatten_blocks(tham.apply_op(
        spec, arrays, tham.unflatten_blocks(x, blocks)))


def _kinds(op):
    """Each mix entry's kind; a per-term chain's is its up part's."""
    return [m.up.kind if m.kind == "chain" else m.kind
            for m in tham.mix_entries(op[0])]


CASES = [("hund", 2, (2, 2), "float64", ()),
         ("hund", 3, (3, 3), "float64", ()),
         ("hund", 4, (4, 4), "float64", ()),
         ("hund", 4, (3, 5), "float64", ()),
         ("hund", 4, (4, 4), "float32", ()),
         ("hund", 3, (3, 3), "float64", (2,)),
         ("hund", 3, (3, 4), "float64", (2, 3)),
         ("superc", 3, 0, "float64", ()),
         ("superc", 3, -1, "float64", (3,))]


@pytest.mark.parametrize("model,nbath,sector,dtype,lead", CASES)
def test_pmix_equals_bmix(model, nbath, sector, dtype, lead, monkeypatch):
    """apply_op with the "pmix" entries equals apply_op with the dense
    "bmix" stacks bitwise, and the dense sector matrix to 1e-12 (1e-5 in
    float32); one "pmix" entry per block pair and no dense stack."""
    if model == "hund":
        cfg, sec, ham = _hund(nbath, sector, dtype)
    else:
        cfg, sec, ham = _superc(sector, nbath)
    op = tham.make_matvec_op(ham, cfg, "cpu")
    dense = _dense_op(monkeypatch, ham, cfg)
    pairs = {(t.src, t.dst) for t in ham.mix}
    assert _kinds(op) == ["pmix"] * len(pairs) and len(pairs) >= 1
    assert _kinds(dense) == ["bmix"] * len(pairs)
    assert sum(m.nterms for m in tham.mix_entries(op[0])) == len(ham.mix)
    # the dense stacks are [L, m, m]; nothing of "pmix" is 3-D
    assert all(a.dim() <= 2 for a in op[1])
    assert any(a.dim() == 3 for a in dense[1])
    rng = np.random.default_rng(sum(np.atleast_1d(sector)) + nbath)
    x = torch.as_tensor(rng.standard_normal(lead + (sec.dim,))).to(
        getattr(torch, dtype))
    got = _apply(op, x)
    assert torch.equal(got, _apply(dense, x))
    H = tham.assemble_dense(ham)
    want = np.einsum("ij,...j->...i", H, x.double().numpy())
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert np.abs(got.double().numpy() - want).max() \
        <= tol * np.abs(want).max()


@pytest.mark.parametrize("nbath,sector", [(3, (3, 3)), (4, (4, 3))])
def test_pmix_above_the_dense_threshold(nbath, sector, monkeypatch):
    """Above dense_matmul_threshold (lowered to 4 here) the per-spin
    operators go COO but the mix terms still go "pmix": the choice reads
    the terms' structure, not their size. It equals the per-term COO
    chains the same terms take when refused as permutations, bitwise (at
    most one term reaches an entry), and the dense sector matrix."""
    cfg, sec, ham = _hund(nbath, sector, dense_matmul_threshold=4)
    op = tham.make_matvec_op(ham, cfg, "cpu")
    coo = _dense_op(monkeypatch, ham, cfg)
    assert "coo" in {p.kind for p in tham.spin_parts(op[0])}
    assert _kinds(op) == ["pmix"]
    assert _kinds(coo) == ["coo"] * len(ham.mix)
    x = torch.as_tensor(np.random.default_rng(nbath).standard_normal(
        (2, sec.dim)))
    got = _apply(op, x)
    assert torch.equal(got, _apply(coo, x))
    want = np.einsum("ij,...j->...i", tham.assemble_dense(ham), x.numpy())
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("model,sector", [("hund", (3, 3)), ("hund", (4, 3)),
                                          ("superc", 0)])
def test_row_sharded_local_operator(model, sector, monkeypatch):
    """On two ranks (rows=2) each rank's local operator, fed the gathered
    blocks, equals the same local operator with "bmix" entries bitwise and
    the unsharded padded operator's rows to 1e-14 (the per-spin dw
    products of a row slice round as BLAS blocks them); its "pmix" tables
    keep the rank's rows."""
    cfg, sec, ham = _hund(3, sector) if model == "hund" \
        else _superc(sector)
    ham_p = pad_rows_ham(ham, 2)
    ops = {"pmix": tham.make_matvec_op(ham_p, cfg, "cpu", fused=False)}
    with monkeypatch.context() as m:
        m.setattr(tham, "_signed_perm", lambda coo: False)
        ops["bmix"] = tham.make_matvec_op(ham_p, cfg, "cpu", fused=False)
    spec, arrays, blocks = ops["pmix"]
    assert "pmix" in _kinds(ops["pmix"]) and "bmix" in _kinds(ops["bmix"])
    rng = np.random.default_rng(17)
    V = tuple(torch.as_tensor(rng.standard_normal((2, ddw, dup)))
              for ddw, dup in blocks)
    for v, b in zip(V, ham.sector.blocks):
        v[:, b.ddw:] = 0.0
    full = tham.apply_op(spec, arrays, V)
    scale = max(float(f.abs().max()) for f in full)
    for rank in range(2):
        mesh = type("Mesh", (), {"shape": {"rows": 2, "sites": 1},
                                 "coord": {"rows": rank, "sites": 0}})()
        sls = [slice(rank * (d // 2), (rank + 1) * (d // 2))
               for d, _ in blocks]
        local = tuple(v[:, sl] for v, sl in zip(V, sls))
        by_id = {id(lv): v for lv, v in zip(local, V)}
        got = {}
        for kind, (sp, ar, _) in ops.items():
            spec_l, arrays_l, _ = local_operator(sp, ar, mesh)
            got[kind] = tham.apply_op(spec_l, arrays_l, local,
                                      gather=lambda v: by_id[id(v)])
            for m in tham.mix_entries(spec_l):
                if m.kind == "pmix":
                    assert m.nrows == arrays_l[m.tables[4]].numel()
                    assert arrays_l[m.tables[0]].shape[1] == \
                        sls[m.dst].stop - sls[m.dst].start
        for y, yd, f, sl in zip(got["pmix"], got["bmix"], full, sls):
            assert torch.equal(y, yd)
            assert float((y - f[:, sl]).abs().max()) <= 1e-14 * scale


@pytest.mark.parametrize("side", ["up", "dw"])
def test_identity_spin_part(side, monkeypatch):
    """A term whose spin part on one side is None (the identity) goes
    "pmix" with the other terms of its pair and equals the dense sector
    matrix (its entries now meet other terms', so the sum's order, and
    not the bitwise result, is the dense encoding's)."""
    cfg, sec, ham = _hund(3, (3, 3))
    ham.mix[0] = ham.mix[0]._replace(**{side: None})
    op = tham.make_matvec_op(ham, cfg, "cpu")
    assert _kinds(op) == ["pmix"] \
        and tham.mix_entries(op[0])[0].nterms == len(ham.mix)
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(sec.dim))
    got = _apply(op, x).numpy()
    want = tham.assemble_dense(ham) @ x.numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale
    dense = _dense_op(monkeypatch, ham, cfg)
    assert np.abs(got - _apply(dense, x).numpy()).max() <= 1e-14 * scale


def test_plain_sums_terms_in_order():
    """Where several terms reach one entry the plain version adds their
    rounded products in term order, then adds the sum to y; rows outside
    `rows` and entries no term reaches are untouched."""
    rng = np.random.default_rng(5)
    L, ms, ks, md, kd = 3, 7, 6, 8, 5
    dsrc = rng.integers(-1, ms, (L, md)).astype(np.int32)
    usrc = rng.integers(-1, ks, (L, kd)).astype(np.int32)
    dsrc[:, 6] = -1
    dwt = rng.standard_normal((L, md))
    usg = rng.choice([-1.0, 1.0], (L, kd))
    rows = np.flatnonzero((dsrc >= 0).any(0)).astype(np.int32)
    v = rng.standard_normal((2, ms, ks))
    y0 = rng.standard_normal((2, md, kd))
    want = y0.copy()
    for b in range(2):
        for r in rows:
            for c in range(kd):
                acc, hit = 0.0, False
                for l in range(L):
                    if dsrc[l, r] >= 0 and usrc[l, c] >= 0:
                        p = (dwt[l, r] * usg[l, c]) * v[b, dsrc[l, r],
                                                        usrc[l, c]]
                        acc, hit = (acc + p if hit else p), True
                if hit:
                    want[b, r, c] = y0[b, r, c] + acc
    t = torch.as_tensor
    y = t(y0.copy())
    out = mix_gather(t(v), y, t(dsrc), t(dwt), t(usrc), t(usg), t(rows))
    assert out is y and np.array_equal(y.numpy(), want)
    assert mix_gather.launches == 0


def _broken(kind):
    """A Hund (3,3) operator with its first mix term changed so that it is
    no signed partial permutation (or with a complex vector dtype)."""
    cfg, sec, ham = _hund(3, (3, 3))
    t = ham.mix[0]
    up = t.up
    if kind == "two_in_a_row":
        up = up._replace(rows=np.r_[up.rows, up.rows[0]],
                         cols=np.r_[up.cols, (up.cols[0] + 1)
                                    % up.shape[1]],
                         vals=np.r_[up.vals, 1.0])
    elif kind == "two_in_a_column":
        free = np.setdiff1d(np.arange(up.shape[0]), up.rows)[0]
        up = up._replace(rows=np.r_[up.rows, free],
                         cols=np.r_[up.cols, up.cols[0]],
                         vals=np.r_[up.vals, -1.0])
    elif kind == "not_a_sign":
        up = up._replace(vals=np.r_[2.0 * up.vals[:1], up.vals[1:]])
    ham.mix[0] = t._replace(up=up)
    if kind == "complex":
        ham = dataclasses.replace(ham, dtype=np.dtype(np.complex128))
    return cfg, sec, ham


@pytest.mark.parametrize("kind", ["two_in_a_row", "two_in_a_column",
                                  "not_a_sign", "complex", "ozaki5x7"])
def test_other_terms_keep_their_encoding(kind, monkeypatch):
    """A term with two nonzeros in a row or a column, or a value other
    than ±1, keeps the dense "bmix" entry (its pair's other terms go
    "pmix"); a complex vector keeps "bmix" for every term; the Ozaki route
    keeps one ozr/ozl chain per term. The result is the dense matrix's."""
    cfg, sec, ham = _broken("ok" if kind == "ozaki5x7" else kind)
    if kind == "ozaki5x7":
        cfg = cfg.replace(matmul_precision="ozaki5x7")
    op = tham.make_matvec_op(ham, cfg, "cpu")
    kinds = _kinds(op)
    if kind == "complex":
        assert kinds == ["bmix"]
    elif kind == "ozaki5x7":
        assert set(kinds) == {"ozr"} and len(kinds) == len(ham.mix)
    else:
        assert kinds == ["pmix", "bmix"]
        assert [m.nterms for m in tham.mix_entries(op[0])
                if m.kind == "pmix"] == [len(ham.mix) - 1]
    rng = np.random.default_rng(8)
    x = rng.standard_normal(sec.dim)
    got = _apply(op, torch.as_tensor(x).to(
        getattr(torch, tham.vector_dtype(op[0]))))
    want = tham.assemble_dense(ham) @ x
    assert np.abs(got.numpy() - want).max() <= 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("model,vtype,dtype",
                         [("hund", torch.complex128, "float64"),
                          ("hund", torch.float64, "float32"),
                          ("superc", torch.complex128, "float64")])
def test_real_tables_meet_other_vectors(model, vtype, dtype, monkeypatch):
    """A complex vector against a real "pmix" operator goes through as its
    real and imaginary parts (between blocks of other shapes in the
    superc case); a float64 vector against float32 tables is promoted
    (exactly: the signed coefficients are float32 values); both equal the
    dense encoding bitwise."""
    cfg, sec, ham = _hund(3, (3, 3), dtype) if model == "hund" \
        else _superc(-1)
    op = tham.make_matvec_op(ham, cfg, "cpu")
    dense = _dense_op(monkeypatch, ham, cfg)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, sec.dim))
    if vtype.is_complex:
        x = x + 1j * rng.standard_normal((2, sec.dim))
    x = torch.as_tensor(x).to(vtype)
    got = _apply(op, x)
    assert got.dtype == vtype and torch.equal(got, _apply(dense, x))


def test_counter_under_the_profiler():
    """Under a profiler each apply_op counts the "pmix" terms it applies
    (four per matvec in the Hund operator), inside the mix span; without
    one nothing is recorded."""
    cfg, sec, ham = _hund(3, (3, 3))
    op = tham.make_matvec_op(ham, cfg, "cpu")
    x = torch.ones(sec.dim, dtype=torch.float64)
    timer.reset()
    _apply(op, x)
    assert timer.STORE.counts == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            _apply(op, x)
    tot = timer.totals()
    timer.reset()
    assert tot["hamiltonian.mix_gather_terms"]["count"] == 12
    assert tot["hamiltonian.mix"]["spans"] == 3


def test_wrapper_refuses_other_operands():
    t = torch.zeros
    i = torch.zeros((1, 4), dtype=torch.int32)
    rows = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        mix_gather(t((4, 4), dtype=torch.complex128),
                   t((4, 4), dtype=torch.complex128), i, t((1, 4)), i,
                   t((1, 4)), rows)
    with pytest.raises(ValueError):
        mix_gather(t((4, 4)), t((4, 4)), i.long(), t((1, 4)), i, t((1, 4)),
                   rows)
    with pytest.raises(ValueError):
        mix_gather(t((4, 4)), t((3, 4)), i, t((1, 4)), i, t((1, 4)), rows)


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _hund_cell(dtype):
    """The benchmark's hund2_nb12 configuration: its (7,7) sector."""
    with open(os.path.join(REPO, "benchmark", "configs",
                           "hund2_nb12.json")) as fh:
        c = json.load(fh)
    cfg = EDConfig(norb=2, nspin=1, bath_type=c["bath_type"],
                   nbath=c["nbath"], uloc=tuple(c["uloc"]), ust=c["ust"],
                   jh=c["jh"], jx=c["jx"], jp=c["jp"], beta=c["beta"],
                   xmu=c["xmu"], dtype=dtype).validate()
    b = Bath(cfg)
    b.e[0, :, :] = np.asarray(c["bath_e"])
    b.v[0, :, :] = np.asarray(c["bath_v"])
    sec = sector_table(cfg).get(*c["sector"])
    return cfg, sec, tham.build_sector_hamiltonian(
        cfg, sec, b, np.zeros((1, 1, 2, 2)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_on_the_hund_cell_operator(dtype, monkeypatch):
    """On the (7,7) sector of hund2_nb12 (3432 x 3432, four terms): the
    kernel equals the plain version on the same tables and the dense
    "bmix" path, bitwise, for a vector and a batch of two."""
    dev = _card()
    cfg, sec, ham = _hund_cell(dtype)
    op = tham.make_matvec_op(ham, cfg, dev)
    assert _kinds(op) == ["pmix"]
    spec, arrays, blocks = op
    tables = [arrays[i] for i in tham.mix_entries(spec)[0].tables]
    dense = _dense_op(monkeypatch, ham, cfg, dev)
    g = torch.Generator(device=dev).manual_seed(11)
    for lead in ((), (2,)):
        x = torch.randn(lead + (sec.dim,), dtype=getattr(torch, dtype),
                        device=dev, generator=g)
        v = x.reshape(lead + blocks[0])
        y0 = torch.randn(v.shape, dtype=v.dtype, device=dev, generator=g)
        n0 = mix_gather.launches
        got = mix_gather(v, y0.clone(), *tables)
        assert mix_gather.launches == n0 + 1
        ref = mix_gather_plain(v.cpu(), y0.cpu(),
                               *[t.cpu() for t in tables])
        assert torch.equal(got.cpu(), ref)
        assert torch.equal(_apply(op, x), _apply(dense, x))


@pytest.mark.gpu
def test_graph_replay_of_a_superc_operator():
    """A multi-block superc operator with "pmix" entries replays from a
    CUDA graph (lanczos._Graphed), bitwise the eager apply_op, for a flat
    vector and a batch, more than once; mix_gather.launches counts the
    kernels each replay launches."""
    dev = _card()
    cfg, sec, ham = _superc(0, nbath=5)
    spec, arrays, blocks = tham.make_matvec_op(ham, cfg, dev)
    assert set(_kinds((spec, arrays, blocks))) == {"pmix"}
    mv = tlanczos._op_matvec(spec, blocks, arrays)
    assert isinstance(mv, tlanczos._Graphed)
    npm = len(tham.mix_entries(spec))
    g = torch.Generator(device=dev).manual_seed(7)
    for shape in ((sec.dim,), (3, sec.dim)):
        for i in range(2):
            x = torch.randn(shape, dtype=torch.float64, device=dev,
                            generator=g)
            eager = _apply((spec, arrays, blocks), x)
            n0 = mix_gather.launches
            y = mv(x)
            # each replay counts its launches; a shape's first call also
            # runs the warm-up, and its capture counts none
            assert mix_gather.launches - n0 == npm * (2 if i == 0 else 1)
            assert torch.equal(y, eager)


@pytest.mark.gpu
def test_launches_on_the_thick_restart():
    """The Hund cell's thick restart launches the kernel once per matvec
    (a single-block operator: eager, no graph)."""
    dev = _card()
    cfg, sec, ham = _hund_cell("float64")
    spec, arrays, blocks = tham.make_matvec_op(ham, cfg, dev)
    v0 = torch.randn(sec.dim, dtype=torch.float64, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(3))
    v0 = v0 / torch.linalg.vector_norm(v0)
    n0 = mix_gather.launches
    _, _, n = tlanczos.eigs_lanczos_op(spec, blocks, arrays, v0, 1, 23,
                                       maxiter=24, tol=1e-12)
    assert n >= 23 and mix_gather.launches - n0 == n
