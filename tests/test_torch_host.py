"""Host layer of the PyTorch port against the JAX package: sector tables,
per-spin COO operators, factored diagonals and bath codecs are bitwise
equal; reference-format files round-trip through ``convert``; the port
imports neither jax nor the JAX package."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import dmft_ed_tpu.bath as jbath
import dmft_ed_tpu.config as jconfig
import dmft_ed_tpu.hamiltonian as jham
import dmft_ed_tpu.io as jio
import dmft_ed_tpu.sectors as jsectors
import dmft_ed_tpu_torch.bath as tbath
import dmft_ed_tpu_torch.config as tconfig
import dmft_ed_tpu_torch.convert as convert
import dmft_ed_tpu_torch.hamiltonian as tham
import dmft_ed_tpu_torch.io as tio
import dmft_ed_tpu_torch.sectors as tsectors

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "dmft_ed_tpu_torch"

CONFIGS = [
    dict(norb=1, nbath=4, nspin=1, uloc=(2.0,)),
    dict(norb=2, nbath=2, nspin=1, uloc=(2.0, 1.5), ust=1.0, jh=0.25),
    dict(norb=1, nbath=3, nspin=2, uloc=(3.0,), xmu=0.3),
    dict(norb=1, nbath=3, nspin=2, uloc=(3.0,), ed_mode="nonsu2"),
]


def _baths(kw, seed):
    """The same random bath for both packages (numpy seed)."""
    rng = np.random.default_rng(seed)
    jb = jbath.Bath(jconfig.EDConfig(**kw).validate())
    jb.e[:] = rng.uniform(-1.0, 1.0, jb.e.shape)
    jb.v[:] = rng.uniform(0.2, 0.8, jb.v.shape)
    tb = tbath.Bath(tconfig.EDConfig(**kw).validate())
    tb.e[:] = jb.e
    tb.v[:] = jb.v
    if jb.u is not None:        # nonsu2: spin-flip hybridizations
        jb.u[:] = rng.uniform(0.1, 0.3, jb.u.shape)
        tb.u[:] = jb.u
    return jb, tb


def _hloc(cfg, seed):
    rng = np.random.default_rng(seed)
    h = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    for s in range(cfg.nspin):
        h[s, s] = np.diag(rng.uniform(-0.3, 0.3, cfg.norb))
    return h


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_sector_tables_bitwise(ci):
    kw = CONFIGS[ci]
    jt = jsectors.sector_table(jconfig.EDConfig(**kw).validate())
    tt = tsectors.sector_table(tconfig.EDConfig(**kw).validate())
    assert len(jt) == len(tt)
    for a, b in zip(jt.sectors, tt.sectors):
        assert (a.index, a.qn, a.dim, a.ns) == (b.index, b.qn, b.dim, b.ns)
        assert [dataclasses.astuple(x) for x in a.blocks] == \
            [dataclasses.astuple(x) for x in b.blocks]
        for s in (0, 1):
            for op in ("cdg_sector", "c_sector"):
                x = getattr(jt, op)(a, s)
                y = getattr(tt, op)(b, s)
                assert getattr(x, "index", None) == getattr(y, "index", None)


def _same_coo(a, b):
    assert a.shape == b.shape
    for x, y in ((a.rows, b.rows), (a.cols, b.cols), (a.vals, b.vals)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_sector_hamiltonian_bitwise(ci):
    """COO blocks, mix terms, factored and dense diagonals, assembled H."""
    kw = CONFIGS[ci]
    jcfg = jconfig.EDConfig(**kw).validate()
    tcfg = tconfig.EDConfig(**kw).validate()
    jb, tb = _baths(kw, 10 + ci)
    hloc = _hloc(jcfg, 20 + ci)
    jt, tt = jsectors.sector_table(jcfg), tsectors.sector_table(tcfg)
    picks = [s.index for s in jt.sectors if 1 < s.dim <= 400][:6]
    assert picks
    for i in picks:
        hj = jham.build_sector_hamiltonian(jcfg, jt.sectors[i], jb, hloc)
        ht = tham.build_sector_hamiltonian(tcfg, tt.sectors[i], tb, hloc)
        assert np.dtype(hj.dtype) == np.dtype(ht.dtype)
        for a, b in zip(hj.hup + hj.hdw, ht.hup + ht.hdw):
            _same_coo(a, b)
        assert len(hj.mix) == len(ht.mix)
        for a, b in zip(hj.mix, ht.mix):
            assert (a.src, a.dst, a.coeff) == (b.src, b.dst, b.coeff)
            for x, y in ((a.up, b.up), (a.dw, b.dw)):
                assert (x is None) == (y is None)
                if x is not None:
                    _same_coo(x, y)
        assert (hj.dfac is None) == (ht.dfac is None)
        if hj.dfac is not None:
            assert np.array_equal(hj.dfac[0], ht.dfac[0])
            assert hj.dfac[1] == ht.dfac[1]
            for fa, fb in zip(hj.dfac[2], ht.dfac[2]):
                for x, y in zip(fa, fb):
                    assert np.array_equal(x, y)
        for x, y in zip(hj.diag, ht.diag):
            assert np.array_equal(x, y)
        assert np.array_equal(jham.assemble_dense(hj), tham.assemble_dense(ht))


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_bath_codecs_bitwise(ci):
    kw = CONFIGS[ci]
    jcfg = jconfig.EDConfig(**kw).validate()
    tcfg = tconfig.EDConfig(**kw).validate()
    hloc = _hloc(jcfg, 30 + ci)
    assert jbath.get_bath_dimension(jcfg, hloc) == \
        tbath.get_bath_dimension(tcfg, hloc)
    fj = jbath.pack_bath(jbath.init_bath(jcfg, hloc))
    ft = tbath.pack_bath(tbath.init_bath(tcfg, hloc))
    assert np.array_equal(fj, ft)
    rng = np.random.default_rng(40 + ci)
    flat = rng.normal(size=fj.shape)
    ub_j, ub_t = jbath.unpack_bath(jcfg, flat), tbath.unpack_bath(tcfg, flat)
    assert np.array_equal(ub_j.e, ub_t.e) and np.array_equal(ub_j.v, ub_t.v)
    assert np.array_equal(jbath.pack_bath(ub_j), tbath.pack_bath(ub_t))
    for fn in ("ph_symmetrize_bath", "spin_symmetrize_bath",
               "enforce_normal_bath"):
        assert np.array_equal(getattr(jbath, fn)(jcfg, flat),
                              getattr(tbath, fn)(tcfg, flat)), fn


def test_config_from_reference():
    jcfg = jconfig.EDConfig(norb=2, nbath=3, uloc=(2.0, 1.0), ust=0.5,
                            lanc_method="lanczos",
                            matmul_precision="ozaki5x7").validate()
    for src in (jcfg, dataclasses.asdict(jcfg)):
        tcfg = convert.config_from_reference(src)
        assert isinstance(tcfg, tconfig.EDConfig)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError):
        convert.config_from_reference(dict(dataclasses.asdict(jcfg),
                                           not_a_field=1))


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_restart_roundtrip(ci, tmp_path):
    """A restart file the JAX package writes reads back through convert
    exactly as the JAX package reads it, and the port writes it back
    byte-identical."""
    kw = CONFIGS[ci]
    jcfg = jconfig.EDConfig(**kw).validate()
    tcfg = convert.config_from_reference(jcfg)
    jb, _ = _baths(kw, 50 + ci)
    ref = tmp_path / "ref.restart"
    jbath.save_bath(jb, path=str(ref))
    flat = convert.read_bath_restart(tcfg, str(ref))
    jread = jbath.Bath(jcfg)
    jbath.load_bath(jread, str(ref))
    assert np.array_equal(flat, jbath.pack_bath(jread))
    # the flat vector needs no conversion: both packages unpack it alike
    assert np.array_equal(tbath.pack_bath(tbath.unpack_bath(tcfg, flat)),
                          jbath.pack_bath(jbath.unpack_bath(jcfg, flat)))
    out = tmp_path / "port.restart"
    convert.write_bath_restart(tcfg, flat, str(out))
    assert out.read_bytes() == ref.read_bytes()


def test_ed_files_byte_identical(tmp_path, monkeypatch):
    """observables/energy/G .ed files written by the two packages from the
    same numbers are byte-identical, and read back equal."""
    import dmft_ed_tpu.observables as jobs
    import dmft_ed_tpu_torch.observables as tobs
    kw = dict(norb=2, nbath=2, nspin=1, uloc=(2.0, 1.0), lmats=16, lreal=8)
    jcfg = jconfig.EDConfig(**kw).validate()
    tcfg = tconfig.EDConfig(**kw).validate()
    rng = np.random.default_rng(60)
    vals = {f.name: rng.normal(size=2) for f in
            dataclasses.fields(jobs.Observables)
            if f.name in ("dens", "dens_up", "dens_dw", "docc", "magz",
                          "sz2", "n2")}
    simp, zimp = rng.normal(size=(1, 2)), rng.normal(size=(1, 2))
    e = {f.name: float(x) for f, x in zip(dataclasses.fields(jobs.EnergyObs),
                                          rng.normal(size=7))}
    fm = rng.normal(size=(1, 1, 2, 2, 16)) + 1j * rng.normal(
        size=(1, 1, 2, 2, 16))
    fr = rng.normal(size=(1, 1, 2, 2, 8)) + 1j * rng.normal(
        size=(1, 1, 2, 2, 8))
    written = {}
    for name, io_, obs_, cfg in (("jax", jio, jobs, jcfg),
                                 ("torch", tio, tobs, tcfg)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        o = obs_.Observables(s2tot=0.75, **vals)
        io_.write_observables(cfg, o, -3.25, simp, zimp)
        io_.write_energy(cfg, obs_.EnergyObs(**e))
        io_.print_function(cfg, "Sigma", fm, fr)
        written[name] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert written["jax"].keys() == written["torch"].keys()
    assert len(written["jax"]) >= 5
    for k in written["jax"]:
        assert written["jax"][k] == written["torch"][k], k
    monkeypatch.chdir(tmp_path / "jax")
    rm_j, rr_j = jio.read_function(jcfg, "Sigma")
    rm_t, rr_t = tio.read_function(tcfg, "Sigma")
    assert np.array_equal(rm_j, rm_t) and np.array_equal(rr_j, rr_t)


def test_import_leaves_out_jax():
    """Importing the port (and its solver path) pulls in neither jax nor
    the JAX package."""
    code = ("import sys\n"
            "import dmft_ed_tpu_torch\n"
            "import dmft_ed_tpu_torch.models.hm_bethe\n"
            "import dmft_ed_tpu_torch.convert, dmft_ed_tpu_torch.fit\n"
            "import dmft_ed_tpu_torch.chi\n"
            "import dmft_ed_tpu_torch.parallel.spawn\n"
            "import dmft_ed_tpu_torch.benches.bench, "
            "dmft_ed_tpu_torch.benches.bench_e2e\n"
            "import dmft_ed_tpu_torch.benches.bench_scaling, "
            "dmft_ed_tpu_torch.benches.bench_trace\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'dmft_ed_tpu' or "
            "m.startswith('dmft_ed_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    p = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_ast_no_jax_imports():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    assert {"mesh.py", "hxv.py", "spawn.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    assert {"bench.py", "bench_e2e.py", "bench_scaling.py",
            "bench_trace.py"} <= {
        f.name for f in files if f.parent.name == "benches"}
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "dmft_ed_tpu"), (f, mod)


def test_slow_port_tests_import_only_the_port():
    """The port's slow physics files (tests/test_torch_slow_*.py) import
    neither jax nor the JAX package, so they run on a card's machine
    without the reference."""
    files = sorted((REPO / "tests").glob("test_torch_slow_*.py"))
    assert len(files) >= 6
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "dmft_ed_tpu"), (f, mod)
