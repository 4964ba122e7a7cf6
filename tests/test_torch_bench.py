"""The port's benchmark entry points (dmft_ed_tpu_torch/benches/) against
the JAX package's root scripts (bench.py, bench_e2e.py), imported as
modules, on the CPU at small size.

* bench: bench.py's problem at Nbath=7 (the (4,4) sector, 70x70 = 4,900
  states): the same dim and CSR-equivalent nnz; the 30-step alphas and
  betas against bench.lanczos_loop, differences over the largest beta:
  native within 1e-12 (measured 6.6e-15), ozaki5x7 against the JAX
  package's ozaki5x7 within 1e-9, the truncation class (measured 7.3e-12),
  float32 against the JAX package's float64 within 1e-5 (measured
  3.4e-7); the thick restart's egs and matvecs against the JAX package's
  eigs_lanczos_op (egs 1e-12, measured 8.9e-15; the same 111 matvecs);
  main()'s JSON line carries bench.py's metric and detail keys.
* bench_e2e: the canonical and large EDConfigs and hm_bethe.run's keywords
  equal the JAX script's, captured by a recording stub in place of
  hm_bethe.run in both packages (no DMFT loop runs); the large config is
  chip_smoke.MAIN_CFG in every field but nloop, its keywords MAIN_RUN.
* bench_scaling: 2 gloo ranks on the CPU at Nbath=7, native, equal to one
  rank within 1e-12 (measured 1.5e-16).
* bench_trace: 2 ranks at Nbath=5 give every step's all-gather and a
  split whose classes cover the ATen operators' time.
* Every main() raises without a card unless given --device cpu.
* gpu: the kernel at bench.py's Nbath=13 classes (3432x3432, K padded to
  3440) bitwise against its plain version.
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads the OpenBLAS of jax's LAPACK calls)
import torch
try:
    from threadpoolctl import threadpool_limits
except ImportError:           # without it the BLAS pools keep their size
    def threadpool_limits(limits=None):
        return contextlib.nullcontext()

import jax
import jax.numpy as jnp

import bench as jbench
import bench_e2e as jbench_e2e
import chip_smoke
from dmft_ed_tpu.hamiltonian import make_matvec_op as jmake_matvec_op
from dmft_ed_tpu.lanczos import eigs_lanczos_op as jeigs_lanczos_op
from dmft_ed_tpu.models import hm_bethe as jhm_bethe
from dmft_ed_tpu_torch.benches import (bench, bench_e2e, bench_scaling,
                                       bench_trace)
from dmft_ed_tpu_torch.models import hm_bethe as thm_bethe

NBATH = 7
NITER = 30


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread and one BLAS thread per test (see
    tests/test_torch_nano.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX script's 30 steps at Nbath=7 per (dtype, precision), from
    bench.run's start vector, and its problem's dim and nnz."""
    out = {}
    loop = jax.jit(jbench.lanczos_loop, static_argnums=(0, 2))
    for dtype, prec in (("float64", "native"), ("float64", "ozaki5x7")):
        cfg, sec, ham, matvec, template = jbench.build_problem(NBATH, dtype,
                                                               prec)
        blk = sec.blocks[0]
        v0 = jnp.asarray(np.random.default_rng(1).normal(
            size=(blk.ddw, blk.dup)), dtype=template[0].dtype)
        _, al, be = loop(matvec, v0 / jnp.linalg.norm(v0), NITER)
        out[prec] = dict(alphas=np.asarray(al), betas=np.asarray(be),
                         dim=sec.dim, nnz=ham.nnz_estimate())
    return out


def _diff(res, ref):
    d = np.abs(np.r_[res["alphas"], res["betas"]]
               - np.r_[ref["alphas"], ref["betas"]])
    return d.max() / np.abs(ref["betas"]).max()


@pytest.mark.parametrize("name,dtype,prec,ref,tol", [
    ("native", "float64", "native", "native", 1e-12),
    ("ozaki5x7", "float64", "ozaki5x7", "ozaki5x7", 1e-9),
    ("float32", "float32", "native", "native", 1e-5)])
def test_bench_recurrence_matches_jax(jax_runs, name, dtype, prec, ref, tol):
    r = bench.run(NBATH, dtype, NITER, 1, prec, "cpu")
    assert (r["dim"], r["nnz"]) == (jax_runs[ref]["dim"],
                                    jax_runs[ref]["nnz"]) == (4900, 44100)
    assert r["finite"] and r["launches"] == {"digit_matmul": 0,
                                           "digit_split": 0,
                                           "mix_gather": 0}
    assert r["lanczos_iters_per_s"] > 0 and r["peak_gib"] is None
    assert _diff(r, jax_runs[ref]) <= tol


def test_bench_ground_state_matches_jax():
    """bench.ground_state's thick restart against the JAX package's
    eigs_lanczos_op with diag's basis rule, from the same start vector."""
    g = bench.ground_state(NBATH, "native", "cpu")
    cfg, sec, ham, _, _ = jbench.build_problem(NBATH, "float64")
    spec, arrays, blocks = jmake_matvec_op(ham, cfg)
    v0 = np.random.default_rng(1).normal(size=sec.dim)
    ncv = cfg.lanc_ncv_factor * cfg.lanc_nstates_sector + cfg.lanc_ncv_add
    evals, _, niter = jeigs_lanczos_op(
        spec, blocks, arrays, jnp.asarray(v0 / np.linalg.norm(v0)), 1, ncv,
        maxiter=min(sec.dim, cfg.lanc_niter), tol=cfg.lanc_tolerance)
    assert g["ncv"] == ncv == 23 and g["finite"]
    assert abs(g["egs"] - float(evals[0])) <= 1e-12
    assert g["matvecs"] == niter


def test_bench_main_prints_the_scripts_line(capsys):
    assert bench.main(["--device", "cpu", "--nbath", "5", "--niter", "8",
                       "--repeats", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu" and len(lines) == 2
    head = json.loads(lines[-1])
    runs = head["detail"]["runs"]
    assert list(runs) == ["ozaki5x7", "native", "float32"]
    assert [r["matmul_precision"] for r in runs.values()] == \
        ["ozaki5x7", "native", "native"]
    assert head["metric"] == "sector_HxV_effective_nnz_per_s_f64"
    assert {"metric", "value", "unit", "vs_baseline"} <= set(head)
    assert {"precision_mode", "sector_dim", "csr_equivalent_nnz",
            "lanczos_iters_per_s", "nnz_per_s_f64_emulated",
            "nnz_per_s_f32", "lanczos_iters_per_s_f32",
            "device"} <= set(head["detail"])
    assert head["detail"]["sector_dim"] == 400
    assert head["vs_baseline"] == pytest.approx(
        head["value"] / jbench.CPU_NODE_CSR_BASELINE)


@pytest.mark.parametrize("workload", ["canonical", "large"])
def test_bench_e2e_configs_match_jax(workload, monkeypatch):
    """The EDConfigs and hm_bethe.run keywords of both scripts, captured
    without running a loop."""
    seen = {}

    class Stub:
        iterations, converged, error, ekin = 1, True, 0.0, 0.0
        docc = dens = np.zeros(1)

    def recorder(pkg):
        def run(cfg, **kw):
            seen[pkg] = (dataclasses.asdict(cfg), {
                k: v for k, v in kw.items()
                if k not in ("log", "solver", "device")})
            return Stub()
        return run

    monkeypatch.setattr(jhm_bethe, "run", recorder("jax"))
    monkeypatch.setattr(thm_bethe, "run", recorder("port"))
    if workload == "canonical":
        jbench_e2e.run_canonical(7)
        bench_e2e.run_canonical(7, "cpu")
        assert seen["port"] == seen["jax"]
        assert seen["port"][1] == dict(le=500, wmixing=0.5)
        return
    jbench_e2e.run_large(3, cpu=True)
    bench_e2e.run_large(3, "cpu")
    assert seen["port"] == seen["jax"]
    assert seen["port"][0]["matmul_precision"] == "native"
    jbench_e2e.run_large(3, cpu=False)
    card = dataclasses.asdict(bench_e2e.large_config(3, "ozaki5x7"))
    assert card == seen["jax"][0]
    from dmft_ed_tpu_torch.config import EDConfig
    main = dataclasses.asdict(EDConfig(**chip_smoke.MAIN_CFG).validate())
    assert {k: v for k, v in card.items() if k != "nloop"} == \
        {k: v for k, v in main.items() if k != "nloop"}
    assert seen["jax"][1] == chip_smoke.MAIN_RUN


def test_bench_scaling_two_ranks_match_one():
    recs = bench_scaling.scaling("cpu", NBATH, "native", niter=12,
                                 repeats=1, max_ranks=2)
    assert [r["ranks"] for r in recs] == [1, 2]
    assert all(r["backend"] == "gloo" and not r["shared_card"]
               for r in recs)
    assert recs[1]["local_block"] == [35, 70]
    assert recs[1]["gather_mb"] == pytest.approx(8 * 4900 / 1e6)
    assert recs[1]["max_rel_diff_vs_1rank"] <= 1e-12
    assert recs[0]["dim"] == 4900 and recs[0]["nnz"] == 44100


def test_bench_trace_classes():
    out = bench_trace.trace("cpu", nbath=5, niter=10, ranks=2)
    names = {c for c, _ in bench_trace.CLASSES} | {"other"}
    assert set(out["per_class_ms"]) <= names
    assert {"gemm", "reduction", "collective", "elementwise"} <= \
        set(out["per_class_ms"])
    assert sum(out["per_class_frac"].values()) == pytest.approx(1.0)
    assert out["rank0_all_gathers"] == 10 and out["sector_dim"] == 400
    assert out["rank0_host_s_in_all_gathers"] > 0
    assert bench_trace.classify("void digit_matmul_wgmma<5>") == \
        "digit_kernel"
    assert bench_trace.classify("sm90_xmma_gemm_f64f64") == "gemm"
    assert bench_trace.classify("ncclDevKernel_AllGather_RING_LL") == \
        "collective"


@pytest.mark.parametrize("mod", [bench, bench_e2e, bench_scaling,
                                 bench_trace])
def test_entry_points_need_a_card(mod, monkeypatch):
    """Every main() runs on cuda unless given --device cpu and raises
    without a card instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])


@pytest.mark.gpu
def test_bench_kernel_class_on_card():
    """The kernel at bench.py's Nbath=13 classes on the card (run there
    with ``python -m pytest -m gpu tests/test_torch_bench.py``): H_dw @ V
    and V @ H_up^T at 3432x3432 (K padded to 3440), bitwise against the
    plain version, 1e-9 of the f64 product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from dmft_ed_tpu_torch import ozaki
    from dmft_ed_tpu_torch.kernels import digit_matmul, digit_matmul_plain
    cfg, sec, ham = bench.build_hamiltonian(13)
    K = sec.blocks[0].ddw
    g = torch.Generator().manual_seed(1700)
    V = (torch.randn(K, K, dtype=torch.float64, generator=g) / K).cuda()
    Hdw = torch.as_tensor(ham.hdw[0].to_dense()).cuda()
    HupT = torch.as_tensor(ham.hup[0].to_dense()).T.contiguous().cuda()
    for A, B in ((Hdw, V), (V, HupT)):
        ad, sa = ozaki._left_digits(A, 5, 7)
        bd, sb = ozaki._right_digits(B, 5, 7)
        assert ad.shape[2] == ozaki.kpad(K) == 3440
        args = (ad, bd, sa.reshape(-1), sb.reshape(-1), 7, False, K)
        got = digit_matmul(*args, k=K)
        assert torch.equal(got, digit_matmul_plain(*args, k=K))
        exact = A @ B
        assert float((got - exact).abs().max() / exact.abs().max()) <= 1e-9
