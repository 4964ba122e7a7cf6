"""The comparison that decides ``correct`` fails a broken timed path and the
lower-precision control: each case drives a whole run at a small size on
the CPU (the look for a card skipped) with a fault planted in the program
underneath, and sees ``correct`` come out false. No cell spans chips, so
the fault of a left-out exchange between chips has no case here."""

import numpy as np
import pytest

import dmft_ed_tpu_torch.fit as fit
import dmft_ed_tpu_torch.gf_normal as gf_normal
import dmft_ed_tpu_torch.lanczos as lanczos
import dmft_ed_tpu_torch.models.hm_bethe as hm_bethe

from .small import run

GS = ["impurity_nb13.gs", "impurity_nb13.gs_ozaki5x7"]


def _false(workload, **kw):
    res = run(workload, **kw)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1
    return res


def test_sound_runs_pass():
    for w in ["hm_bethe_nb6.loop"] + GS:
        assert run(w)["correct"] is True


# --- the control: the program's own float32 path in its place -----------

@pytest.mark.parametrize("workload", ["hm_bethe_nb6.loop"] + GS)
def test_control_float32_fails(workload):
    _false(workload, variant="float32")


# --- the DMFT loop --------------------------------------------------------

def test_loop_fit_returns_its_state(monkeypatch):
    """A bath fit that hands its input back unchanged."""
    monkeypatch.setattr(fit, "chi2_fitgf",
                        lambda cfg, fg, bath_flat, *a, **k: bath_flat.copy())
    res = _false("hm_bethe_nb6.loop")
    assert res["checks"]["fit_ratio"]["value"] >= 1.0


def test_loop_half_the_band_left_out(monkeypatch):
    """Gloc summed over half of the DOS grid, the mean over the rest."""
    orig = hm_bethe.gloc_dos

    def half(cfg, eb, db, h0, sigma, axis="mats"):
        return orig(cfg, eb[:, ::2], 2.0 * db[:, ::2], h0, sigma, axis)
    monkeypatch.setattr(hm_bethe, "gloc_dos", half)
    res = _false("hm_bethe_nb6.loop")
    assert res["checks"]["weiss_gap"]["value"] > \
        res["checks"]["weiss_gap"]["limit"]


def test_loop_gf_altered(monkeypatch):
    """G(iw) altered by one part in a million where it is produced."""
    orig = gf_normal.build_gf_normal

    def bent(*a, **k):
        gm, gr = orig(*a, **k)
        return gm * (1 + 1e-6), gr
    monkeypatch.setattr(gf_normal, "build_gf_normal", bent)
    res = _false("hm_bethe_nb6.loop")
    assert res["checks"]["g_gap"]["value"] > res["checks"]["g_gap"]["limit"]


# --- the ground-state solves ----------------------------------------------

@pytest.mark.parametrize("workload", GS)
def test_gs_returns_its_state(workload, monkeypatch):
    """A solve that returns its start vector unchanged."""
    orig = lanczos.eigs_lanczos

    def stuck(matvec, v0, *a, **k):
        evals, evecs, n = orig(matvec, v0, *a, **k)
        return evals, v0[None, :].clone(), n
    monkeypatch.setattr(lanczos, "eigs_lanczos", stuck)
    res = _false(workload)
    assert res["checks"]["residual"]["value"] > 1e-3


@pytest.mark.parametrize("workload", GS)
def test_gs_half_the_vector_left_out(workload, monkeypatch):
    """A matvec that leaves out the second half of the vector's rows and
    scales the rest to keep its norm."""
    orig = lanczos._op_matvec

    def half(*a, **k):
        mv = orig(*a, **k)

        def f(x):
            y = x.clone()
            y[..., x.shape[-1] // 2:] = 0
            return mv(y) * np.sqrt(2.0)
        return f
    monkeypatch.setattr(lanczos, "_op_matvec", half)
    _false(workload)


@pytest.mark.parametrize("workload", GS)
def test_gs_energy_altered(workload, monkeypatch):
    """The ground-state energy altered by one part in a million."""
    orig = lanczos.eigs_lanczos

    def bent(*a, **k):
        evals, evecs, n = orig(*a, **k)
        return evals * (1 + 1e-6), evecs, n
    monkeypatch.setattr(lanczos, "eigs_lanczos", bent)
    res = _false(workload)
    assert res["checks"]["egs_gap"]["value"] > \
        res["checks"]["egs_gap"]["limit"]
