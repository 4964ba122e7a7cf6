"""DMFT-loop cells: the window drives the port's Bethe-lattice driver
(``dmft_ed_tpu_torch.models.hm_bethe.run``, unmodified) in episodes of a
fixed number of iterations.

Each episode has a fresh ``EDSolver`` in a directory of its own under
``TMPDIR`` (the loop writes ``.ed`` files into its working directory).
Its input is one of a pool of ``episode_pool`` inputs drawn from the
traffic's ``pool_seed``: the solver's own initial bath with its levels in
a drawn order (a relabelling: the physics, the sizes and the work stay)
and an ``EDConfig.seed``, which sets the Lanczos start vectors. The run's
seed draws the order in which the window visits the pool, so every run
does the same set of work in another order; the traced episode runs the
pool's first input, whatever the seed and the window's length. The
traffic may set ``dtype`` and ``matmul_precision`` over the
configuration's. The solver is a subclass that
records what each solve and fit took and gave, and whose stage timers are
also the benchmark's host spans while the cell is traced.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch

from dmft_ed_tpu_torch.config import EDConfig
from dmft_ed_tpu_torch.models import hm_bethe
from dmft_ed_tpu_torch.solver import EDSolver
from dmft_ed_tpu_torch.timer import Timers

from benchmark.harness import sync
from benchmark.trace import Spans

_FIELDS = {f.name for f in dataclasses.fields(EDConfig)}
_DRIVER = ("le", "wbethe", "wmixing")
NUMBERS = ("egs_gap", "g_gap", "sigma_gap", "dens_gap", "docc_gap",
           "weiss_gap", "fit_ratio", "mix_gap")


def _none(*_a, **_k):
    return None


class _SpanTimers(Timers):
    """The solver's stage timers; each stage is also a profiler span
    while the cell is traced."""

    def __init__(self, cell):
        super().__init__(None)
        self._cell = cell

    @contextmanager
    def __call__(self, name: str, announce: bool = False):
        with self._cell.spans("stage:" + name), \
                super().__call__(name, announce):
            yield


class _Recorder(EDSolver):
    """EDSolver that starts from the seed's bath and records each solve's
    input and outputs and each fit's input, target and output."""

    def __init__(self, cfg, device, perm, cell):
        super().__init__(cfg, np.zeros((cfg.nspin, cfg.nspin, cfg.norb,
                                        cfg.norb)), log=_none, device=device)
        self.timers = _SpanTimers(cell)
        self.perm = perm
        self.bath0 = None
        self.iters = []

    def init_solver(self) -> np.ndarray:
        flat = super().init_solver()
        nb = self.cfg.nbath
        self.bath0 = np.concatenate([flat[:nb][self.perm],
                                     flat[nb:2 * nb][self.perm]])
        return self.bath0.copy()

    def solve(self, bath_flat):
        res = super().solve(bath_flat)
        self.iters.append({
            "bath": np.array(bath_flat, dtype=np.float64),
            "egs": float(res.egs), "g": res.gmats[0, 0, 0, 0].copy(),
            "sigma": res.smats[0, 0, 0, 0].copy(),
            "dens": float(res.observables.dens[0]),
            "docc": float(res.observables.docc[0])})
        return res

    def chi2_fitgf(self, fg, bath_flat, **kw):
        out = super().chi2_fitgf(fg, bath_flat, **kw)
        self.iters[-1].update(fit_in=np.array(bath_flat, dtype=np.float64),
                              weiss=np.array(fg[0, 0, 0, 0]),
                              fit_out=np.array(out, dtype=np.float64))
        return out


def build(config, traffic, seed, device, reference, variant=None):
    return LoopCell(config, traffic, seed, device, reference, variant)


class LoopCell:
    unit_kind = "iteration"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 reference, variant=None):
        """`reference`: the configuration's plain reference module;
        `variant` "float32" puts the program's float32 path in its place
        (the control)."""
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.ref = reference
        self.variant = variant
        pool = np.random.default_rng(int(traffic["pool_seed"]))
        self.pool = [(int(pool.integers(0, 2 ** 31 - 1024)),
                      pool.permutation(config["nbath"]))
                     for _ in range(int(traffic["episode_pool"]))]
        order = np.random.default_rng([seed % 2 ** 63, 0]).permutation(
            len(self.pool))
        self.inputs = [self.pool[i] for i in order]
        self.workdir = tempfile.mkdtemp(prefix="bench_loop_")
        self.episodes, self.count = [], 0
        self.stage_s = defaultdict(float)
        self.spans = Spans()

    def _cfg(self, niter: int, seed: int) -> EDConfig:
        kw = {k: v for k, v in self.config.items() if k in _FIELDS}
        kw["uloc"] = tuple(kw["uloc"])
        kw.update({k: self.traffic[k] for k in ("dtype", "matmul_precision")
                   if k in self.traffic})
        kw.update(nloop=niter, seed=seed)
        if self.variant == "float32":
            kw["dtype"] = "float32"
        return EDConfig(**kw).validate()

    def _episode(self, inputs, niter: int, tag: str, keep: bool) -> int:
        seed, perm = inputs
        cfg = self._cfg(niter, seed)
        where = os.path.join(self.workdir, tag)
        os.makedirs(where)
        back = os.getcwd()
        os.chdir(where)
        try:
            solver = _Recorder(cfg, self.device, perm, self)
            with self.spans("hm_bethe.run"):
                res = hm_bethe.run(cfg, log=_none, solver=solver,
                                   **{k: self.config[k] for k in _DRIVER})
            sync(self.device)
        finally:
            os.chdir(back)
            shutil.rmtree(where, ignore_errors=True)
        if keep:
            self.episodes.append({"bath0": solver.bath0,
                                  "iters": solver.iters})
            for k, v in solver.timers.acc.items():
                self.stage_s[k] += v
        return int(res.iterations)

    def warm(self) -> None:
        """One iteration of the first input, as the window's first
        episode starts."""
        self._episode(self.inputs[0], 1, "warm", keep=False)

    def unit(self) -> int:
        """The next input's episode, the pool visited in the seed's order
        and then again; while traced, the pool's first input's."""
        k = self.count
        self.count += 1
        traced = self.spans.on
        return self._episode(self.pool[0] if traced
                             else self.inputs[k % len(self.inputs)],
                             int(self.traffic["iters_per_episode"]),
                             f"episode{k}", keep=not traced)

    def records(self) -> dict:
        return {"stage_s": dict(self.stage_s),
                "iterations": sum(len(e["iters"]) for e in self.episodes)}

    def release(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _compare(self, ep: dict, i: int) -> dict:
        """The compared numbers of iteration i of an episode."""
        ref, c = self.ref, self.config
        it = ep["iters"][i]
        nb = c["nbath"]
        e, v = ref.split_bath(it["bath"], nb)
        o = ref.impurity_solve(e, v, c["uloc"][0], c["beta"], c["lmats"],
                               c.get("gs_threshold", 1e-9),
                               c.get("xmu", 0.0), self.device)
        z = 1j * ref.matsubara(c["beta"], c["lmats"])
        sig = ref.self_energy(z, e, v, o["g"], c.get("xmu", 0.0))
        weiss = ref.weiss_field(z, sig, c["wbethe"], c["le"],
                                c.get("xmu", 0.0))
        nfit = min(c.get("lfit", 1000), c["lmats"])

        def rel(a, b):
            return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

        def chi2(x):
            return ref.chi2(x, z[:nfit], weiss[:nfit], c.get("xmu", 0.0))

        w = c["wmixing"]
        if i == 0:
            expect = ep["bath0"]
        elif i == 1:
            expect = ep["iters"][0]["fit_out"]
        else:
            prev = ep["iters"][i - 1]
            expect = w * prev["fit_out"] + (1 - w) * prev["bath"]
        return {"egs_gap": abs(it["egs"] - o["egs"]),
                "g_gap": rel(it["g"], o["g"]),
                "sigma_gap": rel(it["sigma"], sig),
                "dens_gap": abs(it["dens"] - o["dens"]),
                "docc_gap": abs(it["docc"] - o["docc"]),
                "weiss_gap": rel(it["weiss"], weiss),
                "fit_ratio": chi2(it["fit_out"]) / chi2(it["fit_in"]),
                "mix_gap": float(np.max(np.abs(it["bath"] - expect)))}

    def check(self, limits: dict, rng):
        """Worst numbers over the iterations of up to ``check_episodes``
        window episodes drawn from the seed."""
        n = min(len(self.episodes), int(self.traffic["check_episodes"]))
        picked = sorted(rng.choice(len(self.episodes), n, replace=False))
        worst = {k: 0.0 for k in NUMBERS}
        failed = 0
        for j in picked:
            ep = self.episodes[j]
            for i in range(len(ep["iters"])):
                nums = self._compare(ep, i)
                failed += any(not nums[k] <= limits[k] for k in NUMBERS)
                for k in NUMBERS:
                    worst[k] = max(worst[k], nums[k]) \
                        if np.isfinite(nums[k]) else float("inf")
        return {k: (worst[k], limits[k]) for k in NUMBERS}, failed
