"""Ground-state cells: the window drives the port's thick-restart Lanczos
(``dmft_ed_tpu_torch.lanczos.eigs_lanczos_op``: one eigenpair, the basis
size of ``diag._ncv``, ``cfg.lanc_niter`` and ``cfg.lanc_tolerance``) on one
sector's operator, as ``diag`` runs it for a sector above
``lanc_dim_threshold``.

Set-up builds the operator through the port
(``hamiltonian.build_sector_hamiltonian``, ``make_matvec_op``) from the
configuration's bath and warms up one solve. The traffic may set
``matmul_precision`` and ``dtype`` (else the configuration's, else
``native`` and ``float64``). Each solve starts from one of a pool of
``start_pool`` vectors drawn on the device from the traffic's
``pool_seed``; the run's seed draws the order in which the window visits
the pool, so every run does the same set of work in another order (the
matvecs a solve takes depend on its start vector). The traced solve starts
from the pool's first vector, whatever the seed and the window's length.
"""

from __future__ import annotations

import numpy as np
import torch

from dmft_ed_tpu_torch.bath import Bath
from dmft_ed_tpu_torch.config import EDConfig
from dmft_ed_tpu_torch.diag import _ncv
from dmft_ed_tpu_torch.hamiltonian import (build_sector_hamiltonian,
                                           make_matvec_op)
from dmft_ed_tpu_torch.lanczos import eigs_lanczos_op
from dmft_ed_tpu_torch.sectors import sector_table

from benchmark.harness import sync
from benchmark.trace import Spans

NUMBERS = ("egs_gap", "residual")


def visit_order(traffic: dict, seed: int) -> list:
    """The pool's start vectors in the order the seed draws."""
    return [int(i) for i in np.random.default_rng([seed % 2 ** 63, 0])
            .permutation(int(traffic["start_pool"]))]


def _setting(key: str, traffic: dict, config: dict, default: str) -> str:
    return traffic.get(key, config.get(key, default))


def build(config, traffic, seed, device, reference, variant=None):
    return GsCell(config, traffic, seed, device, reference, variant)


class GsCell:
    unit_kind = "solve"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 reference, variant=None):
        """`reference`: the configuration's plain reference module;
        `variant` "float32" puts the program's float32 path with native
        products in its place (the control)."""
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.ref = reference
        dtype = _setting("dtype", traffic, config, "float64")
        precision = _setting("matmul_precision", traffic, config, "native")
        if variant == "float32":
            dtype, precision = "float32", "native"
        self.precision = precision
        cfg = EDConfig(norb=1, nspin=1, nbath=config["nbath"],
                       uloc=(config["uloc"][0],), beta=config["beta"],
                       dtype=dtype, matmul_precision=precision).validate()
        self.e = np.asarray(config["bath_e"], dtype=np.float64)
        self.v = np.asarray(config["bath_v"], dtype=np.float64)
        bath = Bath(cfg)
        bath.e[:] = self.e[None, None, :]
        bath.v[:] = self.v[None, None, :]
        nup, ndw = config["sector"]
        sec = sector_table(cfg).get(nup, ndw)
        self.shape = (sec.blocks[0].ddw, sec.blocks[0].dup)
        ham = build_sector_hamiltonian(cfg, sec, bath, np.zeros((1, 1, 1, 1)))
        self.op = make_matvec_op(ham, cfg, self.device)
        self.vdtype = getattr(torch, self.op[0][-1])
        self.dim = int(sec.dim)
        self.ncv = _ncv(cfg, sec.dim, 1)
        self.maxiter = min(sec.dim, cfg.lanc_niter)
        self.tol = cfg.lanc_tolerance
        self.order = visit_order(traffic, seed)
        self.gen = torch.Generator(device=self.device)
        self.count = 0
        self.pick = np.random.default_rng([seed % 2 ** 63, 2])
        self.nkeep = int(traffic["check_vectors"])
        self.egs, self.matvecs, self.kept = [], [], []
        self.spans = Spans()

    def _solve(self, k: int):
        """The solve from the pool's k-th start vector (drawn anew from
        its own generator state each time)."""
        self.gen.manual_seed(int(self.traffic["pool_seed"]) * 4096 + k)
        v0 = torch.randn(self.dim, generator=self.gen, device=self.device,
                         dtype=torch.float64).to(self.vdtype)
        v0 = v0 / torch.linalg.vector_norm(v0)
        spec, arrays, blocks = self.op
        with self.spans("lanczos.eigs_lanczos_op"):
            evals, evecs, niter = eigs_lanczos_op(
                spec, blocks, arrays, v0, 1, self.ncv, maxiter=self.maxiter,
                tol=self.tol)
        sync(self.device)
        return float(evals[0]), evecs[0], int(niter)

    def warm(self) -> None:
        self._solve(self.order[0])

    def unit(self) -> int:
        """The next solve of the pool in the seed's order; while traced,
        the pool's first."""
        if self.spans.on:
            self._solve(0)
            return 1
        egs, vec, niter = self._solve(
            self.order[self.count % len(self.order)])
        self.count += 1
        i = len(self.egs)
        self.egs.append(egs)
        self.matvecs.append(niter)
        # reservoir sample of the returned vectors, drawn from the seed
        if i < self.nkeep:
            self.kept.append((i, vec))
        else:
            j = int(self.pick.integers(0, i + 1))
            if j < self.nkeep:
                self.kept[j] = (i, vec)
        return 1

    def records(self) -> dict:
        return {"matvecs": list(self.matvecs), "precision": self.precision,
                "shape": self.shape}

    def release(self) -> None:
        self.op = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict, rng):
        """egs of every window solve against the reference's, and the
        residual |H x - egs x| of the sampled vectors under the
        reference's own operator."""
        c = self.config
        nup, ndw = c["sector"]
        op = self.ref.SectorOperator(self.e, self.v, c["uloc"][0], nup, ndw,
                                     self.device)
        e0 = op.lowest_eigenvalue(np.random.default_rng(0))
        gaps = [abs(e - e0) for e in self.egs]
        res = {i: op.residual(vec, self.egs[i]) for i, vec in self.kept}
        failed = sum(1 for i, g in enumerate(gaps)
                     if not (g <= limits["egs_gap"]
                             and res.get(i, 0.0) <= limits["residual"]))
        return {"egs_gap": (max(gaps), limits["egs_gap"]),
                "residual": (max(res.values()), limits["residual"])}, failed
