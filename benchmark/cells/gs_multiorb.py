"""Ground-state cells of a multi-orbital impurity: the window of
``cells/gs.py`` (thick-restart ground states of one sector, each from one
of a pool of start vectors visited in the seed's order; the traced
solve from the pool's first) on the operator of an Norb-orbital impurity with
the Kanamori interaction and a hybrid or normal bath, built as ``diag``
builds it for a sector above ``lanc_dim_threshold``:
``EDConfig(norb, bath_type, nbath, uloc, ust, jh, jx, jp, ...)``, the
configuration's bath levels ``bath_e`` (one row, as the hybrid bath holds
them) and hybridizations ``bath_v[orb][k]``,
``sector_table(cfg).get(*sector)`` → ``build_sector_hamiltonian`` →
``make_matvec_op``. One unit of the window is a pass over the whole
pool in the seed's order, so every run times the same solves.

The check holds every window solve's egs and the sampled vectors'
residuals against the configuration's plain reference
(``reference/<config>.py``: its own basis, the mix terms as signed
gathers). The records carry the mix terms' least bytes per matvec
(``roofline_mix.mix_bytes``) for ``mix_roofline.gs``.
"""

from __future__ import annotations

import numpy as np
import torch

from dmft_ed_tpu_torch.bath import Bath
from dmft_ed_tpu_torch.config import EDConfig
from dmft_ed_tpu_torch.diag import _ncv
from dmft_ed_tpu_torch.hamiltonian import (build_sector_hamiltonian,
                                           make_matvec_op)
from dmft_ed_tpu_torch.sectors import sector_table

from benchmark.cells.gs import GsCell, _setting, visit_order
from benchmark.roofline_mix import mix_bytes
from benchmark.trace import Spans


def build(config, traffic, seed, device, reference, variant=None):
    return GsMultiorbCell(config, traffic, seed, device, reference, variant)


class GsMultiorbCell(GsCell):

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 reference, variant=None):
        """As ``GsCell``, on the multi-orbital operator; `variant`
        "float32" puts the program's float32 path with native products in
        its place (the control)."""
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.ref = reference
        dtype = _setting("dtype", traffic, config, "float64")
        precision = _setting("matmul_precision", traffic, config, "native")
        if variant == "float32":
            dtype, precision = "float32", "native"
        self.precision = precision
        c = config
        norb = int(c["norb"])
        cfg = EDConfig(norb=norb, nspin=1, bath_type=c["bath_type"],
                       nbath=c["nbath"], uloc=tuple(c["uloc"]),
                       ust=c["ust"], jh=c["jh"], jx=c["jx"], jp=c["jp"],
                       beta=c["beta"], xmu=c["xmu"], dtype=dtype,
                       matmul_precision=precision).validate()
        self.e = np.asarray(c["bath_e"], dtype=np.float64)
        self.v = np.asarray(c["bath_v"], dtype=np.float64)
        bath = Bath(cfg)
        bath.e[0, :, :] = self.e
        bath.v[0, :, :] = self.v
        nup, ndw = c["sector"]
        sec = sector_table(cfg).get(nup, ndw)
        self.shape = (sec.blocks[0].ddw, sec.blocks[0].dup)
        ham = build_sector_hamiltonian(cfg, sec, bath,
                                       np.zeros((1, 1, norb, norb)))
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
        self._refop = None

    def _reference(self):
        """The reference's operator of the sector, built once, after the
        window."""
        if self._refop is None:
            c = self.config
            self._refop = self.ref.SectorOperator(
                self.e, self.v, c["uloc"], c["ust"], c["jh"], c["jx"],
                c["jp"], *c["sector"], self.device, xmu=c["xmu"])
        return self._refop

    def warm(self) -> None:
        """One thick restart from the pool's first vector: the first
        expansion, a restart and a second expansion (maxiter ncv + 1) run
        every shape the window's solves run, in a fixed number of
        matvecs whatever the seed."""
        full, self.maxiter = self.maxiter, self.ncv + 1
        self._solve(0)
        self.maxiter = full

    def unit(self) -> int:
        """One pass over the whole pool in the seed's order (on the card
        the solves take 353 to 507 matvecs by start vector and a window
        holds about seven, so a window of single solves would time another
        mix of them for each seed); while traced, the pool's first vector
        alone."""
        if self.spans.on:
            return super().unit()
        return sum(GsCell.unit(self) for _ in self.order)

    def records(self) -> dict:
        ref = self._reference()
        return dict(super().records(),
                    mix_bytes=mix_bytes(ref.gathers, ref.dim))

    def check(self, limits: dict, rng):
        """egs of every window solve against the reference's, and the
        residual |H x - egs x| of the sampled vectors under the
        reference's own operator."""
        op = self._reference()
        e0 = op.lowest_eigenvalue(np.random.default_rng(0))
        gaps = [abs(e - e0) for e in self.egs]
        res = {i: op.residual(vec, self.egs[i]) for i, vec in self.kept}
        failed = sum(1 for i, g in enumerate(gaps)
                     if not (g <= limits["egs_gap"]
                             and res.get(i, 0.0) <= limits["residual"]))
        return {"egs_gap": (max(gaps), limits["egs_gap"]),
                "residual": (max(res.values()), limits["residual"])}, failed
