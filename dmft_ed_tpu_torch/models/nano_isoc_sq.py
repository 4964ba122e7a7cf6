"""Square-cluster nano with intrinsic SOC + q-resolved bare susceptibility
and local Chern marker post-processing
(drivers/ed_nano_isoc_sq.f90, ed_nano_isoc_chi0.f90).

The reference drivers are ed_nano_isoc plus two post-DMFT analyses:
- chi0ij: the full inter-site Matsubara GF Gij on an Nx x Nx periodic
  square arrangement -> static bare susceptibility chi0(q) on the cluster
  q grid, per spin channel, optionally with Sigma = 0 (self_zero;
  ed_nano_isoc_sq.f90:95-125 + chi0_lattice.f90:ed_get_chi0ij);
- chern: the interacting local Chern marker from Hij and the converged
  self-energy (ed_nano_isoc_chi0.f90 + chern_marker3_NF.f90:get_local_chern
  -> topology.local_chern_marker).

PyTorch port of dmft_ed_tpu/models/nano_isoc_sq.py: the DMFT loop is the
port's nano.run and Gij inverts on the device (lattice.gij_realspace); the
bubble, chi0(q) and the marker are the JAX package's numpy, copied. Run:
``python -m dmft_ed_tpu_torch.models.nano_isoc_sq [input] NSPIN=2 NX=4
TS=1.0 LAM=0.1 WMIXING=0.5 SELF_ZERO=F CHERN=F`` (``DEVICE=cpu`` runs on
the CPU; the default is cuda).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from ..lattice import gij_realspace, chi0_q_static
from .. import io as edio
from . import driver_args, flag, split_device
from .nano import run as nano_run, NanoResult


def square_torus_isoc_hij(nx: int, t: float = 1.0, lam: float = 0.1):
    """Periodic nx x nx square lattice with intrinsic SOC: NN hopping -t
    (spin diagonal) plus spin-dependent NNN (diagonal-bond) hopping
    i lam nu sigma_z with chirality nu = +1 along (+1,+1) and nu = -1
    along (+1,-1) — the square-lattice analogue of the Kane-Mele term used
    by the hexagon isoc cluster (ed_nano_isoc.f90 class). Site-major
    (site, spin) layout; every site equivalent by translation symmetry.

    Returns (hij [2 nx^2, 2 nx^2] complex, lat2ineq [nx^2] zeros,
    positions [nx^2, 2])."""
    n = nx * nx

    def idx(x, y):
        return (x % nx) + nx * (y % nx)

    H = np.zeros((2 * n, 2 * n), dtype=complex)
    for y in range(nx):
        for x in range(nx):
            i = idx(x, y)
            for (dx, dy) in ((1, 0), (0, 1)):
                j = idx(x + dx, y + dy)
                for s in range(2):
                    H[2 * i + s, 2 * j + s] += -t
                    H[2 * j + s, 2 * i + s] += -t
            for (dx, dy, nu) in ((1, 1, 1.0), (1, -1, -1.0)):
                j = idx(x + dx, y + dy)
                for s, sgn in ((0, 1.0), (1, -1.0)):
                    H[2 * i + s, 2 * j + s] += 1j * lam * nu * sgn
                    H[2 * j + s, 2 * i + s] += -1j * lam * nu * sgn
    positions = np.array([[x, y] for y in range(nx) for x in range(nx)],
                         dtype=float)
    return H, np.zeros(n, dtype=int), positions


def cluster_qgrid(nx: int) -> np.ndarray:
    """The nx x nx commensurate q points 2 pi (m, n)/nx
    (chi0_lattice.f90's TB_build_kgrid over Nvec)."""
    fr = 2 * np.pi * np.arange(nx) / nx
    return np.array([[qx, qy] for qy in fr for qx in fr])


def post_chi0(cfg: EDConfig, hij: np.ndarray, smats_lat: np.ndarray,
              positions: np.ndarray, qpts=None, self_zero: bool = False,
              write: bool = True, device="cuda"):
    """chi0(q) from the inter-site Matsubara GF
    (ed_nano_isoc_sq.f90:95-125): Gij with the converged Sigma (or
    Sigma = 0 when self_zero) -> static bubble -> cluster q grid.
    Returns (chi0 [Nspin, Nq], qpts)."""
    nlat = smats_lat.shape[0]
    ns_, no = cfg.nspin, cfg.norb
    nso = ns_ * no
    if self_zero:
        smats_lat = np.zeros_like(smats_lat)
    if qpts is None:
        qpts = cluster_qgrid(int(round(np.sqrt(nlat))))
    gfull = gij_realspace(cfg, hij, smats_lat, "mats",
                          device=device)                 # [Nlso, Nlso, L]
    L = gfull.shape[-1]
    # [Nlat, Nlat, Nspin, Nspin, Norb, Norb, L] (site-major so blocks)
    g = gfull.reshape(nlat, nso, nlat, nso, L).transpose(0, 2, 1, 3, 4)
    g = g.reshape(nlat, nlat, ns_, no, ns_, no, L).transpose(
        0, 1, 2, 4, 3, 5, 6)
    chi0 = chi0_q_static(cfg, g, positions, qpts)
    if write:
        names = ["chi0_up.ed", "chi0_dw.ed"][:ns_]
        for s, name in enumerate(names):
            edio.splot(name, np.arange(len(qpts)), chi0[s] + 0j)
    return chi0, qpts


def post_chern(cfg: EDConfig, hij: np.ndarray, smats_lat: np.ndarray,
               positions: np.ndarray):
    """Interacting local Chern marker from the topological Hamiltonian
    Hij + Sigma(iw -> 0) (ed_nano_isoc_chi0.f90 + chern_marker3_NF.f90;
    topology.local_chern_marker)."""
    from ..topology import local_chern_marker
    ns_, no = cfg.nspin, cfg.norb
    nso = ns_ * no
    nlat = smats_lat.shape[0]
    # per-site Sigma(iw1) -> 0-frequency estimate [Nlat, nso, nso]
    s0 = smats_lat[..., 0].transpose(0, 1, 3, 2, 4).reshape(nlat, nso, nso)
    return local_chern_marker(hij, positions, nso=nso, sigma0=s0.real)


@dataclass
class NanoIsocSqResult:
    dmft: NanoResult
    chi0: np.ndarray        # [Nspin, Nq]
    qpts: np.ndarray
    chern: np.ndarray | None


def run(cfg: EDConfig, nx: int = 4, t: float = 1.0, lam: float = 0.1,
        wmixing: float = 0.5, self_zero: bool = False, chern: bool = False,
        log=None, device="cuda") -> NanoIsocSqResult:
    cfg = cfg.validate()
    if cfg.nspin != 2 or cfg.norb != 1:
        raise ValueError("nano_isoc_sq: Nspin=2, Norb=1 (isoc cluster)")
    hij, lat2ineq, pos = square_torus_isoc_hij(nx, t, lam)
    r = nano_run(cfg, hij, lat2ineq, wmixing=wmixing, log=log, device=device)
    smats_lat = r.smats_ineq[lat2ineq]
    chi0, qpts = post_chi0(cfg, hij, smats_lat, pos, self_zero=self_zero,
                           device=device)
    cm = post_chern(cfg, hij, smats_lat, pos) if chern else None
    return NanoIsocSqResult(dmft=r, chi0=chi0, qpts=qpts, chern=cm)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    cfg = read_input(path, argv)
    kw = driver_args(argv, {
        "NX": ("nx", int), "TS": ("t", float), "LAM": ("lam", float),
        "WMIXING": ("wmixing", float), "SELF_ZERO": ("self_zero", flag),
        "CHERN": ("chern", flag)})
    r = run(cfg, device=device, **kw)
    s = r.chi0[0]
    print(f"converged={r.dmft.converged} chi0(q) max={s.max():.6f} "
          f"argmax={int(np.argmax(s))}")
    return r


if __name__ == "__main__":
    main()
