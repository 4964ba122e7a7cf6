"""3D BHZ model (strong topological insulator) DMFT
(drivers/ed_bhz_3d.f90), PyTorch port of dmft_ed_tpu/models/bhz_3d.py.

Same 4 spin-orbitals as the 2D BHZ, with a kz dispersion in the mass term
and a spin-mixing λ·sin(kz)·τx inter-block coupling
(ed_bhz_3d.f90 hk_bhz): the impurity Hloc stays spin-diagonal (the kz term
k-averages to zero) so the solver runs in ed_mode=normal, while the
lattice Gloc inverts the full spin-mixed 4x4 Bloch matrix. Reuses the
bhz_2d DMFT loop with this Bloch builder.

Run: ``python -m dmft_ed_tpu_torch.models.bhz_3d [input_file] [KEY=value
...]`` (``DEVICE=cpu`` runs on the CPU; NK, MH, LAMBDA, EZ set the
model).
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import EDConfig, read_input
from . import driver_args, split_device
from .bhz_2d import run as bhz_run, BhzResult  # noqa: F401


def hk_bhz_3d(kx, ky, kz, mh=1.0, llambda=0.3, ez=1.0):
    """[4, 4] 3D BHZ Bloch Hamiltonian, basis (orb1↑, orb2↑, orb1↓, orb2↓):
    spin blocks h(±k) of the 2D model with mass mh - cos kx - cos ky -
    ez·cos kz, coupled by λ sin(kz) τx (ed_bhz_3d.f90 hk_bhz)."""
    m = mh - np.cos(kx) - np.cos(ky) - ez * np.cos(kz)
    tx = np.array([[0, 1], [1, 0]], dtype=complex)
    ty = np.array([[0, -1j], [1j, 0]], dtype=complex)
    tz = np.array([[1, 0], [0, -1]], dtype=complex)
    hup = m * tz + llambda * np.sin(kx) * tx + llambda * np.sin(ky) * ty
    hdw = np.conj(m * tz + llambda * np.sin(-kx) * tx
                  + llambda * np.sin(-ky) * ty)
    hk = np.zeros((4, 4), dtype=complex)
    hk[:2, :2] = hup
    hk[2:, 2:] = hdw
    hk[:2, 2:] = llambda * np.sin(kz) * tx
    hk[2:, :2] = llambda * np.sin(kz) * tx
    return hk


def build_hk_grid_3d(nk=8, mh=1.0, llambda=0.3, ez=1.0):
    """Hk [4, 4, Nk^3] on the uniform 3D BZ grid + local Hamiltonian."""
    ks = np.linspace(-np.pi, np.pi, nk, endpoint=False)
    hks = np.stack([hk_bhz_3d(kx, ky, kz, mh, llambda, ez)
                    for kx in ks for ky in ks for kz in ks], axis=-1)
    hloc_so = hks.mean(axis=-1)
    hloc_so[np.abs(hloc_so) < 1e-10] = 0.0
    return hks, hloc_so


def run(cfg: EDConfig | None = None, nk: int = 8, mh: float = 1.0,
        llambda: float = 0.3, ez: float = 1.0, wmixing: float = 0.5,
        spinsym: bool = True, log=None, device="cuda") -> BhzResult:
    hk_hloc = build_hk_grid_3d(nk, mh, llambda, ez)
    return bhz_run(cfg, wmixing=wmixing, spinsym=spinsym, log=log,
                   hk_hloc=hk_hloc, device=device)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv, norb=2, nspin=2)
    kw = driver_args(argv, {"NK": ("nk", int), "MH": ("mh", float),
                            "LAMBDA": ("llambda", float),
                            "EZ": ("ez", float)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iterations={r.iterations} dens={r.dens}")
    return r


if __name__ == "__main__":
    main()
