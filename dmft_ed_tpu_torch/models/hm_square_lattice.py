"""Hubbard model on a finite square-lattice flake — inequivalent-site
real-space DMFT (drivers/ed_hm_square_lattice.f90; BASELINE config 5),
PyTorch port of dmft_ed_tpu/models/hm_square_lattice.py.

Thin geometry wrapper over the generic nano driver: builds the
nearest-neighbor flake Hamiltonian + symmetry classes and runs nano.run.

Run: ``python -m dmft_ed_tpu_torch.models.hm_square_lattice [input_file]
[KEY=value ...]`` (``DEVICE=cpu`` runs on the CPU; the default is cuda;
LX, LY and TS set the flake).
"""

from __future__ import annotations

import sys

from ..config import EDConfig, read_input
from . import driver_args, split_device
from .nano import run as nano_run, square_flake_hij, NanoResult  # noqa: F401


def run(cfg: EDConfig, lx: int = 4, ly: int = 4, ts: float = 0.25,
        pbc: bool = False, **kw) -> NanoResult:
    hij, lat2ineq = square_flake_hij(lx, ly, t=ts, pbc=pbc)
    return nano_run(cfg, hij, lat2ineq, **kw)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv)
    kw = driver_args(argv, {"LX": ("lx", int), "LY": ("ly", int),
                            "TS": ("ts", float)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iterations={r.iterations} "
          f"dens={r.dens} ekin={r.ekin:.8f}")
    return r


if __name__ == "__main__":
    main()
