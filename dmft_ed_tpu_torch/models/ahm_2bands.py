"""Two-band attractive Hubbard on Bethe lattices of bandwidth ratio alpha
(drivers/ed_ahm_2bands_bethe.f90), PyTorch port of
dmft_ed_tpu/models/ahm_2bands.py.

W_1 = 1, W_2 = alpha (ed_ahm_2bands_bethe.f90:60-67); the superc DMFT
loop (Nambu Gloc over the two DOS, joint (G, F) bath fit, optional
ph/normal bath symmetrization) is models.ahm_bethe's, which takes
per-orbital bandwidths.

Run: ``python -m dmft_ed_tpu_torch.models.ahm_2bands [input] NORB=2
ULOC=-2.0,-2.0 ALPHA=0.5`` (``DEVICE=cpu`` runs on the CPU; the default
is cuda; PHSYM and NORMAL take T/F).
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import EDConfig, read_input
from . import ahm_bethe, driver_args, flag, split_device


def run(cfg: EDConfig | None = None, alpha: float = 1.0, le: int = 500,
        wmixing: float = 1.0, phsym: bool = False, normal_bath: bool = False,
        log=None, device="cuda") -> ahm_bethe.AhmResult:
    if cfg is None:
        cfg = EDConfig(norb=2, ed_mode="superc", uloc=(-2.0, -2.0))
    cfg = cfg.validate()
    if cfg.norb != 2 or cfg.nspin != 1:
        raise ValueError("ed_ahm_2bands requires Norb=2, Nspin=1 "
                         "(ed_ahm_2bands_bethe.f90:44)")
    return ahm_bethe.run(cfg, le=le, wbethe=np.array([1.0, alpha]),
                         wmixing=wmixing, phsym=phsym,
                         normal_bath=normal_bath, log=log, device=device)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv, ed_mode="superc")
    kw = driver_args(argv, {"ALPHA": ("alpha", float), "LE": ("le", int),
                            "WMIXING": ("wmixing", float),
                            "PHSYM": ("phsym", flag),
                            "NORMAL": ("normal_bath", flag)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iters={r.iterations} dens={r.dens} "
          f"docc={r.docc} phi={r.phisc}")
    return r


if __name__ == "__main__":
    main()
