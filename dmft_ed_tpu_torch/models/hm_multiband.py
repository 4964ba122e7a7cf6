"""Degenerate multiband Hubbard models on square / cubic Bloch grids,
PyTorch port of dmft_ed_tpu/models/hm_multiband.py.

Named drivers over the generic k-space loop (kspace.run_kspace):
- 2b_square: two degenerate square-lattice bands
  (drivers/ed_hm_2b_square.f90:128-147, k-sum Gloc + matrix Weiss).
- 3b_square: three square-lattice bands, the third (dxy) raised by
  0.5*ts (drivers/ed_hm_3b_square.f90:133-152).
- 2b_cubic: two degenerate simple-cubic bands
  (drivers/ed_hm_2b_cubic.f90, the same loop in 3d).

Run: ``python -m dmft_ed_tpu_torch.models.hm_multiband [input]
MODEL=3b_square NORB=3 NK=16 TS=0.5`` (``DEVICE=cpu`` runs on the CPU;
the default is cuda).
"""

from __future__ import annotations

import sys

from ..config import EDConfig, read_input
from . import driver_args, split_device
from .kspace import (run_kspace, KspaceResult,  # noqa: F401
                     hk_multiband_square, hk_multiband_cubic)

_MODELS = {"2b_square": (hk_multiband_square, 2, None),
           "3b_square": (hk_multiband_square, 3, "dxy"),
           "2b_cubic": (hk_multiband_cubic, 2, None)}


def run(cfg: EDConfig | None = None, model: str = "2b_square",
        nk: int = 20, ts: float = 0.5, wmixing: float = 0.5,
        log=None, device="cuda") -> KspaceResult:
    if cfg is None:
        cfg = EDConfig()
    cfg = cfg.validate()
    builder, norb, flavor = _MODELS[model]
    if cfg.norb != norb:
        raise ValueError(f"{model} needs Norb={norb} "
                         "(reference driver guard)")
    shifts = None
    if flavor == "dxy":
        shifts = [0.0, 0.0, 0.5 * ts]      # ed_hm_3b_square.f90:146-150
    hk = builder(nk=nk, ts=ts, norb=norb, shifts=shifts)
    return run_kspace(cfg, hk, wmixing=wmixing, log=log, device=device)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv)
    kw = driver_args(argv, {"MODEL": ("model", str.lower),
                            "NK": ("nk", int), "TS": ("ts", float),
                            "WMIXING": ("wmixing", float)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iterations={r.iterations} "
          f"dens={r.dens} docc={r.docc}")
    return r


if __name__ == "__main__":
    main()
