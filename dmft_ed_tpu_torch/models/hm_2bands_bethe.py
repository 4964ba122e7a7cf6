"""Two inequivalent Bethe bands (width ratio + crystal field), PyTorch port
of dmft_ed_tpu/models/hm_2bands_bethe.py.

drivers/ed_hm_2bands_bethe.f90: Wband = [1, Wratio], H0 = [-Delta/2,
+Delta/2], with the driver's two self-consistency modes (SC_METHOD=1
matrix Weiss update, =2 Bethe shortcut Delta_a = (W_a/2)^2 G_a) and two
mixing modes (MIX_METHOD=1 bath, =2 Weiss), all options of the shared
hm_bethe loop (wbethe/dbethe/bethe_sc/mix_g0/wgimp).

Run: ``python -m dmft_ed_tpu_torch.models.hm_2bands_bethe [input]
WRATIO=2.0 DELTA=0.5 SC_METHOD=2 MIX_METHOD=1`` (``DEVICE=cpu`` runs on
the CPU; the default is cuda).
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import EDConfig, read_input
from . import driver_args, split_device
from .hm_bethe import run as _bethe_run, BetheResult  # noqa: F401


def run(cfg: EDConfig | None = None, wratio: float = 1.0,
        delta: float = 0.0, le: int = 500, sc_method: int = 1,
        mix_method: int = 1, wmixing: float = 0.5, wgimp: bool = True,
        phsym: bool = False, log=None, device="cuda") -> BetheResult:
    if cfg is None:
        cfg = EDConfig()
    cfg = cfg.validate()
    if cfg.norb != 2 or cfg.nspin != 1:
        raise ValueError("hm_2bands_bethe needs Norb=2, Nspin=1 "
                         "(ed_hm_2bands_bethe.f90:44)")
    wb = np.array([1.0, wratio])
    db = np.array([-delta / 2.0, delta / 2.0])
    # SC_METHOD=2 uses Gimp in the Bethe shortcut (the driver's zeta
    # expression with Gimp, ed_hm_2bands_bethe.f90:104-110)
    return _bethe_run(cfg, le=le, wbethe=wb, dbethe=db, wmixing=wmixing,
                      bethe_sc=(sc_method == 2), wgimp=wgimp,
                      mix_g0=(mix_method == 2), phsym=phsym, log=log,
                      device=device)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv)
    kw = driver_args(argv, {"WRATIO": ("wratio", float),
                            "DELTA": ("delta", float), "LE": ("le", int),
                            "SC_METHOD": ("sc_method", int),
                            "MIX_METHOD": ("mix_method", int),
                            "WMIXING": ("wmixing", float)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iterations={r.iterations} "
          f"dens={r.dens} docc={r.docc}")
    return r


if __name__ == "__main__":
    main()
