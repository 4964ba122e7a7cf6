"""Multi-band Hubbard-Hund model on the Bethe lattice
(drivers/ed_hm_bethe_Nbands.f90; BASELINE.json config 2: 2-band with Hund
coupling, hybrid-bath chi^2 fit), PyTorch port of
dmft_ed_tpu/models/hm_bethe_nbands.py.

The same DMFT loop as hm_bethe.run: the reference duplicates the driver
per band count, here the band structure is config-driven (norb,
wbethe/dbethe per orbital, bath_type=hybrid for the interorbital bath).

Run: ``python -m dmft_ed_tpu_torch.models.hm_bethe_nbands [input_file]
[KEY=value ...]`` (``DEVICE=cpu`` runs on the CPU; the default is cuda;
WBETHE and DBETHE take one value per orbital, comma-separated), e.g.
``... inputED.in DEVICE=cpu NORB=2 BATH_TYPE=hybrid NBATH=4 JH=0.25``.
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import read_input
from . import split_device
from .hm_bethe import run, BetheResult  # noqa: F401 — same loop, multi-band


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv)
    wb = [1.0] * cfg.norb
    db = [0.0] * cfg.norb
    for tok in argv:
        if tok.upper().startswith("WBETHE="):
            vals = [float(x) for x in tok.split("=")[1].split(",")]
            wb = (vals + wb)[:cfg.norb]
        if tok.upper().startswith("DBETHE="):
            vals = [float(x) for x in tok.split("=")[1].split(",")]
            db = (vals + db)[:cfg.norb]
    r = run(cfg, wbethe=np.asarray(wb), dbethe=np.asarray(db), device=device)
    print(f"converged={r.converged} iterations={r.iterations} "
          f"dens={r.dens} docc={r.docc}")
    return r


if __name__ == "__main__":
    main()
