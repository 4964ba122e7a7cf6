"""DOS-driven Hubbard DMFT drivers, PyTorch port of
dmft_ed_tpu/models/hm_dos.py.

Covers drivers/ed_hm_2bands_dos.f90 (two bands, per-orbital half widths
WBAND, crystal-field splitting DELTA, dos_model in {bethe, flat}) and
drivers/ed_hm_square_dos.f90 (single band, analytic 2d-square DOS with
hopping TS), plus a 'file' mode reading two-column (e, rho) DOS files:
the DOS-integral Gloc (lattice.gloc_dos over lattice.dos_bands) inside
the standard hm_bethe loop.

Run: ``python -m dmft_ed_tpu_torch.models.hm_dos [input] DOS_MODEL=flat
WBAND=1.0,2.0 DELTA=0.5 [DOS_FILE=...]`` (``DEVICE=cpu`` runs on the CPU;
the default is cuda).
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import EDConfig, read_input
from ..lattice import dos_bands
from . import split_device
from .hm_bethe import run as _bethe_run, BetheResult  # noqa: F401


def run(cfg: EDConfig | None = None, dos_model: str = "bethe", wband=1.0,
        delta: float = 0.0, le: int = 500, ts: float = 1.0, dos_file=None,
        wmixing: float = 0.5, log=None, device="cuda") -> BetheResult:
    if cfg is None:
        cfg = EDConfig()
    cfg = cfg.validate()
    h0 = np.zeros(cfg.norb)
    if cfg.norb == 2:
        # H0 = [-Delta/2, +Delta/2] (ed_hm_2bands_dos.f90:64-66)
        h0 = np.array([-delta / 2.0, delta / 2.0])
    bands = dos_bands(cfg.norb, dos_model, wband, le, h0, ts, dos_file)
    return _bethe_run(cfg, le=le, wmixing=wmixing, log=log, bands=bands,
                      device=device)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv)
    kw = {}
    for tok in argv:
        if "=" not in tok:
            continue
        k, v = tok.split("=", 1)
        k = k.upper()
        if k == "DOS_MODEL":
            kw["dos_model"] = v.lower()
        elif k == "WBAND":
            vals = [float(x) for x in v.split(",")]
            kw["wband"] = vals[0] if len(vals) == 1 else vals
        elif k == "DELTA":
            kw["delta"] = float(v)
        elif k == "LE":
            kw["le"] = int(v)
        elif k == "TS":
            kw["ts"] = float(v)
        elif k == "DOS_FILE":
            kw["dos_file"] = v.split(",") if "," in v else v
        elif k == "WMIXING":
            kw["wmixing"] = float(v)
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iterations={r.iterations} "
          f"dens={r.dens} docc={r.docc}")
    return r


if __name__ == "__main__":
    main()
