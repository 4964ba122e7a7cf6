"""Generic material driver: DMFT over an H(k) file (the ed_STO / ed_LVO /
ed_SIO class, drivers/ed_STO.f90:54-94), PyTorch port of
dmft_ed_tpu/models/material.py.

Those drivers read a Bloch Hamiltonian written by DMFT_Tools'
`write_hk_w90` (ed_STO.f90:284) instead of constructing it analytically,
then run the standard k-sum DMFT loop. Here the same flow is one driver
for any material: `read_hk_w90` ingests the file, `run` dispatches to the
generic k-space loop (normal/nonsu2 per config).

File format (write_hk_w90, DMFT_Tools TB_IO):
    line 1:  Nk  Nd  Np  Nineq        (sizes; Nso = Nd + Np per ineq)
    per k:   kx  ky  kz
             Nso lines of 2*Nso floats (Re Im pairs of one H(k) row)

Run: ``python -m dmft_ed_tpu_torch.models.material [input]
HKFILE=hkfile.in`` (``DEVICE=cpu`` runs on the CPU; the default is cuda).
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import EDConfig, read_input
from . import split_device
from .kspace import run_kspace, KspaceResult  # noqa: F401


def read_hk_w90(path: str):
    """Returns (hk [Nso, Nso, Nk], kpts [Nk, 3], header tuple)."""
    with open(path) as fh:
        toks = fh.readline().split()
        nk, nd, npp, nineq = (int(t) for t in toks[:4])
        nso = (nd + npp) * max(nineq, 1)
        hk = np.zeros((nso, nso, nk), dtype=complex)
        kpts = np.zeros((nk, 3))
        for ik in range(nk):
            kpts[ik] = [float(x) for x in fh.readline().split()[:3]]
            for i in range(nso):
                row = [float(x) for x in fh.readline().split()]
                hk[i, :, ik] = np.array(row[0::2]) + 1j * np.array(row[1::2])
    return hk, kpts, (nk, nd, npp, nineq)


def write_hk_w90(path: str, hk: np.ndarray, kpts: np.ndarray,
                 nd: int | None = None, npp: int = 0, nineq: int = 1):
    """Inverse of read_hk_w90 (write_hk_w90, ed_STO.f90:284)."""
    nso, _, nk = hk.shape
    if nd is None:
        nd = nso // max(nineq, 1) - npp
    with open(path, "w") as fh:
        fh.write(f" {nk:10d}{nd:4d}{npp:4d}{nineq:4d}\n")
        for ik in range(nk):
            fh.write(" ".join(f"{x:18.12f}" for x in kpts[ik]) + "\n")
            for i in range(nso):
                fh.write(" ".join(
                    f"{hk[i, j, ik].real:18.12f} {hk[i, j, ik].imag:18.12f}"
                    for j in range(nso)) + "\n")


def run(cfg: EDConfig, hkfile: str = "hkfile.in", device="cuda",
        **kw) -> KspaceResult:
    """DMFT on the material's H(k) file via the generic k-space loop; `kw`
    goes to kspace.run_kspace."""
    hk, _, _ = read_hk_w90(hkfile)
    nso = cfg.nspin * cfg.norb
    if hk.shape[0] != nso:
        raise ValueError(f"hkfile Nso={hk.shape[0]} != Nspin*Norb={nso}")
    return run_kspace(cfg, hk, device=device, **kw)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    device, argv = split_device(argv)
    cfg = read_input(path, argv)
    hkfile = "hkfile.in"
    for tok in argv:
        k, _, v = tok.partition("=")
        if k.upper() == "HKFILE":
            hkfile = v
    r = run(cfg, hkfile, device=device)
    print(f"converged={r.converged} iterations={r.iterations} dens={r.dens}")
    return r


if __name__ == "__main__":
    main()
