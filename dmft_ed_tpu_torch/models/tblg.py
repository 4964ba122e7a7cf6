"""Twisted bilayer graphene flat-band effective model from Wannier
hoppings (drivers/ed_tBLG_wannier.f90; model of arXiv:1805.06819;
drivers/ed_effective_tBLG.f90 is byte-identical to ed_tBLG_wannier.f90 and
is covered by this same module; the Nvalley=2 x Norb=2 regrouping of
ed_tBLG_wannier_2bands.f90 is `run_2bands` below).

The reference reads ``eff_hopping.dat`` — lines ``m n p q Re Im`` giving the
hopping t_pq(R = m*L1 + n*L2) in eV between the two Wannier flat-band
orbitals (p, q ∈ {1, 2}) of one valley on the moiré superlattice
(ed_tBLG_wannier.f90:98-105) — converts to meV, and builds the 4x4
valley-block Bloch Hamiltonian

    H(k) = diag(h+(k), h-(k)),   h±(k)[p,q] = Σ_R e^{±i k·R} t_pq(R)

(ed_tBLG_wannier.f90:176-222: the two valleys carry opposite phases, so
h-(k) = h+(-k)). DMFT treats the 4 (orbital x valley) Wannier states as
Nlat=4 inequivalent single-orbital impurities with a shared k-sum Gloc
(ed_tBLG_wannier.f90:126-157), exactly the mixed k+site geometry of
`lattice.gloc_hk_lattice`.

PyTorch port of dmft_ed_tpu/models/tblg.py over the port's
lattice_loop.run_sites; the hopping reader, writer and the Bloch builder
are the JAX package's numpy, copied. Run:
``python -m dmft_ed_tpu_torch.models.tblg [input] HOPFILE=eff_hopping.dat
NK=100 WMIXING=0.75 VARIANT=4site|2bands`` (``DEVICE=cpu`` runs on the CPU;
the default is cuda).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from . import driver_args, split_device

#: moiré lattice constant at theta = 1.05 deg (ed_tBLG_wannier.f90:81, nm)
LM = 13.422225299852479

EV_TO_MEV = 1000.0


def moire_vectors(lm: float = LM):
    """Direct (L1, L2) and reciprocal (G1, G2) moiré lattice vectors
    (ed_tBLG_wannier.f90:82-87)."""
    l1 = np.array([np.sqrt(3.0) / 2.0, 0.5]) * lm
    l2 = np.array([0.0, 1.0]) * lm
    det = l2[1] * l1[0] - l1[1] * l2[0]
    g1 = (2.0 * np.pi / det) * np.array([l2[1], -l2[0]])
    g2 = (2.0 * np.pi / det) * np.array([-l1[1], l1[0]])
    return l1, l2, g1, g2


def read_hopping(path: str = "eff_hopping.dat"):
    """Parse the Wannier hopping file: each line ``m n p q Re Im`` (eV).

    Returns (idx [nhop, 4] int, t [nhop] complex in meV) — the eV->meV
    conversion mirrors ed_tBLG_wannier.f90:102.
    """
    raw = np.loadtxt(path, ndmin=2)
    idx = raw[:, :4].astype(int)
    t = EV_TO_MEV * (raw[:, 4] + 1j * raw[:, 5])
    return idx, t


def write_hopping(path, idx, t):
    """Inverse of read_hopping (t in meV -> file in eV)."""
    with open(path, "w") as fh:
        for (m, n, p, q), tt in zip(idx, t):
            fh.write(f"{m} {n} {p} {q} {tt.real / EV_TO_MEV:.16e} "
                     f"{tt.imag / EV_TO_MEV:.16e}\n")


def tblg_hk(idx: np.ndarray, t: np.ndarray, nk: int = 20,
            lm: float = LM) -> np.ndarray:
    """4x4 valley-block H(k) on an nk x nk moiré-BZ grid.

    hk[0:2, 0:2] = h+(k), hk[2:4, 2:4] = h-(k) = h+(-k)
    (ed_tBLG_wannier.f90:176-233). Returns [4, 4, nk^2] (meV units).
    """
    l1, l2, g1, g2 = moire_vectors(lm)
    fr = np.linspace(0.0, 1.0, nk, endpoint=False)
    kpts = np.array([f1 * g1 + f2 * g2 for f1 in fr for f2 in fr])
    rvec = idx[:, 0, None] * l1[None] + idx[:, 1, None] * l2[None]
    phase = np.exp(1j * kpts @ rvec.T)               # [Nk, nhop]
    hk = np.zeros((4, 4, len(kpts)), dtype=complex)
    for p in range(2):
        for q in range(2):
            sel = (idx[:, 2] == p + 1) & (idx[:, 3] == q + 1)
            hplus = phase[:, sel] @ t[sel]
            hminus = phase[:, sel].conj() @ t[sel]
            hk[p, q] = hplus
            hk[2 + p, 2 + q] = hminus
    return hk


def synthetic_hopping(rng=None, nshell: int = 1):
    """A small hermiticity-consistent toy hopping set in the reference file
    format, for tests (stands in for the 1162-constant eff_hopping.dat,
    which is not distributed with the source). Units: meV."""
    rng = np.random.default_rng(rng)
    entries = {}
    # on-site energies + local inter-orbital mixing at R=0
    entries[(0, 0, 1, 1)] = 0.5 + 0j
    entries[(0, 0, 2, 2)] = -0.5 + 0j
    v0 = 0.3 + 0.1j
    entries[(0, 0, 1, 2)] = v0
    entries[(0, 0, 2, 1)] = np.conj(v0)
    shells = [(m, n) for m in range(-nshell, nshell + 1)
              for n in range(-nshell, nshell + 1) if (m, n) != (0, 0)]
    for (m, n) in shells:
        for p in (1, 2):
            for q in (1, 2):
                if (m, n, p, q) in entries:
                    continue
                tt = (rng.standard_normal() + 1j * rng.standard_normal())
                tt *= 0.4
                entries[(m, n, p, q)] = tt
                # hermiticity: t_qp(-R) = conj(t_pq(R))
                entries[(-m, -n, q, p)] = np.conj(tt)
    idx = np.array(sorted(entries), dtype=int)
    t = np.array([entries[tuple(k)] for k in idx])
    return idx, t


@dataclass
class TBLGResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    smats_ineq: np.ndarray
    gmats_ineq: np.ndarray
    dens: np.ndarray
    docc: np.ndarray
    error: float


def run(cfg: EDConfig, idx: np.ndarray, t: np.ndarray, nk: int = 20,
        wmixing: float = 0.75, log=None, device="cuda") -> TBLGResult:
    """The ed_tBLG_wannier.f90 DMFT loop: 4 inequivalent Wannier impurities
    over the moiré H(k) (Norb=1 per site, ed_tBLG_wannier.f90:78,126-157)
    — delegates to the shared inequivalent-site loop
    (lattice_loop.run_sites), which fits every spin component."""
    cfg = cfg.validate()
    if cfg.norb != 1:
        raise ValueError("tBLG driver: Norb=1 (ed_tBLG_wannier.f90:78)")
    from .lattice_loop import run_sites
    hk = tblg_hk(idx, t, nk)
    # spin-degenerate model: expand hk over spin if nspin == 2
    if cfg.nspin == 2:
        nkk = hk.shape[-1]
        hks = np.zeros((8, 8, nkk), dtype=complex)
        hks[0::2, 0::2] = hk
        hks[1::2, 1::2] = hk
        hk = hks
    r_ = run_sites(cfg, hk, wmixing=wmixing, log=log, device=device)
    return TBLGResult(converged=r_.converged, iterations=r_.iterations,
                      baths=r_.baths, smats_ineq=r_.smats_ineq,
                      gmats_ineq=r_.gmats_ineq,
                      dens=r_.dens[:, 0], docc=r_.docc[:, 0],
                      error=r_.error)


def run_2bands(cfg: EDConfig, idx: np.ndarray, t: np.ndarray, nk: int = 20,
               wmixing: float = 0.75, log=None,
               device="cuda") -> TBLGResult:
    """The ed_tBLG_wannier_2bands.f90 variant: the same 4x4 valley-block
    H(k), but regrouped as Nvalley=2 inequivalent impurities each carrying
    the TWO Wannier orbitals (Norb=2, Nspin=1 —
    ed_tBLG_wannier_2bands.f90:59-62,97-112). The orbital off-diagonal
    hybridization h±(k)[1,2] then enters the per-valley matrix Weiss
    update instead of being dropped between single-orbital sites.
    Delegates to lattice_loop.run_sites with nso=2 valley blocks."""
    cfg = cfg.validate()
    if cfg.norb != 2 or cfg.nspin != 1:
        raise ValueError("tBLG 2-bands driver: Norb=2, Nspin=1 "
                         "(ed_tBLG_wannier_2bands.f90:59)")
    from .lattice_loop import run_sites
    hk = tblg_hk(idx, t, nk)                       # [4, 4, Nk], 2 valleys
    r_ = run_sites(cfg, hk, wmixing=wmixing, log=log, device=device)
    return TBLGResult(converged=r_.converged, iterations=r_.iterations,
                      baths=r_.baths, smats_ineq=r_.smats_ineq,
                      gmats_ineq=r_.gmats_ineq,
                      dens=r_.dens, docc=r_.docc, error=r_.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    path = argv[0] if argv and "=" not in argv[0] else "inputGRAPHENE.conf"
    cfg = read_input(path, argv)
    kw = dict(dict(hopfile="eff_hopping.dat", nk=100, wmixing=0.75,
                   variant="4site"), **driver_args(argv, {
        "HOPFILE": ("hopfile", str), "NK": ("nk", int),
        "WMIXING": ("wmixing", float), "VARIANT": ("variant", str.lower)}))
    idx, t = read_hopping(kw["hopfile"])
    fn = run_2bands if kw["variant"] in ("2bands", "2band") else run
    r = fn(cfg, idx, t, nk=kw["nk"], wmixing=kw["wmixing"], device=device)
    print(f"converged={r.converged} iters={r.iterations} dens={r.dens}")
    return r


if __name__ == "__main__":
    main()
