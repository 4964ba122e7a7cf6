"""BHZ stripe with AFM 2-site cells — edge + Néel order
(drivers/ed_bhz_2d_edge_afm.f90).

Geometry: Ly layers periodic along x and open along y, each layer holding
the 2-atom AFM cell (Ncell=2, Nlat=2*Ly). The strip Bloch matrix mirrors
bhz_afm2_edge_model (ed_bhz_2d_edge_afm.f90:394-461): intra-layer blocks

    Hmat = [[M, tx + thx e^{2i kx}], [thx + tx e^{-2i kx}, M]]

and interlayer blocks Tmat coupling A_i->B_{i+1} (thy e^{i kx}) and
B_i->A_{i+1} (thy e^{-i kx}), in the repo gamma convention
(models/bhz_afm.py: G5 = s0 x tz, G1 = sz x tx, G2 = s0 x ty; the
reference's gamma2 = tau0 x (-sigma_y) equals -G2, a ky-gauge flip).

Néel symmetry (neelsym=T, :204-210): only the A site of each layer is an
impurity (Nineq = Ly); the B-site self-energy is the spin flip
Sigma_B(s, s) = Sigma_A(-s, -s). The staggered sb_field seeds alternate
sign by layer parity (:166-178). lysym halves the stripe by the y mirror
(odd Ly, :93-99).

PyTorch port of dmft_ed_tpu/models/bhz_edge_afm.py: the impurities' sweeps
stack in one site-batched solve and the k-sum runs on the device. Run:
``python -m dmft_ed_tpu_torch.models.bhz_edge_afm [input] LY=5 NKX=12
MH=1.0 LAMBDA=0.3 WMIXING=0.5 LYSYM=T NEELSYM=T`` (``DEVICE=cpu`` runs on
the CPU; the default is cuda).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..config import EDConfig, read_input
from ..lattice_solver import LatticeEDSolver
from ..lattice import gloc_hk_lattice, self_consistency, ConvergenceMonitor
from ..aux import so2nn
from . import driver_args, flag, split_device
from .bhz_afm import G1, G2, G5


def bhz_afm_strip_hk(nkx: int = 16, ly: int = 5, mh: float = 1.0,
                     llambda: float = 0.3, e0: float = 1.0) -> np.ndarray:
    """[2*Ly*4, 2*Ly*4, Nkx] AFM-cell BHZ stripe
    (bhz_afm2_edge_model, ed_bhz_2d_edge_afm.f90:394-461)."""
    nso = 4
    n = 2 * nso
    M = mh * G5
    tx = -0.5 * e0 * G5 - 0.5j * llambda * G1
    thx = -0.5 * e0 * G5 + 0.5j * llambda * G1
    thy = -0.5 * e0 * G5 - 0.5j * llambda * G2
    kxs = np.linspace(-np.pi, np.pi, nkx, endpoint=False)
    out = np.zeros((ly * n, ly * n, nkx), dtype=complex)
    for ik, kx in enumerate(kxs):
        Hmat = np.zeros((n, n), dtype=complex)
        Hmat[:nso, :nso] = M
        Hmat[nso:, nso:] = M
        Hmat[:nso, nso:] = tx + thx * np.exp(2j * kx)
        Hmat[nso:, :nso] = thx + tx * np.exp(-2j * kx)
        Tmat = np.zeros((n, n), dtype=complex)
        Tmat[:nso, nso:] = thy * np.exp(1j * kx)
        Tmat[nso:, :nso] = thy * np.exp(-1j * kx)
        H = np.zeros((ly * n, ly * n), dtype=complex)
        for i in range(ly):
            H[i * n:(i + 1) * n, i * n:(i + 1) * n] = Hmat
        for i in range(ly - 1):
            H[i * n:(i + 1) * n, (i + 1) * n:(i + 2) * n] = Tmat
            H[(i + 1) * n:(i + 2) * n, i * n:(i + 1) * n] = \
                Tmat.conj().T
        out[:, :, ik] = H
    return out


def _spin_flip_sigma(s: np.ndarray) -> np.ndarray:
    """Sigma_B(s, s) = Sigma_A(-s, -s) (Néel partner,
    ed_bhz_2d_edge_afm.f90:204-210)."""
    out = s.copy()
    out[0, 0], out[1, 1] = s[1, 1].copy(), s[0, 0].copy()
    return out


@dataclass
class BhzEdgeAfmResult:
    converged: bool
    iterations: int
    baths: np.ndarray
    smats_ineq: np.ndarray
    dens: np.ndarray     # [Nineq, Norb]
    magz: np.ndarray     # [Nineq, Norb]
    error: float


def run(cfg: EDConfig, ly: int = 5, nkx: int = 12, mh: float = 1.0,
        llambda: float = 0.3, wmixing: float = 0.5, lysym: bool = True,
        neelsym: bool = True, log=None,
        device="cuda") -> BhzEdgeAfmResult:
    cfg = cfg.validate()
    if cfg.norb != 2 or cfg.nspin != 2:
        raise ValueError("BHZ edge AFM: Nspin=Norb=2")
    if lysym and ly % 2 == 0:
        raise ValueError("lysym needs odd Ly (ed_bhz_2d_edge_afm.f90:93)")
    _log = log if log is not None else (print if cfg.ed_verbose > 0
                                        else lambda *a, **k: None)
    hk = bhz_afm_strip_hk(nkx, ly, mh, llambda)
    nlat, nso = 2 * ly, 4
    # lattice site (layer i, cell c) index = 2*i + c
    if neelsym:
        # impurities: A site of each layer (B = spin-flip partner)
        lat_of_ineq = [2 * i for i in range(ly)]
    else:
        lat_of_ineq = list(range(nlat))
    if lysym:
        # mirror: layer i == layer Ly-1-i
        def fold(i):
            return min(i, ly - 1 - i)
        if neelsym:
            ineq_sites = [2 * i for i in range((ly - 1) // 2 + 1)]
        else:
            ineq_sites = [2 * fold(i // 2) + i % 2
                          for i in range(2 * ((ly - 1) // 2 + 1))]
            ineq_sites = sorted(set(ineq_sites))
    else:
        ineq_sites = lat_of_ineq
    nineq = len(ineq_sites)
    hloc_lat = hk.mean(axis=-1)
    hloc_ineq = np.stack([
        so2nn(hloc_lat[s * nso:(s + 1) * nso, s * nso:(s + 1) * nso],
              cfg.nspin, cfg.norb).real for s in ineq_sites])

    def sigma_full(smats_ineq):
        """Spread Nineq self-energies to all Nlat sites: y-mirror for
        layers, spin flip for the B sublattice."""
        s_lat = np.zeros((nlat,) + smats_ineq.shape[1:], dtype=complex)
        for il in range(nlat):
            layer, c = il // 2, il % 2
            lsrc = min(layer, ly - 1 - layer) if lysym else layer
            if neelsym:
                src = smats_ineq[lsrc]
                s_lat[il] = src if c == 0 else _spin_flip_sigma(src)
            else:
                s_lat[il] = smats_ineq[ineq_sites.index(2 * lsrc + c)]
        return s_lat

    # Néel seed (sbpattern, ed_bhz_2d_edge_afm.f90:158-169): with neelsym
    # the impurities are all A-sublattice sites — the SAME Néel sublattice
    # (adjacent diagonal layers), so the seed is uniform (+1); the B sites
    # get the opposite moment through the spin-flip spread. Without
    # neelsym the A/B impurities alternate by site parity.
    if neelsym:
        sb_sign = [1.0] * nineq
    else:
        sb_sign = [(-1.0) ** (ineq_sites[i] % 2) for i in range(nineq)]
    lsolver = LatticeEDSolver(cfg, hloc_ineq, log=_log, device=device)
    baths = lsolver.init_solvers(sb_field_sign=sb_sign)
    baths_prev = baths.copy()
    monitor = ConvergenceMonitor(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    converged, iloop = False, 0
    while not converged and iloop < cfg.nloop:
        iloop += 1
        _log(f"--- BHZ-edge-AFM DMFT loop {iloop}/{cfg.nloop} "
             f"({nineq} ineq of {nlat} sites) ---")
        lsolver.solve(baths)
        smats_ineq = lsolver.get_sigma_matsubara()
        s_lat = sigma_full(smats_ineq)
        with lsolver.timers("gloc"):
            gm_lat = gloc_hk_lattice(cfg, hk, s_lat, "mats",
                                     device=lsolver.device)
        gm_ineq = gm_lat[ineq_sites]
        weiss_ineq = np.stack([
            self_consistency(cfg, gm_ineq[i], smats_ineq[i], hloc_ineq[i])
            for i in range(nineq)])
        baths = lsolver.chi2_fitgf(weiss_ineq, baths)
        if iloop > 1:
            baths = wmixing * baths + (1 - wmixing) * baths_prev
        baths_prev = baths.copy()
        converged = monitor.check(weiss_ineq[0, 0, 0, 0, 0], log=_log)
    return BhzEdgeAfmResult(converged=converged, iterations=iloop,
                            baths=baths,
                            smats_ineq=lsolver.get_sigma_matsubara(),
                            dens=lsolver.get_dens(),
                            magz=lsolver.get_mag(),
                            error=monitor.error)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    path = argv[0] if argv and "=" not in argv[0] else "inputED.in"
    cfg = read_input(path, argv)
    kw = driver_args(argv, {
        "LY": ("ly", int), "NKX": ("nkx", int), "NK": ("nkx", int),
        "MH": ("mh", float), "LAMBDA": ("llambda", float),
        "WMIXING": ("wmixing", float), "LYSYM": ("lysym", flag),
        "NEELSYM": ("neelsym", flag)})
    r = run(cfg, device=device, **kw)
    print(f"converged={r.converged} iters={r.iterations} "
          f"dens={r.dens.sum():.6f} mag_edge={r.magz[0]}")
    return r


if __name__ == "__main__":
    main()
