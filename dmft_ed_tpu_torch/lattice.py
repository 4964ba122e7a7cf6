"""Lattice layer of the DMFT loops — subset of dmft_ed_tpu/lattice.py:
the semicircular, flat, 2d-square and tabulated DOS (dos_bands), the
DOS-integral local Green's function, the k-sum local Green's function
(normal and Nambu), the Weiss/Δ self-consistency, the kinetic energy
(each DOS form also in its superc Nambu form), the real-space and
site-resolved functions of the inequivalent-site drivers (gloc_realspace,
its full, superc and k-resolved forms, the k-resolved Nambu form
gloc_hk_lattice_superc, transport, the effective exchange,
kinetic_energy_realspace, the static bare susceptibility chi0_ij_static /
chi0_q_static) and the convergence monitor (DMFT_Tools'
dmft_gloc_matsubara/realaxis, dmft_self_consistency, dmft_kinetic_energy,
check_convergence).

The O(Lmats x Le) DOS-integral work, the kinetic energies and the chi0
bubbles run on the host in numpy, as the reference keeps them on its host
backend; the k-sums and the real-space inversions, batched complex128
matrix inverses over chunks of frequencies (x k-points), run on the
device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import EDConfig
from . import grids


def bethe_dos(e: np.ndarray, w: float) -> np.ndarray:
    """Semicircular DOS of half-bandwidth w (SciFortran dens_bethe)."""
    x = np.clip(e / w, -1.0, 1.0)
    return 2.0 / (np.pi * w) * np.sqrt(np.maximum(0.0, 1.0 - x * x))


def bethe_bands(norb: int, wband, le: int = 500, h0=None):
    """(Ebands [Nso, Le], Dbands [Nso, Le], H0 [Nso]) as in
    drivers/ed_hm_bethe.f90:64-77 — Dbands includes the trapezoid measure."""
    wband = np.broadcast_to(np.asarray(wband, dtype=float), (norb,))
    h0 = np.zeros(norb) if h0 is None else np.asarray(h0, dtype=float)
    eb = np.zeros((norb, le))
    db = np.zeros((norb, le))
    for a in range(norb):
        e = np.linspace(-wband[a], wband[a], le)
        de = e[1] - e[0]
        eb[a] = e
        db[a] = bethe_dos(e, wband[a]) * de
    return eb, db, h0


def flat_dos(e, w: float) -> np.ndarray:
    """Box DOS 1/(2W) on [-W, W] (SciFor dens_flat;
    drivers/ed_hm_2bands_dos.f90:57-59 'flat')."""
    e = np.asarray(e, dtype=float)
    return np.where(np.abs(e) <= w, 1.0 / (2.0 * w), 0.0)


def square2d_dos(e, ts: float = 1.0) -> np.ndarray:
    """2d square-lattice DOS rho(e) = K(1-(e/4t)^2) / (2 pi^2 t), |e|<4t
    (SciFor dens_2dsquare; drivers/ed_hm_square_dos.f90:40-45). The log
    singularity at e=0 is integrable; the trapezoid grid never samples it
    exactly for even Le."""
    from scipy.special import ellipk
    e = np.asarray(e, dtype=float)
    m = 1.0 - (e / (4.0 * ts)) ** 2
    out = np.zeros_like(e)
    inside = m > 0
    # clip m<1 so an exact e=0 grid point stays finite (K(m) ~ ln(16/(1-m))
    # there; the singularity is integrable)
    out[inside] = ellipk(np.minimum(m[inside], 1.0 - 1e-15)) \
        / (2.0 * np.pi ** 2 * ts)
    return out


def dos_bands(norb: int, dos_model: str = "bethe", wband=1.0, le: int = 500,
              h0=None, ts: float = 1.0, dos_file=None):
    """(Ebands, Dbands, H0) for the DOS-integral Gloc drivers.

    dos_model: 'bethe' | 'flat' | '2dsquare' | 'file'
    (drivers/ed_hm_2bands_dos.f90:52-62, ed_hm_square_dos.f90:38-45).
    'file': dos_file is one path or a list of per-orbital paths to
    two-column (e, rho(e)) text files; weights get the trapezoid measure."""
    wband = np.broadcast_to(np.asarray(wband, dtype=float), (norb,))
    h0 = np.zeros(norb) if h0 is None else np.asarray(h0, dtype=float)
    if dos_model == "bethe":
        eb, db, _ = bethe_bands(norb, wband, le)
        return eb, db, h0
    if dos_model == "file":
        files = [dos_file] * norb if isinstance(dos_file, (str, bytes)) \
            else list(dos_file)
        if len(files) != norb:
            raise ValueError(f"dos_bands: {len(files)} DOS files for "
                             f"{norb} orbitals")
        data = [np.loadtxt(f) for f in files]
        le = min(d.shape[0] for d in data)
        eb = np.stack([d[:le, 0] for d in data])
        db = np.stack([d[:le, 1] for d in data])
        return eb, db * _trapz_weights(eb), h0
    eb = np.zeros((norb, le))
    db = np.zeros((norb, le))
    for a in range(norb):
        if dos_model == "2dsquare":
            w = 4.0 * ts
            e = np.linspace(-w, w, le)
            rho = square2d_dos(e, ts)
        elif dos_model == "flat":
            e = np.linspace(-wband[a], wband[a], le)
            rho = flat_dos(e, wband[a])
        else:
            raise ValueError(f"dos_bands: unknown dos_model {dos_model!r}")
        eb[a] = e
        db[a] = rho * _trapz_weights(e[None, :])[0]
    return eb, db, h0


def _trapz_weights(e: np.ndarray) -> np.ndarray:
    """Trapezoid quadrature weights along the last axis: Σ w_i f(e_i) ==
    trapz(f, e) — half-weight endpoints (a plain rectangle rule or
    np.gradient double-weights DOS values at the band edges, biasing the
    sum rule for DOS shapes that do not vanish there, e.g. 'flat')."""
    w = np.empty_like(e)
    w[..., 1:-1] = 0.5 * (e[..., 2:] - e[..., :-2])
    w[..., 0] = 0.5 * (e[..., 1] - e[..., 0])
    w[..., -1] = 0.5 * (e[..., -1] - e[..., -2])
    return w


def gloc_dos(cfg: EDConfig, ebands, dbands, h0, sigma, axis="mats"):
    """Gloc_a(z) = Σ_e D_a(e) / (z + mu - H0_a - e - Σ_aa(z)) — the
    orbital-diagonal DOS-integral form used by the Bethe drivers
    (dmft_gloc_matsubara w/ Ebands,Dbands)."""
    z = grids.z_mats(cfg) if axis == "mats" else grids.z_real(cfg)
    ns_, no = cfg.nspin, cfg.norb
    G = np.zeros((ns_, ns_, no, no, z.shape[0]), dtype=complex)
    for s in range(ns_):
        for a in range(no):
            zeta = z + cfg.xmu - h0[a] - np.asarray(sigma[s, s, a, a])
            G[s, s, a, a] = np.sum(np.asarray(dbands[a])[None, :]
                                   / (zeta[:, None]
                                      - np.asarray(ebands[a])[None, :]),
                                   axis=1)
    return G


def gloc_hk(cfg: EDConfig, hk, sigma, axis="mats", chunk=256,
            device="cuda"):
    """Gloc(z) = (1/Nk) Σ_k [(z+mu) - H(k) - Σ(z)]^{-1} over a k-grid.

    hk: [Nso, Nso, Nk] complex. One batched inversion over [chunk, Nk, Nso,
    Nso] per chunk of frequencies on `device` (torch.linalg.inv; the
    reference leaves it to XLA, outside any Pallas kernel)."""
    z = grids.z_mats(cfg) if axis == "mats" else grids.z_real(cfg)
    ns_, no = cfg.nspin, cfg.norb
    nso = ns_ * no
    L = len(z)
    hkT = torch.as_tensor(np.asarray(hk, dtype=complex),
                          device=device).permute(2, 0, 1)   # [Nk, nso, nso]
    sig = torch.as_tensor(np.asarray(sigma, dtype=complex), device=device
                          ).permute(4, 0, 2, 1, 3).reshape(L, nso, nso)
    zt = torch.as_tensor(z, device=device)
    eye = torch.eye(nso, dtype=torch.complex128, device=device)
    out = []
    for i in range(0, L, chunk):
        zeta = (zt[i:i + chunk] + cfg.xmu)[:, None, None] * eye \
            - sig[i:i + chunk]
        M = zeta[:, None, :, :] - hkT[None, :, :, :]    # [Lc, Nk, nso, nso]
        out.append(torch.mean(torch.linalg.inv(M), dim=1))
    g = torch.cat(out).cpu().numpy()
    return g.reshape(L, ns_, no, ns_, no).transpose(1, 3, 2, 4, 0)


def gloc_superc_dos(cfg: EDConfig, ebands, dbands, h0, sigma, sigma_an,
                    axis="mats"):
    """Nambu local GF from the DOS integral (dmft_gloc_matsubara superc;
    H_nambu = [[ξ+Σ, Σᴬ], [Σᴬ, -ξ-Σ]] as in ed_ahm_disorder.f90:253-256):
        det = (z+mu-e-Σ)(z-mu+e+Σ̄) - Σᴬ²
        G   = ∫ D(e) (z-mu+e+Σ̄)/det ,  F = +∫ D(e) Σᴬ/det
    where Σ̄(z) = conj(Σ(z)) on the imaginary axis and +conj(Σ(-w+iη)) on
    the real axis (ED_WRAP_GLOC.f90:335 adds +conjg(Sreal(L-i+1)); a static
    real Σ=s must shift the hole block by +s). Returns (G, F)."""
    z = grids.z_mats(cfg) if axis == "mats" else grids.z_real(cfg)
    ns_, no = cfg.nspin, cfg.norb
    G = np.zeros((ns_, ns_, no, no, z.shape[0]), dtype=complex)
    F = np.zeros_like(G)
    for s in range(ns_):
        for a in range(no):
            sig = sigma[s, s, a, a]
            sa = sigma_an[s, s, a, a]
            if axis == "mats":
                sig_bar = np.conj(sig)
            else:
                sig_bar = np.conj(sig[::-1])
            e = ebands[a][None, :]
            d = dbands[a][None, :]
            z1 = (z + cfg.xmu - h0[a] - sig)[:, None] - e
            z2 = (z - cfg.xmu + h0[a] + sig_bar)[:, None] + e
            det = z1 * z2 - (sa ** 2)[:, None]
            G[s, s, a, a] = np.sum(d * z2 / det, axis=1)
            F[s, s, a, a] = np.sum(d * sa[:, None] / det, axis=1)
    return G, F


def gloc_hk_superc(cfg: EDConfig, hk, sigma, sigma_an, axis: str = "mats",
                   chunk: int = 128, device="cuda"):
    """Nambu local GF from a k-sum (dmft_gloc_matsubara superc over Hk;
    the ed_ahm_square geometry): per (z, k) invert

        M = [[(z+mu)I - H(k) - Σ(z),   -Σᴬ(z)            ],
             [-Σᴬ(z),   (z-mu)I + H(k) + Σ̄(z)]]

    with Σ̄(z) = conj(Σ) on the imaginary axis and +conj(Σ(-w+iη)) on the
    real one. The hole block carries +H(k), not conj(H(k)), as the
    reference's zeta(2,2)+Hk (ED_WRAP_GLOC.f90) and the JAX package
    (dmft_ed_tpu/lattice.py:214-217) do. One batched complex
    torch.linalg.inv over [chunk, Nk, 2Nso, 2Nso] per chunk of
    frequencies on `device`, as gloc_hk.
    hk: [Nso, Nso, Nk]; sigma/sigma_an: [Nspin, Nspin, Norb, Norb, L].
    Returns (G, F) in the same layout."""
    z = grids.z_mats(cfg) if axis == "mats" else grids.z_real(cfg)
    ns_, no = cfg.nspin, cfg.norb
    nso = ns_ * no
    L = len(z)
    sig = np.asarray(sigma, dtype=complex).transpose(4, 0, 2, 1, 3).reshape(
        L, nso, nso)
    san = np.asarray(sigma_an, dtype=complex).transpose(
        4, 0, 2, 1, 3).reshape(L, nso, nso)
    sig_bar = np.conj(sig) if axis == "mats" else np.conj(sig[::-1])
    from .device import resolve
    device = resolve(device)

    def dev(a):
        return torch.as_tensor(a, device=device)
    hkT = dev(np.asarray(hk, dtype=complex)).permute(2, 0, 1)  # [Nk, nso, nso]
    sig, sig_bar, san, zt = dev(sig), dev(sig_bar), dev(san), dev(z)
    eye = torch.eye(nso, dtype=torch.complex128, device=device)
    g, f = [], []
    for i in range(0, L, chunk):
        zc = zt[i:i + chunk][:, None, None, None]
        blk11 = (zc + cfg.xmu) * eye - hkT[None] - sig[i:i + chunk, None]
        blk22 = (zc - cfg.xmu) * eye + hkT[None] + sig_bar[i:i + chunk, None]
        blk12 = (-san[i:i + chunk, None]).expand_as(blk11)
        M = torch.cat([torch.cat([blk11, blk12], dim=-1),
                       torch.cat([blk12, blk22], dim=-1)], dim=-2)
        Gi = torch.mean(torch.linalg.inv(M), dim=1)          # k-sum
        g.append(Gi[:, :nso, :nso])
        f.append(Gi[:, :nso, nso:])

    def layout(parts):
        return torch.cat(parts).cpu().numpy().reshape(
            L, ns_, no, ns_, no).transpose(1, 3, 2, 4, 0)
    return layout(g), layout(f)


def self_consistency_superc(cfg: EDConfig, gloc, floc, sigma, sigma_an,
                            hloc, sctype: Optional[str] = None):
    """Nambu Weiss/Delta update (dmft_self_consistency superc form used by
    drivers/ed_ahm_bethe.f90:92-96). Returns (weiss_normal, weiss_anomalous)
    — for sctype='delta' these are (Δ, FΔ)."""
    sctype = sctype or cfg.cg_scheme
    z = grids.z_mats(cfg)
    ns_, no = cfg.nspin, cfg.norb
    Wn = np.zeros_like(gloc)
    Wa = np.zeros_like(floc)
    for s in range(ns_):
        for a in range(no):
            g, f = gloc[s, s, a, a], floc[s, s, a, a]
            sig, sa = sigma[s, s, a, a], sigma_an[s, s, a, a]
            # invert the local Nambu matrix [[g, f], [f, -g*]]
            det = -np.abs(g) ** 2 - f ** 2
            gi11 = -np.conj(g) / det
            gi12 = -f / det
            # calG0^{-1} = Gloc^{-1} + Sigma
            c11 = gi11 + sig
            c12 = gi12 + sa
            c22 = -np.conj(c11)
            if sctype == "weiss":
                det0 = c11 * c22 - c12 ** 2
                Wn[s, s, a, a] = c22 / det0
                Wa[s, s, a, a] = -c12 / det0
            else:
                Wn[s, s, a, a] = (z + cfg.xmu - hloc[s, s, a, a] - c11)
                Wa[s, s, a, a] = -c12
    return Wn, Wa


def self_consistency(cfg: EDConfig, gloc, sigma, hloc, sctype: Optional[str]
                     = None, wbands=None,
                     diag_only: Optional[bool] = None) -> np.ndarray:
    """New Weiss field (sctype='weiss') or hybridization (sctype='delta').

    weiss: G0^{-1} = Gloc^{-1} + Σ
    delta: Δ = (z+mu) - Hloc - Σ - Gloc^{-1}
    Bethe shortcut (wbands given): Δ_a = (W_a/2)^2 * Gloc_aa
    (drivers/ed_hm_bethe.f90:118-122; DMFT_Tools dmft_self_consistency).

    diag_only: force the orbital-diagonal update. REQUIRED whenever Gloc came
    from the orbital-diagonal DOS integral (gloc_dos): that Gloc discards
    Σ_offdiag, so a full-matrix Weiss update here would re-inject the
    impurity's off-diagonal Σ with nothing on the lattice side to balance
    it — producing a spurious O(Σ_offdiag) off-diagonal Weiss that the bath
    fit then chases (observed: hybrid-bath 2-band Bethe collapsing to an
    orbitally polarized state). Default None keeps the structural choice
    keyed on bath_type (matrix for hybrid/replica, as appropriate for
    k-sum Gloc which retains the full Σ matrix)."""
    sctype = sctype or cfg.cg_scheme
    z = grids.z_mats(cfg)
    ns_, no = cfg.nspin, cfg.norb
    L = gloc.shape[-1]
    out = np.zeros_like(gloc)
    if wbands is not None:
        wb = np.broadcast_to(np.asarray(wbands, dtype=float), (no,))
        for s in range(ns_):
            for a in range(no):
                d = (wb[a] / 2) ** 2 * gloc[s, s, a, a]
                if sctype == "delta":
                    out[s, s, a, a] = d
                else:
                    out[s, s, a, a] = 1.0 / (np.asarray(z) + cfg.xmu
                                             - hloc[s, s, a, a] - d)
        return out
    if cfg.ed_mode == "nonsu2" and not diag_only:
        # full (Nspin*Norb) matrix update including spin off-diagonals
        nso = ns_ * no
        g = gloc.transpose(4, 0, 2, 1, 3).reshape(L, nso, nso)
        sg = sigma.transpose(4, 0, 2, 1, 3).reshape(L, nso, nso)
        hl = hloc.transpose(0, 2, 1, 3).reshape(nso, nso)
        gi = np.linalg.inv(g)
        if sctype == "weiss":
            w = np.linalg.inv(gi + sg)
        else:
            zeta = (np.asarray(z) + cfg.xmu)[:, None, None] * np.eye(nso)[None]
            w = zeta - hl[None] - sg - gi
        return w.reshape(L, ns_, no, ns_, no).transpose(1, 3, 2, 4, 0)
    if diag_only is None:
        diag_only = cfg.bath_type == "normal"
    for s in range(ns_):
        if diag_only:
            for a in range(no):
                gi = 1.0 / gloc[s, s, a, a]
                if sctype == "weiss":
                    out[s, s, a, a] = 1.0 / (gi + sigma[s, s, a, a])
                else:
                    out[s, s, a, a] = (np.asarray(z) + cfg.xmu
                                       - hloc[s, s, a, a]
                                       - sigma[s, s, a, a] - gi)
        else:
            gi = np.linalg.inv(gloc[s, s].transpose(2, 0, 1))
            if sctype == "weiss":
                m = gi + sigma[s, s].transpose(2, 0, 1)
                out[s, s] = np.linalg.inv(m).transpose(1, 2, 0)
            else:
                zeta = (np.asarray(z) + cfg.xmu)[:, None, None] \
                    * np.eye(no)[None]
                d = zeta - hloc[s, s][None] \
                    - sigma[s, s].transpose(2, 0, 1) - gi
                out[s, s] = d.transpose(1, 2, 0)
    return out


# ----------------------------------------------------------------------


def kinetic_energy(cfg: EDConfig, ebands, dbands, h0, sigma) -> float:
    """E_kin = (2/beta)·2·Σ_{n>0} Σ_e D(e)(e+H0)·Re[...] with the standard
    Matsubara tail corrections (cf. the get_energy reference implementation,
    drivers/ed_hm_bethe.f90 appendix)."""
    wm = grids.matsubara_fermionic(cfg)
    beta = cfg.beta
    ns_, no = cfg.nspin, cfg.norb
    spin_fac = 2.0 if ns_ == 1 else 1.0
    etot = 0.0
    for s in range(ns_):
        for a in range(no):
            sig = np.asarray(sigma[s, s, a, a])
            sig_hf = sig[-1].real
            ek = np.asarray(ebands[a]) + h0[a]
            wk = np.asarray(dbands[a])
            Ak = ek
            Bk = -ek - sig_hf
            zw = 1j * wm + cfg.xmu
            Gk = 1.0 / (zw[:, None] - ek[None, :] - sig[:, None])
            Tk = 1.0 / (1j * wm)[:, None] - Bk[None, :] / (1j * wm[:, None]) ** 2
            Ck = Ak[None, :] * (Gk - Tk)
            h = np.sum((Ck * wk[None, :]).real) * 4.0 / beta
            tail0 = 2 * np.sum(0.5 * Ak * wk)
            tail1 = 2 * np.sum(0.25 * Ak * Bk * wk) * beta
            etot += (h + tail0 + tail1) * spin_fac / 2.0
    return float(etot)


def kinetic_energy_superc(cfg: EDConfig, ebands, dbands, h0, sigma,
                          sigma_an) -> float:
    """Nambu kinetic energy (dmft_kinetic_energy(Ebands,Dbands,H0,S,SA)):
    same Matsubara sum + tails as the normal case but with the Nambu
    G_11(e, iw) = (iw - mu + e + Σ̄)/det."""
    wm = grids.matsubara_fermionic(cfg)
    beta = cfg.beta
    ns_, no = cfg.nspin, cfg.norb
    spin_fac = 2.0 if ns_ == 1 else 1.0
    etot = 0.0
    z = 1j * wm
    for s in range(ns_):
        for a in range(no):
            sig = np.asarray(sigma[s, s, a, a])
            sa = np.asarray(sigma_an[s, s, a, a])
            sig_hf = sig[-1].real
            ek = np.asarray(ebands[a]) + h0[a]
            wk = np.asarray(dbands[a])
            Ak = ek
            Bk = -ek - sig_hf
            z1 = (z + cfg.xmu - sig)[:, None] - ek[None, :]
            z2 = (z - cfg.xmu + np.conj(sig))[:, None] + ek[None, :]
            det = z1 * z2 - (sa ** 2)[:, None]
            Gk = z2 / det
            Tk = 1.0 / z[:, None] - Bk[None, :] / z[:, None] ** 2
            Ck = Ak[None, :] * (Gk - Tk)
            h = np.sum((Ck * wk[None, :]).real) * 4.0 / beta
            tail0 = 2 * np.sum(0.5 * Ak * wk)
            tail1 = 2 * np.sum(0.25 * Ak * Bk * wk) * beta
            etot += (h + tail0 + tail1) * spin_fac / 2.0
    return float(etot)


# ----------------------------------------------------------------------
# real-space (inequivalent-site) local GF — the ed_nano-class layer
# ----------------------------------------------------------------------

def _z(cfg: EDConfig, axis: str) -> np.ndarray:
    return grids.z_mats(cfg) if axis == "mats" else grids.z_real(cfg)


def _sig_so(cfg: EDConfig, sigma_lat) -> np.ndarray:
    """[Nlat, Nspin, Nspin, Norb, Norb, L] -> [Nlat, Nso, Nso, L]
    (io = a + s*Norb within a site)."""
    nso = cfg.nspin * cfg.norb
    sig = np.asarray(sigma_lat, dtype=complex)
    return sig.transpose(0, 1, 3, 2, 4, 5).reshape(sig.shape[0], nso, nso,
                                                   sig.shape[-1])


def _embed(sc, nlat: int, nso: int):
    """[Lc, Nlat, Nso, Nso] -> site-block-diagonal [Lc, Nlso, Nlso]."""
    Lc = sc.shape[0]
    S = torch.zeros((Lc, nlat * nso, nlat * nso), dtype=torch.complex128,
                    device=sc.device)
    for i in range(nlat):
        S[:, i * nso:(i + 1) * nso, i * nso:(i + 1) * nso] = sc[:, i]
    return S


def _site_blocks(G, cfg: EDConfig, nlat: int) -> np.ndarray:
    """Site-diagonal blocks of [Lc, Nlso, Nlso] (site-major) as
    [Nlat, Nspin, Nspin, Norb, Norb, Lc] on the host."""
    ns_, no = cfg.nspin, cfg.norb
    nso = ns_ * no
    Lc = G.shape[0]
    d = torch.diagonal(G.reshape(Lc, nlat, nso, nlat, nso), dim1=1, dim2=3)
    d = d.cpu().numpy()                            # [Lc, nso, nso, nlat]
    return d.reshape(Lc, ns_, no, ns_, no, nlat).transpose(5, 1, 3, 2, 4, 0)


def gloc_realspace(cfg: EDConfig, hij: np.ndarray, sigma_lat: np.ndarray,
                   axis: str = "mats", chunk: int = 64,
                   device="cuda") -> np.ndarray:
    """Site-resolved local GF of a finite real-space Hamiltonian:

        G(z) = [(z+mu) I - Hij - Σ(z)]^{-1},  Σ block-diagonal per site

    hij: [Nlso, Nlso] (Nlso = Nlat*Nspin*Norb, io = a + s*Norb + ilat*Nso);
    sigma_lat: [Nlat, Nspin, Nspin, Norb, Norb, L]. Returns the
    site-diagonal blocks [Nlat, Nspin, Nspin, Norb, Norb, L]
    (dmft_gloc_matsubara(Hij,[1d0],...) as drivers/ed_nano.f90:275 uses
    it). One batched complex128 inversion per chunk of frequencies on
    `device` (torch.linalg.inv; the reference leaves it to XLA, outside
    any Pallas kernel)."""
    from .device import resolve
    nlat = sigma_lat.shape[0]
    assert hij.shape[0] == nlat * cfg.nspin * cfg.norb
    out = np.zeros((nlat, cfg.nspin, cfg.nspin, cfg.norb, cfg.norb,
                    sigma_lat.shape[-1]), dtype=complex)
    for sl, G in _inverse_chunks(cfg, hij, sigma_lat, axis, chunk,
                                 resolve(device)):
        out[..., sl] = _site_blocks(G, cfg, nlat)
    return out


def kinetic_energy_realspace(cfg: EDConfig, hij: np.ndarray,
                             sigma_lat: np.ndarray) -> float:
    """E_kin of a finite real-space system (dmft_kinetic_energy(Hij,[1],S)):
    (2/beta)Σ_n Tr[Hij G(iw_n)] + tail corrections (host numpy, one
    inversion per frequency, the reference's arithmetic)."""
    wm = grids.matsubara_fermionic(cfg)
    ns_, no = cfg.nspin, cfg.norb
    nso = ns_ * no
    nlat = sigma_lat.shape[0]
    nlso = nlat * nso
    spin_fac = 2.0 if ns_ == 1 else 1.0
    sig_hf = np.zeros((nlso, nlso))
    for i in range(nlat):
        sig_hf[i * nso:(i + 1) * nso, i * nso:(i + 1) * nso] = \
            np.real(sigma_lat[i, ..., -1].transpose(0, 2, 1, 3
                                                    ).reshape(nso, nso))
    Hk = hij + 0.0
    Ak = Hk
    Bk = -Hk - sig_hf
    acc = 0.0
    sig_so = sigma_lat.transpose(0, 1, 3, 2, 4, 5).reshape(nlat, nso, nso, -1)
    for n, w in enumerate(wm):
        zw = 1j * w + cfg.xmu
        S = np.zeros((nlso, nlso), dtype=complex)
        for i in range(nlat):
            S[i * nso:(i + 1) * nso, i * nso:(i + 1) * nso] = sig_so[i, :, :, n]
        G = np.linalg.inv(zw * np.eye(nlso) - Hk - S)
        Tk = np.eye(nlso) / (1j * w) - Bk / (1j * w) ** 2
        acc += np.real(np.trace(Ak @ (G - Tk)))
    e = acc * 4.0 / cfg.beta
    # traces are real for hermitian Hij (complex SOC hoppings included)
    e += 2 * np.trace(0.5 * Ak).real
    e += 2 * np.trace(0.25 * Ak @ Bk).real * cfg.beta
    return float(e * spin_fac / 2.0 / nlat)


def _inverse_chunks(cfg: EDConfig, hij, sigma_lat, axis, chunk, device,
                    lead=None):
    """Yields (frequency slice, [(z+mu)I - Hij - Σ - lead]^{-1} as
    [Lc, Nlso, Nlso] on `device`) per chunk of the grid; lead: None,
    [Nlso, Nlso] or [Nlso, Nlso, L]."""
    z = _z(cfg, axis)
    nso = cfg.nspin * cfg.norb
    nlat = sigma_lat.shape[0]
    nlso = nlat * nso
    sig = torch.as_tensor(_sig_so(cfg, sigma_lat), device=device)
    hj = torch.as_tensor(np.asarray(hij, dtype=complex), device=device)
    eye = torch.eye(nlso, dtype=torch.complex128, device=device)
    zt = torch.as_tensor(z, device=device)
    ld = None
    if lead is not None:
        ld = torch.as_tensor(np.asarray(lead, dtype=complex), device=device)
        ld = ld.permute(2, 0, 1) if ld.ndim == 3 else ld[None]
    for i0 in range(0, len(z), chunk):
        sl = slice(i0, min(i0 + chunk, len(z)))
        S = _embed(sig[..., sl].permute(3, 0, 1, 2), nlat, nso)
        if ld is not None:
            S = S + (ld[sl] if ld.shape[0] > 1 else ld)
        yield sl, torch.linalg.inv(
            (zt[sl] + cfg.xmu)[:, None, None] * eye - hj[None] - S)


def _full_inverse(cfg: EDConfig, hij, sigma_lat, axis, chunk, device,
                  lead=None):
    """The whole grid of _inverse_chunks as [L, Nlso, Nlso]."""
    return torch.cat([G for _, G in _inverse_chunks(
        cfg, hij, sigma_lat, axis, chunk, device, lead)])


def gij_realspace(cfg: EDConfig, hij: np.ndarray, sigma_lat: np.ndarray,
                  axis: str = "real", chunk: int = 32,
                  device="cuda") -> np.ndarray:
    """FULL lattice Green's matrix [Nlso, Nlso, L] (dmft_gij_realaxis):
    like gloc_realspace but returning all site off-diagonal blocks."""
    from .device import resolve
    G = _full_inverse(cfg, hij, sigma_lat, axis, chunk, resolve(device))
    return G.permute(1, 2, 0).cpu().numpy()


def gloc_realspace_full(cfg: EDConfig, hij: np.ndarray,
                        sigma_lat: np.ndarray, axis: str = "real",
                        lead=None, chunk: int = 32,
                        device="cuda") -> np.ndarray:
    """FULL (site-offdiagonal) real-space GF
    G = [(z+mu)I - Hij - Σ - Σ_lead]^{-1}, returned as the raw
    [Nlso, Nlso, L] matrix (nonlocal propagators for transport and the
    effective-exchange kernel, ed_nano_fix_trans.f90 ed_get_jeff).
    `lead`: optional [Nlso, Nlso] or [Nlso, Nlso, L] lead self-energy.
    Batched over chunks of frequencies on `device`."""
    from .device import resolve
    G = _full_inverse(cfg, hij, sigma_lat, axis, chunk, resolve(device),
                      lead=lead)
    return G.permute(1, 2, 0).cpu().numpy()


def effective_exchange(cfg: EDConfig, gret_full: np.ndarray,
                       sreal_lat: np.ndarray) -> np.ndarray:
    """Effective non-local magnetic exchange from the converged solution
    (ed_get_jeff, ed_nano_fix_trans.f90:930-1010):

        J_ij = (1/pi) Im Σ_w f(w) ΔΣ_i(w) G↑_ij(w) ΔΣ_j(w) G↓_ji(w)

    with ΔΣ = (Σ↑ - Σ↓)/2 (Nspin=2, Norb=1). gret_full: the FULL
    retarded real-space GF [Nlso, Nlso, Lreal] (site-major (site, spin));
    sreal_lat: [Nlat, 2, 2, 1, 1, Lreal]. Returns jeff [Nlat, Nlat]
    (host numpy, as the reference)."""
    assert cfg.nspin == 2 and cfg.norb == 1, \
        "ed_get_jeff: Nspin=2, Norb=1 (ed_nano_fix_trans.f90:961-962)"
    wr = grids.real_axis(cfg)
    fw = 1.0 / (1.0 + np.exp(np.clip(cfg.beta * wr, -500, 500)))
    dsig = 0.5 * (sreal_lat[:, 0, 0, 0, 0] - sreal_lat[:, 1, 1, 0, 0])
    # site-major (site, spin) layout: up index 2i, down index 2i+1
    gup = gret_full[0::2, 0::2]           # [Nlat, Nlat, L]
    gdw = gret_full[1::2, 1::2]
    kern = (dsig[:, None, :] * gup * dsig[None, :, :]
            * gdw.transpose(1, 0, 2)) * fw[None, None, :]
    return np.imag(kern.sum(axis=-1)) / np.pi


def transmission(cfg: EDConfig, hij: np.ndarray, sigma_lat: np.ndarray,
                 gamma_l: np.ndarray, gamma_r: np.ndarray, chunk: int = 32,
                 device="cuda") -> np.ndarray:
    """Landauer transmission T(w) = Tr[Γ_L G^r Γ_R G^a] on the real axis
    (ed_nano_transport). gamma_l/r: [Nlso, Nlso] (wide-band) or
    [Nlso, Nlso, Lreal] (frequency-dependent lead hybridization, the
    reference's set_hyb/dmft_set_Gamma_realaxis path); the lead self-energy
    -(i/2)(Γ_L+Γ_R) is added to G. Batched over chunks of frequencies on
    `device`."""
    from .device import resolve
    device = resolve(device)
    gl = np.asarray(gamma_l, dtype=complex)
    gr = np.asarray(gamma_r, dtype=complex)
    lead = -0.5j * (gl + gr) if gl.ndim == gr.ndim else \
        -0.5j * ((gl if gl.ndim == 3 else gl[..., None])
                 + (gr if gr.ndim == 3 else gr[..., None]))
    G = _full_inverse(cfg, hij, sigma_lat, "real", chunk, device, lead=lead)

    def per_w(g):
        t = torch.as_tensor(g, device=device)
        return t.permute(2, 0, 1) if t.ndim == 3 else t[None]
    tl, tr = per_w(gl), per_w(gr)
    T = torch.einsum("lij,ljk,lkm,lmi->l", tl.expand(G.shape[0], -1, -1),
                     G, tr.expand(G.shape[0], -1, -1),
                     G.conj().transpose(1, 2))
    return T.real.cpu().numpy()


def wideband_leads(nlso: int, sites_l, sites_r, gamma: float,
                   nso: int = 1) -> tuple:
    """Γ_L, Γ_R wide-band coupling matrices for given lead-attached sites
    (the common ed_nano_transport setup)."""
    gl = np.zeros((nlso, nlso))
    gr = np.zeros((nlso, nlso))
    for s in np.atleast_1d(sites_l):
        for k in range(nso):
            gl[s * nso + k, s * nso + k] = gamma
    for s in np.atleast_1d(sites_r):
        for k in range(nso):
            gr[s * nso + k, s * nso + k] = gamma
    return gl, gr


def gloc_hk_lattice(cfg: EDConfig, hk: np.ndarray, sigma_lat: np.ndarray,
                    axis: str = "mats", chunk: int = 64,
                    device="cuda") -> np.ndarray:
    """Layer/site-resolved local GF with k dispersion (the ed_hm_slab
    geometry): hk [Nlat*Nso, Nlat*Nso, Nk], sigma_lat per site
    [Nlat, Nspin, Nspin, Norb, Norb, L] block-diagonal in sites. One
    batched [chunk, Nk, Nlso, Nlso] inversion per chunk of frequencies on
    `device`, averaged over k. Returns the site-diagonal blocks
    [Nlat, Nspin, Nspin, Norb, Norb, L]."""
    from .device import resolve
    device = resolve(device)
    z = _z(cfg, axis)
    nso = cfg.nspin * cfg.norb
    nlat = sigma_lat.shape[0]
    nlso = nlat * nso
    L = len(z)
    sig = torch.as_tensor(_sig_so(cfg, sigma_lat), device=device)
    hkT = torch.as_tensor(np.asarray(hk, dtype=complex),
                          device=device).permute(2, 0, 1)   # [Nk, nlso, nlso]
    eye = torch.eye(nlso, dtype=torch.complex128, device=device)
    zt = torch.as_tensor(z, device=device)
    out = np.zeros((nlat, cfg.nspin, cfg.nspin, cfg.norb, cfg.norb, L),
                   dtype=complex)
    for i0 in range(0, L, chunk):
        zc = zt[i0:i0 + chunk]
        S = _embed(sig[..., i0:i0 + chunk].permute(3, 0, 1, 2), nlat, nso)
        zeta = (zc + cfg.xmu)[:, None, None] * eye - S
        M = zeta[:, None, :, :] - hkT[None, :, :, :]
        out[..., i0:i0 + chunk] = _site_blocks(
            torch.mean(torch.linalg.inv(M), dim=1), cfg, nlat)
    return out


def chi0_ij_static(cfg: EDConfig, gij_mats: np.ndarray) -> np.ndarray:
    """Bare static susceptibility per spin from the non-local Matsubara GF
    (drivers/chi0_lattice.f90:ed_get_chi0ij):

        chi0_ij = -(1/β) Σ_n Tr_orb[ G_ij(iωₙ) G_ji(iωₙ) ]

    with the exact 1/ωₙ² tail resummed analytically beyond the stored
    frequencies (G_ij → δ_ij/(iω) ⇒ Σ_all 1/ωₙ² = β²/4). gij_mats:
    [Nlat, Nlat, Nspin, Nspin, Norb, Norb, L]; returns chi0 [Nspin, Nlat,
    Nlat] (spin-diagonal bubble, one entry per spin channel)."""
    nlat = gij_mats.shape[0]
    ns_, no = cfg.nspin, cfg.norb
    L = gij_mats.shape[-1]
    wn = np.pi / cfg.beta * (2 * np.arange(1, L + 1) - 1)
    chi0 = np.zeros((ns_, nlat, nlat))
    for s in range(ns_):
        g = gij_mats[:, :, s, s]                        # [Nlat,Nlat,no,no,L]
        # Tr_orb[G_ij G_ji] summed over positive freqs (x2 Re for ±n)
        gg = np.einsum("ijabl,jibal->ijl", g, g)
        chi0[s] = -(2.0 / cfg.beta) * np.sum(gg.real, axis=-1)
    # analytic tail: diagonal 1/(iω)^2 term beyond the stored frequencies
    tail = (1.0 / cfg.beta) * (cfg.beta ** 2 / 4.0 - 2.0 * np.sum(1 / wn ** 2))
    for s in range(ns_):
        chi0[s] += no * tail * np.eye(nlat)
    return chi0


def chi0_q_static(cfg: EDConfig, gij_mats: np.ndarray,
                  positions: np.ndarray, qpts: np.ndarray) -> np.ndarray:
    """chi0(q) = Σ_ij e^{-i q·(R_i - R_j)} chi0_ij / Nlat on arbitrary q
    points (the q-resolved output of chi0_lattice.f90). Returns
    [Nspin, Nq]."""
    chi0 = chi0_ij_static(cfg, gij_mats)
    nlat = positions.shape[0]
    dr = positions[:, None, :] - positions[None, :, :]   # [i, j, dim]
    ph = np.exp(-1j * np.einsum("qd,ijd->qij", qpts, dr))
    return np.einsum("qij,sij->sq", ph, chi0).real / nlat


def gloc_hk_lattice_superc(cfg: EDConfig, hk: np.ndarray,
                           sigma_lat: np.ndarray, sigma_an_lat: np.ndarray,
                           axis: str = "mats", chunk: int = 32,
                           device="cuda"):
    """Site-resolved Nambu local GF with k dispersion (the ed_ahm_stripe
    supercell and ed_ahm_stackU geometries: a [Nlat*Nso, Nlat*Nso, Nk]
    Bloch Hamiltonian over the reduced BZ with site-block-diagonal Σ, Σᴬ).
    Per (z, k) inverts

        M = [[(z+mu)I - H(k) - Σ,  -Σᴬ          ],
             [-Σᴬ,   (z-mu)I + H(k) + Σ̄]]

    and k-averages; the hole block carries +H(k), not conj(H(k)), and
    Σ̄(z) = conj(Σ(z)) on the imaginary axis and conj(Σ(-w)) (the reversed
    grid) on the real one, as gloc_hk_superc. One batched complex
    torch.linalg.inv over [chunk, Nk, 2Nlso, 2Nlso] per chunk of
    frequencies on `device`. Returns (G, F) site-diagonal blocks
    [Nlat, Nspin, Nspin, Norb, Norb, L]."""
    from .device import resolve
    device = resolve(device)
    z = _z(cfg, axis)
    nso = cfg.nspin * cfg.norb
    nlat = sigma_lat.shape[0]
    nlso = nlat * nso
    L = len(z)
    sig_np = _sig_so(cfg, sigma_lat)
    sbar_np = np.conj(sig_np) if axis == "mats" \
        else np.conj(sig_np[..., ::-1])
    sig = torch.as_tensor(sig_np, device=device)
    sbar = torch.as_tensor(np.ascontiguousarray(sbar_np), device=device)
    san = torch.as_tensor(_sig_so(cfg, sigma_an_lat), device=device)
    hkT = torch.as_tensor(np.asarray(hk, dtype=complex),
                          device=device).permute(2, 0, 1)   # [Nk, nlso, nlso]
    eye = torch.eye(nlso, dtype=torch.complex128, device=device)
    zt = torch.as_tensor(z, device=device)
    shape = (nlat, cfg.nspin, cfg.nspin, cfg.norb, cfg.norb, L)
    G = np.zeros(shape, dtype=complex)
    F = np.zeros(shape, dtype=complex)
    for i0 in range(0, L, chunk):
        zc = zt[i0:i0 + chunk][:, None, None, None]
        sl = slice(i0, i0 + zc.shape[0])

        def emb(a):
            return _embed(a[..., sl].permute(3, 0, 1, 2), nlat, nso)[:, None]
        S, Sb, SA = emb(sig), emb(sbar), emb(san)
        blk11 = (zc + cfg.xmu) * eye - hkT[None] - S
        blk22 = (zc - cfg.xmu) * eye + hkT[None] + Sb
        blk12 = (-SA).expand_as(blk11)
        M = torch.cat([torch.cat([blk11, blk12], dim=-1),
                       torch.cat([blk12, blk22], dim=-1)], dim=-2)
        Gi = torch.mean(torch.linalg.inv(M), dim=1)          # k-sum
        G[..., sl] = _site_blocks(Gi[:, :nlso, :nlso], cfg, nlat)
        F[..., sl] = _site_blocks(Gi[:, :nlso, nlso:], cfg, nlat)
    return G, F


def gloc_realspace_superc(cfg: EDConfig, hij: np.ndarray,
                          sigma_lat: np.ndarray, sigma_an_lat: np.ndarray,
                          axis: str = "mats", chunk: int = 32,
                          device="cuda"):
    """Site-resolved Nambu local GF of a finite real-space system
    (the ed_ahm_disorder / ed_ahm_stripe / ed_nano_sc geometry):

        M = [[(z+mu) - H - Σ,  -Σᴬ       ],
             [-Σᴬ,            (z-mu) + H + Σ̄]]

    with Σ, Σᴬ site-block-diagonal; Σ̄(z) = conj(Σ(z)) on the imaginary
    axis and conj(Σ(-w)) (the reversed grid) on the real axis. One batched
    inversion per chunk of frequencies on `device`. Returns (G, F)
    site-diagonal blocks [Nlat, Nspin, Nspin, Norb, Norb, L]."""
    from .device import resolve
    device = resolve(device)
    z = _z(cfg, axis)
    nso = cfg.nspin * cfg.norb
    nlat = sigma_lat.shape[0]
    nlso = nlat * nso
    L = len(z)
    sig_np = _sig_so(cfg, sigma_lat)
    sbar_np = np.conj(sig_np) if axis == "mats" \
        else np.conj(sig_np[..., ::-1])
    sig = torch.as_tensor(sig_np, device=device)
    sbar = torch.as_tensor(np.ascontiguousarray(sbar_np), device=device)
    san = torch.as_tensor(_sig_so(cfg, sigma_an_lat), device=device)
    hj = torch.as_tensor(np.asarray(hij, dtype=complex), device=device)
    eye = torch.eye(nlso, dtype=torch.complex128, device=device)
    zt = torch.as_tensor(z, device=device)
    shape = (nlat, cfg.nspin, cfg.nspin, cfg.norb, cfg.norb, L)
    G = np.zeros(shape, dtype=complex)
    F = np.zeros(shape, dtype=complex)
    for i0 in range(0, L, chunk):
        zc = zt[i0:i0 + chunk]
        sl = slice(i0, i0 + len(zc))

        def emb(a):
            return _embed(a[..., sl].permute(3, 0, 1, 2), nlat, nso)
        S, Sb, SA = emb(sig), emb(sbar), emb(san)
        blk11 = (zc + cfg.xmu)[:, None, None] * eye - hj[None] - S
        blk22 = (zc - cfg.xmu)[:, None, None] * eye + hj[None] + Sb
        M = torch.cat([torch.cat([blk11, -SA], dim=-1),
                       torch.cat([-SA, blk22], dim=-1)], dim=-2)
        Gi = torch.linalg.inv(M)
        G[..., sl] = _site_blocks(Gi[:, :nlso, :nlso], cfg, nlat)
        F[..., sl] = _site_blocks(Gi[:, :nlso, nlso:], cfg, nlat)
    return G, F


class ConvergenceMonitor:
    """err = Σ|X_new - X_old| / Σ|X_new|; converged after `nsuccess`
    consecutive iterations below threshold.

    `check` returns True ONLY on genuine convergence (DMFT_Tools
    check_convergence semantics): loop exhaustion is the caller's
    `iloop < nloop` guard, and an exhausted-but-unconverged loop logs an
    explicit max-iterations warning instead of masquerading as converged
    (the reference prints "Max number of iterations reached"). The final
    state is exposed as `monitor.converged` / `monitor.exhausted`."""

    def __init__(self, threshold: float, nsuccess: int = 1,
                 nloop: int = 100):
        self.threshold = threshold
        self.nsuccess = nsuccess
        self.nloop = nloop
        self._old = None
        self._good = 0
        self.count = 0
        self.error = np.inf
        self.converged = False
        self.exhausted = False

    def check(self, x, log=None) -> bool:
        x = np.asarray(x)
        self.count += 1
        if self._old is None:
            self._old = x.copy()
            self.error = np.inf
            if log:
                log(f"error={self.error:.8E}")
            return False
        num = np.sum(np.abs(x - self._old))
        den = np.sum(np.abs(x))
        self.error = num / max(den, 1e-300)
        self._old = x.copy()
        if self.error <= self.threshold:
            self._good += 1
        else:
            self._good = 0
        conv = self._good >= self.nsuccess
        self.converged = conv
        self.exhausted = not conv and self.count >= self.nloop
        if log:
            log(f"error={self.error:.8E}"
                + ("  [converged]" if conv else ""))
        if self.exhausted and log:
            log(f"WARNING: max number of DMFT loops ({self.nloop}) "
                f"reached without convergence (error={self.error:.8E} "
                f"> {self.threshold:.8E})")
        try:
            with open("error.err", "a") as fh:
                fh.write(f"{self.count} {self.error:.12E}\n")
        except OSError:
            pass
        return conv

