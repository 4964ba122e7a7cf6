"""Lattice layer of the single-site DMFT loops — subset of
dmft_ed_tpu/lattice.py: the semicircular DOS, the DOS-integral local
Green's function, the k-sum local Green's function, the Weiss/Δ
self-consistency, the kinetic energy (each DOS form also in its superc
Nambu form) and the convergence monitor (DMFT_Tools'
dmft_gloc_matsubara/realaxis, dmft_self_consistency, dmft_kinetic_energy,
check_convergence).

The O(Lmats x Le) DOS-integral work runs on the host in numpy, as the
reference keeps it on its host backend; the k-sum (gloc_hk), a batched
matrix inversion over frequencies x k-points, runs on the device.
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

