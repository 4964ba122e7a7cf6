"""Closed-form bath functions Δ(z), FΔ(z), G0(z), F0(z), G0^{-1}(z) in
PyTorch — port of dmft_ed_tpu/bath_fns.py (ed_mode "normal", "superc" and
"nonsu2"; bath types normal, hybrid and replica).

Vectorized over (bath level × frequency); differentiable, so the chi^2 fit
(fit.py) takes its gradients from torch.autograd instead of the reference's
hand-coded derivatives (ED_FIT_CHI2/fitgf_normal_normal.f90:341-359).

Conventions:
  * x: complex frequency tensor [L] (i*wm on the Matsubara axis, w+i*eps real)
  * returns [Nspin, Nspin, Norb, Norb, L] complex128
  * `axis` = "mats" | "real" switches the superc denominator
    (Im(x)^2 + e^2 + d^2 vs -x^2 + e^2 + d^2, delta_bath_{mats,real}_main).
"""

from __future__ import annotations

from typing import Dict

import torch

from .config import EDConfig
from .bath import Bath


def bath_params(bath: Bath, device) -> Dict[str, torch.Tensor]:
    """Bath -> dict of tensors on `device` (fit parameters)."""
    out = {}
    for name in ("e", "d", "v", "u", "h", "vr"):
        a = getattr(bath, name)
        if a is not None:
            out[name] = torch.as_tensor(a, device=device)
    return out


def _superc_den(x, e, d, axis):
    """den[..., k, L]: mats Im(x)^2 + e^2 + d^2, real -x^2 + e^2 + d^2."""
    ed2 = (e ** 2 + d ** 2)[..., None]
    if axis == "mats":
        return (x.imag ** 2 + ed2).to(x.dtype)
    return -(x * x) + ed2


def delta(cfg: EDConfig, x, p, axis: str = "mats") -> torch.Tensor:
    """Hybridization Δ(x) [Nspin,Nspin,Norb,Norb,L]."""
    ns_, no = cfg.nspin, cfg.norb
    L = x.shape[0]
    out = torch.zeros((ns_, ns_, no, no, L), dtype=torch.complex128,
                      device=x.device)
    ar = torch.arange(no, device=x.device)
    bt, sc = cfg.bath_type, cfg.ed_mode == "superc"
    if bt == "normal" and cfg.ed_mode == "nonsu2":
        # helicity sum with the W matrix (get_Whyb_matrix): the helicity
        # index h runs over the spin slot of e[h, a, k]
        W = _whyb(cfg, p).to(x.dtype)                        # [s,h,a,k]
        geh = 1.0 / (x[None, None, None, :] - p["e"][..., None])
        d = torch.einsum("hakl,shak,zhak->szal", geh, W, W)
        for a in range(no):
            out[:, :, a, a] = d[:, :, a]
    elif bt == "hybrid" and cfg.ed_mode == "nonsu2":
        W = _whyb(cfg, p).to(x.dtype)                        # [s,h,a,k]
        geh = 1.0 / (x[None, None, :] - p["e"][:, 0, :, None])  # [h,k,L]
        out = torch.einsum("shak,zhbk,hkl->szabl", W, W, geh)
    elif bt == "normal":
        if sc:
            # Δ_aa = -Σ_k V^2 (x + E) / Den
            den = _superc_den(x, p["e"], p["d"], axis)       # [s,a,k,L]
            num = (p["v"] ** 2)[..., None] * (x[None, None, None, :]
                                              + p["e"][..., None])
            d = -torch.sum(num / den, dim=2)
        else:
            # Δ_aa = Σ_k V_a(k)^2 / (x - E_a(k))
            d = torch.einsum("sak,sakl->sal", (p["v"] ** 2).to(x.dtype),
                             1.0 / (x[None, None, None, :]
                                    - p["e"][..., None]))
        for s in range(ns_):
            out[s, s, ar, ar] = d[s]
    elif bt == "hybrid":
        v = p["v"].to(x.dtype)
        if sc:
            den = _superc_den(x, p["e"][:, 0, :], p["d"][:, 0, :],
                              axis)                            # [s,k,L]
            num = x[None, None, :] + p["e"][:, 0, :, None]
            d = -torch.einsum("sak,sbk,skl->sabl", v, v, num / den)
        else:
            ge = 1.0 / (x[None, None, :] - p["e"][:, 0, :, None])  # [s,k,L]
            d = torch.einsum("sak,sbk,skl->sabl", v, v, ge)
        for s in range(ns_):
            out[s, s] = d[s]
    else:  # replica: Δ = Σ_k vr* (x - h_k)^{-1} vr
        nso = ns_ * no
        hk = p["h"].permute(4, 0, 2, 1, 3).reshape(cfg.nbath, nso, nso)
        eye = torch.eye(nso, dtype=x.dtype, device=x.device)
        zi = x[:, None, None] * eye[None] - hk[:, None, :, :]
        inv = torch.linalg.inv(zi)                       # [k, L, nso, nso]
        w2 = (torch.conj(p["vr"]) * p["vr"]).real
        d = torch.einsum("k,klij->lij", w2.to(inv.dtype), inv)
        out = d.reshape(L, ns_, no, ns_, no).permute(1, 3, 2, 4, 0)
    return out


def _whyb(cfg: EDConfig, p):
    """W^{s,h}_{a}(k) spin-helicity hybridization (get_Whyb_matrix,
    ED_BATH/dmft_aux.f90:1098-1117): v on the diagonal, u on the spin
    off-diagonal."""
    ns_, no, nb = cfg.nspin, cfg.norb, cfg.nbath
    v, u = p["v"], p["u"]
    W = torch.zeros((ns_, ns_, no, nb), dtype=v.dtype, device=v.device)
    for s in range(ns_):
        W[s, s] = v[0] if cfg.ed_para else v[s]
    W[0, ns_ - 1] = u[0]
    W[ns_ - 1, 0] = u[0] if cfg.ed_para else u[ns_ - 1]
    return W


def fdelta(cfg: EDConfig, x, p, axis: str = "mats") -> torch.Tensor:
    """Anomalous FΔ(x) (superc only; fdelta_bath_mats_main); zero in the
    other modes."""
    ns_, no = cfg.nspin, cfg.norb
    out = torch.zeros((ns_, ns_, no, no, x.shape[0]), dtype=torch.complex128,
                      device=x.device)
    if cfg.ed_mode != "superc":
        return out
    if cfg.bath_type == "normal":
        den = _superc_den(x, p["e"], p["d"], axis)           # [s,a,k,L]
        num = (p["d"] * p["v"] ** 2)[..., None]
        f = torch.sum(num / den, dim=2)                      # [s,a,L]
        ar = torch.arange(no, device=x.device)
        for s in range(ns_):
            out[s, s, ar, ar] = f[s]
    else:  # hybrid
        den = _superc_den(x, p["e"][:, 0, :], p["d"][:, 0, :], axis)
        num = p["d"][:, 0, :, None] / den                    # [s,k,L]
        v = p["v"].to(x.dtype)
        f = -torch.einsum("sak,sbk,skl->sabl", v, v, num)
        for s in range(ns_):
            out[s, s] = f[s]
    return out


def _eye_nn(nspin, norb, device):
    e = torch.zeros((nspin, nspin, norb, norb), dtype=torch.float64,
                    device=device)
    for s in range(nspin):
        for a in range(norb):
            e[s, s, a, a] = 1.0
    return e


def invg0(cfg: EDConfig, x, p, hloc, axis: str = "mats") -> torch.Tensor:
    """G0^{-1}(x) = (x+mu) - Hloc - Δ(x) (invg0_bath_mats_main)."""
    D = delta(cfg, x, p, axis)
    hl = torch.as_tensor(hloc, device=x.device).to(torch.complex128)[..., None]
    zmu = (x + cfg.xmu)[None, None, None, None, :]
    eye = _eye_nn(cfg.nspin, cfg.norb, x.device)[..., None]
    return zmu * eye - hl - D


def _nambu_g0(cfg: EDConfig, x, p, hloc, axis, anomalous: bool):
    """Normal (G0) or anomalous (F0) block of the inverse noninteracting
    Nambu matrix [[(x+mu) - Hloc - Δ, -FΔ], [-FΔ, (x-mu) + Hloc + Δ*]]:
    a 2x2 inverse per (spin, orbital) for a normal bath, a 2Norb x 2Norb
    one per spin for a hybrid bath."""
    ns_, no = cfg.nspin, cfg.norb
    out = torch.zeros((ns_, ns_, no, no, x.shape[0]), dtype=torch.complex128,
                      device=x.device)
    F = fdelta(cfg, x, p, axis)
    if cfg.bath_type == "normal":
        ig = invg0(cfg, x, p, hloc, axis)
        for s in range(ns_):
            for a in range(no):
                fg = ig[s, s, a, a]
                ff = -F[s, s, a, a]
                det = torch.abs(fg) ** 2 + ff * ff
                out[s, s, a, a] = (ff if anomalous else torch.conj(fg)) / det
        return out
    hl = torch.as_tensor(hloc, device=x.device).to(torch.complex128)
    D = delta(cfg, x, p, axis)
    eye = torch.eye(no, dtype=x.dtype, device=x.device)[None]
    for s in range(ns_):
        Ds = D[s, s].permute(2, 0, 1)
        blk11 = (x + cfg.xmu)[:, None, None] * eye - hl[s, s][None] - Ds
        blk12 = -F[s, s].permute(2, 0, 1)
        blk22 = ((x - cfg.xmu)[:, None, None] * eye + hl[s, s][None]
                 + torch.conj(Ds))
        Minv = torch.linalg.inv(torch.cat(
            [torch.cat([blk11, blk12], dim=-1),
             torch.cat([blk12, blk22], dim=-1)], dim=-2))
        blk = Minv[:, :no, no:] if anomalous else Minv[:, :no, :no]
        out[s, s] = blk.permute(1, 2, 0)
    return out


def g0and(cfg: EDConfig, x, p, hloc, axis: str = "mats") -> torch.Tensor:
    """Noninteracting impurity G0(x) (g0and_bath_mats/real_main)."""
    if cfg.ed_mode == "superc":
        return _nambu_g0(cfg, x, p, hloc, axis, anomalous=False)
    ns_, no = cfg.nspin, cfg.norb
    ig = invg0(cfg, x, p, hloc, axis)
    if cfg.ed_mode == "nonsu2":
        # invert in the full (spin x orbital) space
        L, nso = x.shape[0], ns_ * no
        m = ig.permute(4, 0, 2, 1, 3).reshape(L, nso, nso)
        return torch.linalg.inv(m).reshape(L, ns_, no, ns_, no).permute(
            1, 3, 2, 4, 0)
    out = torch.zeros_like(ig)
    if cfg.bath_type == "normal":
        ar = torch.arange(no, device=x.device)
        for s in range(ns_):
            diag = torch.stack([1.0 / ig[s, s, a, a] for a in range(no)])
            out[s, s, ar, ar] = diag
        return out
    # hybrid/replica: invert in orbital space per spin & frequency
    for s in range(ns_):
        m = ig[s, s].permute(2, 0, 1)                      # [L,no,no]
        out[s, s] = torch.linalg.inv(m).permute(1, 2, 0)
    return out


def f0and(cfg: EDConfig, x, p, hloc, axis: str = "mats") -> torch.Tensor:
    """Anomalous noninteracting F0(x) (f0and_bath_mats_main); zero in the
    other modes."""
    if cfg.ed_mode == "superc":
        return _nambu_g0(cfg, x, p, hloc, axis, anomalous=True)
    return torch.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb,
                        x.shape[0]), dtype=torch.complex128, device=x.device)
