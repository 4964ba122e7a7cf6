"""Plain reference of the single-band Hubbard model on the Bethe lattice
(dmft-ed's ed_hm_bethe driver): one DMFT iteration's impurity solve by
full diagonalization and a Lehmann sum, the Bethe lattice's local Green's
function and Weiss field, and the chi^2 of a bath against a Weiss field.

The solve is at zero temperature: every state within ``gs_threshold`` of
the lowest energy over all (n_up, n_dw) sectors is kept with equal
weight, and G(iw) is the up-spin impurity function
``<c (z - H + E)^-1 c+> + <c+ (z + H - E)^-1 c>`` averaged over them.
The user bath vector of a normal bath with one spin and one orbital is
``[e_1..e_Nbath, v_1..v_Nbath]`` (upstream's get_dmft_bath layout).

Written from the definitions; it imports neither jax nor either solver
package. Dense eigensolves run in float64 with torch on the device the
caller names (the card after the timed window, the CPU in the tests).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import minimize

from .fock import Sector, add_up_impurity, remove_up_impurity


def split_bath(flat: np.ndarray, nbath: int):
    """(e, v) of a user bath vector."""
    flat = np.asarray(flat, dtype=np.float64)
    return flat[:nbath].copy(), flat[nbath:2 * nbath].copy()


def matsubara(beta: float, n: int) -> np.ndarray:
    """The first n fermionic Matsubara frequencies pi/beta (2k - 1)."""
    return np.pi / beta * (2 * np.arange(1, n + 1) - 1)


def _eigh(h: np.ndarray, device):
    w, q = torch.linalg.eigh(torch.as_tensor(h, device=device))
    return w.cpu().numpy(), q.cpu().numpy()


def _eigvalsh_min(h: np.ndarray, device) -> float:
    return float(torch.linalg.eigvalsh(torch.as_tensor(h, device=device))[0])


def impurity_solve(e, v, u: float, beta: float, lmats: int,
                   gs_threshold: float = 1e-9, mu: float = 0.0,
                   device="cpu") -> dict:
    """egs, G(iw_n) (up spin, n < lmats), dens = <n_up + n_dw> and
    docc = <n_up n_dw> of the impurity, averaged over the ground states."""
    ns = len(e) + 1
    sectors = {(a, b): Sector(e, v, u, a, b, mu)
               for a in range(ns + 1) for b in range(ns + 1)}
    lowest = {k: _eigvalsh_min(s.dense(), device) for k, s in
              sectors.items()}
    e0 = min(lowest.values())
    states = []
    spectra = {}

    def spectrum(key):
        if key not in spectra:
            spectra[key] = _eigh(sectors[key].dense(), device)
        return spectra[key]

    for key, emin in lowest.items():
        if emin - e0 > gs_threshold:
            continue
        w, q = spectrum(key)
        for i in np.nonzero(w - e0 <= gs_threshold)[0]:
            states.append((key, float(w[i]), q[:, i]))
    z = 1j * matsubara(beta, lmats)
    g = np.zeros(lmats, dtype=complex)
    dens = docc = 0.0
    for (nup, ndw), en, vec in states:
        sec = sectors[(nup, ndw)]
        p = np.abs(vec.reshape(sec.shape)) ** 2
        dens += float(np.sum(p * (sec.n0_dw[:, None] + sec.n0_up[None, :])))
        docc += float(np.sum(p * sec.n0_dw[:, None] * sec.n0_up[None, :]))
        if nup < ns:
            dst = sectors[(nup + 1, ndw)]
            w, q = spectrum((nup + 1, ndw))
            amp = q.T @ add_up_impurity(sec, dst, vec)
            g += np.sum(amp ** 2 / (z[:, None] - (w - en)[None, :]), axis=1)
        if nup > 0:
            dst = sectors[(nup - 1, ndw)]
            w, q = spectrum((nup - 1, ndw))
            amp = q.T @ remove_up_impurity(sec, dst, vec)
            g += np.sum(amp ** 2 / (z[:, None] + (w - en)[None, :]), axis=1)
    n = len(states)
    return {"egs": e0, "g": g / n, "dens": dens / n, "docc": docc / n,
            "nstates": n}


def hybridization(z: np.ndarray, e: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Delta(z) = sum_k v_k^2 / (z - e_k)."""
    return np.sum(v[None, :] ** 2 / (z[:, None] - e[None, :]), axis=1)


def self_energy(z, e, v, g, mu: float = 0.0) -> np.ndarray:
    """Sigma = G0^-1 - G^-1 with G0^-1 = z + mu - Delta(z)."""
    return z + mu - hybridization(z, e, v) - 1.0 / g


def bethe_grid(wband: float, le: int):
    """(energies, weights) of the semicircular DOS of half-bandwidth
    wband on le equally spaced points, the weights carrying the spacing."""
    en = np.linspace(-wband, wband, le)
    x = np.clip(en / wband, -1.0, 1.0)
    dos = 2.0 / (np.pi * wband) * np.sqrt(np.maximum(0.0, 1.0 - x * x))
    return en, dos * (en[1] - en[0])


def weiss_field(z, sigma, wband: float, le: int, mu: float = 0.0):
    """The Weiss field G0 = (Gloc^-1 + Sigma)^-1, Gloc the DOS integral
    sum_e D(e) / (z + mu - e - Sigma)."""
    en, wt = bethe_grid(wband, le)
    gloc = np.sum(wt[None, :] / ((z + mu - sigma)[:, None] - en[None, :]),
                  axis=1)
    return 1.0 / (1.0 / gloc + sigma)


def chi2(x: np.ndarray, z: np.ndarray, target: np.ndarray, mu: float = 0.0,
         grad: bool = False):
    """chi^2 = sum_n |G0_And(z_n) - target_n|^2 / L of the bath
    x = [e, v] (L = len(z), upstream's default weight), and its gradient."""
    nb = x.size // 2
    e, v = x[:nb], x[nb:]
    d = z[:, None] - e[None, :]
    a = z + mu - np.sum(v[None, :] ** 2 / d, axis=1)
    g0 = 1.0 / a
    r = g0 - target
    f = float(np.sum(np.abs(r) ** 2)) / z.size
    if not grad:
        return f
    da_de = -(v[None, :] ** 2) / d ** 2
    da_dv = -2.0 * v[None, :] / d
    dg = -(g0 ** 2)[:, None] * np.concatenate([da_de, da_dv], axis=1)
    return f, 2.0 * np.real(np.conj(r)[:, None] * dg).sum(axis=0) / z.size


def polish(x0: np.ndarray, z: np.ndarray, target: np.ndarray,
           mu: float = 0.0) -> float:
    """The lowest chi^2 that L-BFGS-B reaches from x0."""
    res = minimize(lambda x: chi2(x, z, target, mu, grad=True), x0,
                   jac=True, method="L-BFGS-B",
                   options={"maxiter": 2000, "ftol": 1e-15, "gtol": 1e-14})
    return min(float(res.fun), chi2(x0, z, target, mu))
