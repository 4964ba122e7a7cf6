"""Auxiliary helpers: index reshapes and chemical-potential search.

Replaces ED_AUX_FUNX.f90: the lso<->nnn array reshapes (:181-447), the
secant ('charge compressibility') chemical-potential search
(ed_search_variable, :487-561) and the adaptive-threshold bisection
variant (search_chemical_potential, :567-672), plus the atomic J/SOC
operator matrices (:780-1053) behind ed_get_quantum_SOC_operators
(ED_IO/get_imp_SOC_op.f90).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .config import EDConfig
from .parallel.mesh import from_rank0, writes_files


# ----------------------------------------------------------------------
# reshapes between [Nspin,Nspin,Norb,Norb,...] and [Nso,Nso,...]
# ----------------------------------------------------------------------

def nn2so(f: np.ndarray, nspin: int, norb: int) -> np.ndarray:
    """[Nspin,Nspin,Norb,Norb,(L)] -> [Nso,Nso,(L)] with io = a + s*Norb."""
    nso = nspin * norb
    if f.ndim == 4:
        return f.transpose(0, 2, 1, 3).reshape(nso, nso)
    return f.transpose(0, 2, 1, 3, 4).reshape(nso, nso, f.shape[-1])


def so2nn(f: np.ndarray, nspin: int, norb: int) -> np.ndarray:
    """[Nso,Nso,(L)] -> [Nspin,Nspin,Norb,Norb,(L)]."""
    if f.ndim == 2:
        return f.reshape(nspin, norb, nspin, norb).transpose(0, 2, 1, 3)
    return f.reshape(nspin, norb, nspin, norb, f.shape[-1]
                     ).transpose(0, 2, 1, 3, 4)


def lso2nnn(f: np.ndarray, nlat: int, nspin: int, norb: int) -> np.ndarray:
    """[Nlat*Nso, Nlat*Nso,(L)] -> [Nlat,Nspin,Nspin,Norb,Norb,(L)]
    (site-diagonal part), io = a + s*Norb + ilat*Nspin*Norb."""
    nso = nspin * norb
    out_shape = (nlat, nspin, nspin, norb, norb) + f.shape[2:]
    out = np.zeros(out_shape, dtype=f.dtype)
    for i in range(nlat):
        blk = f[i * nso:(i + 1) * nso, i * nso:(i + 1) * nso]
        out[i] = so2nn(blk, nspin, norb)
    return out


# ----------------------------------------------------------------------
# spin-orbit helpers (ED_AUX_FUNX.f90:780-1053)
# ----------------------------------------------------------------------

_PAULI = {
    "x": np.array([[0, 1], [1, 0]], dtype=complex),
    "y": np.array([[0, -1j], [1j, 0]], dtype=complex),
    "z": np.array([[1, 0], [0, -1]], dtype=complex),
}


def atomic_soc(nspin: int = 2, norb: int = 3) -> np.ndarray:
    """t2g atomic L·S matrix, [Nspin, Nspin, Norb, Norb] (atomic_SOC,
    ED_AUX_FUNX.f90:926-940: blocks (1,2)=+iσz/2, (1,3)=-iσy/2,
    (2,3)=+iσx/2 in orbital-major/spin-fast ordering + h.c.)."""
    assert nspin == 2 and norb == 3, "atomic SOC defined for t2g (2x3)"
    nso = nspin * norb
    ls_os = np.zeros((nso, nso), dtype=complex)     # os: i = s + 2*orb
    ls_os[0:2, 2:4] = +1j * _PAULI["z"] / 2
    ls_os[0:2, 4:6] = -1j * _PAULI["y"] / 2
    ls_os[2:4, 4:6] = +1j * _PAULI["x"] / 2
    ls_os = ls_os + ls_os.conj().T
    # os (orbital-major, spin-fast) -> nn [Nspin, Nspin, Norb, Norb]
    ls = ls_os.reshape(norb, nspin, norb, nspin).transpose(1, 3, 0, 2)
    return ls


def orbital_lz_rotation(nspin: int = 2, norb: int = 3) -> np.ndarray:
    """{cubic t2g} -> {Lz eigenbasis} rotation, [Nso, Nso] spin-block
    diagonal (orbital_Lz_rotation_NorbNspin, ED_AUX_FUNX.f90). In the
    rotated basis Lz is diagonal = Lzdiag = [-1, +1, 0] — required for
    Jz_basis runs."""
    assert nspin == 2 and norb == 3
    u = np.zeros((3, 3), dtype=complex)
    u[0, 0] = -1j / np.sqrt(2)
    u[1, 1] = 1 / np.sqrt(2)
    u[2, 2] = 1j
    u[0, 1] = -1j / np.sqrt(2)
    u[1, 0] = -1 / np.sqrt(2)
    U = np.zeros((6, 6), dtype=complex)
    U[:3, :3] = u
    U[3:, 3:] = u
    return U


def atomic_j(component: str, nspin: int = 2, norb: int = 3) -> np.ndarray:
    """Total angular momentum J_a = L_a + S_a for the t2g shell,
    [Nso, Nso] in the spin-major layout io = a + s*Norb (atomic_j,
    ED_AUX_FUNX.f90:1021-1049; orbital order 1=yz 2=zx 3=xy, t2g
    effective l=1 matrices Lx=i(|3><2|-|2><3|) etc.)."""
    assert nspin == 2 and norb == 3, "atomic J defined for t2g (2x3)"
    L = np.zeros((3, 3), dtype=complex)
    if component == "x":
        L[2, 1], L[1, 2] = 1j, -1j
    elif component == "y":
        L[0, 2], L[2, 0] = 1j, -1j
    elif component == "z":
        L[1, 0], L[0, 1] = 1j, -1j
    else:
        raise ValueError(component)
    return (np.kron(np.eye(nspin), L)
            + np.kron(_PAULI[component] / 2, np.eye(norb)))


def atomic_soc_rotation(nspin: int = 2, norb: int = 3) -> np.ndarray:
    """{t2g, Sz} -> {J, jz} rotation, [Nso, Nso] spin-major columns
    ordered (1/2,-1/2), (1/2,+1/2), (3/2,-3/2), (3/2,+3/2), (3/2,-1/2),
    (3/2,+1/2) (atomic_SOC_rotation, ED_AUX_FUNX.f90:942-981)."""
    assert nspin == 2 and norb == 3
    U = np.zeros((6, 6), dtype=complex)
    # rows: io = orb + 3*spin (yz up, zx up, xy up, yz dw, zx dw, xy dw)
    U[0, 0], U[1, 0], U[5, 0] = 1, -1j, -1
    U[:, 0] /= np.sqrt(3.0)
    U[3, 1], U[4, 1], U[2, 1] = 1, 1j, 1
    U[:, 1] /= np.sqrt(3.0)
    U[3, 2], U[4, 2] = 1, -1j
    U[:, 2] /= np.sqrt(2.0)
    U[0, 3], U[1, 3] = -1, -1j
    U[:, 3] /= np.sqrt(2.0)
    U[0, 4], U[1, 4], U[5, 4] = 1, -1j, 2
    U[:, 4] /= np.sqrt(6.0)
    U[3, 5], U[4, 5], U[2, 5] = -1, -1j, 2
    U[:, 5] /= np.sqrt(6.0)
    return U


def quantum_soc_operators(cfg: EDConfig, rho_so: np.ndarray):
    """<S_a>, <L_a>, <J_a>, <J_a^2>, <L.S> from the impurity density
    matrix (ed_get_quantum_SOC_operators_single,
    ED_IO/get_imp_SOC_op.f90:3-110). `rho_so` is the [Nso, Nso]
    single-particle density matrix in the solver basis; it is rotated to
    the {t2g, Sz} reference frame per (bath_type, jz_basis) exactly like
    the reference. Returns a dict with keys S [3,Norb,Norb],
    L [3,Nspin,Nspin], J [3], Jsq [3], LS (scalar)."""
    if cfg.norb != 3 or cfg.nspin != 2:
        raise ValueError("SOC operators implemented only for Norb=3 Nspin=2")
    nspin, norb = cfg.nspin, cfg.norb
    if cfg.bath_type == "replica" and not cfg.jz_basis:
        U = np.eye(nspin * norb, dtype=complex)
    elif cfg.bath_type == "replica" and cfg.jz_basis:
        # dm in {Lz,Sz}: rotate {Lz,Sz} -> {t2g,Sz}
        U = orbital_lz_rotation(nspin, norb).conj().T
    else:
        # dm in {J,jz}: rotate {J,jz} -> {t2g,Sz}
        U = atomic_soc_rotation(nspin, norb).conj().T
    rho = U.conj().T @ rho_so @ U
    rnn = so2nn(rho, nspin, norb)           # [s,s',a,b]
    S = np.zeros((3, norb, norb), dtype=complex)
    S[0] = 0.5 * (rnn[0, 1] + rnn[1, 0])
    S[1] = 0.5j * (rnn[1, 0] - rnn[0, 1])
    S[2] = 0.5 * (rnn[0, 0] - rnn[1, 1])
    L = np.zeros((3, nspin, nspin), dtype=complex)
    L[0] = 1j * (rnn[:, :, 2, 1] - rnn[:, :, 1, 2])
    L[1] = 1j * (rnn[:, :, 0, 2] - rnn[:, :, 2, 0])
    L[2] = 1j * (rnn[:, :, 1, 0] - rnn[:, :, 0, 1])
    J = np.zeros(3, dtype=complex)
    Jsq = np.zeros(3, dtype=complex)
    for i, comp in enumerate("xyz"):
        ja = atomic_j(comp, nspin, norb)
        J[i] = np.trace(rho @ ja)
        Jsq[i] = np.trace(rho @ ja @ ja)
    LS = np.trace(rho @ nn2so(atomic_soc(nspin, norb), nspin, norb))
    return {"S": S, "L": L, "J": J, "Jsq": Jsq, "LS": LS}


def atomic_soc_jz(nspin: int = 2, norb: int = 3) -> np.ndarray:
    """Atomic L.S expressed in the Lz eigenbasis ([Nspin,Nspin,Norb,Norb]),
    the form used by Jz_basis runs (set_dmft_bath replica/nonsu2 branch:
    hrep = eps·1 + λ·U† (L.S) U, ED_BATH/dmft_aux.f90:699-706).

    NOTE basis ordering: the rotation acts in the orbital-major space but
    our so-layout is spin-major — handled via the nn<->so reshapes."""
    ls_so = nn2so(atomic_soc(nspin, norb), nspin, norb)
    # reference U blocks act in orbital space per spin; in our spin-major
    # so-layout (io = s*Norb + a) that is kron(I_spin, u)
    u = orbital_lz_rotation(nspin, norb)[:3, :3]
    U_so = np.kron(np.eye(nspin), u)
    out_so = U_so.conj().T @ ls_so @ U_so
    return so2nn(out_so, nspin, norb)


# ----------------------------------------------------------------------
# chemical potential search (secant on the density)
# ----------------------------------------------------------------------

def search_variable(cfg: EDConfig, var: float, ntmp: float, state: dict,
                    log=None, mesh=None) -> Tuple[float, bool]:
    """One step of the reference's compressibility-based mu search
    (ed_search_variable). `state` is caller-held mutable memory across DMFT
    iterations. `mesh`: the solver's parallel.Mesh, if any — only its rank
    0 reads the compressibility restart file and writes the iteration
    files. Returns (new_var, density_converged)."""
    count = state.get("count", 0) + 1
    state["count"] = count
    if count == 1:
        state["chich"] = from_rank0(mesh, lambda: _read_compressibility(
            cfg.ndelta))
        state["var_old"] = var
        state["nold"] = ntmp
    else:
        dv = var - state["var_old"]
        if abs(dv) > 1e-12:
            state["chich"] = (ntmp - state["nold"]) / dv
    chich = state["chich"]
    if abs(chich) < 1e-4:
        chich = np.sign(chich or 1.0) * 1e-4
    ndiff = ntmp - cfg.nread
    var_new = var - ndiff / chich
    state["nold"] = ntmp
    state["var_old"] = var
    if log:
        log(f"n    = {ntmp:16.9f} | instead of {cfg.nread:15.9f}")
        log(f"dn   = {ndiff:16.9E} / {cfg.nerr:16.9E}")
        log(f"var  = {var_new:16.9f}")
    if not writes_files(mesh):
        return float(var_new), bool(abs(ndiff) <= cfg.nerr)
    try:
        mode = "a" if count > 1 else "w"
        with open("search_variable_iteration_info.ed", mode) as fh:
            if count == 1:
                fh.write("#var,ntmp,ndiff\n")
            fh.write(f"{var_new} {ntmp} {ndiff}\n")
        with open("var_compressibility.used", "w") as fh:
            fh.write(f"{chich}\n")
    except OSError:
        pass
    return float(var_new), bool(abs(ndiff) <= cfg.nerr)


def _read_compressibility(default: float) -> float:
    """var_compressibility.restart's value, else `default`."""
    if not os.path.exists("var_compressibility.restart"):
        return default
    with open("var_compressibility.restart") as fh:
        return float(fh.read().split()[0])


def search_chemical_potential(cfg: EDConfig, var: float, ntmp: float,
                              converged: bool, state: dict, log=None,
                              suffix: str = "", niter: int = 10,
                              mesh=None) -> Tuple[float, bool]:
    """Adaptive-threshold/step bisection mu search
    (search_chemical_potential, ED_AUX_FUNX.f90:567-672).

    Walks mu by +-ndelta toward nread, halving the step whenever the walk
    reverses direction (sign-flip history over the last 3 moves), and —
    once the density sits inside the current threshold `nth` AND the DMFT
    loop reports convergence — tightens the threshold by a decade (down to
    cfg.nerr), un-converging the loop so it keeps refining. `state` is
    caller-held mutable memory across DMFT iterations; `converged` is the
    DMFT convergence flag, returned possibly reset to False. `niter`
    bounds the per-threshold iteration count before threshold reduction is
    abandoned (the reference's `niter` is an unset module variable — we
    expose it with a sane default). `mesh`: as in search_variable."""
    nratio = 0.5
    ndiff = ntmp - cfg.nread
    st = state
    st.setdefault("ndelta", cfg.ndelta)
    st.setdefault("nindex", 0)
    st.setdefault("nindex_old", [0, 0, 0])
    st.setdefault("nth_magnitude", -2)
    st.setdefault("nth_magnitude_old", -2)
    st.setdefault("nth", 1e-2)
    st.setdefault("ireduce", True)
    st["count"] = st.get("count", 0) + 1
    st["totcount"] = st.get("totcount", 0) + 1
    if st["count"] > 2:
        st["nindex_old"][2] = st["nindex_old"][1]
        st["nindex_old"][1] = st["nindex_old"][0]
    st["nindex_old"][0] = st["nindex"]
    nth = st["nth"]
    if ndiff >= nth:
        nindex = -1
    elif ndiff <= -nth:
        nindex = 1
    else:
        nindex = 0
    st["nindex"] = nindex
    ndelta_old = st["ndelta"]
    osc = nindex != 0 and (
        nindex + st["nindex_old"][0] == 0
        or nindex + sum(st["nindex_old"]) == 0)
    if osc:
        st["ndelta"] = ndelta_old * nratio    # reverse => halve the step
    if ndelta_old < 1e-9:
        ndelta_old = 0.0
        nindex = 0
    var = var + nindex * st["ndelta"]
    if log:
        log(f"n    = {ntmp:16.9f} /{cfg.nread:15.9f}")
        log(f"shift= {nindex * st['ndelta']:16.9E}")
        log(f"var  = {var:15.9f}")
        log(f"dn   = {ndiff:16.9E}/{nth:16.9E}")
    if writes_files(mesh):
        try:
            with open(f"search_mu_iteration{suffix}.ed", "a") as fh:
                fh.write(f"{var} {ntmp} {ndiff}\n")
        except OSError:
            pass
    # threshold tightening: inside nth + DMFT converged + nth still > nerr
    if st["ireduce"] and abs(ndiff) < nth and converged and nth > cfg.nerr:
        st["nth_magnitude_old"] = st["nth_magnitude"]
        st["nth_magnitude"] -= 1
        st["nth"] = max(cfg.nerr, 10.0 ** st["nth_magnitude"])
        st["count"] = 0
        converged = False
        st["ndelta"] = ndelta_old * nratio
    if abs(ndiff) > st["nth"]:
        converged = False
    # give up tightening if this threshold does not converge within niter
    if st["ireduce"] and st["count"] > niter and not converged:
        st["ireduce"] = False
        st["nth"] = 10.0 ** st["nth_magnitude_old"]
    if log:
        log(f"count= {st['count']:5d}")
        log(f"Converged={converged}")
    return float(var), bool(converged)
