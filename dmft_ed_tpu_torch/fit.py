"""chi^2 bath fitting — PyTorch port of dmft_ed_tpu/fit.py (chi2_fitgf;
ed_mode "normal", "superc" and "nonsu2"; bath types normal, hybrid and
replica).

The Anderson functions come from bath_fns (differentiable torch), so the
gradients are torch.autograd instead of the reference's hand-coded analytic
derivatives (fitgf_normal_normal.f90:341-359). They feed the same scipy
L-BFGS-B call as the reference: same x0, the same smooth box penalty, the
same Δ-target pre-conditioning on the cold start (normal mode only) and
the same jittered restart backstop. chi^2 = Σ_n |X(iw_n) - X_And(iw_n)|^2 /
W_n over the first Lfit Matsubara points with the reference's cg_weight
schemes; in superc the anomalous residual |F - F_And|^2 / W_n adds to it.

The inequivalent-site drivers fit every site's bath at once
(chi2_fitgf_sites): one L-BFGS-B on the concatenated parameters, whose
objective and gradient take one autograd pass over all sites.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.optimize import minimize

from .config import EDConfig
from .bath import unpack_bath, pack_bath, save_bath
from .bath_fns import delta, fdelta, g0and, f0and
from .parallel.mesh import site_chunk, sites_sharded


def _param_bound(xw: np.ndarray) -> float:
    """Box bound for every fitted bath parameter.

    Bath poles beyond the largest fitted Matsubara frequency are numerically
    degenerate with a static shift, so the chi^2 landscape is flat there and
    an unbounded quasi-Newton step (or a jittered restart) can random-walk
    |e_k| to 1e3+ — physically meaningless and destabilizing for the DMFT
    fixed point (observed as an orbital-polarization collapse in the 2-band
    Hund hybrid loop). The reference's warm-started fmin_cg never explores
    that region; we exclude it explicitly. 3x the largest fit frequency
    (>= 10) is far outside any physical pole of Delta/G0.

    Enforced as a smooth quadratic penalty INSIDE the autodiff objective
    (exactly zero in the interior), not as scipy box bounds: the bounded
    L-BFGS-B code path (generalized-Cauchy-point subspace steps) measurably
    degrades convergence on these ill-conditioned landscapes even with no
    bound ever active (stalls at chi^2 ~ 5e-4 where the unbounded driver
    reaches 3e-16 on the hybrid recovery test)."""
    return max(10.0, 3.0 * float(xw[-1]))


def _box_penalty(xv, bnd: float):
    """Smooth wall at |x| = bnd: zero inside, quadratic outside."""
    return torch.sum(torch.clamp(torch.abs(xv) - bnd, min=0.0) ** 2)


def _weights(cfg: EDConfig, ldelta: int) -> np.ndarray:
    x = np.pi / cfg.beta * (2 * np.arange(1, ldelta + 1) - 1)
    if cfg.cg_weight == 1:
        return np.ones(ldelta)
    if cfg.cg_weight == 2:
        return np.arange(1, ldelta + 1).astype(float)
    if cfg.cg_weight == 3:
        return x
    return np.full(ldelta, float(ldelta))   # default: 1/Ldelta normalization


def _component_mask(cfg: EDConfig, ispin: Optional[int],
                    iorb: Optional[int], mask_r=None) -> np.ndarray:
    """Bool [Nspin,Nspin,Norb,Norb]: which components enter chi^2."""
    m = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb), dtype=bool)
    spins = range(cfg.nspin) if ispin is None else [ispin]
    orbs = range(cfg.norb) if iorb is None else [iorb]
    if cfg.bath_type == "normal":
        if cfg.ed_mode == "nonsu2":
            for s in range(cfg.nspin):
                for s2 in range(cfg.nspin):
                    for a in orbs:
                        m[s, s2, a, a] = True
        else:
            for s in spins:
                for a in orbs:
                    m[s, s, a, a] = True
    elif cfg.bath_type == "hybrid":
        if cfg.ed_mode == "nonsu2":
            m[:, :, :, :] = True
        else:
            for s in spins:
                m[s, s, :, :] = True
    else:  # replica: fit components present in the bath mask + diagonal
        m[:, :, :, :] = False
        for s in range(cfg.nspin):
            m[s, s][np.eye(cfg.norb, dtype=bool)] = True
        if mask_r is not None:
            m |= mask_r[..., 0] | mask_r[..., 1]
    return m


def _fit_pack(cfg: EDConfig, b):
    """(x0, inject) where inject maps the flat fit vector back into the
    bath-params dict differentiably."""
    if cfg.bath_type == "replica":
        return _fit_pack_replica(cfg, b)
    names = {"superc": ["e", "d", "v"],
             "nonsu2": ["e", "v", "u"]}.get(cfg.ed_mode, ["e", "v"])
    shapes = {n: np.asarray(getattr(b, n)).shape for n in names}
    sizes = {n: int(np.prod(shapes[n])) for n in names}
    x0 = np.concatenate([np.asarray(getattr(b, n)).ravel() for n in names])

    def inject(xv):
        p = {}
        off = 0
        for n in names:
            p[n] = xv[off:off + sizes[n]].reshape(shapes[n])
            off += sizes[n]
        return p
    return x0, inject


def _fit_pack_replica(cfg: EDConfig, b):
    """Replica bath: the masked Re/Im elements of the upper triangle of h
    (in the combined spin-orbital index), one parameter per bath copy, then
    the real vr: x = [re-elems x nbath][im-elems x nbath][vr x nbath], the
    JAX package's fit layout (the user bath vector interleaves Re and Im
    per copy; pack_bath / unpack_bath convert)."""
    mask = b.mask
    idx_re, idx_im = [], []
    maxspin = 1 if (cfg.ed_para and cfg.ed_mode == "normal") else cfg.nspin
    for s in range(maxspin):
        for s2 in ([s] if cfg.ed_mode == "normal" else range(cfg.nspin)):
            for a in range(cfg.norb):
                for c in range(cfg.norb):
                    if a + s * cfg.norb > c + s2 * cfg.norb:
                        continue
                    if mask[s, s2, a, c, 0]:
                        idx_re.append((s, s2, a, c))
                    if mask[s, s2, a, c, 1]:
                        idx_im.append((s, s2, a, c))
    nb = cfg.nbath
    x0 = np.concatenate([b.h[e].real for e in idx_re]
                        + [b.h[e].imag for e in idx_im] + [b.vr.real])
    # one out-of-place scatter: flat position of each parameter in h
    shape = (cfg.nspin, cfg.nspin, cfg.norb, cfg.norb, nb)
    flat = [np.ravel_multi_index(e + (k,), shape)
            for e in idx_re + idx_im for k in range(nb)]
    nre = len(idx_re) * nb

    def inject(xv):
        pos = torch.as_tensor(np.asarray(flat, dtype=np.int64),
                              device=xv.device)
        re, im = xv[:nre], xv[nre:len(flat)]
        vals = torch.cat([torch.complex(re, torch.zeros_like(re)),
                          torch.complex(torch.zeros_like(im), im)])
        h = torch.zeros(int(np.prod(shape)), dtype=torch.complex128,
                        device=xv.device).index_add(0, pos, vals)
        vr = xv[len(flat):len(flat) + nb]
        return {"h": _herm_fill(cfg, h.reshape(shape)),
                "vr": vr.to(torch.complex128)}
    return x0, inject


def _herm_fill(cfg: EDConfig, h):
    """Fill the lower triangle of h (in combined spin-orbital space) from
    the upper triangle by hermiticity, and mirror the spin copies for
    ed_para; out of place, so autograd follows it."""
    nso = cfg.nspin * cfg.norb
    hso = h.permute(0, 2, 1, 3, 4).reshape(nso, nso, cfg.nbath)
    low = torch.tril(torch.ones(nso, nso, dtype=torch.bool,
                                device=h.device), -1)[..., None]
    hso = torch.where(low, hso.transpose(0, 1).conj(), hso)
    h = hso.reshape(cfg.nspin, cfg.norb, cfg.nspin, cfg.norb, cfg.nbath
                    ).permute(0, 2, 1, 3, 4)
    if cfg.ed_para and cfg.ed_mode == "normal" and cfg.nspin == 2:
        h = torch.stack([torch.stack([h[0, 0], h[0, 1]]),
                         torch.stack([h[1, 0], h[0, 0]])])
    return h


def _model(cfg: EDConfig, x, p, hloc, scheme):
    """Fit target functions per cg_scheme: (normal, anomalous-or-None)."""
    sc = cfg.ed_mode == "superc"
    if scheme == "weiss":
        return (g0and(cfg, x, p, hloc, "mats"),
                f0and(cfg, x, p, hloc, "mats") if sc else None)
    return delta(cfg, x, p, "mats"), fdelta(cfg, x, p, "mats") if sc else None


def _delta_target_from_weiss(cfg: EDConfig, g0, x, hloc) -> np.ndarray:
    """Δ_target = (z+mu) - Hloc - G0^{-1} componentwise/matrixwise."""
    out = np.zeros_like(g0)
    zmu = x + cfg.xmu
    if cfg.bath_type == "normal" and cfg.ed_mode != "nonsu2":
        for s in range(cfg.nspin):
            for a in range(cfg.norb):
                out[s, s, a, a] = zmu - hloc[s, s, a, a] - 1.0 / g0[s, s, a, a]
    elif cfg.ed_mode != "nonsu2":
        for s in range(cfg.nspin):
            m = g0[s, s].transpose(2, 0, 1)
            ig = np.linalg.inv(m).transpose(1, 2, 0)
            out[s, s] = (zmu[None, None, :] * np.eye(cfg.norb)[..., None]
                         - hloc[s, s][..., None] - ig)
    else:
        nso = cfg.nspin * cfg.norb
        L = g0.shape[-1]
        m = g0.transpose(4, 0, 2, 1, 3).reshape(L, nso, nso)
        ig = np.linalg.inv(m)
        hl = hloc.transpose(0, 2, 1, 3).reshape(nso, nso)
        d = zmu[:, None, None] * np.eye(nso)[None] - hl[None] - ig
        out = d.reshape(L, cfg.nspin, cfg.norb, cfg.nspin, cfg.norb
                        ).transpose(1, 3, 2, 4, 0)
    return out


def chi2_fitgf_sites(cfg: EDConfig, fgs, baths_flat, hlocs,
                     ispin: Optional[int] = None, iorb: Optional[int] = None,
                     fgs_an=None, masks=None, cfgs=None, suffixes=None,
                     log=None, save: bool = True,
                     precondition: bool = True, mesh=None,
                     device="cuda") -> np.ndarray:
    """Joint bath fit over N inequivalent sites (the lattice fit stage,
    ED_FIT_CHI2.f90 lattice variants).

    The per-site chi^2 problems are block-separable, so ONE L-BFGS-B run on
    the concatenated parameter vector reaches the same minima while every
    objective/gradient evaluation serves ALL sites in one autograd pass on
    `device` — iterations become max-over-sites instead of sum-over-sites
    (the reference distributes sites over MPI ranks and fits serially per
    rank, ED_FIT_CHI2.f90:187-225). A site whose joint fit clearly failed
    (chi^2 above 1e-3 of its weighted target norm) falls back to the
    single-site path with its jittered restarts.

    fgs: [S, Nspin, Nspin, Norb, Norb, L]; baths_flat: [S, Nb]; the
    sites' bath structures and replica masks must agree (ValueError
    otherwise).
    mesh: optional parallel.Mesh with a 'sites' axis that divides S (as in
    the reference, the fit stays whole otherwise) — each sites rank then
    evaluates its sites' objective terms and gradients, and every
    evaluation all-gathers them and sums them in the unsharded order, so
    every rank runs the same L-BFGS-B iterates as the unsharded fit (the
    mesh form of the reference's per-rank site fits,
    ED_FIT_CHI2.f90:187-225). The mesh's device replaces `device`.
    Returns the updated [S, Nb] bath stack; each site's bath is saved with
    its suffix (``<hfile>_ineq####.restart`` by default)."""
    from .device import resolve
    device = mesh.device if mesh is not None else resolve(device)
    S = len(baths_flat)
    cfgs = list(cfgs) if cfgs is not None else [cfg] * S
    masks = list(masks) if masks is not None else [None] * S
    suffixes = list(suffixes) if suffixes is not None \
        else [f"_ineq{i + 1:04d}" for i in range(S)]
    bs = [unpack_bath(cfgs[i], baths_flat[i], masks[i]) for i in range(S)]
    ldelta = min(cfg.lfit, fgs.shape[-1])
    xw = np.pi / cfg.beta * (2 * np.arange(1, ldelta + 1) - 1)
    xnp = 1j * xw
    x = torch.as_tensor(xnp, device=device)
    Wnp = _weights(cfg, ldelta)
    W = torch.as_tensor(Wnp, device=device)
    cmask_np = _component_mask(cfg, ispin, iorb, bs[0].mask)
    cmask = torch.as_tensor(cmask_np, device=device)
    tgts_np = np.stack([np.asarray(fgs[i])[..., :ldelta] for i in range(S)])
    tans_np = np.stack([np.asarray(fgs_an[i])[..., :ldelta]
                        for i in range(S)]) if fgs_an is not None else None
    tgts = torch.as_tensor(tgts_np, device=device)
    tgts_an = torch.as_tensor(tans_np, device=device) \
        if tans_np is not None else None

    # one inject for all sites — requires identical bath structure and
    # component mask across sites (the joint objective builds inject/cmask
    # from site 0); verify rather than silently mis-fit
    packs = [_fit_pack(cfg, bs[i]) for i in range(S)]
    inject = packs[0][1]
    n = packs[0][0].size
    for i in range(1, S):
        if packs[i][0].size != n:
            raise ValueError(
                f"chi2_fitgf_sites: site {i} bath pack size "
                f"{packs[i][0].size} != site 0 size {n}; per-site bath "
                "structures must match for the joint fit")
        mi, m0 = bs[i].mask, bs[0].mask
        if (mi is None) != (m0 is None) or \
                (mi is not None and not np.array_equal(np.asarray(mi),
                                                       np.asarray(m0))):
            raise ValueError(
                f"chi2_fitgf_sites: site {i} replica mask differs from "
                "site 0; per-site masks must match for the joint fit")
    x0 = np.concatenate([p[0] for p in packs])
    base_ps = [{k: torch.as_tensor(v, device=device) for k, v in
                {"e": b.e, "d": b.d, "v": b.v, "u": b.u, "h": b.h,
                 "vr": b.vr}.items() if v is not None} for b in bs]
    bnd = _param_bound(xw)

    def site_chi2(scheme, xv, i, targets, targets_an):
        p = dict(base_ps[i])
        p.update(inject(xv))
        G, F = _model(cfg, x, p, hlocs[i], scheme)
        r = (G - targets[i]) * cmask[..., None]
        c = torch.sum(torch.abs(r) ** 2 / W)
        if F is not None and targets_an is not None:
            ra = (F - targets_an[i]) * cmask[..., None]
            c = c + torch.sum(torch.abs(ra) ** 2 / W)
        return c + _box_penalty(xv, bnd)

    # the sites this rank evaluates: all, or its chunk of the sites axis
    split = sites_sharded(mesh) and S % mesh.shape["sites"] == 0
    mine = range(S)[site_chunk(mesh, S)] if split else range(S)

    def per_site(scheme, xmat, targets, targets_an):
        """[len(mine)] chi^2 of this rank's sites (xmat holds their rows)."""
        return torch.stack([site_chi2(scheme, xmat[j], i, targets,
                                      targets_an)
                            for j, i in enumerate(mine)])

    def gathered(x):
        return mesh.all_gather("sites", x) if split else x

    def make_joint(scheme, targets, targets_an):
        def fun(xflat):
            xall = np.asarray(xflat, dtype=np.float64).reshape(S, n)
            xmat = torch.tensor(xall[mine.start:mine.stop], device=device,
                                requires_grad=True)
            c_loc = per_site(scheme, xmat, targets, targets_an)
            torch.sum(c_loc).backward()
            # the gathered terms summed as the unsharded objective sums
            # them: one reduction over all S, in site order
            c = torch.sum(gathered(c_loc.detach()))
            return float(c), gathered(xmat.grad).cpu().numpy().ravel()
        return fun

    opts = {"maxiter": cfg.cg_niter, "ftol": cfg.cg_ftol * 1e-3,
            "gtol": 1e-12}
    if precondition and cfg.cg_scheme == "weiss" \
            and cfg.ed_mode != "superc":
        # two-stage weiss fit (see chi2_fitgf): the Δ-target
        # pre-conditioning pass, then the polish on the true weiss
        # objective; cold starts only inside a DMFT loop
        dts = np.stack([_delta_target_from_weiss(cfg, tgts_np[i], xnp,
                                                 hlocs[i])
                        for i in range(S)])
        fun_d = make_joint("delta", torch.as_tensor(dts, device=device),
                           None)
        x0 = minimize(fun_d, x0, jac=True, method="L-BFGS-B",
                      options=opts).x
    fun = make_joint(cfg.cg_scheme, tgts, tgts_an)
    res = minimize(fun, x0, jac=True, method="L-BFGS-B", options=opts)
    xmat = res.x.reshape(S, n)
    with torch.no_grad():
        per = gathered(per_site(
            cfg.cg_scheme, torch.as_tensor(xmat[mine.start:mine.stop],
                                           device=device),
            tgts, tgts_an)).cpu().numpy()
    # fallback threshold RELATIVE to the weighted target norm: at strong
    # coupling / small baths the true minimum routinely exceeds any
    # absolute cutoff, which would silently refit every site serially
    cm = cmask_np[..., None]
    tnorm = np.array([np.sum(np.abs(tgts_np[i] * cm) ** 2 / Wnp)
                      for i in range(S)])
    if tans_np is not None:
        tnorm += np.array([np.sum(np.abs(tans_np[i] * cm) ** 2 / Wnp)
                           for i in range(S)])
    thresh = 1e-3 * np.maximum(tnorm, 1e-6)
    out = np.empty_like(np.asarray(baths_flat))
    for i in range(S):
        if per[i] > thresh[i]:
            # failed joint fit for this site: single-site backstop
            out[i] = chi2_fitgf(cfgs[i], np.asarray(fgs[i]), baths_flat[i],
                                hlocs[i], ispin=ispin, iorb=iorb,
                                fg_an=None if fgs_an is None
                                else np.asarray(fgs_an[i]),
                                mask=masks[i], suffix=suffixes[i], log=log,
                                save=save, precondition=precondition,
                                device=device)
            continue
        b = bs[i]
        p_fit = inject(torch.as_tensor(xmat[i], device=device))
        for name, val in p_fit.items():
            setattr(b, name, val.detach().cpu().numpy())
        if log:
            log(f"chi^2|iter{suffixes[i]}=  {per[i]:.9E} | {res.nit}")
        try:
            with open(f"chi2fit_results{suffixes[i]}.ed", "a") as fh:
                fh.write(f"{per[i]:18.9E} {res.nit:5d}\n")
        except OSError:
            pass
        if save:
            save_bath(b, suffix=suffixes[i])
        out[i] = pack_bath(b)
    return out


def chi2_fitgf(cfg: EDConfig, fg, bath_flat: np.ndarray,
               hloc: np.ndarray, ispin: Optional[int] = None,
               iorb: Optional[int] = None, fg_an=None, mask=None,
               suffix: str = "", log=None, save: bool = True,
               precondition: bool = True, device="cuda") -> np.ndarray:
    """Fit the bath to the target function fg [Nspin,Nspin,Norb,Norb,Lmats]
    (Weiss field if cg_scheme='weiss', hybridization Δ if 'delta';
    fg_an: the anomalous target for ed_mode='superc').

    precondition: run the Δ-target pre-conditioning pass before the weiss
    polish — True only on the FIRST (cold-start) fit of a DMFT loop, as in
    the reference port (EDSolver.chi2_fitgf passes it). Normal mode only:
    the superc fit starts on the weiss objective, as the reference's does.

    Returns the updated flat bath vector (ed_chi2_fitgf)."""
    b = unpack_bath(cfg, bath_flat, mask)
    ldelta = min(cfg.lfit, fg.shape[-1])
    xw = np.pi / cfg.beta * (2 * np.arange(1, ldelta + 1) - 1)
    xnp = 1j * xw
    x = torch.as_tensor(xnp, device=device)
    Wnp = _weights(cfg, ldelta)
    W = torch.as_tensor(Wnp, device=device)
    cmask_np = _component_mask(cfg, ispin, iorb, b.mask)
    cmask = torch.as_tensor(cmask_np, device=device)
    tgt_np = np.asarray(fg)[..., :ldelta]
    tgt = torch.as_tensor(tgt_np, device=device)
    tan_np = np.asarray(fg_an)[..., :ldelta] if fg_an is not None else None
    tgt_an = torch.as_tensor(tan_np, device=device) \
        if tan_np is not None else None

    x0, inject = _fit_pack(cfg, b)
    base_p = {k: torch.as_tensor(v, device=device) for k, v in
              {"e": b.e, "d": b.d, "v": b.v, "u": b.u, "h": b.h,
               "vr": b.vr}.items() if v is not None}

    def make_obj(target, target_an, scheme):
        def fun(xv_np):
            xv = torch.tensor(np.asarray(xv_np, dtype=np.float64),
                              device=device, requires_grad=True)
            p = dict(base_p)
            p.update(inject(xv))
            G, F = _model(cfg, x, p, hloc, scheme)
            r = (G - target) * cmask[..., None]
            c = torch.sum(torch.abs(r) ** 2 / W)
            if F is not None and target_an is not None:
                ra = (F - target_an) * cmask[..., None]
                c = c + torch.sum(torch.abs(ra) ** 2 / W)
            c = c + _box_penalty(xv, bnd)
            c.backward()
            return float(c.detach()), xv.grad.cpu().numpy()
        return fun

    opts = {"maxiter": cfg.cg_niter, "ftol": cfg.cg_ftol * 1e-3,
            "gtol": 1e-12}
    bnd = _param_bound(xw)

    if precondition and cfg.cg_scheme == "weiss" \
            and cfg.ed_mode != "superc":
        # two stages (see the reference's chi2_fitgf): pre-condition on the
        # exactly-equivalent, collapse-free Δ target, then polish on the
        # true weiss objective from that basin
        dt = _delta_target_from_weiss(cfg, tgt_np, xnp, hloc)
        pre = minimize(make_obj(torch.as_tensor(dt, device=device), None,
                                "delta"),
                       x0, jac=True, method="L-BFGS-B", options=opts)
        x0 = pre.x
    fun = make_obj(tgt, tgt_an, cfg.cg_scheme)
    res = minimize(fun, x0, jac=True, method="L-BFGS-B", options=opts)
    # jittered restarts only as a backstop against clearly-failed fits,
    # "clearly" RELATIVE to the weighted target norm (reference semantics)
    tnorm = float(np.sum(np.abs(tgt_np * cmask_np[..., None]) ** 2 / Wnp))
    if tan_np is not None:
        tnorm += float(np.sum(np.abs(tan_np * cmask_np[..., None]) ** 2
                              / Wnp))
    if res.fun > 1e-3 * max(tnorm, 1e-6):
        rng = np.random.default_rng(cfg.seed + 101)
        best = res
        for _ in range(3):
            scale = np.clip(np.abs(best.x), 0.5, 2.0)
            x0j = np.clip(best.x + rng.normal(size=x0.shape) * scale * 0.5,
                          -bnd, bnd)
            r2 = minimize(fun, x0j, jac=True, method="L-BFGS-B",
                          options=opts)
            if r2.fun < best.fun:
                best = r2
            if best.fun <= 1e-9:
                break
        if best.fun < 0.7 * res.fun:
            res = best
    p_fit = inject(torch.as_tensor(res.x, device=device))
    for name, val in p_fit.items():
        setattr(b, name, val.detach().cpu().numpy())
    if log:
        log(f"chi^2|iter{suffix}=  {res.fun:.9E} | {res.nit}")
    try:
        with open(f"chi2fit_results{suffix}.ed", "a") as fh:
            fh.write(f"{res.fun:18.9E} {res.nit:5d}\n")
    except OSError:
        pass
    if save:
        save_bath(b, suffix=suffix)
    return pack_bath(b)
