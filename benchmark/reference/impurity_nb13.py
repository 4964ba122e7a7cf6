"""Plain reference of one sector of the single-band Anderson impurity:
the sector's operator from its own Fock basis (``fock.Sector``), its
lowest eigenvalue by the plain three-term Lanczos recurrence, and the
residual of a given eigenpair.

The operator acts as ``H V = D * V + H_dw @ V + V @ H_up^T`` on
``V[i_dw, i_up]`` with dense float64 matrices; on the card the products
are plain ``torch.matmul`` in float64. It imports neither jax nor either
solver package.
"""

from __future__ import annotations

import numpy as np
import torch

from .fock import Sector


class SectorOperator:
    def __init__(self, e, v, u: float, nup: int, ndw: int, device,
                 mu: float = 0.0):
        sec = Sector(e, v, u, nup, ndw, mu)
        self.shape = sec.shape
        self.dim = sec.dim
        self.device = torch.device(device)
        f64 = dict(dtype=torch.float64, device=self.device)
        self.h_up_t = torch.as_tensor(sec.h_up.T.copy(), **f64)
        self.h_dw = torch.as_tensor(sec.h_dw, **f64)
        self.diag = torch.as_tensor(sec.diag, **f64)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        X = x.reshape(self.shape)
        return (self.diag * X + self.h_dw @ X + X @ self.h_up_t).reshape(-1)

    def lowest_eigenvalue(self, rng, max_steps: int = 1500,
                          every: int = 10, rtol: float = 1e-15) -> float:
        """The lowest eigenvalue: plain Lanczos (no reorthogonalization,
        which leaves the extreme Ritz value exact) from a random start,
        stopped when the lowest Ritz value moves by less than rtol*|e|
        over `every` steps twice running."""
        x = torch.as_tensor(rng.standard_normal(self.dim),
                            dtype=torch.float64, device=self.device)
        v = x / torch.linalg.vector_norm(x)
        v_prev = torch.zeros_like(v)
        b = 0.0
        alphas, betas = [], []
        last, calm = None, 0
        for j in range(max_steps):
            w = self.matvec(v)
            a = torch.dot(v, w)
            w = w - a * v - b * v_prev
            bn = torch.linalg.vector_norm(w)
            alphas.append(a)
            betas.append(bn)
            v_prev, v = v, w / bn
            b = bn
            if (j + 1) % every:
                continue
            al = torch.stack(alphas).cpu().numpy()
            be = torch.stack(betas).cpu().numpy()[:-1]
            t = np.diag(al) + np.diag(be, 1) + np.diag(be, -1)
            e0 = float(np.linalg.eigvalsh(t)[0])
            if last is not None and abs(e0 - last) <= rtol * abs(e0):
                calm += 1
                if calm == 2:
                    return e0
            else:
                calm = 0
            last = e0
        raise RuntimeError("reference Lanczos did not settle")

    def residual(self, vec: torch.Tensor, egs: float) -> float:
        """|H x - egs x| of the normalized float64 copy x of `vec`."""
        x = vec.to(device=self.device, dtype=torch.float64).reshape(-1)
        x = x / torch.linalg.vector_norm(x)
        return float(torch.linalg.vector_norm(self.matvec(x) - egs * x))
