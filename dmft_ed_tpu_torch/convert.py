"""Carrying a run's state between the JAX reference and the port.

The port's "weights" are the run's state: its configuration, the flat bath
vector (a [Nineq, Nb] stack of them for inequivalent sites), and the
reference-format text files (``<hfile>.restart`` bath restarts, one
``<hfile>_ineq####.restart`` per inequivalent site, and the ``.ed``
outputs). The flat bath vector has the same
layout in both packages and passes between them as a numpy array. The file formats are shared code (the
copied bath.py / io.py), so a file the reference writes reads back here and
the port writes byte-identical ones.

Nothing here imports the reference package: a reference ``EDConfig`` is
read through its dataclass fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .bath import Bath, load_bath, pack_bath, save_bath, unpack_bath
from .config import EDConfig


def config_from_reference(cfg) -> EDConfig:
    """The port's EDConfig from a reference EDConfig or its
    ``dataclasses.asdict``. Raises on a field the port does not know."""
    d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) \
        else dict(cfg)
    known = {f.name for f in dataclasses.fields(EDConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"config_from_reference: unknown fields {unknown}")
    if "uloc" in d:
        d["uloc"] = tuple(d["uloc"])
    return EDConfig(**d).validate()


def _need_mask(cfg: EDConfig, mask) -> None:
    if cfg.bath_type == "replica" and mask is None:
        raise ValueError("a replica bath's flat vector holds only its "
                         "masked elements: pass mask=bath.replica_mask("
                         "cfg, hloc), as EDSolver builds it")


def read_bath_restart(cfg: EDConfig, path: str, mask=None) -> np.ndarray:
    """Flat bath vector from a reference ``<hfile>.restart`` file (a replica
    bath needs its fit mask)."""
    _need_mask(cfg, mask)
    b = Bath(cfg)
    if mask is not None:
        b.mask = mask
    load_bath(b, path)
    return pack_bath(b)


def write_bath_restart(cfg: EDConfig, flat: np.ndarray, path: str,
                       mask=None) -> None:
    """Write a flat bath vector as a reference-format restart file."""
    _need_mask(cfg, mask)
    save_bath(unpack_bath(cfg, flat, mask), path=path)


def _ineq_path(cfg: EDConfig, i: int, hfile=None) -> str:
    return f"{hfile or cfg.hfile}_ineq{i + 1:04d}.restart"


def read_bath_stack(cfg: EDConfig, nineq: int, masks=None,
                    hfile=None) -> np.ndarray:
    """[Nineq, Nb] bath stack from the per-site restart files
    ``<hfile>_ineq####.restart`` (site i -> ``_ineq{i+1:04d}``), as the
    lattice solvers of both packages write them; `masks`: one replica mask
    per site (or None)."""
    masks = [None] * nineq if masks is None else list(masks)
    return np.stack([read_bath_restart(cfg, _ineq_path(cfg, i, hfile),
                                       mask=masks[i])
                     for i in range(nineq)])


def write_bath_stack(cfg: EDConfig, baths: np.ndarray, masks=None,
                     hfile=None) -> None:
    """Write a [Nineq, Nb] bath stack as the per-site restart files
    ``<hfile>_ineq####.restart`` that LatticeEDSolver.init_solvers reads
    back."""
    masks = [None] * len(baths) if masks is None else list(masks)
    for i, flat in enumerate(baths):
        write_bath_restart(cfg, flat, _ineq_path(cfg, i, hfile),
                           mask=masks[i])
