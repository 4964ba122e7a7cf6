"""The ``(sites, rows)`` process mesh on torch.distributed — port of
dmft_ed_tpu/parallel/mesh.py.

One process per rank, every rank running the same driver code on the same
host data (the reference's MPI model): each rank returns the whole,
replicated result, so a DMFT loop runs unchanged on every rank.

  * ``rows``  : the partition of each sector vector's down-spin (row)
    index, the reference's 1-D MPI row split (ED_HAMILTONIAN.f90:56-62);
    a matvec all-gathers the vector's blocks, the reference's AllGatherv
    SpMV (ED_HAMILTONIAN_STORED_HxV.f90:163-196), and Krylov dot products
    are all-reduced over the rows group.
  * ``sites`` : the distribution of inequivalent impurity sites (and of
    the members of a stacked restart) over ranks, the reference's site
    loop over MPI ranks (ED_MAIN.f90:576-678).

Collectives are ``all_gather`` and ``all_reduce``, and the broadcast of
what rank 0 reads back from its own files (``from_rank0``), which both
NCCL and gloo carry. The backend is whatever the caller gave
``init_process_group``: NCCL where each rank has its own card, gloo on the
CPU or for ranks that share one card. Under gloo, a collective on CUDA
tensors goes through host copies.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

AXES = ("sites", "rows")


class Mesh:
    """What the solvers read of the mesh: ``shape[axis]``, this rank's
    ``coord[axis]``, each axis's process ``group``, and the ``device``
    this rank's tensors live on."""

    def __init__(self, device_mesh, device):
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        self.shape = {a: device_mesh.size(i) for i, a in enumerate(AXES)}
        self.coord = dict(zip(AXES, device_mesh.get_coordinate()))
        self.group = {a: device_mesh.get_group(a) for a in AXES}
        self.backend = dist.get_backend()
        # gloo's collectives are run on host tensors
        self._host = self.backend == "gloo" and self.device.type == "cuda"

    # ------------------------------------------------------------------
    def all_gather(self, axis: str, x, dim: int = 0):
        """The ranks' equally shaped tensors `x` of one `axis`,
        concatenated along `dim` in rank (coordinate) order."""
        if self.shape[axis] == 1:
            return x
        src = x.detach().contiguous()
        if self._host:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.shape[axis])]
        dist.all_gather(parts, src, group=self.group[axis])
        out = torch.cat(parts, dim=dim)
        return out.to(x.device) if self._host else out

    def all_reduce(self, axis: str, x, op=dist.ReduceOp.SUM):
        """`x` reduced over one `axis` (a new tensor; `x` is unchanged)."""
        if self.shape[axis] == 1:
            return x
        buf = x.detach().clone()
        if self._host:
            buf = buf.cpu()
        dist.all_reduce(buf, op=op, group=self.group[axis])
        return buf.to(x.device) if self._host else buf


def make_mesh(n_rows: Optional[int] = None, n_sites: int = 1,
              device="cuda") -> Mesh:
    """The ``(sites, rows)`` mesh over every rank of the default process
    group (``torch.distributed.init_process_group`` must have run):
    n_sites x n_rows ranks, n_rows = world size // n_sites by default.
    `device` is where this rank's tensors live ("cuda" for the current
    card, "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh: call torch.distributed."
                           "init_process_group first (one process per rank)")
    world = dist.get_world_size()
    if n_rows is None:
        n_rows = world // n_sites
    if n_sites * n_rows != world:
        raise ValueError(f"make_mesh: sites={n_sites} x rows={n_rows} != "
                         f"world size {world}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = dist.get_backend()
    dm = init_device_mesh(dev.type, (n_sites, n_rows), mesh_dim_names=AXES,
                          backend_override={a: backend for a in AXES})
    return Mesh(dm, dev)


def row_slice(mesh: Optional[Mesh], n: int) -> slice:
    """The rows of an n-row (padded, a multiple of the rows axis) block
    that this rank owns: the port of row_sharding's P('rows', None)."""
    if mesh is None or mesh.shape["rows"] == 1:
        return slice(0, n)
    nr = mesh.shape["rows"]
    if n % nr:
        raise ValueError(f"row_slice: {n} rows do not split over {nr} ranks")
    r = mesh.coord["rows"]
    return slice(r * (n // nr), (r + 1) * (n // nr))


def site_chunk(mesh: Optional[Mesh], n: int) -> slice:
    """The members of an n-member stack (padded to a multiple of the sites
    axis) that this rank's sites coordinate owns: P('sites', ...)."""
    if mesh is None or mesh.shape["sites"] == 1:
        return slice(0, n)
    ns = mesh.shape["sites"]
    if n % ns:
        raise ValueError(f"site_chunk: {n} members do not split over {ns}")
    s = mesh.coord["sites"]
    return slice(s * (n // ns), (s + 1) * (n // ns))


def _axis_split(mesh, axis: str) -> bool:
    if mesh is None:
        return False
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (make_mesh), not "
                        f"{type(mesh).__name__}")
    return mesh.shape[axis] > 1


def writes_files(mesh: Optional[Mesh]) -> bool:
    """Whether this rank writes the solver's output files: always without
    a mesh (independent solves, even inside a process group, keep every
    file), and only on the mesh's global rank 0 with one — the reference
    writes on the MPI master only. Every rank still returns the whole
    result and reads rank 0's files through `from_rank0`, so the ranks of
    a mesh may share one working directory."""
    if mesh is None:
        return True
    return dist.get_rank() == 0


def from_rank0(mesh: Optional[Mesh], read):
    """``read()`` on the mesh's global rank 0, its value (or its exception)
    broadcast to every rank; without a mesh, ``read()`` here. Every rank of
    a mesh calls it at the same point: a file that rank 0 alone wrote is
    then read back the same on every rank, whether the ranks share one
    working directory or have one each."""
    if mesh is None or dist.get_world_size() == 1:
        return read()
    box = [None]
    if dist.get_rank() == 0:
        try:
            box[0] = (True, read())
        except Exception as exc:        # raised on every rank below
            box[0] = (False, exc)
    dist.broadcast_object_list(box, src=0)
    ok, value = box[0]
    if not ok:
        raise value
    return value


def sites_sharded(mesh: Optional[Mesh]) -> bool:
    """Whether `mesh` splits work over more than one sites rank."""
    return _axis_split(mesh, "sites")


def rows_sharded(mesh: Optional[Mesh]) -> bool:
    """Whether `mesh` splits sector rows over more than one rank."""
    return _axis_split(mesh, "rows")
