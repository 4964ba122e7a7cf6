"""The ``(sites, rows)`` mesh on torch.distributed and the row-sharded
sector solve (port of dmft_ed_tpu/parallel/)."""

from .mesh import Mesh, make_mesh, row_slice
from .hxv import sharded_sector_op, solve_sector_sharded

__all__ = ["Mesh", "make_mesh", "row_slice", "sharded_sector_op",
           "solve_sector_sharded"]
