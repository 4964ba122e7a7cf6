"""The least work of a sector operator's mix terms (spin exchange and pair
hopping), fixed by the terms and not by the code that applies them.

Each mix term maps some entries of the sector vector V to entries of the
result Y with a coefficient and a sign. Whatever the encoding (dense
per-spin products, gathers, a kernel), one H·v has to read each entry of V
that some term reads and write each entry of Y that some term writes; the
least bytes are 8 (float64) times the distinct entries of each, once. The
entries are counted from the terms' nonzero pattern in the plain
reference's own basis (``reference/<config>.py``, ``mix_gathers``).
"""

from __future__ import annotations

import numpy as np

from benchmark.roofline import peaks


def mix_bytes(gathers, dim: int, itemsize: int = 8) -> int:
    """The least bytes one application of the terms moves: `itemsize` x
    (the distinct source entries + the distinct destination entries) over
    [(src, dst, weight)] of flat indices into a sector of `dim` states."""
    seen = 0
    for k in (0, 1):
        hit = np.zeros(dim, dtype=bool)
        for g in gathers:
            hit[g[k]] = True
        seen += int(hit.sum())
    return itemsize * seen


def mix_bound_s(nbytes: int, kind: str) -> float:
    """The least seconds of one application on the card named `kind`: its
    bytes at the card's memory bandwidth."""
    return nbytes / peaks(kind)["hbm_bytes_per_s"]
