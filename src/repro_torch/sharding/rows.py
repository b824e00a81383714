"""Row blocks of the client axis: what a rank of the client mesh holds of
an (N, ...) client table (rows ``row0 .. row0 + n_loc``), and the helpers
the row-block code shares."""
from __future__ import annotations

import torch

from . import collectives as _coll


def first_row(mesh, client_axes, n_loc: int) -> int:
    """The global row where this rank's block of ``n_loc`` rows starts:
    0 without a mesh."""
    if mesh is None:
        return 0
    return _coll.shard_index(mesh, client_axes) * n_loc


def eye_rows(m: int, n: int, row0: int = 0, device=None) -> torch.Tensor:
    """(m, n) bool: row r is one-hot at column ``row0 + r``, the diagonal
    of the (m, n) row block of an (n, n) matrix that starts at row
    ``row0``."""
    rows = torch.arange(row0, row0 + m, device=device)
    return torch.arange(n, device=device)[None, :] == rows[:, None]


def mesh_kw(mesh, client_axes) -> dict:
    """The ``mesh=`` / ``client_axes=`` keywords of a `kernels.ops` call:
    none on one device, so such a call keeps its one-device signature."""
    return {} if mesh is None else dict(mesh=mesh, client_axes=client_axes)
