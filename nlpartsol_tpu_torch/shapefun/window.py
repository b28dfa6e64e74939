"""Arithmetic neighborhood windows on the structured background grid.

Counterpart of ``nlpartsol_tpu/shapefun/window.py``.  On a structured grid
the candidate support of a particle is a static ``(2W+1)^d`` window of node
multi-indices around its cell — computed arithmetically, padded to a static
``K``, and masked.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..types import Grid


def window_offsets(dim: int, lo: int, hi: int) -> np.ndarray:
    """All integer offset vectors in [lo, hi]^dim, shape (K, dim), C-order."""
    rng = np.arange(lo, hi + 1)
    mesh = np.meshgrid(*([rng] * dim), indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=-1).astype(np.int32)


def window_nodes(grid: Grid, x: torch.Tensor, offsets: np.ndarray):
    """Candidate support nodes for particles at ``x``.

    Args:
      grid: background grid.
      x: (Np, d) particle positions.
      offsets: (K, d) static integer window offsets relative to the cell.

    Returns:
      node_ids: (Np, K) int32 flat node ids (clamped in-bounds; use mask).
      rel: (Np, K, d) l = x_p - x_node.
      mask: (Np, K) bool — offset lands inside the grid (and node active).
    """
    dev = x.device
    offs = torch.as_tensor(offsets, device=dev)
    cell = grid.cell_of(x)  # (Np, d)
    dims = torch.tensor(grid.dims, dtype=cell.dtype, device=dev)
    # Clamp the cell so boundary/outside particles still index validly.
    cell = torch.minimum(torch.clamp(cell, min=0), dims - 2)
    multi = cell[:, None, :] + offs[None, :, :]  # (Np, K, d)
    inb = torch.all((multi >= 0) & (multi < dims), dim=-1)
    multi_c = torch.minimum(torch.clamp(multi, min=0), dims - 1)
    node_ids = grid.flat_index(multi_c)
    node_pos = multi_c.to(x.dtype) * grid.spacing + torch.tensor(
        grid.origin, dtype=x.dtype, device=dev
    )
    rel = x[:, None, :] - node_pos
    mask = inb
    if grid.valid_lo is not None or grid.valid_hi is not None:
        # local grid strip: mask phantom planes beyond the global grid edge
        # so the basis renormalises exactly as the whole grid would at its
        # boundary
        lo, hi = grid.valid_bounds()
        vlo = torch.tensor(lo, dtype=multi.dtype, device=dev)
        vhi = torch.tensor(hi, dtype=multi.dtype, device=dev)
        mask = mask & torch.all((multi >= vlo) & (multi <= vhi), dim=-1)
    if grid.active is not None:
        mask = mask & grid.active[node_ids.long()]
    return node_ids.to(config.index_dtype()), rel, mask
