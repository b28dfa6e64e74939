"""Multilinear FEM hat shape functions on the structured background grid.

Counterpart of ``nlpartsol_tpu/shapefun/fem.py`` (the structured-grid
counterpart of the reference's Q4/H8 isoparametric elements).  On a regular
Cartesian grid the isoparametric map is affine, so N and ∇N are closed-form
products of 1D hats over the 2^d corners of the particle's cell: no λ, no
Newton inversion.  The arithmetic is the JAX package's, step for step (the
clip, the guarded divide for the product over the other axes, −sign(t)/h).
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import Grid
from .window import window_nodes, window_offsets


def offsets_for(dim: int) -> np.ndarray:
    return window_offsets(dim, 0, 1)  # the 2^d cell corners


def evaluate(grid: Grid, x: torch.Tensor) -> dict:
    """Multilinear N (Np, K) and ∇N (Np, K, d), K = 2^d; the same dict as
    ``lme.evaluate`` with ``lam`` None."""
    offs = offsets_for(grid.dim)
    node_ids, rel, mask = window_nodes(grid, x, offs)
    h = grid.spacing
    # t = (x_p − x_node)/h ∈ [0, 1] for the lower corner, [−1, 0] the upper
    t = rel / h
    n1d = torch.clamp(1.0 - torch.abs(t), 0.0, 1.0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    N = torch.where(mask, torch.prod(n1d, dim=-1), zero)
    # ∂_i Π_j n1d_j = −sign(t_i)/h · Π_{j≠i} n1d_j
    dsign = -torch.sign(t) / h
    prod_except = N[..., None] / torch.where(n1d > 0.0, n1d, torch.ones_like(n1d))
    dN = torch.where(mask[..., None], dsign * prod_except, zero)
    return dict(node_ids=node_ids, N=N, dN=dN, mask=mask, lam=None)
