"""Sparse particle↔grid transfer core.

Counterpart of ``nlpartsol_tpu/ops/sparse.py``: the particle-to-grid
pattern of the shape functions is a padded (Np, K) block of node ids with a
mask; P2G is a segment sum of the masked edge values into their nodes, in
particle order, and G2P its transpose, a gather and a contraction.  The
grid-partitioned ``axis_name`` of the JAX package waits for ROADMAP.md
queue 1, item 15.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def p2g(node_ids: Tensor, mask: Tensor, vals: Tensor, n_nodes: int) -> Tensor:
    """Scatter-add edge contributions (Np, K[, c]) to grid nodes: returns
    (n_nodes[, c])."""
    m = mask if vals.ndim == 2 else mask[..., None]
    flat = torch.where(m, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    flat = flat.reshape((-1,) + tuple(vals.shape[2:]))
    out = torch.zeros((n_nodes,) + tuple(vals.shape[2:]), dtype=vals.dtype, device=vals.device)
    return out.index_add(0, node_ids.reshape(-1).long(), flat)


def g2p(node_ids: Tensor, mask: Tensor, weights: Tensor, field: Tensor) -> Tensor:
    """Gather a grid field to particles: out_p = Σ_a w_pa·field[ids_pa];
    (Np[, c])."""
    gathered = field[node_ids.long()]  # (Np, K[, c])
    w = torch.where(mask, weights, torch.zeros((), dtype=weights.dtype, device=weights.device))
    if field.ndim == 1:
        return torch.sum(w * gathered, dim=-1)
    return torch.einsum("pk,pkc->pc", w, gathered)


def nnz(mask: Tensor) -> Tensor:
    """Number of nonzeros in the current pattern (for nnz/s accounting);
    a 0-dim int32 tensor on the mask's device."""
    return torch.sum(mask, dtype=torch.int32)
