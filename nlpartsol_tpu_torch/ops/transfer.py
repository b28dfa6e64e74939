"""Particle↔grid transfer engine behind one interface.

Counterpart of ``nlpartsol_tpu/ops/transfer.py``, two backends behind one
interface:

* ``scatter`` — segment sums and gathers over the padded (Np, K) pattern
  (ops/sparse.py), in particle order: any particle order, no slot layout;
  the engine of the reference binary's DEM goldens.
* ``windowed`` — the structured-grid engine (ops/windowed.py): cell-binned
  slot layout plus static-slice dense adds.

The steps build one engine per step after shape-function evaluation and
express every transfer through it:
  p2g(vals)         (Np,K[,c]) per-edge values → (n_nodes[,c])
  g2p(weights, f)   Σ_k w·f[node_k]           → (Np[,c])
  edge_gather(f)    f[node_k] per edge        → (Np,K,c)  (for ΔF assembly)

With ``axis_name`` (a :class:`~..parallel.collectives.Comm`) the particles
are split over ranks and the grid replicated: every P2G is summed over the
group.  :class:`HaloEngine` is the windowed engine on a rank's strip of a
block-partitioned grid (parallel/domain.py).
"""

from __future__ import annotations

import numpy as np
import torch

from . import sparse, windowed
from ..types import Grid


class ScatterEngine:
    """On a Grid or a FEMesh (any background with ``n_nodes``).  The node
    ids are widened to int64 once here, not in every transfer."""

    def __init__(self, grid, node_ids, mask, axis_name=None):
        self.grid = grid
        self.ids = node_ids.long()
        self.mask = mask
        self.axis_name = axis_name

    def p2g(self, vals):
        return sparse.p2g(self.ids, self.mask, vals, self.grid.n_nodes, axis_name=self.axis_name)

    def g2p(self, weights, field):
        return sparse.g2p(self.ids, self.mask, weights, field)

    def edge_gather(self, field):
        g = field[self.ids]  # (Np, K[, c])
        m = self.mask if g.ndim == 2 else self.mask[..., None]
        return torch.where(m, g, torch.zeros((), dtype=g.dtype, device=g.device))


class WindowedEngine:
    def __init__(self, grid: Grid, box: windowed.ActiveBox, offsets: np.ndarray, mask,
                 axis_name=None):
        self.grid = grid
        self.box = box
        self.offsets = offsets
        self.mask = mask
        self.axis_name = axis_name

    def _m(self, vals):
        m = self.mask if vals.ndim == 2 else self.mask[..., None]
        return torch.where(m, vals, torch.zeros_like(vals))

    def p2g(self, vals):
        return windowed.p2g(self._m(vals), self.box, self.grid, self.offsets,
                            axis_name=self.axis_name)

    def g2p(self, weights, field):
        return windowed.g2p(field, self._m(weights), self.box, self.grid, self.offsets)

    def edge_gather(self, field):
        box = self.box
        per_cell = windowed.cell_edge_field(field, box, self.grid, self.offsets)
        nc = box.n_cells
        K = self.offsets.shape[0]
        c = per_cell.shape[-1]
        # every slot in a cell sees the same K node values: broadcast over C
        # (capacity-major slots: leading C axis)
        out = per_cell.reshape((1, nc, K, c)).expand(box.capacity, nc, K, c)
        return self._m(out.reshape(box.n_slots, K, c))


class HaloEngine(WindowedEngine):
    """The windowed engine on a rank's strip of a block-partitioned grid
    (parallel/domain.py): P2G completes the owned planes by the
    neighbours' halo adds, G2P and edge gathers fill the ghost planes first.
    Every node vector it returns is owned-complete and ghost-zero, so a
    global sum is an all-reduce of local ones."""

    def __init__(self, grid: Grid, box, offsets, mask, halo):
        super().__init__(grid, box, offsets, mask)
        self.halo = halo

    def p2g(self, vals):
        from ..parallel import domain

        return domain.halo_exchange_add(super().p2g(vals), self.halo)

    def g2p(self, weights, field):
        from ..parallel import domain

        return super().g2p(weights, domain.halo_fill(field, self.halo))

    def edge_gather(self, field):
        from ..parallel import domain

        return super().edge_gather(domain.halo_fill(field, self.halo))
