"""The cell tiles of the 2D scatter kernel (``lme_scatter2d``): the plan of
``ops/fused_transfer.py::tile_plan`` walked with the kernel's own index
arithmetic.  Every box cell falls in exactly one tile, and every slot of a
tile in exactly one of its block's items, every window node of a tile's
cells falls in that tile's shared-memory footprint, and the planned shared
memory fits a block or the plan raises.  No JAX and no kernel
run here: the plan is host code, checked on the CPU."""

import numpy as np
import pytest

from nlpartsol_tpu_torch.ops import fused_transfer as ft
from nlpartsol_tpu_torch.shapefun import lme
from nlpartsol_tpu_torch.types import Grid

PARAMS = lme.LMEParams(gamma=3.0)


def _window(margin):
    grid = Grid(dims=(64, 64), spacing=1.0 / 63, origin=(0.0, 0.0))
    return ft._geom(grid, PARAMS, margin)


def _tiles(plan, cdims):
    """Per block: its first box cell and its (t0·t1, 2) in-box cells, as
    ``lme_scatter2d_kernel`` computes them from blockIdx and the plan."""
    t, (q0, q1) = plan.tile, plan.counts
    local = np.stack(np.meshgrid(*[np.arange(n) for n in t], indexing="ij"), -1).reshape(-1, 2)
    for b in range(q0 * q1):
        a = np.array([b // q1, b % q1]) * t
        cells = a + local
        yield a, cells[np.all(cells < np.asarray(cdims), axis=1)]


def _items(plan, cdims, a, capacity):
    """A block's items as the kernel walks them: (rank, cell) of every
    in-box item."""
    tc = plan.tile[0] * plan.tile[1]
    k = np.arange(capacity * tc)
    rank, lc = k // tc, k % tc
    cells = a + np.stack([lc // plan.tile[1], lc % plan.tile[1]], -1)
    keep = np.all(cells < np.asarray(cdims), axis=1)
    return rank[keep], cells[keep]


# boxes and their tiles: the 2D main path (512² grid), the `large` leg
# (2048²), chip_smoke.py's small kernel boxes (ragged 37×53, 24²) and a box
# one cell thin; the default tile cut to the box, axis 0 halved while the
# box has fewer than MIN_TILES tiles
TILES = {(260, 260): (4, 8), (1028, 1028): (4, 8), (37, 53): (2, 8), (24, 24): (2, 8),
         (1, 24): (1, 8)}


@pytest.mark.parametrize("cdims", list(TILES), ids=lambda c: "x".join(map(str, c)))
def test_tile_plan_covers_every_cell_once(cdims):
    plan = ft.tile_plan(cdims, _window(1).offsets, 3)
    hits = np.zeros(cdims, np.int32)
    capacity = 6
    tiles = list(_tiles(plan, cdims))
    for a, cells in tiles:
        np.add.at(hits, tuple(cells.T), 1)
    # the first tile, and the last (ragged where the box is): every (rank,
    # cell) of the tile in one item
    for a, cells in (tiles[0], tiles[-1]):
        rank, item_cells = _items(plan, cdims, a, capacity)
        assert len(rank) == len({(r, *c) for r, c in zip(rank, item_cells)})
        assert len(rank) == len(cells) * capacity
    assert hits.min() == hits.max() == 1
    assert plan.tile == TILES[cdims]
    assert plan.counts == tuple(-(-c // t) for c, t in zip(cdims, plan.tile))


@pytest.mark.parametrize("margin", [0, 1])
def test_every_window_node_lies_in_its_tiles_footprint(margin):
    g = _window(margin)
    offs = np.asarray(g.offsets)
    # the kernels' window is the same offsets as rows (o0 fixed, o1 rising
    # by one), the rows nearest-first from the cell centre
    kern = np.asarray(list(g.offs_c)).reshape(-1, 2)
    assert sorted(map(tuple, kern)) == sorted(g.offsets)
    assert len(kern) == (32, 60)[margin]
    rows = np.split(kern, np.flatnonzero(np.diff(kern[:, 0]) != 0) + 1)
    assert len(rows) == len({o[0] for o in g.offsets}) == (6, 8)[margin]
    assert all(np.all(np.diff(r[:, 1]) == 1) for r in rows)
    dist = [(r[0, 0] - 0.5) ** 2 for r in rows]
    assert np.all(np.diff(dist) >= 0) and rows[0][0, 0] == 0
    for cdims in [(37, 53), (1, 24), (260, 260)]:
        plan = ft.tile_plan(cdims, g.offsets, 3)
        assert plan.lo == tuple(offs.min(0))
        assert plan.footprint == tuple(np.asarray(plan.tile) + offs.max(0) - offs.min(0))
        for a, cells in _tiles(plan, cdims):
            rel = cells[:, None, :] + offs[None, :, :] - (a + np.asarray(plan.lo))
            assert rel.min() >= 0
            assert np.all(rel < np.asarray(plan.footprint))


def test_shared_bytes_fit_a_block_or_the_plan_raises():
    """cout 1-11 (up to 8 N-weighted channels, G and gnorm) at margins 0
    and 1: the 4×8 tile's footprint sums fit the 227 KB a block may use (at
    most 7,260 bytes); a footprint too large for them raises instead of
    shrinking."""
    for margin, foot, most in ((0, (9, 13), 5148), (1, (11, 15), 7260)):
        offsets = _window(margin).offsets
        plans = [ft.tile_plan((260, 260), offsets, c) for c in range(1, 12)]
        assert plans[0].footprint == foot
        sizes = [p.shared_bytes for p in plans]
        assert sizes == [4 * c * foot[0] * foot[1] for c in range(1, 12)]
        assert sizes[-1] == most <= ft.MAX_SHARED_BYTES == 232448
    # a window spanning 16 nodes an axis: a 20 x 24 node footprint, 1,920
    # bytes a channel
    wide = [(-8, -8), (8, 8)]
    assert ft.tile_plan((260, 260), wide, 121).shared_bytes == 232320
    with pytest.raises(ValueError, match="shared memory"):
        ft.tile_plan((260, 260), wide, 122)
