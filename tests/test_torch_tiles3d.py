"""The cell tiles of the 3D scatter kernel (``lme_scatter3d``): the plan of
``ops/fused_transfer.py::tile_plan`` walked with the kernel's own index
arithmetic.  Every box cell falls in exactly one tile, every window node of a
tile's cells falls in that tile's shared-memory footprint, and the planned
shared memory fits a block or the plan raises.  No JAX and no kernel run
here: the plan is host code, checked on the CPU."""

import numpy as np
import pytest

from nlpartsol_tpu_torch.ops import fused_transfer as ft
from nlpartsol_tpu_torch.shapefun import lme
from nlpartsol_tpu_torch.types import Grid

PARAMS = lme.LMEParams(gamma=3.0)


def _window(margin):
    grid = Grid(dims=(32, 32, 32), spacing=1.0 / 31, origin=(0.0, 0.0, 0.0))
    return ft._geom(grid, PARAMS, margin)


def _tiles(plan, cdims):
    """Per block: its first box cell and its (t0·t1·t2, 3) in-box cells, as
    ``lme_scatter3d_kernel`` computes them from blockIdx and the plan."""
    t, (q0, q1, q2) = plan.tile, plan.counts
    local = np.stack(np.meshgrid(*[np.arange(n) for n in t], indexing="ij"), -1).reshape(-1, 3)
    for b in range(q0 * q1 * q2):
        a = np.array([b // (q1 * q2), b // q2 % q1, b % q2]) * t
        cells = a + local
        yield a, cells[np.all(cells < np.asarray(cdims), axis=1)]


# boxes and their tiles: the default tile cut to the box, axis 0 halved
# while the box has fewer than MIN_TILES tiles
TILES = {(52, 52, 52): (8, 4, 4), (84, 84, 84): (8, 4, 4), (24, 24, 24): (2, 4, 4),
         (21, 21, 21): (2, 4, 4), (1, 24, 24): (1, 4, 4)}


@pytest.mark.parametrize("cdims", list(TILES), ids=lambda c: "x".join(map(str, c)))
def test_tile_plan_covers_every_cell_once(cdims):
    plan = ft.tile_plan(cdims, _window(0).offsets, 4)
    hits = np.zeros(cdims, np.int32)
    for _, cells in _tiles(plan, cdims):
        np.add.at(hits, tuple(cells.T), 1)
    assert hits.min() == hits.max() == 1
    assert plan.tile == TILES[cdims]
    assert plan.tile == ft.TILE or np.prod(plan.counts) >= ft.MIN_TILES or plan.tile[0] <= 2
    assert plan.counts == tuple(-(-c // t) for c, t in zip(cdims, plan.tile))


@pytest.mark.parametrize("margin", [0, 1])
def test_every_window_node_lies_in_its_tiles_footprint(margin):
    g = _window(margin)
    offs = np.asarray(g.offsets)
    # the kernels' window is the same offsets as rows (o0, o1 fixed, o2
    # rising by one), the rows nearest-first from the cell centre
    kern = np.asarray(list(g.offs_c)).reshape(-1, 3)
    assert sorted(map(tuple, kern)) == sorted(g.offsets)
    starts = np.flatnonzero(np.any(np.diff(kern[:, :2], axis=0) != 0, axis=1)) + 1
    rows = np.split(kern, starts)
    assert len(rows) == len({tuple(o[:2]) for o in g.offsets})
    assert all(np.all(np.diff(r[:, 2]) == 1) for r in rows)
    dist = [((r[0, :2] - 0.5) ** 2).sum() for r in rows]
    assert np.all(np.diff(dist) >= 0) and tuple(rows[0][0, :2]) == (0, 0)
    for cdims in [(21, 21, 21), (1, 24, 24)]:
        plan = ft.tile_plan(cdims, g.offsets, 4)
        assert plan.lo == tuple(offs.min(0))
        assert plan.footprint == tuple(np.asarray(plan.tile) + offs.max(0) - offs.min(0))
        for a, cells in _tiles(plan, cdims):
            rel = cells[:, None, :] + offs[None, :, :] - (a + np.asarray(plan.lo))
            assert rel.min() >= 0
            assert np.all(rel < np.asarray(plan.footprint))


def test_shared_bytes_fit_a_block_or_the_plan_raises():
    """cout 1-12 (up to 8 N-weighted channels, G and gnorm) at margins 0
    and 1: the default tile's footprint sums fit the 227 KB a block may use
    (at most 87,120 bytes); a footprint too large for them raises instead
    of shrinking."""
    for margin, most in ((0, 50544), (1, 87120)):
        offsets = _window(margin).offsets
        sizes = [ft.tile_plan((52, 52, 52), offsets, c).shared_bytes for c in range(1, 13)]
        assert sizes == [c * sizes[0] for c in range(1, 13)]
        assert sizes[-1] == most <= ft.MAX_SHARED_BYTES == 232448
    # a window spanning 16 nodes an axis: a 24 x 20 x 20 node footprint,
    # 4 * 9,600 = 38,400 bytes a channel
    wide = [(-8, -8, -8), (8, 8, 8)]
    assert ft.tile_plan((52, 52, 52), wide, 6).shared_bytes == 230400
    with pytest.raises(ValueError, match="shared memory"):
        ft.tile_plan((52, 52, 52), wide, 7)
