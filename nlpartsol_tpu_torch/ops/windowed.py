"""Slot-layout ("windowed") particle↔grid transfer engine.

Counterpart of ``nlpartsol_tpu/ops/windowed.py``.  On a structured
background grid the P2G/G2P sparsity is *banded by construction* — every
particle touches exactly the (2W+1)^d node window around its cell — so the
transfers can be organised as dense operations:

1. **Cell binning**: particles are binned into per-cell slots of a static
   ``capacity`` C over a static ``ActiveBox`` of cells.  Particle state then
   lives in slot layout: arrays of static size Ns = Ncells·C.  Slots are
   **capacity-major**: ``slot = rank·n_cells + cell`` — a slot array viewed
   as (C, cells…) puts the large cell axis last, so neighbouring slots are
   neighbouring cells (coalesced loads in the CUDA kernels).
2. **P2G**: per-edge values (Ns, K, c) → reshape (C, cells…, K, c) → sum
   over C → for each static window offset k, a static-slice dense add into
   the node array.
3. **G2P**: for each static offset k, a static slice of the node array is
   broadcast-multiplied into the slot array.

This engine is the port's reference for the fused CUDA kernels
(ops/fused_transfer.py), as it is for the fused kernels of the JAX package.

Particles that leave the ActiveBox or overflow a cell's capacity are
dropped from the simulation (counted in ``Binning.lost``); size the box and
capacity for the problem's reachable extent.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch

from .. import config
from ..types import Grid, Particles, Record, _prod

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ActiveBox:
    """Static cell subgrid that carries particle slots."""

    offset: tuple  # cell origin (per axis)
    cdims: tuple  # cells per axis
    capacity: int  # slots per cell (C)

    @property
    def n_cells(self) -> int:
        return _prod(self.cdims)

    @property
    def n_slots(self) -> int:
        return self.n_cells * self.capacity

    @property
    def dim(self) -> int:
        return len(self.cdims)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def full_box(grid: Grid, capacity: int) -> ActiveBox:
    return ActiveBox(
        offset=(0,) * grid.dim,
        cdims=tuple(n - 1 for n in grid.dims),
        capacity=capacity,
    )


def box_for_extent(grid: Grid, lo, hi, capacity: int, margin: int = 1) -> ActiveBox:
    """ActiveBox covering [lo, hi] (world coords) plus a cell margin."""
    lo_c = np.floor((np.asarray(lo) - np.asarray(grid.origin)) / grid.spacing).astype(int) - margin
    hi_c = np.floor((np.asarray(hi) - np.asarray(grid.origin)) / grid.spacing).astype(int) + margin
    lo_c = np.maximum(lo_c, 0)
    hi_c = np.minimum(hi_c, np.asarray(grid.dims) - 2)
    return ActiveBox(
        offset=tuple(int(v) for v in lo_c),
        cdims=tuple(int(v) for v in (hi_c - lo_c + 1)),
        capacity=capacity,
    )


@dataclasses.dataclass(frozen=True)
class Binning(Record):
    box: ActiveBox
    slot_particle: Tensor  # (Ns,) int32 index into source order; Np ⇒ empty
    valid: Tensor  # (Ns,) bool
    lost: Tensor  # () int32 active particles dropped


def _cell_strides(cdims) -> np.ndarray:
    return np.concatenate([np.cumprod(cdims[::-1])[-2::-1], [1]]).astype(np.int64)


def slot_cells(box: ActiveBox) -> np.ndarray:
    """(Ns, d) integer cell multi-index (grid frame) of every slot — static.
    Capacity-major: slot = rank·n_cells + cell."""
    idx = np.indices(box.cdims).reshape(len(box.cdims), -1).T  # (Nc, d)
    idx = idx + np.asarray(box.offset)
    return np.tile(idx, (box.capacity, 1)).astype(np.int32)


def require_grid(grid, what: str):
    """The slot layout bins particles to the cells of a structured Grid: an
    unstructured FEMesh has none, and raises naming the scatter engine."""
    if not isinstance(grid, Grid):
        raise ValueError(f"{what} needs a structured Grid's cells, not a "
                         f"{type(grid).__name__}: an unstructured FEMesh runs on the "
                         "scatter engine (transfer='scatter')")


def required_capacity(grid: Grid, box: ActiveBox, x, active=None) -> int:
    """Host-side (NumPy) max particle count over the box's cells — the
    minimum slot capacity that loses nothing for this configuration.  Use at
    setup time."""
    require_grid(grid, "required_capacity")
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if active is None:
        active = np.ones(x.shape[0], bool)
    elif isinstance(active, torch.Tensor):
        active = active.detach().cpu().numpy()
    active = np.asarray(active)
    cell = np.floor(
        (x - np.asarray(grid.origin)) / grid.spacing
    ).astype(np.int64) - np.asarray(box.offset)
    inside = np.all((cell >= 0) & (cell < np.asarray(box.cdims)), axis=-1) & active
    cid = np.sum(cell[inside] * _cell_strides(box.cdims), axis=-1)
    if cid.size == 0:
        return 1
    counts = np.bincount(cid, minlength=box.n_cells)
    return int(counts.max())


def default_box(grid: Grid, x, active=None, slack: float = 2.0) -> ActiveBox:
    """Full-grid ActiveBox with auto-sized capacity: the current per-cell
    maximum × ``slack`` (local compaction headroom), so a run neither drops
    particles at t=0 nor silently under-provisions moderate compaction."""
    probe = full_box(grid, capacity=1)
    cap = required_capacity(grid, probe, x, active)
    return full_box(grid, capacity=max(2, int(np.ceil(cap * slack))))


def bin_particles(grid: Grid, box: ActiveBox, x: Tensor, active: Tensor) -> Binning:
    """Sort-based cell binning: stable sort by cell id, rank within the
    cell, one Np-sized scatter into the slot table."""
    require_grid(grid, "bin_particles")
    n = x.shape[0]
    dev = x.device
    it = config.index_dtype()
    cell = grid.cell_of(x) - torch.tensor(box.offset, dtype=it, device=dev)
    cdims = torch.tensor(box.cdims, dtype=it, device=dev)
    inside = torch.all((cell >= 0) & (cell < cdims), dim=-1) & active
    # flat cell id within the box; sentinel n_cells for outside/inactive
    strides = torch.tensor(_cell_strides(box.cdims), dtype=it, device=dev)
    cid = torch.sum(cell * strides, dim=-1)
    cid = torch.where(inside, cid, torch.full_like(cid, box.n_cells)).to(torch.int32)

    s, order = torch.sort(cid, stable=True)
    first = torch.searchsorted(s, s, right=False)
    rank = torch.arange(n, dtype=torch.int64, device=dev) - first
    keep = (s < box.n_cells) & (rank < box.capacity)
    # dropped particles write to a spare last row that is cut off below
    slots = torch.where(keep, rank * box.n_cells + s, box.n_slots)

    slot_particle = torch.full((box.n_slots + 1,), n, dtype=torch.int32, device=dev)
    slot_particle[slots] = order.to(torch.int32)
    slot_particle = slot_particle[: box.n_slots]
    valid = slot_particle < n
    lost = torch.sum(active, dtype=torch.int32) - torch.sum(keep, dtype=torch.int32)
    return Binning(box=box, slot_particle=slot_particle, valid=valid, lost=lost)


def permute_to_slots(p: Particles, binning: Binning) -> Particles:
    """Re-layout the particle SoA into slot order (static size Ns): one row
    gather per field, each in its own dtype.  Empty slots hold copies of the
    last source row with ``active`` False."""
    idx = torch.clamp(binning.slot_particle, max=p.count - 1).long()
    p_s = p.map_tensors(lambda a: a[idx])
    return p_s.replace(active=p_s.active & binning.valid)


def _shift_cells(arr: Tensor, d, cell_axes) -> Tensor:
    """Zero-padded shift of a per-cell array: out[t] = arr[t − d] (cells
    outside the box contribute zero).  ``cell_axes`` are the positions of
    the cell axes in ``arr``."""
    out = arr
    for ax, dd in zip(cell_axes, d):
        if dd == 0:
            continue
        out = torch.roll(out, dd, dims=ax)
        # zero the wrapped strip
        n = arr.shape[ax]
        idx = torch.arange(n, device=arr.device)
        valid = (idx - dd >= 0) & (idx - dd < n)
        shape = [1] * arr.ndim
        shape[ax] = n
        out = out * valid.reshape(shape).to(arr.dtype)
    return out


def local_rebin(p: Particles, grid: Grid, box: ActiveBox, in_capacity: int = None):
    """Slot-layout-native re-binning for particles that drift ≤ 1 cell since
    the last binning (guaranteed per explicit step by CFL ≤ 1).

    ``in_capacity`` (≥ box.capacity; default box.capacity) lets the input
    carry extra capacity rows that are compacted back to C (a sharded
    migration merges neighbour-seam buffers as rows [C, in_capacity)).

    Replaces the global sort + row gather of :func:`bin_particles` /
    :func:`permute_to_slots` with index arithmetic: every particle's target
    cell is one of the 3^d neighbours of its slot cell, so destination ranks
    are per-cell running counts over the 3^d candidate groups (a
    capacity-axis cumsum on small int arrays, no sort), and the inverse
    permutation is built with 3^d masked compares.  The candidate groups are
    walked in the order ``itertools.product((0, -1, 1), repeat=d)``; the
    ranks, and with them the slot order, depend on it.

    Returns ``(particles, lost)`` where ``lost`` counts active particles
    that drifted > 1 cell, left the box, or overflowed a cell's capacity
    (their slots are zeroed: mass 0, active False).
    """
    C = box.capacity
    Cin = C if in_capacity is None else int(in_capacity)
    if Cin < C:
        raise ValueError("local_rebin: in_capacity must be >= box.capacity")
    cdims = tuple(box.cdims)
    nd = len(cdims)
    nc = box.n_cells
    dev = p.x.device
    i32 = torch.int32
    x_c = p.x.reshape((Cin,) + cdims + (p.dim,))
    act_c = p.active.reshape((Cin,) + cdims)

    # the same operations in the same order as Grid.cell_of
    org = torch.tensor(grid.origin, dtype=x_c.dtype, device=dev)
    cell_new = torch.floor((x_c - org) / grid.spacing).to(i32) - torch.tensor(
        box.offset, dtype=i32, device=dev
    )
    here = torch.stack(
        torch.meshgrid(
            *[torch.arange(n, dtype=i32, device=dev) for n in cdims], indexing="ij"
        ),
        dim=-1,
    )
    delta = cell_new - here  # (C, cells…, d)
    near = torch.all(torch.abs(delta) <= 1, dim=-1)
    cd = torch.tensor(cdims, dtype=i32, device=dev)
    inbox = torch.all((cell_new >= 0) & (cell_new < cd), dim=-1)
    act_eff = act_c & near & inbox

    strides_np = _cell_strides(cdims)
    strides = torch.tensor(strides_np, dtype=i32, device=dev)

    # destination rank: candidates for a target cell are ordered by
    # (offset group, capacity slot); rank = running count per target cell.
    cum = torch.zeros(cdims, dtype=i32, device=dev)
    rank = torch.zeros((Cin,) + cdims, dtype=i32, device=dev)
    axes0 = tuple(range(nd))
    axes1 = tuple(range(1, nd + 1))
    groups = list(itertools.product((0, -1, 1), repeat=nd))
    sels = []
    for d in groups:
        sel = act_eff & torch.all(
            delta == torch.tensor(d, dtype=i32, device=dev), dim=-1
        )
        sels.append(sel)
        mi = sel.to(i32)
        # rank in the target cell's frame, evaluated at the SOURCE slot:
        # shift cum (target-aligned) back to the source cells
        cum_src = _shift_cells(cum, tuple(-dd for dd in d), axes0)
        r = cum_src + torch.cumsum(mi, dim=0, dtype=i32) - mi
        rank = torch.where(sel, r, rank)
        cum = cum + _shift_cells(torch.sum(mi, dim=0, dtype=i32), d, axes0)
    keep = act_eff & (rank < C)

    # Dense INVERSE permutation (destination → source, no sort, no scatter):
    # every destination's candidates are its 3^d neighbour cells.
    cell_flat = torch.sum(here * strides, dim=-1, dtype=i32)  # (cdims,)
    tgt_q = torch.arange(C, dtype=i32, device=dev).reshape((C, 1) + (1,) * nd)
    src_r = (torch.arange(Cin, dtype=i32, device=dev) * nc).reshape((Cin,) + (1,) * nd)
    inv = torch.full((C,) + cdims, Cin * nc, dtype=i32, device=dev)  # sentinel
    for d, sel in zip(groups, sels):
        doff = int(np.dot(d, strides_np))
        sel_d = keep & sel
        # target-frame views (out[t] = src[t - d]; wrapped strips zeroed)
        sel_t = _shift_cells(sel_d.to(i32), d, axes1) > 0
        rank_t = _shift_cells(rank, d, axes1)
        src_t = src_r + (cell_flat - doff)[None]
        m = sel_t[None] & (tgt_q == rank_t[None])  # (C, Cin, cdims)
        hit = torch.amax(torch.where(m, src_t[None], -1), dim=1)
        inv = torch.where(hit >= 0, hit, inv)

    inv_flat = inv.reshape(-1)
    valid_row = inv_flat < Cin * nc
    safe = torch.clamp(inv_flat, max=Cin * nc - 1).long()

    def move(a):
        # rows with no source become zero (mass 0, active False)
        m = valid_row.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(m, a[safe], torch.zeros((), dtype=a.dtype, device=dev))

    p_new = p.map_tensors(move)
    lost = torch.sum(act_c, dtype=i32) - torch.sum(keep, dtype=i32)
    return p_new, lost


def _node_slices(box: ActiveBox, grid_dims, off) -> Optional[tuple]:
    """Static cell-range/node-range intersection for one window offset.
    Returns (cell_slices, node_slices) or None if empty."""
    cs, ns = [], []
    for ax in range(len(box.cdims)):
        o = int(box.offset[ax]) + int(off[ax])
        # node index = cell_in_box + o must lie in [0, grid_dims[ax])
        c0 = max(0, -o)
        c1 = min(box.cdims[ax], grid_dims[ax] - o)
        if c1 <= c0:
            return None
        cs.append(slice(c0, c1))
        ns.append(slice(c0 + o, c1 + o))
    return tuple(cs), tuple(ns)


def p2g(
    vals: Tensor,  # (Ns, K) or (Ns, K, c) per-edge contributions (masked)
    box: ActiveBox,
    grid: Grid,
    offsets: np.ndarray,  # (K, d) static window offsets
    axis_name=None,
) -> Tensor:
    """Windowed P2G: returns (n_nodes,) or (n_nodes, c) flat node array,
    summed over ``axis_name``'s group (a ``parallel.collectives.Comm``:
    particles split over ranks, the grid replicated) when given."""
    scalar = vals.ndim == 2
    if scalar:
        vals = vals[..., None]
    c = vals.shape[-1]
    K = vals.shape[1]
    per_cell = vals.reshape((box.capacity,) + tuple(box.cdims) + (K, c)).sum(dim=0)
    out = torch.zeros(tuple(grid.dims) + (c,), dtype=vals.dtype, device=vals.device)
    for k in range(K):
        sl = _node_slices(box, grid.dims, offsets[k])
        if sl is None:
            continue
        cs, ns = sl
        out[ns] += per_cell[cs + (k,)]
    out = out.reshape(grid.n_nodes, c)
    if axis_name is not None:
        from ..parallel.collectives import all_sum

        out = all_sum([out], axis_name)[0]
    if scalar:
        out = out[:, 0]
    return out


def cell_edge_field(
    field: Tensor,  # (n_nodes,) or (n_nodes, c)
    box: ActiveBox,
    grid: Grid,
    offsets: np.ndarray,
) -> Tensor:
    """Per-cell window view of a node field: out[cell, k, :] =
    field[cell + off_k] (zero outside the grid) — the core of both G2P and
    edge gathering (every slot in a cell sees the same K node values)."""
    scalar = field.ndim == 1
    f = field.reshape(tuple(grid.dims) + ((1,) if scalar else (field.shape[-1],)))
    c = f.shape[-1]
    K = offsets.shape[0]
    out = torch.zeros(tuple(box.cdims) + (K, c), dtype=f.dtype, device=f.device)
    for k in range(K):
        sl = _node_slices(box, grid.dims, offsets[k])
        if sl is None:
            continue
        cs, ns = sl
        out[cs + (k,)] = f[ns]
    return out  # (cells…, K, c)


def g2p(
    field: Tensor,  # (n_nodes,) or (n_nodes, c)
    weights: Tensor,  # (Ns, K) masked weights (e.g. shape values)
    box: ActiveBox,
    grid: Grid,
    offsets: np.ndarray,
) -> Tensor:
    """Windowed G2P: out_s = Σ_k w_sk · field[cell_s + off_k] — one K
    contraction against the stacked per-cell window view."""
    scalar = field.ndim == 1
    per_cell = cell_edge_field(field, box, grid, offsets)  # (cells…, K, c)
    nc = box.n_cells
    K = weights.shape[1]
    c = per_cell.shape[-1]
    w = weights.reshape((box.capacity, nc, K))
    pc = per_cell.reshape((nc, K, c))
    out = torch.einsum("snk,nkc->snc", w, pc).reshape(box.n_slots, c)
    return out[:, 0] if scalar else out
