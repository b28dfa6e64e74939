"""Block-partitioned background grid with neighbour halo exchange.

Counterpart of ``nlpartsol_tpu/parallel/domain.py`` on ``torch.distributed``
(parallel/collectives.py).  The structured grid is cut into contiguous
strips of node planes along grid axis 0 (1-D), or along axes 0 and 1 (2-D,
ranks row-major over (S0, S1)); each rank holds its own strip:

* the global :class:`~..ops.windowed.ActiveBox` is split into slabs of
  ``bc`` cell planes; shard ``s`` owns cells ``[offset0 + s·bc, offset0 +
  (s+1)·bc)`` and their node planes (the edge shards also own the outer
  ghost planes);
* each rank works in a device frame: axis-0 positions are shifted so its
  strip starts at 0 (:meth:`Decomp.shift`), and :func:`unshard_particles`
  shifts them back;
* the local strip has ``ln = bc + wlo + whi`` node planes: ``wlo``/``whi``
  ghost planes below/above (the window's reach, plus the drift ``margin``
  of a k-periodic migration), so particle windows never leave the strip;
* P2G: local scatter, then :func:`halo_exchange_add` adds the ghost planes'
  partial sums into the neighbours' owned planes and zeroes the ghosts —
  every node vector is "owned-complete, ghost-zero", and a global dot is an
  all-reduce of local dots;
* G2P: :func:`halo_fill` fills the ghost planes from the neighbours' owned
  planes before the local gather;
* migration: particles whose cell left the owned slab ship to the adjacent
  shard in fixed-capacity buffers and are re-binned (:func:`migrate_local`,
  sort-free; :func:`migrate_and_rebin`, the sort-based one).  CFL < 1 keeps
  it nearest-neighbour; anything that does not fit is counted in ``lost``.

Phantom planes (a strip reaching past the global grid) are masked by the
strip grid's ``valid_lo``/``valid_hi``, on the windowed engine and in the
fused kernels alike.

The JAX drivers return a jit-able callable over stacked shards; the port's
run on the calling rank's own strip (:func:`sharded_explicit_run` and the
others), take the :class:`~.collectives.Comm`, and return that rank's
particles and the globally summed diagnostics.  One shard needs no group:
every collective is then the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..ops import windowed
from ..types import Grid, Particles, _prod
from .collectives import Comm, all_sum, neighbour_exchange

Tensor = torch.Tensor

_FIELDS = tuple(f.name for f in dataclasses.fields(Particles))


# ---------------------------------------------------------------------------
# specs and the halo exchange
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """The 1-D decomposition: ``n_shards`` strips along grid axis 0, with
    ``wlo``/``whi`` ghost planes, ``bc`` owned cell planes and ``ln`` local
    node planes; ``comm`` is the group the collectives run on (None for one
    shard), the port's counterpart of the JAX axis name."""

    n_shards: int
    wlo: int
    whi: int
    bc: int
    ln: int
    comm: Optional[Comm] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shard(self) -> int:
        return 0 if self.comm is None else self.comm.rank


@dataclasses.dataclass(frozen=True)
class HaloSpec2:
    """The 2-D decomposition: grid axes 0 and 1 over (S0, S1) shards.  Halo
    exchange is two-phase (axis 0 over the full local extent, ghost columns
    included, then axis 1), so corners travel in two hops."""

    shards: tuple
    wlo: tuple
    whi: tuple
    bc: tuple
    ln: tuple
    comm: Optional[Comm] = dataclasses.field(default=None, compare=False, repr=False)

    def coords(self) -> tuple:
        return (0, 0) if self.comm is None else self.comm.coords


def _on_duals(f: Tensor, fn):
    """Apply the linear map ``fn`` to a tensor, or to the primal and tangent
    of a forward-mode dual tensor in one go (one exchange for both)."""
    primal, tangent = fwAD.unpack_dual(f)
    if tangent is None:
        return fn(f)
    out = fn(torch.stack([primal, tangent], dim=-1))
    return fwAD.make_dual(out[..., 0].contiguous(), out[..., 1].contiguous())


def _owned_along(ln, wlo, bc, s, S, device):
    j = torch.arange(ln, device=device)
    return ((j >= wlo) | (s == 0)) & ((j < wlo + bc) | (s == S - 1))


def plane_owned_mask(spec: HaloSpec, device="cpu") -> Tensor:
    """(ln,) bool: the local node planes this shard owns.  Interior shards
    own [wlo, wlo+bc); the first and last also own their outer ghost planes
    (no neighbour owns them, and only their own particles reach them)."""
    return _owned_along(spec.ln, spec.wlo, spec.bc, spec.shard, spec.n_shards, device)


def _axis_exchange_add(g: Tensor, comm, axis, S, wlo, whi, bc, s) -> Tensor:
    """Exchange-add along the leading axis of ``g`` (planes first)."""
    if S > 1:
        from_dn, from_up = neighbour_exchange(g[wlo + bc:] if whi else None,
                                              g[:wlo] if wlo else None, comm, axis)
        g = g.clone()
        if wlo:
            g[bc:bc + wlo] += from_up
        if whi:
            g[wlo:wlo + whi] += from_dn
    owned = _owned_along(g.shape[0], wlo, bc, s, S, g.device)
    return torch.where(owned.reshape((-1,) + (1,) * (g.ndim - 1)), g,
                       torch.zeros((), dtype=g.dtype, device=g.device))


def _axis_fill(g: Tensor, comm, axis, S, wlo, whi, bc, s) -> Tensor:
    out = g
    if S > 1:
        from_dn, from_up = neighbour_exchange(g[bc:bc + wlo] if wlo else None,
                                              g[wlo:wlo + whi] if whi else None, comm, axis)
        out = g.clone()
        if wlo:
            out[:wlo] = from_dn
        if whi:
            out[wlo + bc:] = from_up
    owned = _owned_along(g.shape[0], wlo, bc, s, S, g.device)
    return torch.where(owned.reshape((-1,) + (1,) * (g.ndim - 1)), g, out)


def halo_exchange_add(f: Tensor, spec) -> Tensor:
    """Complete a locally scattered node field: add the ghost planes'
    partial sums into the neighbours' owned planes, then zero the ghosts
    (owned-complete, ghost-zero).  Takes dual tensors (the J·v)."""
    if isinstance(spec, HaloSpec2):
        return halo_exchange_add2(f, spec)
    if spec.n_shards == 1:
        return f

    def fn(a):
        g = a.reshape(spec.ln, -1)
        g = _axis_exchange_add(g, spec.comm, 0, spec.n_shards, spec.wlo, spec.whi, spec.bc,
                               spec.shard)
        return g.reshape(a.shape)

    return _on_duals(f, fn)


def halo_fill(f: Tensor, spec) -> Tensor:
    """Fill the ghost planes of an owned-complete node field from the
    neighbours' owned planes (before a gather); the edge shards keep their
    own outer planes."""
    if isinstance(spec, HaloSpec2):
        return halo_fill2(f, spec)
    if spec.n_shards == 1:
        return f

    def fn(a):
        g = a.reshape(spec.ln, -1)
        g = _axis_fill(g, spec.comm, 0, spec.n_shards, spec.wlo, spec.whi, spec.bc, spec.shard)
        return g.reshape(a.shape)

    return _on_duals(f, fn)


def _two_phase(f, spec: HaloSpec2, one):
    def fn(a):
        g = a.reshape(spec.ln[0], spec.ln[1], -1)
        s = spec.coords()
        for axis in (0, 1):
            mv = torch.movedim(g, axis, 0)
            mv = one(mv, spec.comm, axis, spec.shards[axis], spec.wlo[axis], spec.whi[axis],
                     spec.bc[axis], s[axis])
            g = torch.movedim(mv, 0, axis)
        return g.reshape(a.shape)

    return _on_duals(f, fn)


def halo_exchange_add2(f: Tensor, spec: HaloSpec2) -> Tensor:
    """Owned-complete, ghost-zero on both split axes (two-phase)."""
    return _two_phase(f, spec, _axis_exchange_add)


def halo_fill2(f: Tensor, spec: HaloSpec2) -> Tensor:
    return _two_phase(f, spec, _axis_fill)


# ---------------------------------------------------------------------------
# decomposition (host side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Decomp:
    """The 1-D decomposition bundle: spec, the global grid and box, and the
    local templates (device frame)."""

    spec: HaloSpec
    global_grid: Grid
    global_box: windowed.ActiveBox
    local_grid: Grid
    local_box: windowed.ActiveBox
    mig_capacity: int
    margin: int = 0

    def base_plane(self, s: int) -> int:
        """Global node-plane index of shard s's local plane 0 (negative or
        past the grid: phantom planes, masked by valid_lo/hi)."""
        return self.global_box.offset[0] + s * self.spec.bc - self.spec.wlo

    def shift(self, s: int) -> np.ndarray:
        """World-coordinate shift of shard s's frame: x_local = x − shift."""
        sh = np.zeros(self.global_grid.dim, np.float64)
        sh[0] = self.global_grid.origin[0] + self.base_plane(s) * self.global_grid.spacing
        return sh

    def on(self, comm: Optional[Comm]) -> "Decomp":
        """This decomposition with its collectives on ``comm``."""
        return dataclasses.replace(self, spec=dataclasses.replace(self.spec, comm=comm))


def _padded_box(box, cd):
    return windowed.ActiveBox(offset=tuple(box.offset), cdims=tuple(cd), capacity=box.capacity)


def decompose(grid: Grid, box: windowed.ActiveBox, n_shards: int, offsets,
              mig_capacity: int = None, margin: int = 0, comm: Optional[Comm] = None) -> Decomp:
    """The 1-D decomposition of (grid, box) over ``n_shards`` strips.
    ``offsets`` (K, d) is the shape-function window: its axis-0 reach, plus
    ``margin`` (the drift of a k-periodic migration), sets the halo width.
    The box is padded with empty cell planes to a multiple of ``n_shards``;
    a slab thinner than the halo raises ``ValueError``."""
    offs0 = np.asarray(offsets)[:, 0]
    wlo = int(-offs0.min()) + int(margin)
    whi = int(offs0.max()) + int(margin)
    S = int(n_shards)
    cd = list(box.cdims)
    if cd[0] % S:
        cd[0] += S - cd[0] % S
    box = _padded_box(box, cd)
    bc = box.cdims[0] // S
    if bc < max(wlo, whi, 1):
        raise ValueError(
            f"slab of {bc} cell planes is thinner than the halo "
            f"(wlo={wlo}, whi={whi}): use fewer shards or a larger box"
        )
    ln = bc + wlo + whi
    spec = HaloSpec(n_shards=S, wlo=wlo, whi=whi, bc=bc, ln=ln, comm=comm)
    local_grid = Grid(dims=(ln,) + tuple(grid.dims[1:]), spacing=grid.spacing,
                      origin=(0.0,) + tuple(grid.origin[1:]))
    local_box = windowed.ActiveBox(offset=(wlo,) + tuple(box.offset[1:]),
                                   cdims=(bc,) + tuple(box.cdims[1:]), capacity=box.capacity)
    if mig_capacity is None:
        # CFL < 1: at most one cell plane's worth of particles crosses a seam
        mig_capacity = box.capacity * _prod(box.cdims[1:])
    return Decomp(spec=spec, global_grid=grid, global_box=box, local_grid=local_grid,
                  local_box=local_box, mig_capacity=int(mig_capacity), margin=int(margin))


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _strip(arr, dims, fill, bases, lns, device):
    """The local strip of a flat node array: planes [base, base + ln) of
    each split axis, phantom planes filled with ``fill``."""
    a = _numpy(arr)
    trail = a.shape[1:]
    full = a.reshape(tuple(dims) + trail)
    seg = np.full(tuple(lns) + tuple(dims[len(lns):]) + trail, fill, a.dtype)
    src, dst = [], []
    for b, ln, n in zip(bases, lns, dims):
        lo, hi = max(0, b), min(n, b + ln)
        if hi <= lo:
            return torch.as_tensor(seg.reshape((-1,) + trail), device=device)
        src.append(slice(lo, hi))
        dst.append(slice(lo - b, hi - b))
    seg[tuple(dst)] = full[tuple(src)]
    return torch.as_tensor(seg.reshape((-1,) + trail), device=device)


def _strip_grid(grid, local_grid, bases, lns, device):
    def strips(a, fill):
        return None if a is None else _strip(a, grid.dims, fill, bases, lns,
                                             device or a.device)

    return local_grid.replace(
        dirichlet_mask=strips(grid.dirichlet_mask, False),
        dirichlet_value=strips(grid.dirichlet_value, 0.0),
        active=strips(grid.active, False),
    )


def shard_grid(grid: Grid, decomp: Decomp, shards=None, device=None) -> list:
    """The local strip Grid of each shard in ``shards`` (default all): the
    Dirichlet and active arrays cut to the extended strip (phantom planes
    inert) and the strip's valid plane bounds (``valid_lo``/``valid_hi``,
    axis 0)."""
    spec = decomp.spec
    n0 = grid.dims[0]
    out = []
    for s in range(spec.n_shards) if shards is None else shards:
        base = decomp.base_plane(s)
        g = _strip_grid(grid, decomp.local_grid, [base], [spec.ln], device)
        out.append(g.replace(valid_lo=max(0, -base), valid_hi=min(spec.ln - 1, n0 - 1 - base)))
    return out


def _bin_shard(p, shift, local_grid, local_box):
    ps = p.replace(x=p.x - torch.as_tensor(shift, dtype=p.x.dtype, device=p.x.device))
    binning = windowed.bin_particles(local_grid, local_box, ps.x, ps.active)
    return windowed.permute_to_slots(ps, binning)


def shard_particles(p: Particles, decomp: Decomp, shards=None) -> list:
    """Bin the particles to the shard that owns their cell, in that shard's
    frame, one slot layout per shard of ``shards`` (default all).  With all
    shards, raises if an active particle fits none (outside the box, or a
    cell over capacity)."""
    spec = decomp.spec
    check = shards is None
    parts = [_bin_shard(p, decomp.shift(s), decomp.local_grid, decomp.local_box)
             for s in (range(spec.n_shards) if shards is None else shards)]
    _check_kept(p, parts, check, decomp.global_box.capacity, "shard_particles")
    return parts


def _check_kept(p, parts, check, capacity, who):
    if not check:
        return
    kept = sum(int(q.active.sum()) for q in parts)
    n_active = int(p.active.sum())
    if kept != n_active:
        raise ValueError(
            f"{who}: {n_active - kept} active particles fit no shard (outside the "
            f"active box, or a cell overflowed capacity {capacity})")


def _cat(parts):
    return Particles(**{n: torch.cat([getattr(q, n) for q in parts]) for n in _FIELDS})


def unshard_particles(parts, decomp: Decomp, shards=None) -> Particles:
    """Undo :func:`shard_particles`: each shard's particles shifted back to
    world coordinates, concatenated (slot padding rides along inactive)."""
    shards = range(decomp.spec.n_shards) if shards is None else shards
    out = []
    for s, q in zip(shards, parts):
        out.append(q.replace(x=q.x + torch.as_tensor(decomp.shift(s), dtype=q.x.dtype,
                                                      device=q.x.device)))
    return _cat(out)


# ---------------------------------------------------------------------------
# particle migration
# ---------------------------------------------------------------------------


def _pack(arrays: dict, rows: int) -> Tensor:
    """Every array of ``arrays`` (leading extent ``rows``) as raw bytes, one
    (rows, B) uint8 buffer: one message carries every field, bit for bit."""
    return torch.cat([a.reshape(rows, -1).contiguous().view(torch.uint8)
                      for a in arrays.values()], dim=1)


def _unpack(buf: Tensor, like: dict) -> dict:
    out, i = {}, 0
    rows = buf.shape[0]
    for name, a in like.items():
        flat = a.reshape(rows, -1)
        n = flat.shape[1] * a.element_size()
        out[name] = buf[:, i:i + n].contiguous().view(a.dtype).reshape(a.shape)
        i += n
    return out


def _zero_where(sel: Tensor, a: Tensor) -> Tensor:
    m = sel.reshape(sel.shape + (1,) * (a.ndim - sel.ndim))
    return torch.where(m, torch.zeros((), dtype=a.dtype, device=a.device), a)


def _ship_axis(p: Particles, cin: int, box, axis: int, S: int, bc_spec: int, comm, h: float,
               s: int):
    """Ship the seam planes along split ``axis``: active particles of the
    first (last) owned cell plane whose cell is now below (above) the slab
    go to the previous (next) shard, their frame shifted by bc·h; the
    received buffers become extra capacity rows on the seam planes.  Returns
    (particles at capacity cout, cout, lost at the global edge)."""
    cdims = tuple(box.cdims)
    bca = cdims[axis]
    dev = p.x.device

    def split(a):
        return torch.movedim(a.reshape((cin,) + cdims + tuple(a.shape[1:])), 1 + axis, 1)

    ca = split(torch.floor(p.x[:, axis] / h).to(torch.int32) - int(box.offset[axis]))
    act = split(p.active)
    lo = act[:, 0] & (ca[:, 0] < 0)
    hi = act[:, -1] & (ca[:, -1] >= bca)
    fields = {n: split(getattr(p, n)) for n in _FIELDS}
    shift = bc_spec * h

    def outgoing(sel, plane, dx):
        buf = {}
        for n, v in fields.items():
            a = torch.where(sel.reshape(sel.shape + (1,) * (v.ndim - 1 - sel.ndim)),
                            v[:, plane], torch.zeros((), dtype=v.dtype, device=dev))
            if n == "x":
                a = a.clone()
                a[..., axis] = a[..., axis] + torch.where(
                    sel, torch.tensor(dx, dtype=a.dtype, device=dev),
                    torch.zeros((), dtype=a.dtype, device=dev))
            buf[n] = a
        return buf

    dbuf, ubuf = outgoing(lo, 0, shift), outgoing(hi, -1, -shift)
    rows = lo.numel()
    from_dn, from_up = neighbour_exchange(_pack(ubuf, rows), _pack(dbuf, rows), comm, axis)
    r_dn, r_up = _unpack(from_dn, ubuf), _unpack(from_up, dbuf)

    out = {}
    for n, v in fields.items():
        v = v.clone()
        v[:, 0] = _zero_where(lo, v[:, 0])
        v[:, -1] = _zero_where(hi, v[:, -1])
        if bca >= 2:
            extra = torch.zeros_like(v)
            extra[:, -1] = r_up[n]
            extra[:, 0] = r_dn[n]
            blocks = [v, extra]
        else:
            eu, ed = torch.zeros_like(v), torch.zeros_like(v)
            eu[:, 0] = r_up[n]
            ed[:, 0] = r_dn[n]
            blocks = [v, eu, ed]
        ext = torch.movedim(torch.cat(blocks, dim=0), 1, 1 + axis)
        out[n] = ext.reshape((-1,) + tuple(getattr(p, n).shape[1:]))
    cout = cin * (2 if bca >= 2 else 3)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    edge = (torch.sum(lo, dtype=torch.int32) if s == 0 else zero) + (
        torch.sum(hi, dtype=torch.int32) if s == S - 1 else zero)
    return Particles(**out), cout, edge


def migrate_local(p: Particles, spec: HaloSpec, local_grid: Grid, local_box):
    """Sort-free seam migration and re-bin.  Under CFL ≤ 1 only the first
    and last owned cell planes hold particles that change owner: their slot
    buffers (capacity-padded, no compaction) ship to the adjacent shard, and
    the merged set is compacted back to capacity C by the counting re-bin
    (``windowed.local_rebin`` at input capacity 2C).  Returns (particles,
    lost): lost counts particles that left the global box at an edge shard,
    drifted more than a cell, or overflowed a cell's capacity."""
    if spec.n_shards == 1:
        return windowed.local_rebin(p, local_grid, local_box)
    p_ext, cin, edge = _ship_axis(p, local_box.capacity, local_box, 0, spec.n_shards, spec.bc,
                                  spec.comm, local_grid.spacing, spec.shard)
    p_new, lost = windowed.local_rebin(p_ext, local_grid, local_box, in_capacity=cin)
    return p_new, lost + edge


def migrate_and_rebin(p: Particles, spec: HaloSpec, local_grid: Grid, local_box,
                      mig_capacity: int):
    """Sort-based migration: the movers of each direction are packed by a
    stable sort into a buffer of ``mig_capacity`` rows, shipped, merged and
    binned into the local slot layout.  Returns (particles, lost): lost
    counts particles that left the global box, overflowed a migration
    buffer or a cell's capacity."""
    S = spec.n_shards
    h = local_grid.spacing
    dev = p.x.device
    act = p.active
    c0 = torch.floor(p.x[:, 0] / h).to(torch.int32)
    godown = act & (c0 < spec.wlo)
    goup = act & (c0 >= spec.wlo + spec.bc)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    fields = {n: getattr(p, n) for n in _FIELDS}
    if S > 1:
        shift = spec.bc * h

        def pack(flag, dx0):
            order = torch.argsort((~flag).to(torch.int32), stable=True)
            idx = order[:mig_capacity]
            valid = flag[idx]
            buf = {}
            for n, a in fields.items():
                m = valid.reshape((-1,) + (1,) * (a.ndim - 1))
                b = torch.where(m, a[idx], torch.zeros((), dtype=a.dtype, device=dev))
                if n == "x":
                    b = b.clone()
                    b[:, 0] = b[:, 0] + torch.where(
                        valid, torch.tensor(dx0, dtype=b.dtype, device=dev),
                        torch.zeros((), dtype=b.dtype, device=dev))
                buf[n] = b
            over = torch.sum(flag, dtype=torch.int32) - torch.sum(valid, dtype=torch.int32)
            return buf, over

        dbuf, dover = pack(godown, shift)
        ubuf, uover = pack(goup, -shift)
        rows = next(iter(dbuf.values())).shape[0]
        from_dn, from_up = neighbour_exchange(_pack(ubuf, rows), _pack(dbuf, rows), spec.comm)
        r_dn, r_up = _unpack(from_dn, ubuf), _unpack(from_up, dbuf)
        stay = act & ~godown & ~goup
        fields = dict(fields, active=stay)
        merged = Particles(**{n: torch.cat([fields[n], r_up[n], r_dn[n]]) for n in _FIELDS})
    else:
        merged = p
    binning = windowed.bin_particles(local_grid, local_box, merged.x, merged.active)
    p_new = windowed.permute_to_slots(merged, binning)
    if S == 1:
        return p_new, binning.lost
    s = spec.shard
    lost = binning.lost
    lost = lost + (torch.sum(godown, dtype=torch.int32) if s == 0 else zero)
    lost = lost + (torch.sum(goup, dtype=torch.int32) if s == S - 1 else zero)
    lost = lost + (dover if s > 0 else zero) + (uover if s < S - 1 else zero)
    return p_new, lost


def slot_plane_halo(arrs: dict, spec: HaloSpec, box, reach: int, h: float, x_key: str = "x"):
    """Particle halo for nonlocal neighbourhood sums (the Beps fracture
    drivers): capacity-major slot arrays extended by ``reach`` ghost CELL
    planes a side along the split axis, filled from the neighbours' seam
    planes (positions shifted by ±bc·h into this frame; edge shards get
    zeros, i.e. inactive ghosts).  Returns (extended arrays, extended box:
    cdims[0] = bc + 2·reach, offset[0] − reach)."""
    C = box.capacity
    bc = box.cdims[0]
    rest = box.n_cells // bc
    r = int(reach)
    if not 1 <= r <= bc:
        raise ValueError(f"slot_plane_halo: reach {r} outside [1, {bc}]")
    ext_box = windowed.ActiveBox(offset=(box.offset[0] - r,) + tuple(box.offset[1:]),
                                 cdims=(bc + 2 * r,) + tuple(box.cdims[1:]), capacity=C)
    top, bot, views = {}, {}, {}
    for k, a in arrs.items():
        v = a.reshape((C, bc, rest) + tuple(a.shape[1:]))
        views[k] = v
        t, b = v[:, bc - r:], v[:, :r]
        if k == x_key:
            t, b = t.clone(), b.clone()
            t[..., 0] = t[..., 0] - spec.bc * h  # sent upward: s → s+1
            b[..., 0] = b[..., 0] + spec.bc * h  # sent downward: s → s−1
        top[k], bot[k] = t, b
    rows = C * r * rest
    from_dn, from_up = neighbour_exchange(_pack(top, rows), _pack(bot, rows), spec.comm)
    r_dn, r_up = _unpack(from_dn, top), _unpack(from_up, bot)
    out = {}
    for k, v in views.items():
        e = torch.cat([r_dn[k], v, r_up[k]], dim=1)
        out[k] = e.reshape((C * (bc + 2 * r) * rest,) + tuple(v.shape[3:]))
    return out, ext_box


def slot_plane_restrict(a: Tensor, spec: HaloSpec, box, reach: int) -> Tensor:
    """The owned planes of a :func:`slot_plane_halo`-extended slot array."""
    C = box.capacity
    bc = box.cdims[0]
    rest = box.n_cells // bc
    r = int(reach)
    v = a.reshape((C, bc + 2 * r, rest) + tuple(a.shape[1:]))
    return v[:, r:r + bc].reshape((C * bc * rest,) + tuple(a.shape[1:]))


# ---------------------------------------------------------------------------
# sharded drivers
# ---------------------------------------------------------------------------


def _localize_cfg(cfg, decomp):
    """The step config of the local strip (either decomposition): the
    configured engine ('fused' runs under halo; anything else becomes
    'windowed'), the local box, the halo and its group, particles pre-binned
    (the driver migrates and re-bins after each step; the fused step then
    re-bins nothing itself)."""
    spec = decomp.spec
    transfer = getattr(cfg, "transfer", "windowed")
    if transfer not in ("windowed", "fused"):
        transfer = "windowed"
    kw = dict(transfer=transfer, active_box=decomp.local_box, halo=spec, axis_name=spec.comm,
              prebinned=True)
    if transfer == "fused":
        kw["rebin_mode"] = "none"
    return cfg.replace(**kw)


def _raise_on_lost(lost: int, who: str):
    if lost:
        raise RuntimeError(
            f"{who}: {lost} particles lost (left the global box, drifted more than a cell "
            "between migrations, or overflowed a migration buffer or a cell's capacity)")


def _finish(hist: dict, lost_acc: Tensor, comm, who: str, device):
    lost = int(all_sum([lost_acc], comm)[0])
    _raise_on_lost(lost, who)
    out = {k: torch.stack([torch.as_tensor(v, device=device) for v in vals]) if vals else
           torch.zeros((0,), device=device) for k, vals in hist.items()}
    out["lost"] = torch.tensor(lost, dtype=torch.int32, device=device)
    return out


def sharded_explicit_run(decomp: Decomp, cfg, n_steps: int):
    """Callable (p, grid, mats, body) → (p, diag) running ``n_steps``
    halo-sharded explicit steps on this rank's strip (``p`` and ``grid``
    from :func:`shard_particles`/:func:`shard_grid` for this shard;
    ``decomp.spec.comm`` the group).

    With the fused engine and ``cfg.rebin_every = k > 1`` seam migration is
    k-periodic: the kernels run with a 1-cell drift margin, the halo carries
    it (``decompose(margin=1)``, enforced here), and :func:`migrate_local`
    fires every k-th step (``n_steps % k == 0``).  The windowed engine
    migrates every step.  ``diag``: per step ``kinetic_energy``,
    ``strain_energy``, ``nnz`` (global), and the global ``lost``; a loss
    raises ``RuntimeError``."""
    from ..formulations.explicit import explicit_step

    spec = decomp.spec
    cfgl = _localize_cfg(cfg, decomp)
    k = getattr(cfgl, "rebin_every", 1) if cfgl.transfer == "fused" else 1
    if k > 1:
        if decomp.margin < 1:
            raise ValueError(
                "k-periodic seam migration (rebin_every > 1) needs the drift-widened "
                "halo: build the decomposition with decompose(..., margin=1)")
        if n_steps % k:
            raise ValueError(
                f"n_steps={n_steps} must be a multiple of rebin_every={k} "
                "(the migration period tiles the run)")

    def run(p, grid, mats, body):
        hist = {"kinetic_energy": [], "strain_energy": [], "nnz": []}
        lost_acc = torch.zeros((), dtype=torch.int32, device=p.x.device)
        for i in range(n_steps):
            p, diag = explicit_step(p, grid, mats, cfgl, body)
            for key in hist:
                hist[key].append(diag[key])
            if i % k == k - 1:
                p, lost = migrate_local(p, spec, grid, decomp.local_box)
                lost_acc = lost_acc + lost
        return p, _finish(hist, lost_acc, spec.comm, "sharded_explicit_run", p.x.device)

    return run


def sharded_upw_run(decomp: Decomp, cfg, mix, n_steps: int):
    """Halo-sharded explicit u-pw run with seam migration every step;
    ``pw`` Dirichlet masks, when used, are cut into strips like the grid's.
    Callable (p, grid, mats, body, pw_dirichlet_mask=None) → (p, diag)."""
    from ..formulations.upw import upw_step

    spec = decomp.spec
    cfgl = _localize_cfg(cfg, decomp)

    def run(p, grid, mats, body, pw_dirichlet_mask=None):
        hist = {"nnz": []}
        lost_acc = torch.zeros((), dtype=torch.int32, device=p.x.device)
        for _ in range(n_steps):
            p, diag = upw_step(p, grid, mats, mix, cfgl, body,
                               pw_dirichlet_mask=pw_dirichlet_mask)
            hist["nnz"].append(diag["nnz"])
            p, lost = migrate_local(p, spec, grid, decomp.local_box)
            lost_acc = lost_acc + lost
        return p, _finish(hist, lost_acc, spec.comm, "sharded_upw_run", p.x.device)

    return run


def _implicit_loop(step, spec, local_box, migrate, who):
    def run(p, grid, mats, body, n_steps):
        hist = {"newton_iters": [], "cg_iters": [], "newton_residual": [], "converged": []}
        lost_acc = torch.zeros((), dtype=torch.int32, device=p.x.device)
        for _ in range(n_steps):
            p, diag = step(p, grid, mats, body)
            for key in hist:
                hist[key].append(diag[key])
            p, lost = migrate(p, spec, grid, local_box)
            lost_acc = lost_acc + lost
        return p, _finish(hist, lost_acc, spec.comm, who, p.x.device)

    return run


def sharded_implicit_run(decomp: Decomp, cfg, n_steps: int):
    """Halo-sharded implicit Newmark run: halo P2G residuals, Newton-Krylov
    whose every dot and norm is all-reduced (each rank takes the same
    branches and counts), seam migration every step.  Callable (p, grid,
    mats, body) → (p, diag) with per-step ``newton_iters``, ``cg_iters``,
    ``newton_residual``, ``converged`` and the global ``lost``."""
    from ..formulations.implicit import implicit_step

    cfgl = _localize_cfg(cfg, decomp)
    loop = _implicit_loop(lambda p, g, m, b: implicit_step(p, g, m, cfgl, b), decomp.spec,
                          decomp.local_box, migrate_local, "sharded_implicit_run")
    return lambda p, grid, mats, body: loop(p, grid, mats, body, n_steps)


# ---------------------------------------------------------------------------
# 2-D decomposition
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Decomp2:
    spec: HaloSpec2
    global_grid: Grid
    global_box: windowed.ActiveBox
    local_grid: Grid
    local_box: windowed.ActiveBox
    margin: int = 0

    def base_plane(self, axis: int, s: int) -> int:
        return self.global_box.offset[axis] + s * self.spec.bc[axis] - self.spec.wlo[axis]

    def shift(self, s0: int, s1: int) -> np.ndarray:
        sh = np.zeros(self.global_grid.dim, np.float64)
        for axis, s in ((0, s0), (1, s1)):
            sh[axis] = (self.global_grid.origin[axis]
                        + self.base_plane(axis, s) * self.global_grid.spacing)
        return sh

    def shard_coords(self):
        """(s0, s1) of every shard, row-major: the rank order."""
        return [(a, b) for a in range(self.spec.shards[0]) for b in range(self.spec.shards[1])]

    def on(self, comm: Optional[Comm]) -> "Decomp2":
        return dataclasses.replace(self, spec=dataclasses.replace(self.spec, comm=comm))


def decompose2(grid: Grid, box: windowed.ActiveBox, shards: tuple, offsets, margin: int = 0,
               comm: Optional[Comm] = None) -> Decomp2:
    """The 2-D decomposition: grid axes 0 and 1 over (S0, S1) shards, with
    :func:`decompose`'s padding and slab rules on each axis."""
    offs = np.asarray(offsets)
    S = (int(shards[0]), int(shards[1]))
    cd = list(box.cdims)
    w = []
    for a in (0, 1):
        wlo = int(-offs[:, a].min()) + int(margin)
        whi = int(offs[:, a].max()) + int(margin)
        if cd[a] % S[a]:
            cd[a] += S[a] - cd[a] % S[a]
        bca = cd[a] // S[a]
        if bca < max(wlo, whi, 1):
            raise ValueError(
                f"axis {a}: slab of {bca} cell planes is thinner than the halo "
                f"(wlo={wlo}, whi={whi}): use fewer shards or a larger box")
        w.append((wlo, whi, bca))
    box = _padded_box(box, cd)
    (w0lo, w0hi, bc0), (w1lo, w1hi, bc1) = w
    ln = (bc0 + w0lo + w0hi, bc1 + w1lo + w1hi)
    spec = HaloSpec2(shards=S, wlo=(w0lo, w1lo), whi=(w0hi, w1hi), bc=(bc0, bc1), ln=ln,
                     comm=comm)
    local_grid = Grid(dims=ln + tuple(grid.dims[2:]), spacing=grid.spacing,
                      origin=(0.0, 0.0) + tuple(grid.origin[2:]))
    local_box = windowed.ActiveBox(offset=(w0lo, w1lo) + tuple(box.offset[2:]),
                                   cdims=(bc0, bc1) + tuple(box.cdims[2:]), capacity=box.capacity)
    return Decomp2(spec=spec, global_grid=grid, global_box=box, local_grid=local_grid,
                   local_box=local_box, margin=int(margin))


def shard_grid2(grid: Grid, dec: Decomp2, shards=None, device=None) -> list:
    """The local strip Grid of each shard (row-major index) in ``shards``
    (default all), with valid bounds on both split axes."""
    spec = dec.spec
    dims = grid.dims
    coords = dec.shard_coords()
    out = []
    for i in range(len(coords)) if shards is None else shards:
        s0, s1 = coords[i]
        b = (dec.base_plane(0, s0), dec.base_plane(1, s1))
        g = _strip_grid(grid, dec.local_grid, b, spec.ln, device)
        lo = (max(0, -b[0]), max(0, -b[1])) + (0,) * (grid.dim - 2)
        hi = (min(spec.ln[0] - 1, dims[0] - 1 - b[0]),
              min(spec.ln[1] - 1, dims[1] - 1 - b[1])) + tuple(n - 1 for n in dims[2:])
        out.append(g.replace(valid_lo=lo, valid_hi=hi))
    return out


def shard_particles2(p: Particles, dec: Decomp2, shards=None) -> list:
    coords = dec.shard_coords()
    check = shards is None
    parts = [_bin_shard(p, dec.shift(*coords[i]), dec.local_grid, dec.local_box)
             for i in (range(len(coords)) if shards is None else shards)]
    _check_kept(p, parts, check, dec.global_box.capacity, "shard_particles2")
    return parts


def unshard_particles2(parts, dec: Decomp2, shards=None) -> Particles:
    coords = dec.shard_coords()
    shards = range(len(coords)) if shards is None else shards
    out = []
    for i, q in zip(shards, parts):
        sh = torch.as_tensor(dec.shift(*coords[i]), dtype=q.x.dtype, device=q.x.device)
        out.append(q.replace(x=q.x + sh))
    return _cat(out)


def migrate_local2(p: Particles, spec: HaloSpec2, local_grid: Grid, local_box):
    """Two-phase sort-free migration of the 2-D decomposition: ship the
    axis-0 seam planes, merge, then the axis-1 seam columns of the merged
    set (a diagonal mover reaches the corner shard in two hops), then one
    counting re-bin at input capacity 4C.  Loss accounting as
    :func:`migrate_local`."""
    s = spec.coords()
    h = local_grid.spacing
    cin = local_box.capacity
    lost_edge = torch.zeros((), dtype=torch.int32, device=p.x.device)
    for axis in (0, 1):
        p, cin, e = _ship_axis(p, cin, local_box, axis, spec.shards[axis], spec.bc[axis],
                               spec.comm, h, s[axis])
        lost_edge = lost_edge + e
    p_new, lost = windowed.local_rebin(p, local_grid, local_box, in_capacity=cin)
    return p_new, lost + lost_edge


def sharded_explicit_run2(dec: Decomp2, cfg, n_steps: int):
    """The 2-D-decomposed explicit run (windowed or fused), two-phase seam
    migration every step; the diagnostics are summed over the whole group."""
    from ..formulations.explicit import explicit_step

    spec = dec.spec
    cfgl = _localize_cfg(cfg, dec)

    def run(p, grid, mats, body):
        hist = {"kinetic_energy": [], "strain_energy": [], "nnz": []}
        lost_acc = torch.zeros((), dtype=torch.int32, device=p.x.device)
        for _ in range(n_steps):
            p, diag = explicit_step(p, grid, mats, cfgl, body)
            for key in hist:
                hist[key].append(diag[key])
            p, lost = migrate_local2(p, spec, grid, dec.local_box)
            lost_acc = lost_acc + lost
        return p, _finish(hist, lost_acc, spec.comm, "sharded_explicit_run2", p.x.device)

    return run


def sharded_implicit_run2(dec: Decomp2, cfg, n_steps: int):
    """The 2-D-decomposed implicit Newmark run: the Newton-Krylov dots
    all-reduced over both shard axes."""
    from ..formulations.implicit import implicit_step

    cfgl = _localize_cfg(cfg, dec)
    loop = _implicit_loop(lambda p, g, m, b: implicit_step(p, g, m, cfgl, b), dec.spec,
                          dec.local_box, migrate_local2, "sharded_implicit_run2")
    return lambda p, grid, mats, body: loop(p, grid, mats, body, n_steps)
