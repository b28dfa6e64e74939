"""Fused LME particle↔grid transfers: hand-written CUDA kernels for Hopper.

Counterpart of ``nlpartsol_tpu/ops/pallas_transfer.py``.  The windowed
engine (ops/windowed.py) materialises the per-edge tensors N (Ns, K),
dN (Ns, K, d) and every per-edge value array in device memory.  The fused
kernels never do: for each slot the LME basis (λ-Newton + N + ∇N) is
(re)computed in registers from the slot position and the warm-start λ, and
immediately contracted:

* :func:`fused_scatter` — P2G: per-slot channel values (N-weighted) and/or
  a per-slot d×d matrix G (gradient-weighted: contributes G·∇N_A to node A)
  are added into the node array.  Optionally runs the λ Newton solve (once
  per step) and returns the converged λ.
* :func:`fused_gather` — G2P: node fields are contracted against N (channel
  gather) and ∇N (displacement-gradient gather) per slot.

Both dispatch on ``grid.dim``: 2D grids go to ``csrc/lme_transfer2d.cu``,
3D grids to ``csrc/lme_transfer3d.cu``.  Axis convention: grid dims =
(n0, n1[, n2]), flat node = i0·n1 + i1 (2D) or (i0·n1 + i1)·n2 + i2 (3D).
Slot arrays are capacity-major (ops/windowed.py) and passed channel-leading
as (ch, C, n_cells); coordinate channel c is the position along grid axis c.

The kernels (``csrc/lme_transfer2d.cu``: ``lme_scatter2d``,
``lme_gather2d``; ``csrc/lme_transfer3d.cu``: ``lme_scatter3d``,
``lme_gather3d``) replace the TPU kernels of ``pallas_transfer.py``
(``fused_scatter``, body ``_make_scatter_kernel``; ``fused_gather``, body
``_make_gather_kernel``) and of ``pallas_transfer3d.py`` (``fused_scatter3``
and ``_scatter_pallas3m``, ``fused_gather3`` and ``_gather_pallas3m``: two
lane arrangements of each, chosen by VMEM size, that one thread per slot
serves on the card).  Each call recomputes the basis in registers, so its
time goes to operations, and the first designs lost it to repeated sweeps
over the window and to one global f32 atomic per edge and channel.  Both
dimensions now share one design:

* each evaluation of the moments is one sweep over the window, against a
  running max of f (sums rescaled when it rises): a Newton iteration is one
  sweep, and the gather is one sweep in all — at fixed λ it sums
  e·g_A and e·g_A⊗l_A beside the moments and applies J⁻¹ and r̄ = S1/Z once
  per slot (∇N_A = −N_A·J⁻¹(l_A − r̄) summed);
* the window is walked as rows (all axes but the last fixed), taken
  nearest-first from the cell centre, each cut per slot to the range along
  the last axis that can meet the support radius: only offsets the exact
  test r² ≤ R² rejects are skipped, so nnz stays equal to the plain
  version's;
* a scatter block walks a tile of box cells (:func:`tile_plan`; every
  capacity rank) and adds each edge into the tile's node footprint in
  shared memory, then flushes each non-zero footprint entry with one global
  atomic instead of one per edge and channel.

Each wrapper takes the plain PyTorch version below only for tensors that
lie on the CPU.  For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..shapefun import lme as lme_mod
from ..shapefun.window import window_offsets
from ..types import Grid
from . import cuda_build, windowed

Tensor = torch.Tensor

MAX_CN = 12  # N-weighted channels per call (csrc: MAX_CN)
# window offsets per call, by dimension (csrc: MAX_PAIRS, MAX_TRIPS)
MAX_OFFSETS = {2: 192, 3: 512}
# cells of a scatter tile per box axis, by dimension; the fewest tiles a box
# is cut into (two blocks for each of an H100's 132 SMs); and the shared
# memory a block may use on an H100 (the one check of it is tile_plan's)
TILE = {2: (4, 8), 3: (8, 4, 4)}
MIN_TILES = 2 * 132
MAX_SHARED_BYTES = 232448
_SOURCES = {2: "lme_transfer2d", 3: "lme_transfer3d"}

#: launches per kernel variant, e.g. ``launch_counts["lme_scatter2d:solve"]``.
#: A wrapper adds one where it launches its kernel, and nowhere else.
launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


class _Geom:
    """Static geometry shared by both kernels and their plain versions:
    a function of the dimension, the grid spacing, the LME parameters and
    the margin."""

    def __init__(self, dim: int, h: float, params: lme_mod.LMEParams, margin: int):
        self.dim = dim
        self.h = h
        self.beta = lme_mod.beta_of(params, h)
        r_sup = lme_mod.support_radius(params, h)
        self.r2max = r_sup * r_sup
        # margin widens the window so particles may drift up to `margin`
        # cells from their binned slot cell between re-binnings: the radius
        # mask r² ≤ R² keeps the evaluated basis exact regardless of which
        # cell inside the widened window the particle actually occupies.
        self.w = lme_mod.window_halfwidth(params, 1.0) + margin
        # λ-Newton tolerance of the kernel: relative to the support radius
        self.tol2 = params.tol_lambda * params.tol_lambda * self.r2max

        # Radius culling.  A particle sits within [0, 1) cells (+ margin
        # drift) of its slot cell's LOWER corner, so the closest approach to
        # the node at offset o is ASYMMETRIC: max(0, o − 1 − margin) above,
        # max(0, −o − margin) below.  Offsets whose closest approach exceeds
        # the support radius can never contribute and are skipped statically.
        def _md(o):
            return max(0.0, o - 1.0 - margin, -o - margin)

        rm = r_sup / h
        self.offsets = [
            tuple(int(v) for v in o)
            for o in window_offsets(dim, -self.w, self.w)
            if sum(_md(v) ** 2 for v in o) <= rm * rm
        ]
        # the kernels' window argument: a host array of d-tuples of ints.  The
        # kernels walk it as rows (all axes but the last fixed, the last
        # rising), taken nearest-first from the cell centre so that the
        # running max of f over a slot's window settles in its first rows
        order = sorted(self.offsets,
                       key=lambda o: (sum((v - 0.5) ** 2 for v in o[:-1]), o))
        self.offs_c = (ctypes.c_int * (dim * len(order)))(*[v for o in order for v in o])


_geom_of = functools.lru_cache(maxsize=32)(_Geom)


def _geom(grid: Grid, params: lme_mod.LMEParams, margin: int) -> _Geom:
    """The (cached) geometry of a 2D or 3D grid; four transfers a step
    share it."""
    if grid.dim not in _SOURCES:
        raise ValueError(f"fused transfers take 2D and 3D grids, not {grid.dim}D")
    return _geom_of(grid.dim, grid.spacing, params, margin)


class TilePlan(NamedTuple):
    """The cell tiles of ``lme_scatter2d`` / ``lme_scatter3d``: one block per
    tile."""

    tile: tuple       # cells per box axis
    footprint: tuple  # nodes per axis: tile + the window's offset span
    lo: tuple         # the window's lowest offset per axis
    counts: tuple     # tiles per box axis (the last ones ragged)
    shared_bytes: int  # the footprint's sums, cout float32 channels


def tile_plan(cdims, offsets, cout: int) -> TilePlan:
    """Tile plan of the scatter kernel for a box of ``cdims`` cells (2D or
    3D), a window of ``offsets`` and ``cout`` output channels: ``TILE`` of
    the dimension cut to the box, its axis 0 halved (down to 2 cells) while
    the box has fewer than ``MIN_TILES`` tiles.  A block's threads walk its
    slots in series, so a small box in large tiles runs a few long blocks:
    on an H100, a 24³-cell box in 108 tiles of 8×4×4 took 1.5-2.0× the time
    of one block per 128 slots, in 432 tiles of 2×4×4 about the same; the
    2D main path's 260²-cell box at capacity 6 scatters 1.3-1.5× faster in
    2,145 tiles of 4×8 than in 561 of 8×16 (PERF.md).  Raises ValueError
    when the footprint's sums exceed the shared memory of a block; the plan
    is never shrunk to fit."""
    d = len(cdims)
    t = [min(a, c) for a, c in zip(TILE[d], cdims)]
    while t[0] > 2 and int(np.prod([-(-c // a) for c, a in zip(cdims, t)])) < MIN_TILES:
        t[0] //= 2
    lo = tuple(min(o[ax] for o in offsets) for ax in range(d))
    hi = tuple(max(o[ax] for o in offsets) for ax in range(d))
    foot = tuple(t[ax] + hi[ax] - lo[ax] for ax in range(d))
    shared = 4 * cout * int(np.prod(foot))
    if shared > MAX_SHARED_BYTES:
        raise ValueError(
            f"lme_scatter{d}d tile {tuple(t)} with a {foot} node footprint and {cout} "
            f"channels needs {shared} bytes of shared memory, above the "
            f"{MAX_SHARED_BYTES} a block may use"
        )
    counts = tuple(-(-c // a) for c, a in zip(cdims, t))
    return TilePlan(tuple(t), foot, lo, counts, shared)


_tile_plan_of = functools.lru_cache(maxsize=64)(
    lambda cdims, g, cout: tile_plan(cdims, g.offsets, cout))


def _sq_norm(rel: Tensor) -> Tensor:
    """Σ_i rel_i² summed axis by axis in order — the kernels' order, so the
    radius mask r² ≤ R² is bit-identical on the card (a reduction kernel
    may add three terms in any order)."""
    sq = rel[..., 0] * rel[..., 0]
    for i in range(1, rel.shape[-1]):
        sq = sq + rel[..., i] * rel[..., i]
    return sq


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU tensors; the card's yardstick of correctness)
# ---------------------------------------------------------------------------


def _plain_basis(g: _Geom, grid, box, params, x_t, lam_t, act_t, solve):
    """Slot-cell-centred widened-window LME basis in plain tensor code — the
    exact semantics of the kernels.  The window is centred on the cell of
    the SLOT, never on the cell the particle is in now."""
    dev = x_t.device
    x = from_channel_leading(x_t)
    lam0 = from_channel_leading(lam_t)
    act = from_channel_leading(act_t)[:, 0] > 0.5
    offs = window_offsets(g.dim, -g.w, g.w)  # widened window
    cells = torch.as_tensor(windowed.slot_cells(box), device=dev)  # (Ns, d)
    multi = cells[:, None, :] + torch.as_tensor(offs, device=dev)[None, :, :]
    lo, hi = grid.valid_bounds()
    inb = torch.all(
        (multi >= torch.tensor(lo, dtype=multi.dtype, device=dev))
        & (multi <= torch.tensor(hi, dtype=multi.dtype, device=dev)),
        dim=-1,
    )
    node_pos = multi.to(x.dtype) * g.h + torch.tensor(grid.origin, dtype=x.dtype, device=dev)
    rel = x[:, None, :] - node_pos
    sq = _sq_norm(rel)
    mask = inb & (sq <= torch.tensor(g.r2max, dtype=sq.dtype, device=dev)) & act[:, None]
    if solve:
        lam = lme_mod.solve_lambda(rel, mask, lam0, g.beta, params)
    else:
        lam = lam0
    # rows with an empty mask (inactive slots) come out as NaN here; every
    # consumer masks N and dN with ``where``
    N, dN = lme_mod.basis_from_lambda(rel, sq, mask, lam, g.beta)
    return offs, N, dN, mask, lam


def _scatter_plain(grid, box, params, x_t, lam_t, act_t, fN_t, G_t, solve, margin, gnorm):
    g = _geom(grid, params, margin)
    offs, N, dN, mask, lam = _plain_basis(g, grid, box, params, x_t, lam_t, act_t, solve)
    C, nc = box.capacity, box.n_cells
    fN = from_channel_leading(fN_t)  # (Ns, cN)
    cols = [N[..., None] * fN[:, None, :]]
    if G_t is not None:
        G = from_channel_leading(G_t).reshape(-1, g.dim, g.dim)
        cols.append(dN @ G.transpose(-1, -2))  # Σ_j G_ij ∂_j N
    if gnorm:
        s = fN[:, -1]
        cols.append((s[:, None] * torch.sum(dN * dN, dim=-1))[..., None])
    vals = torch.cat(cols, dim=-1)
    vals = torch.where(mask[..., None], vals, torch.zeros_like(vals))
    nodes = windowed.p2g(vals, box, grid, offs)
    nnz = torch.sum(mask, dtype=torch.int32)
    return nodes, to_channel_leading(lam, C, nc), nnz


def _gather_plain(grid, box, params, x_t, lam_t, act_t, gN, g_grad, margin):
    g = _geom(grid, params, margin)
    offs, N, dN, mask, _ = _plain_basis(g, grid, box, params, x_t, lam_t, act_t, solve=False)
    Nm = torch.where(mask, N, torch.zeros_like(N))
    outN = windowed.g2p(gN, Nm, box, grid, offs) if gN is not None else None
    grad = None
    if g_grad is not None:
        per_cell = windowed.cell_edge_field(g_grad, box, grid, offs)
        K, d = offs.shape
        nc = box.n_cells
        u = per_cell.reshape((1, nc, K, d)).expand(box.capacity, nc, K, d)
        u = u.reshape(box.n_slots, K, d)
        dNm = torch.where(mask[..., None], dN, torch.zeros_like(dN))
        grad = u.transpose(-1, -2) @ dNm  # grad[s,i,j] = Σ_k u_ki ∂_j N_k
    return outN, grad


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _geom_argtypes(dim: int) -> list:
    """Slot/box/grid ints, then floats, then the host window array and its
    length (see ``_geom_args``)."""
    n_int, n_float = (10, 5) if dim == 2 else (15, 6)
    return [_I] * n_int + [_F] * n_float + [ctypes.POINTER(ctypes.c_int), _I]


def _library(dim: int):
    """The loaded library of the ``dim``-D kernels, built at first use."""
    lib = cuda_build.load(_SOURCES[dim])
    scatter = getattr(lib, f"lme_scatter{dim}d")
    if scatter.argtypes is None:
        gather = getattr(lib, f"lme_gather{dim}d")
        # c_void_p for every pointer and the stream: an unset argtype would
        # pass them as 32-bit ints and cut the pointers
        geom = _geom_argtypes(dim)
        plan = [ctypes.POINTER(ctypes.c_int)]
        scatter.argtypes = [_P] * 8 + geom + plan + [_I] * 5 + [_F, _P]
        scatter.restype = _I
        gather.argtypes = [_P] * 7 + geom + [_I, _P]
        gather.restype = _I
    return lib


def _check_slot(name, a, ch, C, nc, dev):
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if a.device != dev:
        raise ValueError(f"{name}: on {a.device}, expected {dev}")
    if a.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernels take float32, got {a.dtype}")
    if tuple(a.shape) != (ch, C, nc):
        raise ValueError(f"{name}: shape {tuple(a.shape)}, expected {(ch, C, nc)}")
    if not a.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_nodes(name, a, n_nodes, c, dev):
    if a.device != dev or a.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 on {dev}, got {a.dtype} on {a.device}")
    if a.ndim != 2 or a.shape[0] != n_nodes or (c is not None and a.shape[1] != c):
        raise ValueError(f"{name}: shape {tuple(a.shape)}, expected ({n_nodes}, {c or 'cN'})")
    if not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _geom_args(g: _Geom, grid: Grid, box: windowed.ActiveBox):
    """The geometry arguments of the C entry points: Ns, nc, the box's
    trailing cell counts, its cell origin, the grid's trailing node counts,
    the valid node bounds per axis; then h, β, R², the origin; then the
    window."""
    d = g.dim
    if len(g.offsets) > MAX_OFFSETS[d]:
        raise ValueError(
            f"LME window of {len(g.offsets)} offsets exceeds the {d}D kernels' "
            f"{MAX_OFFSETS[d]}"
        )
    lo, hi = grid.valid_bounds()
    bounds = [v for ax in range(d) for v in (lo[ax], hi[ax])]
    return [
        box.n_slots, box.n_cells, *box.cdims[1:], *box.offset, *grid.dims[1:], *bounds,
        g.h, g.beta, g.r2max, *grid.origin,
        g.offs_c, len(g.offsets),
    ]


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def _count_launch(kernel: str, **tags) -> None:
    on = [t for t, used in tags.items() if used] or ["N"]
    launch_counts[f"{kernel}:{'+'.join(on)}"] += 1


def scatter_cuda(grid, box, params, x_t, lam_t, act_t, fN_t, G_t=None, solve=True,
                 margin=0, gnorm=False):
    """Launch ``lme_scatter2d`` or ``lme_scatter3d`` (by ``grid.dim``).
    Returns (nodes, lam, cnt) with ``cnt`` an int32 pair [valid edges,
    Newton iterations summed over slots]."""
    g = _geom(grid, params, margin)
    d = g.dim
    dev = x_t.device
    C, nc = box.capacity, box.n_cells
    if fN_t.ndim != 3 or not 1 <= fN_t.shape[0] <= MAX_CN:
        raise ValueError(f"fN_t: needs 1..{MAX_CN} channels, got shape {tuple(fN_t.shape)}")
    cN = fN_t.shape[0]
    _check_slot("x_t", x_t, d, C, nc, dev)
    _check_slot("lam_t", lam_t, d, C, nc, dev)
    _check_slot("act_t", act_t, 1, C, nc, dev)
    _check_slot("fN_t", fN_t, cN, C, nc, dev)
    if G_t is not None:
        _check_slot("G_t", G_t, d * d, C, nc, dev)
    cout = cN + (d if G_t is not None else 0) + (1 if gnorm else 0)
    nodes = torch.zeros((grid.n_nodes, cout), dtype=torch.float32, device=dev)
    lam_out = torch.empty_like(lam_t)
    cnt = torch.zeros((2,), dtype=torch.int32, device=dev)
    tp = _tile_plan_of(tuple(box.cdims), g, cout)
    plan = (ctypes.c_int * (3 * d))(*tp.tile, *tp.footprint, *tp.lo)
    name = f"lme_scatter{d}d"
    fn = getattr(_library(d), name)
    with torch.cuda.device(dev):
        err = fn(
            x_t.data_ptr(), lam_t.data_ptr(), act_t.data_ptr(), fN_t.data_ptr(),
            None if G_t is None else G_t.data_ptr(),
            nodes.data_ptr(), lam_out.data_ptr(), cnt.data_ptr(),
            *_geom_args(g, grid, box), plan,
            cN, int(G_t is not None), int(gnorm), int(solve), params.max_iter, g.tol2,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, name)
    _count_launch(name, solve=solve, G=G_t is not None, gnorm=gnorm)
    return nodes, lam_out, cnt


def gather_cuda(grid, box, params, x_t, lam_t, act_t, gN=None, g_grad=None, margin=0):
    """Launch ``lme_gather2d`` or ``lme_gather3d`` (by ``grid.dim``).
    Returns (outN | None, grad | None)."""
    g = _geom(grid, params, margin)
    d = g.dim
    dev = x_t.device
    C, nc = box.capacity, box.n_cells
    if gN is None and g_grad is None:
        raise ValueError("nothing to gather")
    _check_slot("x_t", x_t, d, C, nc, dev)
    _check_slot("lam_t", lam_t, d, C, nc, dev)
    _check_slot("act_t", act_t, 1, C, nc, dev)
    cN = 0
    if gN is not None:
        _check_nodes("gN", gN, grid.n_nodes, None, dev)
        cN = gN.shape[1]
        if not 1 <= cN <= MAX_CN:
            raise ValueError(f"gN: needs 1..{MAX_CN} channels, got {cN}")
    if g_grad is not None:
        _check_nodes("g_grad", g_grad, grid.n_nodes, d, dev)
    ns = box.n_slots
    outN = torch.empty((ns, cN), dtype=torch.float32, device=dev) if cN else None
    outG = (
        torch.empty((ns, d, d), dtype=torch.float32, device=dev)
        if g_grad is not None
        else None
    )
    name = f"lme_gather{d}d"
    fn = getattr(_library(d), name)
    with torch.cuda.device(dev):
        err = fn(
            x_t.data_ptr(), lam_t.data_ptr(), act_t.data_ptr(),
            None if gN is None else gN.data_ptr(),
            None if g_grad is None else g_grad.data_ptr(),
            None if outN is None else outN.data_ptr(),
            None if outG is None else outG.data_ptr(),
            *_geom_args(g, grid, box),
            cN, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, name)
    _count_launch(name, N=gN is not None, grad=g_grad is not None)
    return outN, outG


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def fused_scatter(
    grid: Grid,
    box: windowed.ActiveBox,
    params: lme_mod.LMEParams,
    x_t: Tensor,     # (d, C, nc) slot positions (world frame)
    lam_t: Tensor,   # (d, C, nc) λ warm start
    act_t: Tensor,   # (1, C, nc) active (0/1, float)
    fN_t: Tensor,    # (cN, C, nc) N-weighted channels
    G_t: Optional[Tensor] = None,  # (d·d, C, nc) grad-weighted row-major d×d
    solve: bool = True,
    margin: int = 0,
    gnorm: bool = False,
):
    """Fused LME+P2G.  Returns (nodes (n_nodes, cout), lam (d, C, nc), nnz);
    cout = cN (+d when G_t given, the Σ G·∇N vector appended; +1 when
    ``gnorm``: Σ s·|∇N|² with s = the LAST fN channel — the Jacobi stiffness
    diagonal of the implicit path).  Node-plane validity comes from
    ``grid.valid_lo``/``grid.valid_hi``."""
    if x_t.device.type == "cpu":
        return _scatter_plain(grid, box, params, x_t, lam_t, act_t, fN_t, G_t,
                              solve, margin, gnorm)
    nodes, lam, cnt = scatter_cuda(grid, box, params, x_t, lam_t, act_t, fN_t,
                                   G_t=G_t, solve=solve, margin=margin, gnorm=gnorm)
    return nodes, lam, cnt[0]


def fused_gather(
    grid: Grid,
    box: windowed.ActiveBox,
    params: lme_mod.LMEParams,
    x_t: Tensor,     # (d, C, nc)
    lam_t: Tensor,   # (d, C, nc) converged λ
    act_t: Tensor,   # (1, C, nc)
    gN: Optional[Tensor] = None,      # (n_nodes, cN)
    g_grad: Optional[Tensor] = None,  # (n_nodes, d)
    margin: int = 0,
):
    """Fused LME+G2P.  Returns (outN (Ns, cN) | None, grad (Ns, d, d) | None)
    where grad[s, i, j] = Σ_A g_grad[A, i]·∂N_A/∂x_j."""
    if gN is None and g_grad is None:
        raise ValueError("nothing to gather")
    if x_t.device.type == "cpu":
        return _gather_plain(grid, box, params, x_t, lam_t, act_t, gN, g_grad, margin)
    return gather_cuda(grid, box, params, x_t, lam_t, act_t, gN=gN, g_grad=g_grad,
                       margin=margin)


# ---------------------------------------------------------------------------
# forward-mode derivatives of the linear uses (the implicit step's J·v)
# ---------------------------------------------------------------------------
#
# At a fixed λ each kernel call below is linear in one node or slot field, so
# its derivative along a tangent is the same call on the tangent: the JAX
# package's ``implicit._linear_op`` (a custom JVP returning fn(x), fn(t)).
# Under forward-mode AD with dual tensors (``solvers.jvp``) each launches its
# kernel for the primal and once more for the tangent.  ``geo`` = (grid,
# box, params, x_t, lam_t, act_t, margin): positions, λ and ``act`` carry no
# tangent.


def _keep_geo(ctx, inputs, output):
    ctx.geo = inputs[1]


def _gather_grad(v: Tensor, geo) -> Tensor:
    grid, box, params, x_t, lam_t, act_t, margin = geo
    return fused_gather(grid, box, params, x_t, lam_t, act_t, g_grad=v.contiguous(),
                        margin=margin)[1]


def _gather_n(v: Tensor, geo) -> Tensor:
    grid, box, params, x_t, lam_t, act_t, margin = geo
    return fused_gather(grid, box, params, x_t, lam_t, act_t, gN=v.contiguous(),
                        margin=margin)[0]


def _gather_n_grad(v: Tensor, geo, n_from: int = 0):
    grid, box, params, x_t, lam_t, act_t, margin = geo
    return fused_gather(grid, box, params, x_t, lam_t, act_t, gN=v[:, n_from:].contiguous(),
                        g_grad=v[:, :grid.dim].contiguous(), margin=margin)


def _scatter_ng(c: Tensor, geo) -> Tensor:
    grid, box, params, x_t, lam_t, act_t, margin = geo
    d = grid.dim
    C, nc = box.capacity, box.n_cells
    fN_t = to_channel_leading(c[:, :c.shape[1] - d * d], C, nc)
    G_t = to_channel_leading(c[:, c.shape[1] - d * d:], C, nc)
    return fused_scatter(grid, box, params, x_t, lam_t, act_t, fN_t, G_t=G_t, solve=False,
                         margin=margin)[0]


def _scatter_g(G: Tensor, geo) -> Tensor:
    grid, box, params, x_t, lam_t, act_t, margin = geo
    d = grid.dim
    C, nc = box.capacity, box.n_cells
    zero = torch.zeros((1, C, nc), dtype=G.dtype, device=G.device)
    G_t = to_channel_leading(G.reshape(-1, d * d), C, nc)
    return fused_scatter(grid, box, params, x_t, lam_t, act_t, zero, G_t=G_t, solve=False,
                         margin=margin)[0]


class GatherGrad(torch.autograd.Function):
    """(n_nodes, d) node field ↦ (Ns, d, d) Σ_A g_A ⊗ ∇N_A at fixed λ."""

    @staticmethod
    def forward(v, geo):
        return _gather_grad(v, geo)

    setup_context = staticmethod(_keep_geo)

    @staticmethod
    def jvp(ctx, t, _):
        return _gather_grad(t, ctx.geo)


class GatherN(torch.autograd.Function):
    """(n_nodes, cN) node field ↦ (Ns, cN) Σ_A N_A·f_A at fixed λ."""

    @staticmethod
    def forward(v, geo):
        return _gather_n(v, geo)

    setup_context = staticmethod(_keep_geo)

    @staticmethod
    def jvp(ctx, t, _):
        return _gather_n(t, ctx.geo)


class GatherNGrad(torch.autograd.Function):
    """(n_nodes, cN ≥ d) node field f ↦ ((Ns, cN − n_from) Σ_A N_A·f_A[n_from:],
    (Ns, d, d) Σ_A f_A[:d] ⊗ ∇N_A) at fixed λ: both from one launch, the
    gradient of the field's first d columns (a copy of its own, so the
    kernel's reuse of the N-sums for a gradient of the same field never
    applies).  ``apply(v, geo)`` or ``apply(v, geo, n_from)``."""

    @staticmethod
    def forward(v, geo, n_from=0):
        return _gather_n_grad(v, geo, n_from)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.geo = inputs[1]
        ctx.n_from = inputs[2] if len(inputs) > 2 else 0

    @staticmethod
    def jvp(ctx, t, *_):
        return _gather_n_grad(t, ctx.geo, ctx.n_from)


class ScatterNG(torch.autograd.Function):
    """(Ns, cN + d·d) slot rows [N channels | G row-major] ↦ the scatter's
    (n_nodes, cN + d) nodes at fixed λ: Σ_p N_A·f, then Σ_p G·∇N_A."""

    @staticmethod
    def forward(c, geo):
        return _scatter_ng(c, geo)

    setup_context = staticmethod(_keep_geo)

    @staticmethod
    def jvp(ctx, t, _):
        return _scatter_ng(t, ctx.geo)


class ScatterG(torch.autograd.Function):
    """(Ns, d, d) slot matrices G ↦ the scatter's (n_nodes, 1 + d) nodes at
    fixed λ: a zero N channel, then Σ_p G·∇N_A."""

    @staticmethod
    def forward(G, geo):
        return _scatter_g(G, geo)

    setup_context = staticmethod(_keep_geo)

    @staticmethod
    def jvp(ctx, t, _):
        return _scatter_g(t, ctx.geo)


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def to_channel_leading(a: Tensor, C: int, nc: int) -> Tensor:
    """(Ns[, ch]) capacity-major slot array → contiguous (ch, C, nc)."""
    if a.ndim == 1:
        return a.reshape(1, C, nc)
    return a.transpose(0, 1).reshape(a.shape[1], C, nc).contiguous()


def from_channel_leading(a: Tensor) -> Tensor:
    """(ch, C, nc) → (Ns, ch)."""
    return a.reshape(a.shape[0], -1).transpose(0, 1)
