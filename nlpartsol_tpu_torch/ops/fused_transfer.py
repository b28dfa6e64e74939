"""Fused LME particle↔grid transfers: hand-written CUDA kernels for Hopper.

Counterpart of ``nlpartsol_tpu/ops/pallas_transfer.py``.  The windowed
engine (ops/windowed.py) materialises the per-edge tensors N (Ns, K),
dN (Ns, K, d) and every per-edge value array in device memory.  The fused
kernels never do: for each slot the LME basis (λ-Newton + N + ∇N) is
(re)computed in registers from the slot position and the warm-start λ, and
immediately contracted:

* :func:`fused_scatter` — P2G: per-slot channel values (N-weighted) and/or
  a per-slot 2×2 matrix G (gradient-weighted: contributes G·∇N_A to node A)
  are added into the node array.  Optionally runs the λ Newton solve (once
  per step) and returns the converged λ.
* :func:`fused_gather` — G2P: node fields are contracted against N (channel
  gather) and ∇N (displacement-gradient gather) per slot.

Axis convention (2D): grid dims = (n0, n1), flat node = i0·n1 + i1.  Slot
arrays are capacity-major (ops/windowed.py) and passed channel-leading as
(ch, C, n_cells); coordinate channel c is the position along grid axis c.

Source notes for the kernels (csrc/lme_transfer2d.cu):

``lme_scatter2d`` replaces the TPU kernel ``pallas_transfer.py::
fused_scatter`` (body ``_make_scatter_kernel``).  The function's bound on
the H100 is a few microseconds, its bytes (each slot channel and node once,
tens of MB) and its operations about level; the kernel spends its time on
operations, because it recomputes instead of storing: it sweeps a 32- or
60-offset window several times per slot, testing every offset and taking
one ``exp`` per valid one each time, and ends in one f32 atomic add per
edge and channel.  One thread per slot over the channel-leading layout
gives coalesced loads and, per window offset, neighbouring node addresses
across a warp; the moments of a converged Newton iteration are reused for
the basis, so a warm-started slot sweeps the window three times in all.

``lme_gather2d`` replaces ``pallas_transfer.py::fused_gather`` (body
``_make_gather_kernel``).  The same balance: three passes over the window per
slot (max, moments, contraction) where the function needs one evaluation; the node
fields (a few MB) are read through L2 with read-only loads, no atomics,
the same result from run to run.

Each wrapper takes the plain PyTorch version below only for tensors that
lie on the CPU.  For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..shapefun import lme as lme_mod
from ..shapefun.window import window_offsets
from ..types import Grid
from . import cuda_build, windowed

Tensor = torch.Tensor

MAX_CN = 8  # N-weighted channels per call (csrc: MAX_CN)
MAX_PAIRS = 192  # window offsets per call (csrc: MAX_PAIRS)

#: launches per kernel variant, e.g. ``launch_counts["lme_scatter2d:solve"]``.
#: A wrapper adds one where it launches its kernel, and nowhere else.
launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


class _Geom:
    """Static geometry shared by both kernels and their plain versions:
    a function of the grid spacing, the LME parameters and the margin."""

    def __init__(self, h: float, params: lme_mod.LMEParams, margin: int):
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
        self.pairs = [
            (o0, o1)
            for o0 in range(-self.w, self.w + 1)
            for o1 in range(-self.w, self.w + 1)
            if _md(o0) ** 2 + _md(o1) ** 2 <= rm * rm
        ]
        # the kernels' window argument: a host array of (o0, o1) int pairs
        self.offs_c = (ctypes.c_int * (2 * len(self.pairs)))(
            *[o for pr in self.pairs for o in pr]
        )


_geom_of = functools.lru_cache(maxsize=32)(_Geom)


def _geom(grid: Grid, params: lme_mod.LMEParams, margin: int) -> _Geom:
    """The (cached) geometry of a 2D grid; four transfers a step share it."""
    if grid.dim != 2:
        raise NotImplementedError(
            "fused transfer kernels are 2D; the 3D kernels come with "
            "ROADMAP.md queue 2 (K3, K4)"
        )
    return _geom_of(grid.spacing, params, margin)


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
    offs = window_offsets(2, -g.w, g.w)  # widened window
    cells = torch.as_tensor(windowed.slot_cells(box), device=dev)  # (Ns, 2)
    multi = cells[:, None, :] + torch.as_tensor(offs, device=dev)[None, :, :]
    lo, hi = grid.valid_bounds()
    inb = torch.all(
        (multi >= torch.tensor(lo, dtype=multi.dtype, device=dev))
        & (multi <= torch.tensor(hi, dtype=multi.dtype, device=dev)),
        dim=-1,
    )
    node_pos = multi.to(x.dtype) * g.h + torch.tensor(grid.origin, dtype=x.dtype, device=dev)
    rel = x[:, None, :] - node_pos
    sq = torch.sum(rel * rel, dim=-1)
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
        G = from_channel_leading(G_t).reshape(-1, 2, 2)
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
        K = offs.shape[0]
        nc = box.n_cells
        u = per_cell.reshape((1, nc, K, 2)).expand(box.capacity, nc, K, 2)
        u = u.reshape(box.n_slots, K, 2)
        dNm = torch.where(mask[..., None], dN, torch.zeros_like(dN))
        grad = u.transpose(-1, -2) @ dNm  # grad[s,i,j] = Σ_k u_ki ∂_j N_k
    return outN, grad


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GEOM_ARGS = [_I] * 10 + [_F] * 5 + [ctypes.POINTER(ctypes.c_int), _I]


def _library():
    lib = cuda_build.load("lme_transfer2d")
    if lib.lme_scatter2d.argtypes is None:
        # c_void_p for every pointer and the stream: an unset argtype would
        # pass them as 32-bit ints and cut the pointers
        lib.lme_scatter2d.argtypes = [_P] * 8 + _GEOM_ARGS + [_I] * 5 + [_F, _P]
        lib.lme_scatter2d.restype = _I
        lib.lme_gather2d.argtypes = [_P] * 7 + _GEOM_ARGS + [_I, _P]
        lib.lme_gather2d.restype = _I
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
    if len(g.pairs) > MAX_PAIRS:
        raise ValueError(
            f"LME window of {len(g.pairs)} offsets exceeds the kernels' {MAX_PAIRS}"
        )
    (lo0, lo1), (hi0, hi1) = grid.valid_bounds()
    return [
        box.n_slots, box.n_cells, box.cdims[1], box.offset[0], box.offset[1],
        grid.dims[1], lo0, hi0, lo1, hi1,
        g.h, g.beta, g.r2max, grid.origin[0], grid.origin[1],
        g.offs_c, len(g.pairs),
    ]


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def _count_launch(kernel: str, **tags) -> None:
    on = [t for t, used in tags.items() if used] or ["N"]
    launch_counts[f"{kernel}:{'+'.join(on)}"] += 1


def scatter_cuda(grid, box, params, x_t, lam_t, act_t, fN_t, G_t=None, solve=True,
                 margin=0, gnorm=False):
    """Launch ``lme_scatter2d``.  Returns (nodes, lam, cnt) with ``cnt`` an
    int32 pair [valid edges, Newton iterations summed over slots]."""
    g = _geom(grid, params, margin)
    dev = x_t.device
    C, nc = box.capacity, box.n_cells
    if fN_t.ndim != 3 or not 1 <= fN_t.shape[0] <= MAX_CN:
        raise ValueError(f"fN_t: needs 1..{MAX_CN} channels, got shape {tuple(fN_t.shape)}")
    cN = fN_t.shape[0]
    _check_slot("x_t", x_t, 2, C, nc, dev)
    _check_slot("lam_t", lam_t, 2, C, nc, dev)
    _check_slot("act_t", act_t, 1, C, nc, dev)
    _check_slot("fN_t", fN_t, cN, C, nc, dev)
    if G_t is not None:
        _check_slot("G_t", G_t, 4, C, nc, dev)
    cout = cN + (2 if G_t is not None else 0) + (1 if gnorm else 0)
    nodes = torch.zeros((grid.n_nodes, cout), dtype=torch.float32, device=dev)
    lam_out = torch.empty_like(lam_t)
    cnt = torch.zeros((2,), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.lme_scatter2d(
            x_t.data_ptr(), lam_t.data_ptr(), act_t.data_ptr(), fN_t.data_ptr(),
            None if G_t is None else G_t.data_ptr(),
            nodes.data_ptr(), lam_out.data_ptr(), cnt.data_ptr(),
            *_geom_args(g, grid, box),
            cN, int(G_t is not None), int(gnorm), int(solve), params.max_iter, g.tol2,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "lme_scatter2d")
    _count_launch("lme_scatter2d", solve=solve, G=G_t is not None, gnorm=gnorm)
    return nodes, lam_out, cnt


def gather_cuda(grid, box, params, x_t, lam_t, act_t, gN=None, g_grad=None, margin=0):
    """Launch ``lme_gather2d``.  Returns (outN | None, grad | None)."""
    g = _geom(grid, params, margin)
    dev = x_t.device
    C, nc = box.capacity, box.n_cells
    if gN is None and g_grad is None:
        raise ValueError("nothing to gather")
    _check_slot("x_t", x_t, 2, C, nc, dev)
    _check_slot("lam_t", lam_t, 2, C, nc, dev)
    _check_slot("act_t", act_t, 1, C, nc, dev)
    cN = 0
    if gN is not None:
        _check_nodes("gN", gN, grid.n_nodes, None, dev)
        cN = gN.shape[1]
        if not 1 <= cN <= MAX_CN:
            raise ValueError(f"gN: needs 1..{MAX_CN} channels, got {cN}")
    if g_grad is not None:
        _check_nodes("g_grad", g_grad, grid.n_nodes, 2, dev)
    ns = box.n_slots
    outN = torch.empty((ns, cN), dtype=torch.float32, device=dev) if cN else None
    outG = (
        torch.empty((ns, 2, 2), dtype=torch.float32, device=dev)
        if g_grad is not None
        else None
    )
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.lme_gather2d(
            x_t.data_ptr(), lam_t.data_ptr(), act_t.data_ptr(),
            None if gN is None else gN.data_ptr(),
            None if g_grad is None else g_grad.data_ptr(),
            None if outN is None else outN.data_ptr(),
            None if outG is None else outG.data_ptr(),
            *_geom_args(g, grid, box),
            cN, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "lme_gather2d")
    _count_launch("lme_gather2d", N=gN is not None, grad=g_grad is not None)
    return outN, outG


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def fused_scatter(
    grid: Grid,
    box: windowed.ActiveBox,
    params: lme_mod.LMEParams,
    x_t: Tensor,     # (2, C, nc) slot positions (world frame)
    lam_t: Tensor,   # (2, C, nc) λ warm start
    act_t: Tensor,   # (1, C, nc) active (0/1, float)
    fN_t: Tensor,    # (cN, C, nc) N-weighted channels
    G_t: Optional[Tensor] = None,  # (4, C, nc) grad-weighted row-major 2×2
    solve: bool = True,
    margin: int = 0,
    gnorm: bool = False,
):
    """Fused LME+P2G.  Returns (nodes (n_nodes, cout), lam (2, C, nc), nnz);
    cout = cN (+2 when G_t given, the Σ G·∇N vector appended; +1 when
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
    x_t: Tensor,     # (2, C, nc)
    lam_t: Tensor,   # (2, C, nc) converged λ
    act_t: Tensor,   # (1, C, nc)
    gN: Optional[Tensor] = None,      # (n_nodes, cN)
    g_grad: Optional[Tensor] = None,  # (n_nodes, 2)
    margin: int = 0,
):
    """Fused LME+G2P.  Returns (outN (Ns, cN) | None, grad (Ns, 2, 2) | None)
    where grad[s, i, j] = Σ_A g_grad[A, i]·∂N_A/∂x_j."""
    if gN is None and g_grad is None:
        raise ValueError("nothing to gather")
    if x_t.device.type == "cpu":
        return _gather_plain(grid, box, params, x_t, lam_t, act_t, gN, g_grad, margin)
    return gather_cuda(grid, box, params, x_t, lam_t, act_t, gN=gN, g_grad=g_grad,
                       margin=margin)


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
