"""uGIMP (uniform Generalized Interpolation MPM) shape functions.

Counterpart of ``nlpartsol_tpu/shapefun/gimp.py``: the per-particle voxel
half-width l_p = ½ V₀^{1/d}, the 1D hat-with-plateau kernel S and its
derivative, and the tensor-product N and ∇N on the structured grid's
arithmetic window of half-width 2 cells (the support |Δx| < h + l_p for
l_p ≤ h).  ∂_j S = dS_j · Π_{k≠j} S_k, as the JAX module computes it.
"""

from __future__ import annotations

import torch

from ..types import Grid
from .window import window_nodes, window_offsets

Tensor = torch.Tensor


def offsets_for(dim: int):
    return window_offsets(dim, -2, 2)  # support radius < 2h for l_p ≤ h


def voxel_halfwidth(vol0: Tensor, dim: int) -> Tensor:
    """l_p = ½ V₀^{1/d} per axis."""
    return 0.5 * vol0 ** (1.0 / dim)


def check_halfwidth(lp: Tensor, h: float):
    """The 2-cell window holds the support only while l_p ≤ h (reads the
    device once: a set-up check, never a step's)."""
    lp_max = float(torch.max(lp)) if lp.numel() else 0.0
    if lp_max > h:
        raise ValueError(
            f"uGIMP voxel half-width l_p={lp_max:.3g} exceeds grid spacing h={h:.3g}: "
            "the 2-cell support window (offsets_for) would truncate the support. "
            "Refine particles or coarsen the grid."
        )


def _sip(L, lp, dx):
    """1D uGIMP kernel, branch-free."""
    a = torch.abs(dx)
    # |dx| <= lp            : 1 − (dx² + lp²)/(2 L lp)
    # lp < |dx| <= L − lp   : 1 − |dx|/L
    # L−lp < |dx| <= L + lp : (L + lp − |dx|)² / (4 L lp)
    r1 = 1.0 - 0.5 * (dx * dx + lp * lp) / (L * lp)
    r2 = 1.0 - a / L
    r3 = 0.25 * (L + lp - a) ** 2 / (L * lp)
    out = torch.where(a <= lp, r1, torch.where(a <= L - lp, r2, r3))
    return torch.where(a < L + lp, out, torch.zeros_like(out))


def _dsip(L, lp, dx):
    """Derivative of the 1D uGIMP kernel."""
    a = torch.abs(dx)
    s = torch.sign(dx)
    r1 = -dx / (L * lp)
    r2 = -s / L
    r3 = -s * 0.5 * (L + lp - a) / (L * lp)
    out = torch.where(a <= lp, r1, torch.where(a <= L - lp, r2, r3))
    return torch.where(a < L + lp, out, torch.zeros_like(out))


def evaluate(grid: Grid, x: Tensor, lp: Tensor):
    """uGIMP N, ∇N on the structured grid.  Never reads the host: the
    l_p ≤ h guard is ``check_halfwidth``, run once at set-up.

    Args:
      x: (Np, d) particle positions.
      lp: (Np,) voxel half-width per particle (isotropic).
    Returns the dict of ``lme.evaluate`` with ``lam`` None.
    """
    offs = offsets_for(grid.dim)
    node_ids, rel, mask = window_nodes(grid, x, offs)
    h = grid.spacing
    lpk = lp[:, None, None]  # (Np, 1, 1)
    s1d = _sip(h, lpk, rel)  # (Np, K, d)
    d1d = _dsip(h, lpk, rel)
    N = torch.prod(s1d, dim=-1)
    d = grid.dim
    cols = []
    for j in range(d):
        others = torch.prod(torch.stack([s1d[..., k] for k in range(d) if k != j], dim=-1),
                            dim=-1)
        cols.append(d1d[..., j] * others)
    dN = torch.stack(cols, dim=-1)
    zero = torch.zeros((), dtype=N.dtype, device=N.device)
    N = torch.where(mask, N, zero)
    dN = torch.where(mask[..., None], dN, zero)
    return dict(node_ids=node_ids, N=N, dN=dN, mask=mask & (N > 0.0), lam=None)
