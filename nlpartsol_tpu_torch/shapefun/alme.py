"""Anisotropic LME (aLME) shape functions.

Counterpart of ``nlpartsol_tpu/shapefun/alme.py``: the LME basis with a
tensor-valued thermalisation parameter per particle,

  f_a = −l_aᵀ β l_a + λ·l_a,   β₀ = γ/h² · I,   β ← ΔF⁻ᵀ β ΔF⁻¹ per step,

and the elliptical support l·C·l ≤ 1 with C = β/(−ln tol), derived from β
(the pull-back commutes with the scaling), so the particle state carries
only β (``Particles.lme_beta``).  The λ-Newton, the gradient formula and the
masked softmax are the isotropic LME module's.  The JAX ``fori_loop`` of
``max_iter`` Newton sweeps is a Python loop of the same count that never
reads the host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import tensor as tn
from ..types import Grid
from .lme import _masked_softmax, _r_and_J, _safe_solve
from .window import window_nodes, window_offsets

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ALMEParams:
    gamma: float = 3.0
    tol_zero: float = 1e-10
    max_iter: int = 10
    tol_lambda: float = 1e-10
    # static bound on the support stretch (window half-width multiplier):
    # the elliptical support grows as β is pulled back by deformation
    max_stretch: float = 1.5

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def beta0(params: ALMEParams, h: float, dim: int) -> np.ndarray:
    """Initial isotropic β = γ/h² · I (the LME value)."""
    return (params.gamma / (h * h)) * np.eye(dim, dtype=np.float32)


def init_lme_beta(n: int, params: ALMEParams, h: float, dim: int, device="cuda",
                  dtype=torch.float32) -> Tensor:
    b = torch.as_tensor(beta0(params, h, dim), dtype=dtype, device=device)
    return b.expand(n, dim, dim).contiguous()


def update_beta(beta_t: Tensor, DF: Tensor) -> Tensor:
    """β ← ΔF⁻ᵀ β ΔF⁻¹."""
    DFinv = tn.inv(DF)
    return tn.bmm(tn.bmm(DFinv.transpose(-1, -2), beta_t), DFinv)


def window_halfwidth(params: ALMEParams) -> int:
    r_over_h = math.sqrt(-math.log(params.tol_zero) / params.gamma)
    return int(math.ceil(r_over_h * params.max_stretch))


def offsets_for(dim: int, params: ALMEParams) -> np.ndarray:
    w = window_halfwidth(params)
    return window_offsets(dim, -w, w)


def evaluate(grid: Grid, x: Tensor, lam0: Tensor, beta_t: Tensor, params: ALMEParams):
    """Fused aLME local search + λ solve + N + ∇N.

    Args:
      beta_t: (Np, d, d) per-particle anisotropic β tensor.
    Same return contract as ``lme.evaluate``.
    """
    offs = offsets_for(grid.dim, params)
    node_ids, rel, inb = window_nodes(grid, x, offs)
    # elliptical cutoff: l·C·l ≤ 1 with C = β / (−ln tol)
    lbl = torch.einsum("pki,pij,pkj->pk", rel, beta_t, rel)
    cutoff = -math.log(params.tol_zero)
    mask = inb & (lbl <= cutoff)

    def f_of(lam):
        return -lbl + (rel @ lam[..., None])[..., 0]

    lam = lam0
    for _ in range(params.max_iter):
        p = _masked_softmax(f_of(lam), mask)
        r, J = _r_and_J(p, rel)
        dlam = _safe_solve(J, r)
        conv = torch.linalg.vector_norm(r, dim=-1) <= params.tol_lambda
        lam = torch.where(conv[..., None], lam, lam - dlam)

    N = _masked_softmax(f_of(lam), mask)
    r, J = _r_and_J(N, rel)
    eye = torch.eye(grid.dim, dtype=J.dtype, device=J.device)
    Jinv = tn.inv(J + 1e-10 * tn.trace(J)[..., None, None] * eye)
    dN = -N[..., None] * ((rel - r[:, None, :]) @ Jinv.transpose(-1, -2))
    return dict(node_ids=node_ids, N=N, dN=dN, mask=mask, lam=lam)
