"""Particle kinematics (counterpart of
``nlpartsol_tpu/formulations/kinematics.py``).

All batched over particles; nodal values arrive as per-edge arrays from the
transfer engine (ops/transfer.py), so these are pure per-particle tensor
algebra.
"""

from __future__ import annotations

import torch

from ..ops import tensor as tn


def disp_gradient(edge_vals: torch.Tensor, dN: torch.Tensor) -> torch.Tensor:
    """Σ_A u_A ⊗ ∇N_A from per-edge nodal values (Np, K, d) and gradients
    (Np, K, d) → (Np, d, d)."""
    return edge_vals.transpose(-1, -2) @ dN


def incremental_deformation_gradient(du_edges, dN) -> torch.Tensor:
    """ΔF = I + Σ_A Δu_A ⊗ ∇N_A."""
    g = disp_gradient(du_edges, dN)
    d = dN.shape[-1]
    return g + torch.eye(d, dtype=g.dtype, device=g.device)


def rate_deformation_gradient_n1(dt_DF, F_n, DF, dFdt_n):
    """Ḟ_{n+1} = (dΔF/dt)·F_n + ΔF·Ḟ_n."""
    return tn.bmm(dt_DF, F_n) + tn.bmm(DF, dFdt_n)


def push_forward_dN(dN, DF):
    """∇N^{n+1} = ΔF^{-T} ∇N^n per particle.

    dN: (Np, K, d); DF: (Np, d, d) → (Np, K, d).
    """
    return dN @ tn.inv(DF)


def cell_patch_jacobian(box, J_n, J_n1, vol0, active):
    """Patch ΔJ = Σ_cell(J_{n+1}·V0)/Σ_cell(J_n·V0) broadcast back to slots
    (the slot layout makes the cell the natural F-bar patch)."""
    nc = box.n_cells
    zero = torch.zeros_like(J_n)
    vn = torch.where(active, J_n * vol0, zero).reshape(box.capacity, nc).sum(0)
    vn1 = torch.where(active, J_n1 * vol0, zero).reshape(box.capacity, nc).sum(0)
    ratio = vn1 / torch.clamp(vn, min=1e-30)
    ratio = torch.where(vn > 0, ratio, torch.ones_like(ratio))
    return ratio.repeat(box.capacity)


def fbar_deformation_gradient(F_n1, J_n1, DJ_patch, alpha_fbar):
    """Locking-free F-bar blend: scale F by (J_patch/J)^{1/d} blended by α."""
    d = F_n1.shape[-1]
    ratio = torch.clamp(DJ_patch / torch.clamp(J_n1, min=1e-12), min=1e-12)
    scale = ratio ** (1.0 / d)
    Fbar = scale[..., None, None] * F_n1
    return alpha_fbar[..., None, None] * Fbar + (1.0 - alpha_fbar)[..., None, None] * F_n1
