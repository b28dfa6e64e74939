"""Local Maximum-Entropy (LME) shape functions — batched, branch-free.

Counterpart of ``nlpartsol_tpu/shapefun/lme.py``:

* basis        p_a ∝ exp(−β‖l_a‖² + λ·l_a), Z-normalised
* λ solved per particle by Newton on r = ∇_λ log Z with Hessian
  J = Σ p l⊗l − r⊗r
* gradient     ∇p_a = −p_a J⁻¹ (l_a − r)
* β = γ/h²,  support radius R = sqrt(−ln(tol_zero)/β)

One batched evaluation per step produces N, ∇N and the padded pattern at
once.  The λ-Newton is a fixed-bound masked iteration; near-singular
Hessians are Tikhonov-damped (the damping vanishes for well-posed supports).
λ is warm-started from the previous step via ``Particles.lme_lambda``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import tensor as tn
from ..types import Grid
from .window import window_nodes, window_offsets

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LMEParams:
    gamma: float = 3.0
    tol_zero: float = 1e-10
    max_iter: int = 10
    # λ-Newton tolerance on ‖r‖ relative to the support radius; 1e-6
    # relative is the practical float32 floor (r = Σp·l is
    # O(radius)·O(eps_f32) at best).
    tol_lambda: float = 1e-6
    # λ-solver wrapper: 'Newton-Raphson' — plain damped Newton;
    # 'Nelder-Mead' — a guarded mode standing in for the derivative-free
    # fallback: the Newton step is clamped to a trust region of the support
    # radius and the iteration cap doubles.
    wrapper: str = "Newton-Raphson"

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def beta_of(params: LMEParams, h: float) -> float:
    """β = γ/h²."""
    return params.gamma / (h * h)


def support_radius(params: LMEParams, h: float) -> float:
    """R = sqrt(−ln(tol_zero)/β)."""
    return math.sqrt(-math.log(params.tol_zero) / beta_of(params, h))


def window_halfwidth(params: LMEParams, h: float) -> int:
    return int(math.ceil(support_radius(params, h) / h))


def offsets_for(dim: int, params: LMEParams) -> np.ndarray:
    w = window_halfwidth(params, 1.0)  # R/h is h-independent
    return window_offsets(dim, -w, w)


def _masked_softmax(f: Tensor, mask: Tensor) -> Tensor:
    """Softmax over the K axis restricted to valid entries."""
    f = torch.where(mask, f, torch.full_like(f, -1e30))
    fmax = torch.amax(f, dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(f - fmax), torch.zeros_like(f))
    z = torch.sum(e, dim=-1, keepdim=True)
    return e / z


def _r_and_J(p: Tensor, rel: Tensor):
    """Gradient r = Σ p l and Hessian J = Σ p l⊗l − r⊗r of log Z."""
    pl = p[..., None] * rel
    r = pl.sum(-2)
    J = pl.transpose(-1, -2) @ rel - r[..., :, None] * r[..., None, :]
    return r, J


def _safe_solve(J: Tensor, r: Tensor) -> Tensor:
    """Solve J x = r with Tikhonov damping when J is near-singular."""
    d = J.shape[-1]
    trJ = tn.trace(J)
    eye = torch.eye(d, dtype=J.dtype, device=J.device)
    Jd = J + (1e-10 * torch.clamp(trJ, min=1e-30))[..., None, None] * eye
    return tn.bmv(tn.inv(Jd), r)


def solve_lambda(
    rel: Tensor, mask: Tensor, lam0: Tensor, beta: float, params: LMEParams
) -> Tensor:
    """Newton iteration on λ, batched over particles with per-particle
    convergence masking.

    Args:
      rel:  (Np, K, d) l = x_p − x_a.
      mask: (Np, K) valid-support mask.
      lam0: (Np, d) warm start.
    Returns:
      lam:  (Np, d) converged multipliers.

    Runs ``max_iter`` sweeps without asking the device whether every
    particle has converged: a converged particle's λ is frozen, so the
    values equal those of a loop that stops early, and no sweep waits on a
    host round trip.
    """
    sq = torch.sum(rel * rel, dim=-1)  # (Np, K)
    # convergence scale: r is O(h)-sized; tol relative to support radius
    scale = torch.sqrt(
        torch.clamp(torch.amax(torch.where(mask, sq, torch.zeros_like(sq)), dim=-1), min=1e-30)
    )

    wrapper = params.wrapper.lower().replace("_", "-")
    if wrapper not in ("newton-raphson", "nelder-mead"):
        raise ValueError(
            f"unknown LME wrapper '{params.wrapper}' "
            "(expected 'Newton-Raphson' or 'Nelder-Mead')"
        )
    guarded = wrapper == "nelder-mead"
    max_iter = params.max_iter * (2 if guarded else 1)

    lam = lam0
    for _ in range(max_iter):
        f = -beta * sq + (rel @ lam[..., None])[..., 0]
        p = _masked_softmax(f, mask)
        r, J = _r_and_J(p, rel)
        dlam = _safe_solve(J, r)
        if guarded:
            # trust-region clamp ‖Δλ‖ ≤ 4β·scale: never take a step larger
            # than the kernel's own curvature scale
            cap = 4.0 * beta * scale
            nrm = torch.linalg.vector_norm(dlam, dim=-1)
            fac = torch.clamp(cap / torch.clamp(nrm, min=1e-30), max=1.0)
            dlam = dlam * fac[..., None]
        conv = torch.linalg.vector_norm(r, dim=-1) <= params.tol_lambda * scale
        lam = torch.where(conv[..., None], lam, lam - dlam)
    return lam


def basis_from_lambda(rel: Tensor, sq: Tensor, mask: Tensor, lam: Tensor, beta: float):
    """N (zero on masked entries) and ∇N at fixed λ.

    ∇p_a = −p_a J⁻¹ (l_a − r).  The −r correction (r = 0 at exact
    convergence) makes Σ_a ∇p_a = 0 and Σ_a ∇p_a ⊗ x_a = I hold *exactly* at
    any finite λ tolerance — essential in float32."""
    d = rel.shape[-1]
    f = -beta * sq + (rel @ lam[..., None])[..., 0]
    N = _masked_softmax(f, mask)
    r, J = _r_and_J(N, rel)
    eye = torch.eye(d, dtype=J.dtype, device=J.device)
    Jinv = tn.inv(J + 1e-10 * tn.trace(J)[..., None, None] * eye)
    dN = -N[..., None] * ((rel - r[:, None, :]) @ Jinv.transpose(-1, -2))
    return N, dN


def evaluate(grid: Grid, x: Tensor, lam0: Tensor, params: LMEParams):
    """Fused local search + λ solve + N + ∇N (one call per step).

    Returns dict with:
      node_ids: (Np, K) int32 flat node ids
      N:        (Np, K) shape-function values (0 on masked entries)
      dN:       (Np, K, d) spatial gradients
      mask:     (Np, K) support mask
      lam:      (Np, d) converged λ (persist as warm start)
    """
    h = grid.spacing
    beta = beta_of(params, h)
    r_sup = support_radius(params, h)
    offs = offsets_for(grid.dim, params)
    node_ids, rel, inb = window_nodes(grid, x, offs)
    sq = torch.sum(rel * rel, dim=-1)
    mask = inb & (sq <= torch.tensor(r_sup * r_sup, dtype=sq.dtype, device=sq.device))

    lam = solve_lambda(rel, mask, lam0, beta, params)
    N, dN = basis_from_lambda(rel, sq, mask, lam, beta)
    return dict(node_ids=node_ids, N=N, dN=dN, mask=mask, lam=lam)
