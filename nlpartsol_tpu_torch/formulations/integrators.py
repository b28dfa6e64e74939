"""Additional explicit integrators: Forward-Euler (momentum form) and
Generalized-α.

Counterpart of ``nlpartsol_tpu/formulations/integrators.py``:

* U_Forward_Euler — legacy momentum-form MPM (USL/FLIP): P2G mass+momentum,
  nodal p += Δt·F, FLIP velocity update + position from nodal momentum
  (NL-PartSol's U-Forward-Euler.c:19-370).
* U_Generalized_alpha — nodal kinetics {m, a0, a1, v} with spectral-radius
  parameterisation α = (2r_b−1)/(1+r_b), β = (5−3r_b)/((1+r_b)²(2−r_b)),
  γ = 3/2 − α (U-Generalized-Alpha.c:107-180); a1 = (F/m − α·a0)/(1−α);
  particle updates at :423-545.

Both run on the windowed engine, as in the JAX package (its driver routes
them there: each step bins its particles to slots at the start, so they
take any particle order), or on the scatter engine (particle order, no
slot layout; the only engine on an unstructured ``FEMesh``); the fused
kernels have no path for these schemes (``ValueError``, as
``common.make_engine`` says).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import dispatch as con
from ..models.materials import MaterialTable
from ..ops import tensor as tn
from ..ops import windowed
from ..ops.sparse import nnz as count_nnz
from ..types import Grid, Particles
from . import kinematics as kin
from .common import (binned_refused, check_background, check_shapefun, found_lost,
                     make_engine, shapefun_eval)
from .explicit import ExplicitConfig

Tensor = torch.Tensor


def generalized_alpha_parameters(rb: float):
    """(α, β, γ) from the spectral radius r_b (U-Generalized-Alpha.c:126-129)."""
    alpha = (2.0 * rb - 1.0) / (1.0 + rb)
    beta = (5.0 - 3.0 * rb) / ((1.0 + rb) ** 2 * (2.0 - rb))
    gamma = 1.5 - alpha
    return alpha, beta, gamma


def _check_supported(cfg: ExplicitConfig, p: Particles, grid):
    check_background(cfg, grid)

    if p.dim not in (2, 3):
        raise ValueError(f"explicit integrators run in 2D and 3D, not {p.dim}D")
    if cfg.damage is not None:
        raise ValueError("Forward-Euler / Generalized-alpha have no fracture hooks")
    check_shapefun(cfg)
    if cfg.transfer == "binned":
        raise binned_refused()
    if cfg.active_box is None and cfg.transfer == "windowed":
        raise ValueError("windowed transfer requires cfg.active_box")


def _begin(p, grid, cfg):
    """Bin to slots (windowed engine), evaluate the basis, build the engine
    and the lumped mass (the part both integrators share)."""
    _check_supported(cfg, p, grid)
    lost = torch.zeros((), dtype=torch.int32, device=p.x.device)
    if cfg.transfer == "windowed":
        binning = windowed.bin_particles(grid, cfg.active_box, p.x, p.active)
        p = windowed.permute_to_slots(p, binning)
        lost = binning.lost
    act = p.active
    sf, offsets = shapefun_eval(cfg, grid, p)
    N, dN, mask = sf["N"], sf["dN"], sf["mask"] & act[:, None]
    lost = lost + found_lost(sf, act)
    eng = make_engine(cfg, grid, sf, offsets, mask)
    m_nodes = eng.p2g(N * p.mass[:, None])
    m_safe = torch.clamp(m_nodes, min=cfg.mass_tol)[:, None]
    return p, act, sf, N, dN, mask, lost, eng, m_nodes, m_safe


def _stress(p, act, mats, cfg, dt, grad_v, eng, N, dN, m_nodes, body_accel, traction,
            traction_area):
    """ΔF = I + Δt·∇v, the constitutive update and the nodal forces."""
    d = p.dim
    eye = torch.eye(d, dtype=grad_v.dtype, device=grad_v.device)
    DF = dt * grad_v + eye
    F_n1 = tn.bmm(DF, p.F)
    J_n1 = torch.clamp(tn.det(F_n1), min=0.0)
    dFdt_n1 = kin.rate_deformation_gradient_n1(grad_v, p.F, DF, p.dFdt)
    # padding slots hold F = 0: the models see the identity there, as in
    # the explicit step (hazard B); active particles are untouched
    live = act[:, None, None]
    cs = con.stress_integration(
        F_n1=torch.where(live, F_n1, eye),
        DF=torch.where(live, DF, eye),
        dFdt_n1=dFdt_n1,
        bemi=p.bemi,
        bemi_zz=p.bemi_zz,
        eps=p.eps,
        kappa=p.kappa,
        back_stress=p.back_stress,
        mat_id=p.mat_id,
        mats=mats,
        kinds=cfg.kinds,
    )
    tau_eff = cs.tau * (1.0 - p.damage)[:, None, None]
    dN1 = kin.push_forward_dN(dN, DF)
    fi = -(dN1 @ (tau_eff * p.vol0[:, None, None]).transpose(-1, -2))
    forces = eng.p2g(fi)
    if traction is not None:
        tr = (N * traction_area[:, None])[..., None] * traction[:, None, :]
        forces = forces + eng.p2g(tr)
    forces = forces + m_nodes[:, None] * body_accel[None, :]
    return F_n1, J_n1, dFdt_n1, cs, forces


def _advance(p, act, sf, cs, F_n1, J_n1, dFdt_n1, du_p, dv_p, a_new):
    sel = act[:, None]
    zero = torch.zeros((), dtype=du_p.dtype, device=du_p.device)
    return p.replace(
        x=torch.where(sel, p.x + du_p, p.x),
        dis=p.dis + torch.where(sel, du_p, zero),
        v=torch.where(sel, p.v + dv_p, p.v),
        a=torch.where(sel, a_new, p.a),
        rho=p.mass / (p.vol0 * torch.clamp(J_n1, min=1e-12)),
        F=F_n1,
        dFdt=dFdt_n1,
        J=J_n1,
        bemi=cs.bemi,
        bemi_zz=cs.bemi_zz,
        stress=cs.tau,
        stress_zz=cs.tau_zz,
        eps=cs.eps,
        kappa=cs.kappa,
        back_stress=cs.back_stress,
        W=cs.W,
        lme_lambda=sf["lam"] if sf["lam"] is not None else p.lme_lambda,
    )


def forward_euler_step(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ExplicitConfig,
    body_accel: Tensor,
    traction: Optional[Tensor] = None,
    traction_area: Optional[Tensor] = None,
):
    """One momentum-form forward-Euler step (U_Forward_Euler).  Returns
    (particles_{n+1}, dict(nnz, lost))."""
    dt = cfg.dt
    p, act, sf, N, dN, mask, lost, eng, m_nodes, m_safe = _begin(p, grid, cfg)

    mom_nodes = eng.p2g((N * p.mass[:, None])[..., None] * p.v[:, None, :])
    if grid.dirichlet_mask is not None:
        mom_nodes = torch.where(grid.dirichlet_mask, grid.dirichlet_value * m_safe, mom_nodes)
    v_nodes = mom_nodes / m_safe

    # local state from nodal velocity: ΔF = I + Δt Σ v_A ⊗ ∇N_A (:560-620)
    grad_v = kin.disp_gradient(eng.edge_gather(v_nodes), dN)
    F_n1, J_n1, dFdt_n1, cs, forces = _stress(
        p, act, mats, cfg, dt, grad_v, eng, N, dN, m_nodes, body_accel, traction, traction_area)
    if grid.dirichlet_mask is not None:
        forces = torch.where(grid.dirichlet_mask, torch.zeros_like(forces), forces)

    # nodal momentum update (:296-340), FLIP particle update (:423-470)
    mom_new = mom_nodes + dt * forces
    a_p = eng.g2p(N, forces / m_safe)
    p_out = _advance(p, act, sf, cs, F_n1, J_n1, dFdt_n1, dt * eng.g2p(N, mom_new / m_safe),
                     dt * a_p, a_p)
    return p_out, dict(nnz=count_nnz(mask), lost=lost)


def generalized_alpha_step(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ExplicitConfig,
    body_accel: Tensor,
    rb: float = 0.6,
    traction: Optional[Tensor] = None,
    traction_area: Optional[Tensor] = None,
):
    """One generalized-α step (U_Generalized_alpha).  Returns
    (particles_{n+1}, dict(nnz, lost))."""
    dt = cfg.dt
    alpha, beta, gamma = generalized_alpha_parameters(rb)
    p, act, sf, N, dN, mask, lost, eng, m_nodes, m_safe = _begin(p, grid, cfg)

    mN = (N * p.mass[:, None])[..., None]
    v_nodes = eng.p2g(mN * p.v[:, None, :]) / m_safe
    a0_nodes = eng.p2g(mN * p.a[:, None, :]) / m_safe
    if grid.dirichlet_mask is not None:
        v_nodes = torch.where(grid.dirichlet_mask, grid.dirichlet_value, v_nodes)
        a0_nodes = torch.where(grid.dirichlet_mask, torch.zeros_like(a0_nodes), a0_nodes)

    # local state from nodal velocity (α-midpoint ΔF)
    grad_v = kin.disp_gradient(eng.edge_gather(v_nodes), dN)
    F_n1, J_n1, dFdt_n1, cs, forces = _stress(
        p, act, mats, cfg, dt, grad_v, eng, N, dN, m_nodes, body_accel, traction, traction_area)

    # a1 = (F/m − α a0)/(1−α)   (:157-162)
    a1_nodes = (forces / m_safe - alpha * a0_nodes) / (1.0 - alpha)
    if grid.dirichlet_mask is not None:
        a1_nodes = torch.where(grid.dirichlet_mask, torch.zeros_like(a1_nodes), a1_nodes)

    # particle updates (:423-545)
    a_p = eng.g2p(N, a1_nodes)
    dv_p = dt * eng.g2p(N, (1.0 - gamma) * a0_nodes + gamma * a1_nodes)
    du_p = dt * eng.g2p(N, v_nodes) + dt * dt * eng.g2p(
        N, (0.5 - beta) * a0_nodes + beta * a1_nodes
    )
    p_out = _advance(p, act, sf, cs, F_n1, J_n1, dFdt_n1, du_p, dv_p, a_p)
    return p_out, dict(nnz=count_nnz(mask), lost=lost)
