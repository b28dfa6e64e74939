"""Discrete Energy-Momentum (EDMC) implicit step.

Counterpart of ``nlpartsol_tpu/formulations/dem.py`` (the reference's
Displacements/U-Discrete-Energy-Momentum.c): an energy-momentum-conserving
midpoint scheme solved by Newton iteration on the nodal velocity V = v_{n+1}:

  dU = Δt·(v_n + V)/2,  F_{n+1} = (I + Σ_A dU_A ⊗ ∇N_A)·F_n
  C_n, C_{n+1}, ΔC = C_{n+1} − C_n, F_mid = (F_n + F_{n+1})/2
  S* = S(F_mid) + 2·(ΔW − ½·S(F_mid):ΔC)/(ΔC:ΔC)·ΔC   (Gonzalez's discrete
       gradient: S*:ΔC/2 = W_{n+1} − W_n exactly), S(F_mid) = sym(F_mid⁻¹·P),
       P = ∂W/∂F at F_mid by reverse-mode autograd
  R_A = m_A·(V − v_n)/Δt + Σ_p V0·P*·GRAD_A − m_A·b,  P* = F_mid·S*,
       GRAD_A = F_nᵀ·∇N_A

solved by Newton-CG with the Jacobi diagonal m/Δt + Σ_p (λ+2G)·V0·(Δt/2)·|∇N|².
Each J·v is forward mode over the residual (``solvers.jvp``), and so forward
over the reverse-mode P: the tangent of P comes from the backward graph of W,
built with ``create_graph=True`` inside the dual level, and the graph is then
cut from P, its tangent kept.  ``stress_mode='average-strain'`` is the
reference's own midpoint rule S(C_mid, J_mid) for Neo-Hookean and
Saint-Venant-Kirchhoff (its halved SVK shear term kept), which the binary's
goldens hold.

Three engines: ``'scatter'`` (the default, as in the JAX package, and the
goldens' engine), ``'windowed'`` and ``'fused'`` (the CUDA kernels,
discrete-gradient mode only; the JAX package's ``'pallas'``).  On the fused
engine the internal forces are G-scatter rows, G = V0·P*·F_nᵀ; λ is solved
once by the first scatter ([m, m·v, (λ+2G)·V0·Δt/2] with ``gnorm``), then
each residual is one gradient gather and one G-scatter at that λ, each
launched once more for the tangent of a J·v.  With n Newton iterations and
L CG iterations in a step, a step launches (as the implicit Newmark step,
formulations/implicit.py):

  scatter λ-solve + gnorm   1
  gradient gather           3 + 7n + 2L
  G-scatter                 1 + 7n + 2L
  N-gather                  1

(7n: each Newton iteration's J·v at CG's x₀ = 0, primal and tangent, four
line-search residuals and the re-evaluated one; 2L: one J·v per CG
iteration; the 3 of the gathers: r₀, and ∇dU and ∇(V − Vₙ) at the end.)

Not ported yet (each raises ``NotImplementedError`` naming its item of
ROADMAP.md queue 1): ``axis_name``/``rebin_mode='none'`` (item 15),
``shapefun='gimp'/'alme'`` and ``transfer='binned'`` (item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.autograd.forward_ad as fwAD

from ..models import dispatch as con
from ..models import materials as M
from ..models.materials import MaterialTable, lame_parameters
from ..ops import fused_transfer as ft
from ..ops import solvers, windowed
from ..ops import tensor as tn
from ..ops.sparse import nnz as count_nnz
from ..shapefun import lme
from ..types import Grid, Particles
from . import kinematics as kin
from .common import check_shapefun, found_lost, make_engine, shapefun_eval
from .explicit import _bin_to_slots, to_slot_layout
from .implicit import _det_clamped

Tensor = torch.Tensor

STRESS_MODES = ("discrete-gradient", "average-strain")


@dataclasses.dataclass(frozen=True)
class DEMConfig:
    dt: float
    shapefun: str = "lme"
    lme_params: lme.LMEParams = dataclasses.field(default_factory=lme.LMEParams)
    kinds: tuple = (3,)  # NEO_HOOKEAN
    mass_tol: float = 1e-12
    newton_tol: float = 1e-6
    newton_maxiter: int = 30
    cg_tol: float = 1e-8
    cg_maxiter: int = 200
    # transfer backend: 'scatter', 'windowed' or 'fused' (the last two need
    # active_box)
    transfer: str = "scatter"
    active_box: Optional[windowed.ActiveBox] = None
    axis_name: Optional[str] = None  # multi-device (not ported yet)
    # fused re-bin: 'local' (end-of-step windowed.local_rebin) or 'global'
    rebin_mode: str = "local"
    # midpoint stress: 'discrete-gradient' (Gonzalez, energy-exact) or
    # 'average-strain' (the reference's S(C_mid, J_mid), windowed and
    # scatter engines)
    stress_mode: str = "discrete-gradient"

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def _check_supported(cfg: DEMConfig, p: Particles):
    def later(what, item, where):
        return NotImplementedError(
            f"{what} is not ported yet: ROADMAP.md queue 1, item {item}, '{where}'")

    if p.dim not in (2, 3):
        raise ValueError(f"DEM steps run in 2D and 3D, not {p.dim}D")
    if cfg.axis_name is not None:
        raise later("axis_name sharding", 15, "Multi-device")
    if cfg.rebin_mode == "none":
        raise later("rebin_mode='none'", 15, "Multi-device")
    if cfg.rebin_mode not in ("local", "global"):
        raise ValueError(f"unknown rebin_mode {cfg.rebin_mode}")
    check_shapefun(cfg)
    if cfg.transfer == "binned":
        raise later("transfer 'binned'", 13, "Other shape functions, engines and integrators")
    if cfg.transfer not in ("scatter", "windowed", "fused"):
        raise ValueError(f"unknown transfer {cfg.transfer}")
    if cfg.transfer != "scatter" and cfg.active_box is None:
        raise ValueError(f"{cfg.transfer} transfer requires cfg.active_box")
    if cfg.stress_mode not in STRESS_MODES:
        raise ValueError(f"unknown stress_mode {cfg.stress_mode}")
    if cfg.transfer == "fused" and cfg.stress_mode != "discrete-gradient":
        raise ValueError(
            "the fused DEM path implements stress_mode='discrete-gradient' (the "
            "parity-gate 'average-strain' rule runs on the windowed/scatter engines)")


def _strain_energy(F_n1, p, mats, kinds):
    """Batched W(F) for hyperelastic kinds (the models return the
    potential)."""
    cs = con.stress_integration(
        F_n1=F_n1,
        DF=torch.eye(F_n1.shape[-1], dtype=F_n1.dtype, device=F_n1.device).expand(F_n1.shape),
        dFdt_n1=torch.zeros_like(F_n1), bemi=p.bemi, bemi_zz=p.bemi_zz, eps=p.eps,
        kappa=p.kappa, back_stress=p.back_stress, mat_id=p.mat_id, mats=mats, kinds=kinds)
    return cs.W


def _energy_gradient(F, p, mats, kinds):
    """P = ∂W/∂F by reverse-mode autograd, with the forward-mode tangent of
    F carried through (the backward graph is built with ``create_graph``
    inside the dual level, then cut from P: a J·v needs P's tangent, never
    its graph).  A tensor ``F`` without tangent gives a plain P."""
    with torch.enable_grad():
        Fm = F.clone().requires_grad_(True)
        (P,) = torch.autograd.grad(_strain_energy(Fm, p, mats, kinds).sum(), Fm,
                                   create_graph=True)
    primal, tangent = fwAD.unpack_dual(P)
    if tangent is None:
        return primal.detach()
    return fwAD.make_dual(primal.detach(), tangent.detach())


def _cauchy_green(F):
    return tn.bmm(F.transpose(-1, -2), F)


def _colon(a, b):
    return torch.sum(a * b, dim=(-2, -1))


def _discrete_gradient_pk1(F_n, F_n1, C_n, W_n, p, mats, kinds):
    """P* = F_mid·S* with the Gonzalez discrete-gradient S*."""
    F_mid = 0.5 * (F_n + F_n1)
    dC = _cauchy_green(F_n1) - C_n
    C_colon = _colon(dC, dC)
    S_mid = tn.bmm(tn.inv(F_mid), _energy_gradient(F_mid, p, mats, kinds))
    # symmetrise: S from AD through F may carry a skew part that does no
    # work against the symmetric ΔC but pollutes the correction
    S_mid = 0.5 * (S_mid + S_mid.transpose(-1, -2))
    dW = _strain_energy(F_n1, p, mats, kinds) - W_n
    S_dC = 0.5 * _colon(S_mid, dC)
    coef = torch.where(C_colon > 1e-16, (dW - S_dC) / torch.clamp(C_colon, min=1e-30),
                       torch.zeros_like(C_colon))
    return tn.bmm(F_mid, S_mid + 2.0 * coef[:, None, None] * dC)


def _average_strain_pk1(F_n, F_n1, C_n, p, mats, kinds):
    """The reference's midpoint rule: S at the averaged C and J (not at
    F_mid), P = F_mid·S (U-Discrete-Energy-Momentum.c:50-80), for its DEM
    materials: Neo-Hookean-Wriggers, and Saint-Venant-Kirchhoff as the
    reference writes it, S = λ·trE·I + G·E — half the textbook 2G·E shear
    term, kept for binary parity (models/ keeps the textbook SVK)."""
    d = F_n.shape[-1]
    eye = torch.eye(d, dtype=F_n.dtype, device=F_n.device)
    F_mid = 0.5 * (F_n + F_n1)
    C_mid = 0.5 * (C_n + _cauchy_green(F_n1))
    mid = p.mat_id.long()
    lam, G = lame_parameters(mats.E[mid], mats.nu[mid])
    if tuple(kinds) == (M.NEO_HOOKEAN,):
        J_mid = 0.5 * (tn.det(F_n) + tn.det(F_n1))
        C_inv = tn.inv(C_mid)
        S = ((0.5 * lam * (J_mid * J_mid - 1.0))[:, None, None] * C_inv
             + G[:, None, None] * (eye - C_inv))
    elif tuple(kinds) == (M.SAINT_VENANT_KIRCHHOFF,):
        E_mid = 0.5 * (C_mid - eye)
        S = (lam * tn.trace(E_mid))[:, None, None] * eye + G[:, None, None] * E_mid
    else:
        raise ValueError(
            "stress_mode='average-strain' implements the reference's DEM dispatch "
            "(Neo-Hookean-Wriggers, Saint-Venant-Kirchhoff — "
            "U-Discrete-Energy-Momentum.c:62-66) only")
    return tn.bmm(F_mid, S)


def _dirichlet(grid, has_mass, Vn, like):
    """Free dofs, prescribed velocities, and Vn with the BC imposed on the
    projected velocity before the solve, as the reference does
    (imposse_Nodal_Velocity, U-Discrete-Energy-Momentum.c:228)."""
    if grid.dirichlet_mask is None:
        return has_mass, torch.zeros_like(Vn), Vn
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    V_dirichlet = torch.where(grid.dirichlet_mask, grid.dirichlet_value, zero)
    return (has_mass & ~grid.dirichlet_mask, V_dirichlet,
            torch.where(grid.dirichlet_mask, grid.dirichlet_value, Vn))


def _newton(residual, Vn, diag, free, cfg):
    diag = torch.where(free, torch.clamp(diag, min=1e-30),
                       torch.ones((), dtype=diag.dtype, device=diag.device))
    return solvers.newton_krylov(residual, Vn, M_inv=lambda r: r / diag, tol=cfg.newton_tol,
                                 maxiter=cfg.newton_maxiter, cg_tol=cfg.cg_tol,
                                 cg_maxiter=cfg.cg_maxiter)


def _stiffness_scale(p, mats, dt):
    mid = p.mat_id.long()
    lam_p, G_p = lame_parameters(mats.E[mid], mats.nu[mid])
    return (lam_p + 2.0 * G_p) * p.vol0 * (0.5 * dt)


def _diagnostics(res, nnz, lost, act, p_out, cs, p, m_nodes, V, Vn, W_n1, W_n):
    """Newton counts and the energies: the particles' kinetic energy after
    the step (over the slots ``p_out`` holds active, re-binned or not) and
    their strain energy, and the grid-level audit the discrete gradient makes
    exact to solver tolerance, ½Σ_A m_A(V² − Vn²) + Σ_p (W_{n+1} − W_n)·V0."""
    zero = torch.zeros((), dtype=V.dtype, device=V.device)
    m = m_nodes[:, None]
    dW_tot = torch.sum(torch.where(act, (W_n1 - W_n) * p.vol0, zero))
    return dict(
        nnz=nnz, newton_iters=res.iters, newton_residual=res.residual_norm,
        cg_iters=res.linear_iters, converged=res.converged, lost=lost,
        kinetic_energy=0.5 * torch.sum(
            torch.where(p_out.active, p_out.mass * torch.sum(p_out.v ** 2, -1), zero)),
        strain_energy=torch.sum(torch.where(act, cs.W * p.vol0, zero)),
        grid_energy_increment=0.5 * torch.sum(m * (V ** 2 - Vn ** 2)) + dW_tot,
        grid_kinetic_energy=0.5 * torch.sum(m * V ** 2),
    )


def _stress(p, mats, cfg, F_n, F_n1, DF, grad_dv):
    return con.stress_integration(
        F_n1=F_n1, DF=DF, dFdt_n1=kin.rate_deformation_gradient_n1(grad_dv, F_n, DF, p.dFdt),
        bemi=p.bemi, bemi_zz=p.bemi_zz, eps=p.eps, kappa=p.kappa, back_stress=p.back_stress,
        mat_id=p.mat_id, mats=mats, kinds=cfg.kinds)


def dem_step(p: Particles, grid: Grid, mats: MaterialTable, cfg: DEMConfig, body_accel: Tensor):
    """One energy-momentum-conserving implicit step.  Returns (particles,
    diagnostics): ``nnz``, ``lost``, ``newton_iters``, ``cg_iters``,
    ``newton_residual``, ``converged``, ``kinetic_energy``,
    ``strain_energy``, ``grid_energy_increment``, ``grid_kinetic_energy``."""
    _check_supported(cfg, p)
    if cfg.transfer == "fused":
        return _dem_step_fused(p, grid, mats, cfg, body_accel)
    d = p.dim
    dt = cfg.dt
    lost = torch.zeros((), dtype=torch.int32, device=p.x.device)
    if cfg.transfer == "windowed":
        p, lost, _, _ = _bin_to_slots(p, grid, cfg.active_box, None, None)
    act = p.active
    sf, offsets = shapefun_eval(cfg, grid, p)
    N, dN, mask = sf["N"], sf["dN"], sf["mask"] & act[:, None]
    lost = lost + found_lost(sf, act)
    eng = make_engine(cfg, grid, sf, offsets, mask)

    m_nodes = eng.p2g(N * p.mass[:, None])
    m_safe = torch.clamp(m_nodes, min=cfg.mass_tol)[:, None]
    mom = (N * p.mass[:, None])[..., None] * p.v[:, None, :]
    free, V_dirichlet, Vn = _dirichlet(grid, (m_nodes > cfg.mass_tol)[:, None],
                                       eng.p2g(mom) / m_safe, p.x)

    eye = torch.eye(d, dtype=p.x.dtype, device=p.x.device)
    C_n = _cauchy_green(p.F)
    W_n = _strain_energy(p.F, p, mats, cfg.kinds)
    if cfg.stress_mode == "average-strain":
        def pk1_of(F_n1):
            return _average_strain_pk1(p.F, F_n1, C_n, p, mats, cfg.kinds)
    else:
        def pk1_of(F_n1):
            return _discrete_gradient_pk1(p.F, F_n1, C_n, W_n, p, mats, cfg.kinds)

    GRAD = torch.einsum("pji,pkj->pki", p.F, dN)  # F_nᵀ·∇N_A per edge

    def residual(V_free):
        V = torch.where(free, V_free, V_dirichlet)
        dU = dt * (0.5 * (Vn + V))
        F_n1 = tn.bmm(kin.disp_gradient(eng.edge_gather(dU), dN) + eye, p.F)
        fi = torch.einsum("pij,pkj->pki", pk1_of(F_n1) * p.vol0[:, None, None], GRAD)
        R = (m_nodes[:, None] * (V - Vn) / dt + eng.p2g(fi)
             - m_nodes[:, None] * body_accel[None, :])
        return torch.where(free, R, torch.zeros_like(R))

    diag_K = eng.p2g(_stiffness_scale(p, mats, dt)[:, None] * torch.sum(dN * dN, dim=-1))
    res = _newton(residual, Vn, diag_K[:, None] + m_nodes[:, None] / dt, free, cfg)
    V = torch.where(free, res.x, V_dirichlet)
    dU = dt * (0.5 * (Vn + V))

    DF = kin.disp_gradient(eng.edge_gather(dU), dN) + eye
    F_n1 = tn.bmm(DF, p.F)
    J_n1 = _det_clamped(F_n1)
    # end-of-step state from the standard constitutive update (the discrete
    # gradient is internal to the solve): the true τ(F_{n+1})
    cs = _stress(p, mats, cfg, p.F, F_n1, DF,
                 kin.disp_gradient(eng.edge_gather(V - Vn), dN) / dt * dt)
    dis_inc = eng.g2p(N, dU)
    sel = act[:, None]
    p_out = p.replace(
        x=torch.where(sel, p.x + dis_inc, p.x),
        dis=torch.where(sel, p.dis + dis_inc, p.dis),
        v=torch.where(sel, p.v + eng.g2p(N, V - Vn), p.v),  # FLIP velocity increment
        a=torch.where(sel, eng.g2p(N, (V - Vn) / dt), p.a),
        rho=p.mass / (p.vol0 * torch.clamp(J_n1, min=1e-12)),
        F=F_n1, J=J_n1, bemi=cs.bemi, bemi_zz=cs.bemi_zz, stress=cs.tau, stress_zz=cs.tau_zz,
        W=cs.W, lme_lambda=p.lme_lambda if sf["lam"] is None else sf["lam"],
    )
    return p_out, _diagnostics(res, count_nnz(mask), lost, act, p_out, cs, p, m_nodes, V, Vn,
                               _strain_energy(F_n1, p, mats, cfg.kinds), W_n)


def _dem_step_fused(p, grid, mats, cfg, body_accel):
    """Fused-kernel DEM step (LME, discrete gradient): the windowed step's
    physics; each residual is one gradient gather and one G-scatter
    (P*·GRAD_A = G·∇N_A with G = V0·P*·F_nᵀ), launch formula in the module
    docstring."""
    box, params = cfg.active_box, cfg.lme_params
    d = p.dim
    dt = cfg.dt
    C, nc = box.capacity, box.n_cells
    local_mode = cfg.rebin_mode == "local"
    lost = torch.zeros((), dtype=torch.int32, device=p.x.device)
    if not local_mode:
        p, lost, _, _ = _bin_to_slots(p, grid, box, None, None)
    act = p.active
    sel3 = act[:, None, None]
    eye = torch.eye(d, dtype=p.x.dtype, device=p.x.device)
    zero = torch.zeros((), dtype=p.x.dtype, device=p.x.device)
    # idle slots carry F = 0, which W and the inverses cannot digest
    Fb = torch.where(sel3, p.F, eye)
    pb = p.replace(F=Fb)
    x_t, lam_t, act_t = (ft.to_channel_leading(a, C, nc)
                         for a in (p.x, p.lme_lambda, act.to(p.x.dtype)))

    # scatter #1 (solves λ): mass, momentum, and the stiffness scale, the
    # LAST channel, which gnorm weighs
    chans = torch.cat([p.mass[:, None], p.mass[:, None] * p.v,
                       _stiffness_scale(p, mats, dt)[:, None]], dim=1)
    nodes1, lam_f, nnz = ft.fused_scatter(grid, box, params, x_t, lam_t, act_t,
                                          ft.to_channel_leading(chans, C, nc), solve=True,
                                          gnorm=True)
    m_nodes = nodes1[:, 0]
    m_safe = torch.clamp(m_nodes, min=cfg.mass_tol)[:, None]
    free, V_dirichlet, Vn = _dirichlet(grid, (m_nodes > cfg.mass_tol)[:, None],
                                       nodes1[:, 1:1 + d] / m_safe, p.x)

    # λ frozen through the Newton loop
    geo = (grid, box, params, x_t, lam_f, act_t, 0)
    C_n = _cauchy_green(Fb)
    W_n = _strain_energy(Fb, pb, mats, cfg.kinds)

    def residual(V_free):
        V = torch.where(free, V_free, V_dirichlet)
        dU = dt * (0.5 * (Vn + V))
        F_n1 = tn.bmm(ft.GatherGrad.apply(dU, geo) + eye, Fb)
        P_star = _discrete_gradient_pk1(Fb, F_n1, C_n, W_n, pb, mats, cfg.kinds)
        G = torch.where(sel3, tn.bmm_t(P_star * p.vol0[:, None, None], Fb), zero)
        R = (m_nodes[:, None] * (V - Vn) / dt + ft.ScatterG.apply(G, geo)[:, 1:1 + d]
             - m_nodes[:, None] * body_accel[None, :])
        return torch.where(free, R, torch.zeros_like(R))

    res = _newton(residual, Vn, nodes1[:, -1:] + m_nodes[:, None] / dt, free, cfg)
    V = torch.where(free, res.x, V_dirichlet)
    dU = dt * (0.5 * (Vn + V))

    DF = ft.GatherGrad.apply(dU, geo) + eye
    F_n1 = tn.bmm(DF, Fb)
    J_n1 = _det_clamped(F_n1)
    cs = _stress(p, mats, cfg, Fb, F_n1, DF, ft.GatherGrad.apply(V - Vn, geo))
    gout, _ = ft.fused_gather(grid, box, params, x_t, lam_f, act_t,
                              gN=torch.cat([dU, V - Vn], dim=1))
    dis_inc, dv = gout[:, :d], gout[:, d:2 * d]
    sel = act[:, None]
    p_out = p.replace(
        x=torch.where(sel, p.x + dis_inc, p.x),
        dis=torch.where(sel, p.dis + dis_inc, p.dis),
        v=torch.where(sel, p.v + dv, p.v),
        a=torch.where(sel, dv / dt, p.a),
        rho=p.mass / (p.vol0 * torch.clamp(J_n1, min=1e-12)),
        F=torch.where(sel3, F_n1, p.F), J=torch.where(act, J_n1, p.J), bemi=cs.bemi,
        bemi_zz=cs.bemi_zz, stress=cs.tau, stress_zz=cs.tau_zz, W=cs.W,
        lme_lambda=ft.from_channel_leading(lam_f),
    )
    if local_mode:
        p_out, lost = windowed.local_rebin(p_out, grid, box)
    return p_out, _diagnostics(res, nnz, lost, act, p_out, cs, p, m_nodes, V, Vn,
                               _strain_energy(F_n1, pb, mats, cfg.kinds), W_n)


def run(p: Particles, grid: Grid, mats: MaterialTable, cfg: DEMConfig, n_steps: int,
        body_accel=None):
    """Time loop (binned once by ``to_slot_layout`` on the windowed and fused
    engines).  Returns (particles, dict(kinetic_energy, strain_energy,
    newton_iters), one entry a step)."""
    _check_supported(cfg, p)
    if body_accel is None:
        body_accel = torch.zeros((p.dim,), dtype=p.x.dtype, device=p.x.device)
    if cfg.transfer in ("windowed", "fused"):
        p = to_slot_layout(p, grid, cfg.active_box)
    ke, se, iters = [], [], []
    for _ in range(n_steps):
        p, dg = dem_step(p, grid, mats, cfg, body_accel)
        ke.append(dg["kinetic_energy"])
        se.append(dg["strain_energy"])
        iters.append(dg["newton_iters"])
    return p, dict(kinetic_energy=torch.stack(ke), strain_energy=torch.stack(se),
                   newton_iters=torch.tensor(iters, dtype=torch.int32, device=p.x.device))
