"""Implicit Newmark-β and quasi-static step: matrix-free Newton-Krylov.

Counterpart of ``nlpartsol_tpu/formulations/implicit.py``:

  Newmark parameters α₁..α₆
  lumped mass, nodal v/a projection (P2G ÷ mass)
  residual R(dU) = F_int(dU) − F_tra + M⊙(α₁dU − α₂u̇ₙ − α₃üₙ − b)
  J·v by forward-mode AD through R (``solvers.jvp``, dual tensors): the exact
      consistent tangent, no assembly on the Newton path
  Dirichlet by dof masking; reactions = −R on the fixed dofs
  FLIP/PIC particle update

The quasi-static mode is the same machinery without inertial terms.

Three engines, as in the explicit step: ``'windowed'`` (plain tensor code,
ops/windowed.py — the reference of the kernels, with both preconditioners),
``'scatter'`` (segment sums over the (Np, K) pattern in particle order, no
slot layout, both preconditioners) and ``'fused'`` (the default; the CUDA
kernels of ops/fused_transfer.py, the JAX package's ``'pallas'``;
``precond='jacobi'`` only).  On the fused engine
λ is solved once per step by the first scatter, which also gives the Jacobi
stiffness diagonal Σ s·|∇N|² (``gnorm``); every residual is then one
gradient gather and one G-scatter at that λ, wrapped as linear operations
whose JVP is the same kernel on the tangent (``fused_transfer.GatherGrad``,
``ScatterG``).  With n Newton iterations and L CG iterations in a step and
no Dirichlet mask, a step launches:

  scatter λ-solve + gnorm   1
  gradient gather           3 + 7n + 2L
  G-scatter                 1 + 7n + 2L   (+1 for the reactions of a
                                           Dirichlet mask)
  N-gather                  1

(7n: each Newton iteration's JVP at x₀ = 0 in CG, primal and tangent, four
line-search residuals and the re-evaluated one; 2L: one JVP, primal and
tangent, per CG iteration.)  The Newton and Krylov loops read their
condition on the host once per iteration (``solvers.host_syncs``).

Nonlocal fracture (``damage``) is STAGGERED, as in the JAX package: the
Newton residuals and the reactions keep the frozen damage d_n, and the
driver's update runs once at the converged state on the slot layout
(windowed and fused engines; the scatter engine refuses it).  It launches
no kernel.

Every material kind of the dispatch runs: the J·v goes through the return
mappings in forward mode, with the spectral tangent of
``ops.tensor.isotropic_map``, and the history (b_e, eps, kappa, back stress)
is written from the converged iterate only.
Multi-device (parallel/domain.py): with ``halo`` the step runs on the
rank's strip (the halo engine, or the fused kernels with a halo add after
each scatter and a ghost fill before each gather, the forward-mode tangent
included), and every dot and norm of the Newton-Krylov loop is an
all-reduce over the halo's group, so every rank takes the same branches;
``axis_name`` sums the diagnostics (and, without a halo, every P2G).
On an unstructured ``FEMesh`` (shapefun/femesh.py) the step runs on the
scatter engine only; 'windowed' and 'fused' raise ``ValueError``.
``transfer='binned'`` is on the do-not-port list (ROADMAP.md queue 2) and
raises ``NotImplementedError``.
``shapefun='fem'``, ``'gimp'`` and ``'alme'`` run on the windowed and
scatter engines; the fused kernels compute LME only and refuse them with
``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..models import dispatch as con
from ..models import fracture
from ..models.materials import MaterialTable, lame_parameters
from ..ops import bsr, solvers, windowed
from ..ops import fused_transfer as ft
from ..ops import tensor as tn
from ..ops.sparse import nnz as count_nnz
from ..shapefun import alme, lme
from ..types import Grid, Particles
from . import kinematics as kin
from .common import (binned_refused, check_background, check_rebin_mode, check_shapefun,
                     found_lost, global_sums, halo_ops, make_engine, shapefun_eval)
from .explicit import _bin_to_slots, to_slot_layout

Tensor = torch.Tensor


class NewmarkParams(NamedTuple):
    """α₁..α₆ of the Newmark-β scheme."""

    alpha_1: float
    alpha_2: float
    alpha_3: float
    alpha_4: float
    alpha_5: float
    alpha_6: float
    dt: float


def newmark_parameters(beta: float, gamma: float, dt: float) -> NewmarkParams:
    return NewmarkParams(
        alpha_1=1.0 / (beta * dt * dt),
        alpha_2=1.0 / (beta * dt),
        alpha_3=(1.0 - 2.0 * beta) / (2.0 * beta),
        alpha_4=gamma / (beta * dt),
        alpha_5=1.0 - gamma / beta,
        alpha_6=(1.0 - gamma / (2.0 * beta)) * dt,
        dt=dt,
    )


@dataclasses.dataclass(frozen=True)
class ImplicitConfig:
    dt: float
    beta: float = 0.25
    gamma: float = 0.5
    shapefun: str = "lme"
    lme_params: lme.LMEParams = dataclasses.field(default_factory=lme.LMEParams)
    alme_params: Optional[alme.ALMEParams] = None
    kinds: tuple = (3,)  # NEO_HOOKEAN
    mass_tol: float = 1e-12
    # solver tolerances (reference: TOL_NR 1e-5; KSP defaults)
    newton_tol: float = 1e-5
    newton_maxiter: int = 20
    cg_tol: float = 1e-7
    cg_maxiter: int = 200
    alpha_blend: float = 1.0  # 1 ⇒ FLIP
    quasi_static: bool = False
    # preconditioner: 'jacobi' (α₁·m + a spectrally scaled stiffness
    # diagonal) or 'block-jacobi' (exact AD-assembled d×d diagonal blocks;
    # windowed engine only)
    precond: str = "jacobi"
    # inner solver: 'cg' | 'bicgstab' | 'gmres' | 'dense'
    linear: str = "cg"
    # inner tolerance: 'ew' (Eisenstat-Walker) | 'fixed' (every solve to cg_tol)
    forcing: str = "ew"
    # transfer backend: 'fused' (CUDA kernels) or 'windowed' (both need
    # active_box), or 'scatter' (any particle order)
    transfer: str = "fused"
    active_box: Optional[windowed.ActiveBox] = None
    # nonlocal fracture driver, staggered at the converged state: None |
    # 'eigenerosion' | 'eigensoftening'; the static cell reach of the Beps sums
    damage: Optional[str] = None
    beps_reach: int = 1
    # multi-device: the group of the diagnostics' sums (and, without a
    # halo, of every P2G), a parallel.collectives.Comm; the rank's strip
    # (parallel.domain HaloSpec/HaloSpec2), whose group the solvers' dots
    # are summed over
    axis_name: Optional[object] = None
    halo: Optional[object] = None
    # particles already in slot layout: skip the step's own binning
    prebinned: bool = False
    # fused re-bin: 'local' (end-of-step windowed.local_rebin; per-step
    # drift must stay ≤ 1 cell, losses are counted in 'lost') or 'global'
    # (sort-based binning at step start; tractions always take it), or
    # 'none' (the sharded drivers' migration re-bins)
    rebin_mode: str = "local"

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def _check_supported(cfg: ImplicitConfig, p: Particles, grid):
    check_background(cfg, grid)

    if p.dim not in (2, 3):
        raise ValueError(f"implicit steps run in 2D and 3D, not {p.dim}D")
    check_rebin_mode(cfg)
    if cfg.halo is not None and cfg.transfer == "scatter":
        raise ValueError("a halo strip runs on the windowed or fused engine")
    if cfg.damage not in (None, "eigenerosion", "eigensoftening"):
        raise ValueError(f"unknown damage driver {cfg.damage}")
    check_shapefun(cfg)
    if cfg.transfer == "binned":
        raise binned_refused()
    if cfg.transfer not in ("windowed", "fused", "scatter"):
        raise ValueError(f"unknown transfer {cfg.transfer}")
    if cfg.transfer == "scatter":
        if cfg.damage is not None:
            raise ValueError("fracture drivers require windowed transfer")
    elif cfg.active_box is None:
        raise ValueError(f"{cfg.transfer} transfer requires cfg.active_box")
    if cfg.precond not in ("jacobi", "block-jacobi"):
        raise ValueError(f"unknown precond {cfg.precond}")
    if cfg.transfer == "fused" and cfg.precond == "block-jacobi":
        raise ValueError("fused implicit supports precond='jacobi' only")


def edge_force_jacobian(fi_fn, grad0: Tensor) -> Tensor:
    """H[p, A, i, l, m] = ∂f_{pA,i}/∂(∇du_p)_{lm} by d² forward-mode JVPs of
    the batched integrand: each particle's f depends only on its own
    gradient, so one broadcast basis direction gives the exact derivative
    of every particle at once."""
    d = grad0.shape[-1]
    cols = []
    for l in range(d):
        for m in range(d):
            E = torch.zeros((d, d), dtype=grad0.dtype, device=grad0.device)
            E[l, m] = 1.0
            cols.append(solvers.jvp(fi_fn, grad0, E.expand_as(grad0).contiguous())[1])
    H = torch.stack(cols, dim=-1)  # (Ns, K, d, d·d)
    return H.reshape(H.shape[:-1] + (d, d))


def _local_state(p, mats, cfg, nm, grad_vel_const, grad_du):
    """ΔF, F_{n+1}, Ḟ_{n+1} and the stress at a displacement gradient of the
    Newton iterate (particle state is not touched)."""
    d = grad_du.shape[-1]
    eye = torch.eye(d, dtype=grad_du.dtype, device=grad_du.device)
    DF = grad_du + eye
    F_n1 = tn.bmm(DF, p.F)
    dt_DF = nm.alpha_4 * grad_du + grad_vel_const
    dFdt_n1 = kin.rate_deformation_gradient_n1(dt_DF, p.F, DF, p.dFdt)
    # emptied slots hold F = 0, which the fluids and Hencky cannot digest
    # (hazard B, ROADMAP.md queue 3): the models see the identity there
    cs = con.stress_integration(
        F_n1=torch.where(p.active[:, None, None], F_n1, eye), DF=DF, dFdt_n1=dFdt_n1,
        bemi=p.bemi, bemi_zz=p.bemi_zz, eps=p.eps,
        kappa=p.kappa, back_stress=p.back_stress, mat_id=p.mat_id, mats=mats, kinds=cfg.kinds,
    )
    return DF, F_n1, dFdt_n1, cs


def _balance(R, f_tra, m_nodes, dU, Un_dt, Un_dt2, body_accel, nm, cfg):
    """Internal forces R minus traction, plus the inertial (or, quasi-static,
    the body-force) terms."""
    if f_tra is not None:
        R = R - f_tra
    m = m_nodes[:, None]
    if cfg.quasi_static:
        return R - m * body_accel[None, :]
    return R + m * (nm.alpha_1 * dU - nm.alpha_2 * Un_dt - nm.alpha_3 * Un_dt2
                    - body_accel[None, :])


def _free_dofs(grid, has_mass, d, like):
    if grid.dirichlet_mask is not None:
        free = has_mass & ~grid.dirichlet_mask
        dU_dirichlet = torch.where(grid.dirichlet_mask, grid.dirichlet_value,
                                   torch.zeros((), dtype=like.dtype, device=like.device))
    else:
        free = has_mass
        dU_dirichlet = torch.zeros((grid.n_nodes, d), dtype=like.dtype, device=like.device)
    return free, dU_dirichlet


def _jacobi(diag_K, m_nodes, free, nm, cfg):
    """The Jacobi preconditioner: α₁·m plus the stiffness diagonal
    Σ_p V0(λ+2G)|∇N_pA|², 1 on constrained dofs."""
    diag = diag_K[:, None] + (0.0 if cfg.quasi_static else nm.alpha_1 * m_nodes[:, None])
    diag = torch.where(free, torch.clamp(diag, min=1e-30),
                       torch.ones((), dtype=diag.dtype, device=diag.device))
    return lambda r: r / diag


def _newton(residual, M_inv, n_nodes, d, like, cfg):
    # grid-partitioned vectors (a halo strip): every dot and norm all-reduced
    return solvers.newton_krylov(
        residual,
        torch.zeros((n_nodes, d), dtype=like.dtype, device=like.device),
        M_inv=M_inv, tol=cfg.newton_tol, maxiter=cfg.newton_maxiter, cg_tol=cfg.cg_tol,
        cg_maxiter=cfg.cg_maxiter, linear=cfg.linear, forcing=cfg.forcing,
        axis_name=None if cfg.halo is None else cfg.halo.comm,
    )


def _increments(nm, dU, Un_dt, Un_dt2):
    """Nodal velocity and acceleration increments at the converged dU."""
    dU_dt = nm.alpha_4 * dU + (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    dU_dt2 = nm.alpha_1 * dU - nm.alpha_2 * Un_dt - (nm.alpha_3 + 1.0) * Un_dt2
    return dU_dt, dU_dt2


def _staggered_damage(p, grid, mats, cfg, act, cs, J_n1, F_n1):
    """The fracture driver's (damage, strain_f) at the converged state (the
    state's own without a driver)."""
    if cfg.damage is None:
        return p.damage, p.strain_f
    return tuple(fracture.damage_update(p, grid, cfg.active_box, cfg.damage, mats, act, cs,
                                        J_n1, F_n1, cfg.beps_reach, halo=cfg.halo))


def _advance(p, act, cs, F_n1, dFdt_n1, J_n1, dis_inc, dv, da, a_blend, lam, damage=None,
             strain_f=None, lme_beta=None):
    """FLIP/PIC particle update (``alpha_blend`` = 1 ⇒ pure FLIP); damage,
    strain_f and lme_beta keep the state's own unless given."""
    sel = act[:, None]
    return p.replace(
        x=torch.where(sel, p.x + dis_inc, p.x),
        dis=torch.where(sel, p.dis + dis_inc, p.dis),
        v=torch.where(sel, a_blend * p.v + dv, p.v),
        a=torch.where(sel, p.a + da, p.a),
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
        damage=p.damage if damage is None else damage,
        strain_f=p.strain_f if strain_f is None else strain_f,
        lme_lambda=lam,
        lme_beta=p.lme_beta if lme_beta is None else lme_beta,
    )


def _det_clamped(F_n1):
    J_n1 = tn.det(F_n1)
    return torch.where(J_n1 > 0.0, J_n1, torch.zeros_like(J_n1))


class _Windowed(NamedTuple):
    """What a windowed step builds once at step start."""

    sf: dict
    N: Tensor
    dN: Tensor
    mask: Tensor
    eng: object
    m_nodes: Tensor
    has_mass: Tensor
    Un_dt: Tensor
    Un_dt2: Tensor
    grad_vel_const: Tensor
    fi_of_grad: object


def _windowed_setup(p, grid, mats, cfg, nm) -> _Windowed:
    """Shape functions and the engine, lumped mass, the nodal velocity and
    acceleration (P2G ÷ mass), the fixed part of the velocity gradient
    (dU̇ = α₄·dU + const), and the per-edge internal-force integrand."""
    sf, offsets = shapefun_eval(cfg, grid, p)
    N, dN, mask = sf["N"], sf["dN"], sf["mask"] & p.active[:, None]
    eng = make_engine(cfg, grid, sf, offsets, mask)
    m_nodes = eng.p2g(N * p.mass[:, None])
    m_safe = torch.clamp(m_nodes, min=cfg.mass_tol)[:, None]

    def project(field_p):
        mom = (N * p.mass[:, None])[..., None] * field_p[:, None, :]
        return eng.p2g(mom) / m_safe

    Un_dt, Un_dt2 = project(p.v), project(p.a)
    vel_const_nodes = (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    grad_vel_const = kin.disp_gradient(eng.edge_gather(vel_const_nodes), dN)

    def fi_of_grad(grad_du):
        """f_pA = V0·τ·∇N¹_A, whose forward-mode derivative is the exact
        consistent tangent."""
        DF, _, _, cs = _local_state(p, mats, cfg, nm, grad_vel_const, grad_du)
        tau_eff = cs.tau * (1.0 - p.damage)[:, None, None]
        dN1 = kin.push_forward_dN(dN, DF)
        return dN1 @ (tau_eff * p.vol0[:, None, None]).transpose(-1, -2)

    return _Windowed(sf, N, dN, mask, eng, m_nodes, (m_nodes > cfg.mass_tol)[:, None], Un_dt,
                     Un_dt2, grad_vel_const, fi_of_grad)


def implicit_step(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ImplicitConfig,
    body_accel: Tensor,  # (d,)
    traction: Optional[Tensor] = None,  # (Np, d) nominal traction t̄
    traction_area: Optional[Tensor] = None,  # (Np,) reference area A0_p
):
    """One implicit Newmark-β (or quasi-static) step.  Returns (particles,
    diagnostics): ``nnz``, ``newton_iters`` and ``cg_iters`` (ints),
    ``newton_residual``, ``converged`` (device tensors), ``lost``,
    ``reactions``."""
    _check_supported(cfg, p, grid)
    if cfg.transfer == "fused":
        return _implicit_step_fused(p, grid, mats, cfg, body_accel, traction, traction_area)
    d = p.dim
    nm = newmark_parameters(cfg.beta, cfg.gamma, cfg.dt)
    lost = torch.zeros((), dtype=torch.int32, device=p.x.device)
    if cfg.transfer == "windowed" and not cfg.prebinned:
        p, lost, traction, traction_area = _bin_to_slots(
            p, grid, cfg.active_box, traction, traction_area)
    act = p.active

    w = _windowed_setup(p, grid, mats, cfg, nm)
    N, dN, eng, m_nodes, fi_of_grad = w.N, w.dN, w.eng, w.m_nodes, w.fi_of_grad
    Un_dt, Un_dt2 = w.Un_dt, w.Un_dt2
    lost = lost + found_lost(w.sf, act)
    free, dU_dirichlet = _free_dofs(grid, w.has_mass, d, p.x)
    f_tra = None
    if traction is not None:
        f_tra = eng.p2g((N * traction_area[:, None])[..., None] * traction[:, None, :])

    def residual(dU_free):
        dU = torch.where(free, dU_free, dU_dirichlet)
        grad_du = kin.disp_gradient(eng.edge_gather(dU), dN)
        R = eng.p2g(fi_of_grad(grad_du))
        R = _balance(R, f_tra, m_nodes, dU, Un_dt, Un_dt2, body_accel, nm, cfg)
        return torch.where(free, R, torch.zeros_like(R))

    if cfg.precond == "block-jacobi":
        # exact AD-assembled d×d diagonal blocks K_AA (+ α₁·m·I), inverted
        # in closed form per node
        H = edge_force_jacobian(fi_of_grad, torch.zeros_like(p.F))
        Bi = torch.einsum("skilm,skm->skil", H, dN)  # pair (i, i) blocks
        ns_, K_ = dN.shape[0], dN.shape[1]
        diag_blocks = eng.p2g(Bi.reshape(ns_, K_, d * d)).reshape(grid.n_nodes, d, d)
        shift = None if cfg.quasi_static else nm.alpha_1 * m_nodes
        Dinv = bsr.block_jacobi_inverse(diag_blocks, free=free, shift=shift)

        def M_inv(r):
            return tn.bmv(Dinv, r)

    else:
        lam_p, G_p = lame_parameters(mats.E[p.mat_id.long()], mats.nu[p.mat_id.long()])
        stiff_scale = (lam_p + 2.0 * G_p) * p.vol0
        diag_K = eng.p2g(stiff_scale[:, None] * torch.sum(dN * dN, dim=-1))
        M_inv = _jacobi(diag_K, m_nodes, free, nm, cfg)

    res = _newton(residual, M_inv, grid.n_nodes, d, p.x, cfg)
    dU = torch.where(free, res.x, dU_dirichlet)
    dU_dt, dU_dt2 = _increments(nm, dU, Un_dt, Un_dt2)

    grad_du = kin.disp_gradient(eng.edge_gather(dU), dN)
    DF, F_n1, dFdt_n1, cs = _local_state(p, mats, cfg, nm, w.grad_vel_const, grad_du)
    J_n1 = _det_clamped(F_n1)
    damage_n1, strain_f_n1 = _staggered_damage(p, grid, mats, cfg, act, cs, J_n1, F_n1)

    # reactions: minus the unmasked residual on the Dirichlet rows
    if grid.dirichlet_mask is not None:
        R_full = eng.p2g(fi_of_grad(grad_du))
        R_full = _balance(R_full, f_tra, m_nodes, dU, Un_dt, Un_dt2, body_accel, nm, cfg)
        reactions = torch.where(grid.dirichlet_mask, -R_full, torch.zeros_like(R_full))
    else:
        reactions = torch.zeros((grid.n_nodes, d), dtype=p.x.dtype, device=p.x.device)

    a_blend = cfg.alpha_blend
    dis_inc = eng.g2p(N, dU)
    dv = eng.g2p(N, dU_dt + (1.0 - a_blend) * Un_dt)
    da = eng.g2p(N, dU_dt2)
    lam = p.lme_lambda if w.sf["lam"] is None else w.sf["lam"]
    lme_beta = alme.update_beta(p.lme_beta, DF) if cfg.shapefun == "alme" else p.lme_beta
    p_out = _advance(p, act, cs, F_n1, dFdt_n1, J_n1, dis_inc, dv, da, a_blend, lam,
                     damage_n1, strain_f_n1, lme_beta)
    nnz, lost = global_sums(cfg, count_nnz(w.mask), lost)
    diag_out = dict(
        nnz=nnz,
        newton_iters=res.iters,
        newton_residual=res.residual_norm,
        cg_iters=res.linear_iters,
        converged=res.converged,
        lost=lost,
        reactions=reactions,
    )
    return p_out, diag_out


def _implicit_step_fused(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ImplicitConfig,
    body_accel: Tensor,
    traction: Optional[Tensor] = None,
    traction_area: Optional[Tensor] = None,
):
    """Fused-kernel implicit step (2D/3D LME): the windowed step's physics
    with no (Ns, K, ·) edge tensor; each J·v is one gradient gather and one
    G-scatter, each launched for the primal and for the tangent."""
    box = cfg.active_box
    d = p.dim
    nm = newmark_parameters(cfg.beta, cfg.gamma, cfg.dt)
    C, nc = box.capacity, box.n_cells
    local_mode = cfg.rebin_mode == "local" and traction is None and not cfg.prebinned
    lost = torch.zeros((), dtype=torch.int32, device=p.x.device)
    if not local_mode and not cfg.prebinned:
        p, lost, traction, traction_area = _bin_to_slots(p, grid, box, traction, traction_area)
    act = p.active

    x_t = ft.to_channel_leading(p.x, C, nc)
    lam_t = ft.to_channel_leading(p.lme_lambda, C, nc)
    act_t = ft.to_channel_leading(act.to(p.x.dtype), C, nc)

    # scatter #1 (solves λ): mass, v and a momenta, traction, and the
    # stiffness scale, the LAST channel, which gnorm weighs: Σ s·|∇N|²
    lam_p, G_p = lame_parameters(mats.E[p.mat_id.long()], mats.nu[p.mat_id.long()])
    stiff_scale = (lam_p + 2.0 * G_p) * p.vol0
    chans = [p.mass[:, None], p.mass[:, None] * p.v, p.mass[:, None] * p.a]
    if traction is not None:
        chans.append(traction_area[:, None] * traction)
    chans.append(stiff_scale[:, None])
    fN = ft.to_channel_leading(torch.cat(chans, dim=1), C, nc)
    nodes1, lam_f, nnz = ft.fused_scatter(grid, box, cfg.lme_params, x_t, lam_t, act_t, fN,
                                          solve=True, gnorm=True)
    # halo strip: owned-complete scatters, ghost-filled gathers (the
    # tangents of the J·v too)
    xadd, fill = halo_ops(cfg)
    nodes1 = xadd(nodes1)
    m_nodes = nodes1[:, 0]
    m_safe = torch.clamp(m_nodes, min=cfg.mass_tol)[:, None]
    has_mass = (m_nodes > cfg.mass_tol)[:, None]
    Un_dt = nodes1[:, 1:1 + d] / m_safe
    Un_dt2 = nodes1[:, 1 + d:1 + 2 * d] / m_safe
    f_tra = nodes1[:, 1 + 2 * d:1 + 3 * d] if traction is not None else None
    diag_K = nodes1[:, -1]
    free, dU_dirichlet = _free_dofs(grid, has_mass, d, p.x)

    # λ frozen through the Newton loop
    geo = (grid, box, cfg.lme_params, x_t, lam_f, act_t, 0)

    def grad_gather(nodes):
        return ft.GatherGrad.apply(fill(nodes), geo)

    def g_scatter(G):
        return xadd(ft.ScatterG.apply(G, geo))[:, 1:1 + d]

    vel_const_nodes = (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    grad_vel_const = grad_gather(vel_const_nodes)
    eye = torch.eye(d, dtype=p.x.dtype, device=p.x.device)
    act3 = act[:, None, None]

    def internal_forces(DF, cs):
        # R_A = Σ_p G·∇N_A with G = V0·τ·ΔF⁻ᵀ; an idle slot inverts I
        tau_eff = cs.tau * (1.0 - p.damage)[:, None, None]
        G = tn.bmm(tau_eff * p.vol0[:, None, None],
                   tn.inv_transpose(torch.where(act3, DF, eye)))
        return g_scatter(G)

    def residual(dU_free):
        dU = torch.where(free, dU_free, dU_dirichlet)
        DF, _, _, cs = _local_state(p, mats, cfg, nm, grad_vel_const, grad_gather(dU))
        R = _balance(internal_forces(DF, cs), f_tra, m_nodes, dU, Un_dt, Un_dt2, body_accel,
                     nm, cfg)
        return torch.where(free, R, torch.zeros_like(R))

    M_inv = _jacobi(diag_K, m_nodes, free, nm, cfg)
    res = _newton(residual, M_inv, grid.n_nodes, d, p.x, cfg)
    dU = torch.where(free, res.x, dU_dirichlet)
    dU_dt, dU_dt2 = _increments(nm, dU, Un_dt, Un_dt2)

    DF, F_n1, dFdt_n1, cs = _local_state(p, mats, cfg, nm, grad_vel_const, grad_gather(dU))
    J_n1 = _det_clamped(F_n1)
    # the staggered update reads the slot arrays of ``p``, not the kernels'
    # channel-leading copies
    damage_n1, strain_f_n1 = _staggered_damage(p, grid, mats, cfg, act, cs, J_n1, F_n1)

    # reactions on Dirichlet rows: one more G-scatter at the converged state
    if grid.dirichlet_mask is not None:
        R_full = _balance(internal_forces(DF, cs), f_tra, m_nodes, dU, Un_dt, Un_dt2,
                          body_accel, nm, cfg)
        reactions = torch.where(grid.dirichlet_mask, -R_full, torch.zeros_like(R_full))
    else:
        reactions = torch.zeros((grid.n_nodes, d), dtype=p.x.dtype, device=p.x.device)

    a_blend = cfg.alpha_blend
    gfields = torch.cat([dU, dU_dt + (1.0 - a_blend) * Un_dt, dU_dt2], dim=1)
    gout = ft.GatherN.apply(fill(gfields), geo)
    p_out = _advance(p, act, cs, F_n1, dFdt_n1, J_n1, gout[:, :d], gout[:, d:2 * d],
                     gout[:, 2 * d:], a_blend, ft.from_channel_leading(lam_f), damage_n1,
                     strain_f_n1)
    if local_mode:
        p_out, lost = windowed.local_rebin(p_out, grid, box)
    nnz, lost = global_sums(cfg, nnz, lost)
    diag_out = dict(
        nnz=nnz,
        newton_iters=res.iters,
        newton_residual=res.residual_norm,
        cg_iters=res.linear_iters,
        converged=res.converged,
        lost=lost,
        reactions=reactions,
    )
    return p_out, diag_out


def assemble_tangent(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ImplicitConfig,
    dU: Optional[Tensor] = None,
):
    """Assembled banded-BSR Newmark tangent J = Σ_p H·∇N + α₁·M at the
    iterate dU (default 0), Dirichlet rows and columns zeroed; windowed
    engine only.  Returns (A, dict(free, m_nodes, binning))."""
    if cfg.transfer != "windowed":
        raise ValueError("assemble_tangent requires cfg.transfer='windowed'")
    _check_supported(cfg, p, grid)
    nm = newmark_parameters(cfg.beta, cfg.gamma, cfg.dt)
    binning = windowed.bin_particles(grid, cfg.active_box, p.x, p.active)
    p = windowed.permute_to_slots(p, binning)
    w = _windowed_setup(p, grid, mats, cfg, nm)
    free, _ = _free_dofs(grid, w.has_mass, p.dim, p.x)

    if dU is None:
        grad0 = torch.zeros_like(p.F)
    else:
        grad0 = kin.disp_gradient(w.eng.edge_gather(dU), w.dN)
    H = edge_force_jacobian(w.fi_of_grad, grad0)
    A = bsr.assemble(H, w.dN, w.mask, cfg.active_box, grid, w.eng.offsets)
    if not cfg.quasi_static:
        A = bsr.add_diagonal(A, nm.alpha_1 * w.m_nodes)
    A = bsr.apply_dof_masks(A, free)
    return A, dict(free=free, m_nodes=w.m_nodes, binning=binning)


def run(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ImplicitConfig,
    n_steps: int,
    body_accel=None,
):
    """Time loop from any particle order (binned once by ``to_slot_layout``
on the slot-layout engines).
    Returns (particles, dict(newton_iters (n_steps,) int32, newton_residual
    (n_steps,)))."""
    _check_supported(cfg, p, grid)
    if body_accel is None:
        body_accel = torch.zeros((p.dim,), dtype=p.x.dtype, device=p.x.device)
    if cfg.transfer != "scatter":
        p = to_slot_layout(p, grid, cfg.active_box)
    iters, rnorm = [], []
    for _ in range(n_steps):
        p, dg = implicit_step(p, grid, mats, cfg, body_accel)
        iters.append(dg["newton_iters"])
        rnorm.append(dg["newton_residual"])
    return p, dict(
        newton_iters=torch.tensor(iters, dtype=torch.int32, device=p.x.device),
        newton_residual=torch.stack(rnorm) if rnorm else torch.zeros((0,), device=p.x.device),
    )
