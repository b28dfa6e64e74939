"""Mixed displacement–pressure (u-p) implicit Newmark-β step.

Counterpart of ``nlpartsol_tpu/formulations/up.py`` (the reference's
Displacements-Pressure/U-p-Newmark-beta.c): a monolithic matrix-free
Newton-Krylov on the stacked nodal unknown z = (dU, dλ),

  λ_{n+1,p} = λ_n,p + Σ_A N_A·dλ_A   (carried in ``Particles.pw``)
  τ_total   = dev τ(F) + λ_{n+1}·I
  R_u,A = Σ_p V0·τ_total·∇N¹_A − f_tra + m_A·(α₁dU − α₂u̇ₙ − α₃üₙ − b)
  R_λ,A = Σ_p N_A·(p̄(F_p) − λ_{n+1,p})·V0        (p̄: Kirchhoff mean stress)

solved by Newton-GMRES on the row- and column-scaled residual of the u-pw
step (u rows over their Jacobi diagonal times h, λ rows over the lumped
volume Σ N·V0 times the mean P-wave modulus of the table).

Three engines: ``'scatter'`` (the default, as in the JAX package: segment
sums over the (Np, K) pattern in particle order, ops/sparse.py),
``'windowed'`` (the slot-layout engine) — both plain tensor code, LME or FEM
— and ``'fused'`` (the CUDA kernels of ops/fused_transfer.py, LME only; the
JAX package's ``'pallas'``).  The fused step solves λ once, in the first
scatter, with the Jacobi stiffness diagonal as its ``gnorm`` (2 + 2d + 1
channels: mass, V0, the v and a momenta, the stiffness scale; d traction
channels more before the last); gathers the gradient of the fixed velocity
constant once; then evaluates each residual with one ``GatherNGrad`` (the
N-sample of dλ, column d of z, with the gradient of dU, columns 0..d−1) and
one ``ScatterNG`` ([(p̄ − λ)·V0 | G], G = V0·τ_total·ΔF⁻ᵀ), each launched
once more for the tangent of a J·v; and gathers [dU | dU̇ | dÜ] at the end.
With n Newton iterations, L GMRES iterations (20 a cycle) and K GMRES
convergence checks (``solvers.host_syncs["krylov"]``) in a step, the step
makes R = 1 + 5n residuals and V = n + K + 21·L/20 J·v products (as the
u-pw step, formulations/upw.py), and launches:

  scatter λ-solve + gnorm     1
  gather gradient             1
  gather N + gradient         1 + R + 2V
  G-scatter                   R + 2V
  N-gather                    1

(the 1 of the N + gradient gathers: the local state at the converged
iterate.)  K = n + L/20 when no solve runs all its cycles.

Every material kind of the dispatch runs.
Multi-device: ``axis_name`` (a ``parallel.collectives.Comm``) sums the
diagnostics and, on the windowed and scatter engines, every P2G over the
group (particles split over ranks, the grid replicated);
``rebin_mode='none'`` re-bins nothing (an outside owner keeps the slots).
On an unstructured ``FEMesh`` (shapefun/femesh.py) the step runs on the
scatter engine only; 'windowed' and 'fused' raise ``ValueError``.
``transfer='binned'`` is on the do-not-port list (ROADMAP.md queue 2) and
raises ``NotImplementedError``.
uGIMP and aLME run on the scatter and windowed engines (aLME's
β pulled back by ΔF each step).  The step is
dimension-generic like the JAX package's; the tests and ``chip_smoke.py``
hold it in 2D.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.materials import MaterialTable, lame_parameters
from ..ops import fused_transfer as ft
from ..ops import windowed
from ..ops import tensor as tn
from ..ops.sparse import nnz as count_nnz
from ..shapefun import alme, lme
from ..types import Grid, Particles
from . import kinematics as kin
from .common import (binned_refused, check_background, check_rebin_mode, check_shapefun,
                     found_lost, make_engine, shapefun_eval)
from .explicit import _bin_to_slots, to_slot_layout
from .implicit import (_advance, _balance, _det_clamped, _free_dofs, _increments, _local_state,
                       newmark_parameters)
from .upw import _implicit_diag, _scaled_newton

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class UpConfig:
    dt: float
    beta: float = 0.25
    gamma: float = 0.5
    shapefun: str = "lme"
    lme_params: lme.LMEParams = dataclasses.field(default_factory=lme.LMEParams)
    alme_params: Optional[alme.ALMEParams] = None
    kinds: tuple = (3,)  # NEO_HOOKEAN
    mass_tol: float = 1e-12
    newton_tol: float = 1e-5
    newton_maxiter: int = 20
    krylov_tol: float = 1e-7
    krylov_maxiter: int = 200
    alpha_blend: float = 1.0  # 1 ⇒ FLIP
    quasi_static: bool = False
    # transfer backend: 'scatter', 'windowed' or 'fused' (the last two need
    # active_box)
    transfer: str = "scatter"
    active_box: Optional[windowed.ActiveBox] = None
    # multi-device: the group of the P2G and diagnostic sums, a
    # parallel.collectives.Comm
    axis_name: Optional[object] = None
    # particles already in slot layout: skip the step's own binning
    prebinned: bool = False
    # fused re-bin: 'local' (end-of-step windowed.local_rebin), 'global'
    # (binning at step start; tractions always take it) or 'none'
    rebin_mode: str = "local"

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def _check_supported(cfg: UpConfig, p: Particles, grid):
    check_background(cfg, grid)

    if p.dim not in (2, 3):
        raise ValueError(f"u-p steps run in 2D and 3D, not {p.dim}D")
    check_rebin_mode(cfg)
    check_shapefun(cfg)
    if cfg.transfer == "binned":
        raise binned_refused()
    if cfg.transfer not in ("scatter", "windowed", "fused"):
        raise ValueError(f"unknown transfer {cfg.transfer}")
    if cfg.transfer != "scatter" and cfg.active_box is None:
        raise ValueError(f"{cfg.transfer} transfer requires cfg.active_box")


def _mean_and_dev(tau, tau_zz, dim):
    """Kirchhoff mean stress and deviator with the plane-strain zz channel
    (2D tensors carry the out-of-plane component separately)."""
    tr = tn.trace(tau)
    if dim == 2:
        tr = tr + tau_zz
    mean = tr / 3.0
    eye = torch.eye(dim, dtype=tau.dtype, device=tau.device)
    return mean, tau - mean[:, None, None] * eye, tau_zz - mean


def _constrained_stress(cs, p, lam_n1, d):
    """The mean of the damaged constitutive stress, and the constrained
    stress: its deviator plus the nodal pressure field λ_{n+1}·I."""
    keep = 1.0 - p.damage
    mean, dev, _ = _mean_and_dev(cs.tau * keep[:, None, None], cs.tau_zz * keep, d)
    eye = torch.eye(d, dtype=dev.dtype, device=dev.device)
    return mean, dev + lam_n1[:, None, None] * eye


def _scales(diag_K, m_nodes, v_nodes, free_u, free_l, nm, cfg, mats, h):
    """Row scales of the u rows (Jacobi diagonal: stiffness + α₁·m) and of
    the λ rows (the lumped volume), and the characteristic unknowns h and
    θ_ref = mean over the table of λ + 2G."""
    one = torch.ones((), dtype=diag_K.dtype, device=diag_K.device)
    diag_u = diag_K[:, None] + (0.0 if cfg.quasi_static else nm.alpha_1 * m_nodes[:, None])
    diag_u = torch.where(free_u, torch.clamp(diag_u, min=1e-30), one)
    diag_l = torch.where(free_l, torch.clamp(v_nodes, min=1e-30), one)
    lam_m, G_m = lame_parameters(mats.E, mats.nu)
    h_ref = torch.tensor(h, dtype=diag_K.dtype, device=diag_K.device)
    return diag_u, diag_l, h_ref, torch.mean(lam_m + 2.0 * G_m)


def _stiffness_scale(p, mats):
    mid = p.mat_id.long()
    lam_p, G_p = lame_parameters(mats.E[mid], mats.nu[mid])
    return (lam_p + 2.0 * G_p) * p.vol0


def up_step(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: UpConfig,
    body_accel: Tensor,  # (d,)
    traction: Optional[Tensor] = None,  # (Np, d) nominal traction t̄
    traction_area: Optional[Tensor] = None,  # (Np,) reference area A0_p
):
    """One implicit Newmark-β (or quasi-static) step of the mixed u-p
    formulation; λ_n is carried in ``Particles.pw``.  Returns (particles,
    diagnostics): ``nnz``, ``lost``, ``newton_iters`` and ``cg_iters``
    (ints; the latter counts GMRES iterations), ``newton_residual``,
    ``converged``."""
    _check_supported(cfg, p, grid)
    if cfg.transfer == "fused":
        return _up_step_fused(p, grid, mats, cfg, body_accel, traction, traction_area)
    d = p.dim
    nm = newmark_parameters(cfg.beta, cfg.gamma, cfg.dt)
    lost = torch.zeros((), dtype=torch.int32, device=p.x.device)
    if cfg.transfer == "windowed" and not cfg.prebinned:
        p, lost, traction, traction_area = _bin_to_slots(p, grid, cfg.active_box, traction,
                                                         traction_area)
    act = p.active
    sf, offsets = shapefun_eval(cfg, grid, p)
    N, dN, mask = sf["N"], sf["dN"], sf["mask"] & act[:, None]
    lost = lost + found_lost(sf, act)
    eng = make_engine(cfg, grid, sf, offsets, mask)

    m_nodes = eng.p2g(N * p.mass[:, None])
    m_safe = torch.clamp(m_nodes, min=cfg.mass_tol)[:, None]
    has_mass = (m_nodes > cfg.mass_tol)[:, None]
    # lumped volume (the pressure projection's "mass"): Σ_p N·V0
    v_nodes = eng.p2g(N * p.vol0[:, None])

    def project(field_p):
        mom = (N * p.mass[:, None])[..., None] * field_p[:, None, :]
        return eng.p2g(mom) / m_safe

    Un_dt, Un_dt2 = project(p.v), project(p.a)
    free_u, dU_dirichlet = _free_dofs(grid, has_mass, d, p.x)
    free_l = has_mass[:, 0]
    zero = torch.zeros((), dtype=p.x.dtype, device=p.x.device)
    f_tra = None
    if traction is not None:
        f_tra = eng.p2g((N * traction_area[:, None])[..., None] * traction[:, None, :])

    vel_const_nodes = (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    grad_vel_const = kin.disp_gradient(eng.edge_gather(vel_const_nodes), dN)
    diag_K = eng.p2g(_stiffness_scale(p, mats)[:, None] * torch.sum(dN * dN, dim=-1))
    diag_u, diag_l, h_ref, theta_ref = _scales(diag_K, m_nodes, v_nodes, free_u, free_l, nm,
                                               cfg, mats, grid.spacing)

    def local_state(dU, dlam):
        grad_du = kin.disp_gradient(eng.edge_gather(dU), dN)
        DF, F_n1, dFdt_n1, cs = _local_state(p, mats, cfg, nm, grad_vel_const, grad_du)
        return DF, F_n1, dFdt_n1, p.pw + eng.g2p(N, dlam), cs

    def masked(z):
        return torch.where(free_u, z[:, :d], dU_dirichlet), torch.where(free_l, z[:, d], zero)

    def residual_rows(z):
        dU, dlam = masked(z)
        DF, _, _, lam_n1, cs = local_state(dU, dlam)
        mean, tau_tot = _constrained_stress(cs, p, lam_n1, d)
        dN1 = kin.push_forward_dN(dN, DF)
        fi = torch.einsum("pij,pkj->pki", tau_tot * p.vol0[:, None, None], dN1)
        R_u = _balance(eng.p2g(fi), f_tra, m_nodes, dU, Un_dt, Un_dt2, body_accel, nm, cfg)
        # pressure projection rows: λ is the L2 projection of the mean stress
        R_l = eng.p2g(N * ((mean - lam_n1) * p.vol0)[:, None])
        return R_u, R_l

    res = _scaled_newton(residual_rows, free_u, free_l, diag_u, diag_l, h_ref, theta_ref,
                         grid.n_nodes, d, p.x, cfg)
    dU, dlam = masked(res.x)
    dU_dt, dU_dt2 = _increments(nm, dU, Un_dt, Un_dt2)
    DF, F_n1, dFdt_n1, lam_n1, cs = local_state(dU, dlam)
    a_blend = cfg.alpha_blend
    p_out = _advance(p, act, cs, F_n1, dFdt_n1, _det_clamped(F_n1), eng.g2p(N, dU),
                     eng.g2p(N, dU_dt + (1.0 - a_blend) * Un_dt), eng.g2p(N, dU_dt2), a_blend,
                     p.lme_lambda if sf["lam"] is None else sf["lam"],
                     lme_beta=(alme.update_beta(p.lme_beta, DF) if cfg.shapefun == "alme"
                               else None))
    p_out = p_out.replace(pw=torch.where(act, lam_n1, p.pw))  # λ_n ← λ_{n+1}
    return p_out, _implicit_diag(res, count_nnz(mask), lost, cfg)


def _up_step_fused(p, grid, mats, cfg, body_accel, traction=None, traction_area=None):
    """Fused-kernel u-p step (LME): the windowed step's physics with every
    transfer of the Newton-GMRES loop through the kernels' linear wrappers
    (launch formula in the module docstring); λ is solved once by the first
    scatter and frozen through the loop."""
    box, params = cfg.active_box, cfg.lme_params
    d = p.dim
    nm = newmark_parameters(cfg.beta, cfg.gamma, cfg.dt)
    C, nc = box.capacity, box.n_cells
    local_mode = cfg.rebin_mode == "local" and traction is None and not cfg.prebinned
    lost = torch.zeros((), dtype=torch.int32, device=p.x.device)
    if not local_mode and not cfg.prebinned:
        p, lost, traction, traction_area = _bin_to_slots(p, grid, box, traction, traction_area)
    act = p.active
    sel3 = act[:, None, None]
    eye = torch.eye(d, dtype=p.x.dtype, device=p.x.device)
    zero = torch.zeros((), dtype=p.x.dtype, device=p.x.device)
    x_t, lam_t, act_t = (ft.to_channel_leading(a, C, nc)
                         for a in (p.x, p.lme_lambda, act.to(p.x.dtype)))

    # scatter #1 (solves λ): mass, lumped volume, v and a momenta, traction,
    # and the stiffness scale, the LAST channel, which gnorm weighs
    chans = [p.mass[:, None], p.vol0[:, None], p.mass[:, None] * p.v, p.mass[:, None] * p.a]
    if traction is not None:
        chans.append(traction_area[:, None] * traction)
    chans.append(_stiffness_scale(p, mats)[:, None])
    nodes1, lam_f, nnz = ft.fused_scatter(grid, box, params, x_t, lam_t, act_t,
                                          ft.to_channel_leading(torch.cat(chans, dim=1), C, nc),
                                          solve=True, gnorm=True)
    m_nodes = nodes1[:, 0]
    m_safe = torch.clamp(m_nodes, min=cfg.mass_tol)[:, None]
    has_mass = (m_nodes > cfg.mass_tol)[:, None]
    Un_dt = nodes1[:, 2:2 + d] / m_safe
    Un_dt2 = nodes1[:, 2 + d:2 + 2 * d] / m_safe
    f_tra = nodes1[:, 2 + 2 * d:2 + 3 * d] if traction is not None else None
    free_u, dU_dirichlet = _free_dofs(grid, has_mass, d, p.x)
    free_l = has_mass[:, 0]
    diag_u, diag_l, h_ref, theta_ref = _scales(nodes1[:, -1], m_nodes, nodes1[:, 1], free_u,
                                               free_l, nm, cfg, mats, grid.spacing)

    # λ frozen through the Newton loop
    geo = (grid, box, params, x_t, lam_f, act_t, 0)
    grad_vel_const = ft.GatherGrad.apply((nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2, geo)

    def local_state(zm):
        # N-sample of dλ (column d) and ∇dU (columns 0..d−1): one launch
        outN, grad_du = ft.GatherNGrad.apply(zm, geo, d)
        DF, F_n1, dFdt_n1, cs = _local_state(p, mats, cfg, nm, grad_vel_const, grad_du)
        return DF, F_n1, dFdt_n1, p.pw + outN[:, 0], cs

    def masked(z):
        dU = torch.where(free_u, z[:, :d], dU_dirichlet)
        return dU, torch.cat([dU, torch.where(free_l, z[:, d], zero)[:, None]], dim=1)

    def residual_rows(z):
        dU, zm = masked(z)
        DF, _, _, lam_n1, cs = local_state(zm)
        mean, tau_tot = _constrained_stress(cs, p, lam_n1, d)
        # R_u,A = Σ_p G·∇N_A with G = V0·τ_total·ΔF⁻ᵀ; an idle slot inverts I
        G = tn.bmm(tau_tot * p.vol0[:, None, None], tn.inv_transpose(torch.where(sel3, DF, eye)))
        G = torch.where(sel3, G, zero)
        rlam = torch.where(act, (mean - lam_n1) * p.vol0, zero)
        nodes = ft.ScatterNG.apply(torch.cat([rlam[:, None], G.reshape(-1, d * d)], dim=1), geo)
        R_u = _balance(nodes[:, 1:1 + d], f_tra, m_nodes, dU, Un_dt, Un_dt2, body_accel, nm, cfg)
        return R_u, nodes[:, 0]

    res = _scaled_newton(residual_rows, free_u, free_l, diag_u, diag_l, h_ref, theta_ref,
                         grid.n_nodes, d, p.x, cfg)
    dU, zm = masked(res.x)
    dU_dt, dU_dt2 = _increments(nm, dU, Un_dt, Un_dt2)
    _, F_n1, dFdt_n1, lam_n1, cs = local_state(zm)
    a_blend = cfg.alpha_blend
    gout, _ = ft.fused_gather(grid, box, params, x_t, lam_f, act_t,
                              gN=torch.cat([dU, dU_dt + (1.0 - a_blend) * Un_dt, dU_dt2], dim=1))
    p_out = _advance(p, act, cs, F_n1, dFdt_n1, _det_clamped(F_n1), gout[:, :d],
                     gout[:, d:2 * d], gout[:, 2 * d:], a_blend, ft.from_channel_leading(lam_f))
    p_out = p_out.replace(pw=torch.where(act, lam_n1, p.pw))  # λ_n ← λ_{n+1}
    if local_mode:
        p_out, lost = windowed.local_rebin(p_out, grid, box)
    return p_out, _implicit_diag(res, nnz, lost, cfg)


def run(p: Particles, grid: Grid, mats: MaterialTable, cfg: UpConfig, n_steps: int,
        body_accel=None):
    """Time loop (binned once by ``to_slot_layout`` on the windowed and fused
    engines).  Returns (particles, dict(newton_iters (n_steps,) int32,
    newton_residual (n_steps,)))."""
    _check_supported(cfg, p, grid)
    if body_accel is None:
        body_accel = torch.zeros((p.dim,), dtype=p.x.dtype, device=p.x.device)
    if cfg.transfer in ("windowed", "fused"):
        p = to_slot_layout(p, grid, cfg.active_box)
    iters, rnorm = [], []
    for _ in range(n_steps):
        p, dg = up_step(p, grid, mats, cfg, body_accel)
        iters.append(dg["newton_iters"])
        rnorm.append(dg["newton_residual"])
    return p, dict(
        newton_iters=torch.tensor(iters, dtype=torch.int32, device=p.x.device),
        newton_residual=torch.stack(rnorm) if rnorm else torch.zeros((0,), device=p.x.device),
    )
