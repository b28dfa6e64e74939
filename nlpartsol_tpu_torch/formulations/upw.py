"""Soil-water mixture formulation (-upw): the explicit two-phase step and
the monolithic implicit Newmark-β step.

Counterpart of ``nlpartsol_tpu/formulations/upw.py`` (the reference's
Displacements-WaterPressure/U-pw-Verlet.c and U-pw-Newmark-beta.c):

  lumped mixture mass  m_A = Σ m_p N, fluid compressibility
      C_A = Σ (J·φ_f·ρ_f/K_f)·V0·N (the implicit step leaves J out, as the
      JAX package does)
  predictor: Δu_p, v_p, θ_p += (1−γ)Δt·θ̇_p; P2G of Δu, v, θ; Dirichlet
  local state: ΔF → F → J, Cauchy p_w = θ/J, ρ_f = ρ_f0·exp((p_w − p_w0)/K_f),
      φ_s = φ_s0/J, φ_f = 1 − (1−φ_f0)/J, effective stress of the soil
  mixture equilibrium with τ_tot = τ' − θ·I (Terzaghi), a_A = b + f_A/m_A
  mass balance C·θ̇ = −Σ N ρ_f (dJ/dt) V0 + (1/g)·Σ ∇N·(F⁻¹k)·∇θ V0
      + (Jρ_f/g)·Σ ∇N·(F⁻¹k)·(a − b) V0 (g = −9.81, the reference's sign)
  corrector: v += γΔt·a, x += Δu, θ += γΔt·θ̇

The implicit step solves the stacked nodal unknown z = (dU, dθ) by
Newton-GMRES on a row- and column-scaled residual (without the scaling the
storativity-sized θ rows never reach the float32 residual norm).

Three engines, as for the single-phase steps: ``'windowed'`` (plain tensor
code, ops/windowed.py), ``'scatter'`` (segment sums over the (Np, K)
pattern in particle order, no slot layout), both with LME, FEM, uGIMP or
aLME shape functions, and ``'fused'`` (the CUDA kernels of
ops/fused_transfer.py, LME only; the JAX package's ``'pallas'``).
The fused explicit step is 3 scatters and 5 gathers at margin 0, then a
local re-bin: scatter λ-solve (2 + 2d + 1 channels), gathers of [Δu | θ]
with ∇Δu, of ∇v and of ∇θ (θ packed in row 0 of a d-vector field),
scatter of the jacobian-rate channel with G = −V0·τ_tot·ΔF⁻ᵀ, gather of
the accelerations, scatter of the Darcy and fluid-inertia terms as one G
row (GRAD_A·w = ∇N_A·(F_n·w), read in column 1 behind a zero channel), and
gather of θ̇.

The fused implicit step solves λ once (scatter with the stiffness
``gnorm`` diagonal), takes the Darcy diagonal from a second scatter
(``solve=False``, ``gnorm``, one channel: its column 1), gathers the fixed
fields once (N-gather of [α₂u̇ₙ + α₃üₙ | θₙ] with the gradient of the
velocity constant; ∇θₙ), and then evaluates each residual with two gathers
(``GatherNGrad`` of [dU | dθ] with ∇dU; ``GatherGrad`` of the packed dθ)
and two G-scatters (``ScatterNG`` of the rate channel with the mixture G;
``ScatterG`` of the flow row), each launched once more for the tangent of a
J·v.  With n Newton iterations, L GMRES iterations (20 a cycle) and K
GMRES convergence checks (``solvers.host_syncs["krylov"]``) in a step, the
step makes R = 1 + 5n residuals and V = n + K + 21·L/20 J·v products, and
launches:

  scatter λ-solve + gnorm         1
  scatter gnorm (solve=False)     1
  gather N + gradient             2 + R + 2V
  gather gradient                 2 + R + 2V
  G-scatter                       2R + 4V
  N-gather                        1

(R: r₀, then per Newton iteration four line-search residuals and the
re-evaluated one; V per GMRES solve: one product per convergence check, 21
per cycle — its residual and 20 Arnoldi steps — and one for the final
residual; the 2 of the gathers: the fixed fields, and the local state at the
converged iterate.)  K = n + L/20 when no solve runs all its cycles.

Every soil kind of the dispatch runs (``mix.soil_id`` selects the soil's
row).  Multi-device (parallel/domain.py): with ``halo`` both steps run on
the rank's strip (the halo engine, or the kernels with a halo add after each
scatter and a ghost fill before each gather, tangents included), the
implicit step's Newton-GMRES dots all-reduced over the halo's group;
``rebin_mode='none'`` leaves the re-bin to the sharded driver's migration;
``axis_name`` sums the diagnostics (and, without a halo, every P2G).
On an unstructured ``FEMesh`` (shapefun/femesh.py) the step runs on the
scatter engine only; 'windowed' and 'fused' raise ``ValueError``.
``transfer='binned'`` is on the do-not-port list (ROADMAP.md queue 2) and
raises ``NotImplementedError``.
The steps are dimension-generic like the JAX package's; the tests and
``chip_smoke.py`` hold them in 2D.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import config
from ..models import dispatch as con
from ..models.materials import MaterialTable, lame_parameters
from ..ops import fused_transfer as ft
from ..ops import solvers, windowed
from ..ops import tensor as tn
from ..ops.sparse import nnz as count_nnz
from ..shapefun import alme, lme
from ..types import Grid, Particles, Record
from . import kinematics as kin
from .common import (binned_refused, check_background, check_rebin_mode, check_shapefun,
                     found_lost, global_sums, halo_ops, make_engine, shapefun_eval)
from .explicit import _bin_to_slots, to_slot_layout
from .implicit import newmark_parameters

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MixtureTable(Record):
    """Soil-water mixture parameters, indexed by the particle's mixture id
    (carried in ``Particles.mat_id``)."""

    soil_id: Tensor  # (Nmix,) int32 row of the MaterialTable (solid)
    water_id: Tensor  # (Nmix,) int32 row of the MaterialTable (fluid)
    phi_s0: Tensor  # reference solid volume fraction
    phi_f0: Tensor  # reference fluid volume fraction
    permeability: Tensor  # isotropic Darcy conductivity k


def make_mixture_table(rows, device="cuda") -> MixtureTable:
    cols = {f.name: [r[f.name] for r in rows] for f in dataclasses.fields(MixtureTable)}
    ids = ("soil_id", "water_id")
    return MixtureTable(**{
        k: torch.tensor(v, dtype=torch.int32 if k in ids else config.dtype(), device=device)
        for k, v in cols.items()})


@dataclasses.dataclass(frozen=True)
class UpwConfig:
    dt: float
    gamma: float = 0.5
    shapefun: str = "lme"
    lme_params: lme.LMEParams = dataclasses.field(default_factory=lme.LMEParams)
    alme_params: Optional[alme.ALMEParams] = None
    kinds: tuple = (3,)  # NEO_HOOKEAN
    mass_tol: float = 1e-12
    # transfer backend: 'windowed' or 'fused' (both need active_box), or
    # 'scatter' (any particle order)
    transfer: str = "windowed"
    active_box: Optional[windowed.ActiveBox] = None
    # multi-device: the group of the diagnostics' sums (and, without a
    # halo, of every P2G), a parallel.collectives.Comm; the rank's strip
    # (parallel.domain HaloSpec); particles pre-binned by the sharded driver
    axis_name: Optional[object] = None
    gravity_g: float = -9.81
    halo: Optional[object] = None
    prebinned: bool = False
    # fused: 'local' re-bins at step end (windowed.local_rebin), 'none'
    # leaves it to the sharded driver; the windowed engine bins at step start
    rebin_mode: str = "local"

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class UpwImplicitConfig:
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
    # transfer backend: 'fused' (CUDA kernels) or 'windowed' (both need
    # active_box), or 'scatter' (any particle order)
    transfer: str = "fused"
    active_box: Optional[windowed.ActiveBox] = None
    # multi-device: the group of the diagnostics' sums (and, without a
    # halo, of every P2G), a parallel.collectives.Comm; the rank's strip
    # (parallel.domain HaloSpec); particles pre-binned by the sharded driver
    axis_name: Optional[object] = None
    gravity_g: float = -9.81
    halo: Optional[object] = None
    prebinned: bool = False
    # fused: 'local' — particles arrive in slot layout, re-binned at step
    # end ('none': by the sharded driver); the windowed engine bins at step
    # start
    rebin_mode: str = "local"

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def _check_supported(cfg, p: Particles, grid):
    check_background(cfg, grid)

    if p.dim not in (2, 3):
        raise ValueError(f"u-pw steps run in 2D and 3D, not {p.dim}D")
    check_rebin_mode(cfg, ("local", "none"))
    if cfg.halo is not None and cfg.transfer == "fused" and cfg.rebin_mode != "none":
        raise ValueError("halo-sharded fused steps re-bin by the driver's "
                         "domain.migrate_local after the step: use rebin_mode='none'")
    if cfg.halo is not None and cfg.transfer == "scatter":
        raise ValueError("a halo strip runs on the windowed or fused engine")
    if cfg.transfer == "binned":
        raise binned_refused()
    if cfg.transfer not in ("windowed", "fused", "scatter"):
        raise ValueError(f"unknown transfer {cfg.transfer}")
    check_shapefun(cfg)
    if cfg.transfer != "scatter" and cfg.active_box is None:
        raise ValueError(f"{cfg.transfer} transfer requires cfg.active_box")


def _bin_windowed(p, grid, cfg):
    """The windowed engine bins to slots at step start; the scatter engine
    takes the particles in their order."""
    if cfg.transfer == "windowed" and not cfg.prebinned:
        p, lost, _, _ = _bin_to_slots(p, grid, cfg.active_box, None, None)
        return p, lost
    return p, torch.zeros((), dtype=torch.int32, device=p.x.device)


def init_mixture_state(p: Particles, mats: MaterialTable, mix: MixtureTable) -> Particles:
    """The two-phase particle fields from the mixture table: intrinsic
    densities, volume fractions, mixture density and mass."""
    mid = p.mat_id.long()
    rho_s0 = mats.rho0[mix.soil_id.long()[mid]]
    rho_f0 = mats.rho0[mix.water_id.long()[mid]]
    phi_s = mix.phi_s0[mid]
    phi_f = mix.phi_f0[mid]
    rho_mix = rho_s0 * phi_s + rho_f0 * phi_f
    return p.replace(rho_s=rho_s0, rho_f=rho_f0, phi_s=phi_s, phi_f=phi_f, rho=rho_mix,
                     mass=rho_mix * p.vol0)


def _mixture_fields(p, mats, mix):
    """Per-particle K_f, ρ_f0, φ_s0, φ_f0, k and the soil's material row."""
    mid = p.mat_id.long()
    water = mix.water_id.long()[mid]
    return (mats.compressibility[water], mats.rho0[water], mix.phi_s0[mid], mix.phi_f0[mid],
            mix.permeability[mid], mix.soil_id.long()[mid])


def _stress(mats, cfg, p, soil, F_n1, DF, dFdt_n1):
    # the identity on emptied slots (F = 0; hazard B, ROADMAP.md queue 3)
    eye = torch.eye(F_n1.shape[-1], dtype=F_n1.dtype, device=F_n1.device)
    return con.stress_integration(
        F_n1=torch.where(p.active[:, None, None], F_n1, eye), DF=DF, dFdt_n1=dFdt_n1,
        bemi=p.bemi, bemi_zz=p.bemi_zz, eps=p.eps, kappa=p.kappa, back_stress=p.back_stress,
        mat_id=soil, mats=mats, kinds=cfg.kinds)


def _advance(p, act, cs, kin_n1, mix_n1, dis_inc, v_new, a_new, pw_new, dpw_dt_new, lam):
    """The particle update both steps share; ``kin_n1`` = (F, Ḟ, J, dJ/dt),
    ``mix_n1`` = (ρ_f, φ_s, φ_f, ρ_mix) at n+1."""
    F_n1, dFdt_n1, J_n1, dJdt_n1 = kin_n1
    rho_f_n1, phi_s_n1, phi_f_n1, rho_mix = mix_n1
    sel = act[:, None]
    return p.replace(
        x=torch.where(sel, p.x + dis_inc, p.x),
        dis=torch.where(sel, p.dis + dis_inc, p.dis),
        v=torch.where(sel, v_new, p.v),
        a=torch.where(sel, a_new, p.a),
        F=F_n1,
        dFdt=dFdt_n1,
        J=J_n1,
        dJdt=dJdt_n1,
        bemi=cs.bemi,
        bemi_zz=cs.bemi_zz,
        stress=cs.tau,
        stress_zz=cs.tau_zz,
        eps=cs.eps,
        kappa=cs.kappa,
        back_stress=cs.back_stress,
        W=cs.W,
        pw=torch.where(act, pw_new, p.pw),
        dpw_dt=torch.where(act, dpw_dt_new, p.dpw_dt),
        rho_f=torch.where(act, rho_f_n1, p.rho_f),
        phi_s=torch.where(act, phi_s_n1, p.phi_s),
        phi_f=torch.where(act, phi_f_n1, p.phi_f),
        rho=torch.where(act, rho_mix, p.rho),
        lme_lambda=lam,
    )


def _fluid_state(p, pw_cauchy, J_n1, K_f, rho_f0, phi_s0, phi_f0):
    """ρ_f, φ_s, φ_f and the mixture density at the Cauchy pore pressure."""
    rho_f_n1 = rho_f0 * torch.exp((pw_cauchy - p.pw0) / torch.clamp(K_f, min=1e-30))
    phi_s_n1 = phi_s0 / J_n1
    phi_f_n1 = 1.0 - (1.0 - phi_f0) / J_n1
    return rho_f_n1, phi_s_n1, phi_f_n1, p.rho_s * phi_s_n1 + rho_f_n1 * phi_f_n1


def upw_step(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    mix: MixtureTable,
    cfg: UpwConfig,
    body_accel: Tensor,  # (d,)
    pw_dirichlet_mask: Optional[Tensor] = None,  # (n_nodes,) bool
    pw_dirichlet_value: Optional[Tensor] = None,  # (n_nodes,)
):
    """One explicit two-phase step.  Returns (particles, dict(nnz, lost)).

    ``grid.dirichlet_mask`` constrains the solid velocity dofs;
    ``pw_dirichlet_*`` the nodal pore pressure."""
    _check_supported(cfg, p, grid)
    if cfg.transfer == "fused":
        return _upw_step_fused(p, grid, mats, mix, cfg, body_accel, pw_dirichlet_mask,
                               pw_dirichlet_value)
    dt, gamma, d = cfg.dt, cfg.gamma, p.dim
    p, lost = _bin_windowed(p, grid, cfg)
    act = p.active
    K_f, rho_f0, phi_s0, phi_f0, k_perm, soil = _mixture_fields(p, mats, mix)
    g = cfg.gravity_g

    sf, offsets = shapefun_eval(cfg, grid, p)
    N, dN, mask = sf["N"], sf["dN"], sf["mask"] & act[:, None]
    lost = lost + found_lost(sf, act)
    eng = make_engine(cfg, grid, sf, offsets, mask)

    # --- lumped mixture mass + fluid compressibility ---
    m_nodes = eng.p2g(N * p.mass[:, None])
    m_safe = torch.clamp(m_nodes, min=cfg.mass_tol)
    comp_density = (p.J * p.phi_f * p.rho_f / torch.clamp(K_f, min=1e-30)) * p.vol0
    C_nodes = eng.p2g(N * comp_density[:, None])
    C_safe = torch.clamp(C_nodes, min=cfg.mass_tol)

    # --- predictor ---
    pw_pred = p.pw + (1.0 - gamma) * dt * p.dpw_dt
    d_dis_p = dt * p.v + 0.5 * dt * dt * p.a
    v_pred = p.v + (1.0 - gamma) * dt * p.a

    # --- P2G: Δu, v, θ ---
    mN = N * p.mass[:, None]
    d_dis_nodes = eng.p2g(mN[..., None] * d_dis_p[:, None, :]) / m_safe[:, None]
    v_nodes = eng.p2g(mN[..., None] * v_pred[:, None, :]) / m_safe[:, None]
    pw_nodes = eng.p2g(N * comp_density[:, None] * pw_pred[:, None]) / C_safe

    if grid.dirichlet_mask is not None:
        v_nodes = torch.where(grid.dirichlet_mask, grid.dirichlet_value, v_nodes)
        d_dis_nodes = torch.where(grid.dirichlet_mask, grid.dirichlet_value * dt, d_dis_nodes)
    if pw_dirichlet_mask is not None:
        pw_nodes = torch.where(pw_dirichlet_mask, pw_dirichlet_value, pw_nodes)

    # --- local state ---
    DF = kin.incremental_deformation_gradient(eng.edge_gather(d_dis_nodes), dN)
    F_n1 = tn.bmm(DF, p.F)
    J_n1 = torch.clamp(tn.det(F_n1), min=1e-8)
    v_edges = eng.edge_gather(v_nodes)
    grad_v = kin.disp_gradient(v_edges, dN)  # Σ v_A ⊗ ∇N_A at config n
    dFdt_n1 = kin.rate_deformation_gradient_n1(grad_v, p.F, DF, p.dFdt)
    # dJ/dt = J·tr(L) with L the spatial velocity gradient at n+1
    dN1_v = torch.einsum("pij,pkj->pki", tn.inv_transpose(DF), dN)
    dJdt_n1 = J_n1 * tn.trace(kin.disp_gradient(v_edges, dN1_v))

    pw_cauchy = torch.where(act, eng.g2p(N, pw_nodes) / J_n1, p.pw)
    theta_p = pw_cauchy * J_n1  # particles carry the Kirchhoff pressure θ = J·p
    fluid = _fluid_state(p, pw_cauchy, J_n1, K_f, rho_f0, phi_s0, phi_f0)
    rho_f_n1 = fluid[0]
    cs = _stress(mats, cfg, p, soil, F_n1, DF, dFdt_n1)

    # --- mixture equilibrium: τ_tot = τ' − θ·I ---
    eye = torch.eye(d, dtype=p.x.dtype, device=p.x.device)
    tau_tot = cs.tau - theta_p[:, None, None] * eye
    dN1 = kin.push_forward_dN(dN, DF)
    fi = -torch.einsum("pij,pkj->pki", tau_tot * p.vol0[:, None, None], dN1)
    accel_nodes = body_accel[None, :] + eng.p2g(fi) / m_safe[:, None]
    if grid.dirichlet_mask is not None:
        accel_nodes = torch.where(grid.dirichlet_mask, torch.zeros_like(accel_nodes), accel_nodes)
    a_p = eng.g2p(N, accel_nodes)

    # --- mass balance: jacobian rate, Darcy, fluid inertia ---
    src = -eng.p2g(N * (rho_f_n1 * dJdt_n1 * p.vol0)[:, None])
    pw_edges = eng.edge_gather(pw_nodes[:, None])[..., 0]  # (Np, K)
    grad_pw = torch.einsum("pk,pki->pi", pw_edges, dN)  # spatial gradient at n
    Finv = tn.inv(F_n1)
    Fk_gradpw = k_perm[:, None] * torch.einsum("pij,pj->pi", Finv, grad_pw)
    GRAD = torch.einsum("pji,pkj->pki", p.F, dN)  # reference gradient F_nᵀ∇N
    src = src + (1.0 / g) * eng.p2g(
        torch.einsum("pki,pi->pk", GRAD, Fk_gradpw) * p.vol0[:, None])
    dyn = a_p - body_accel[None, :]
    Fk_dyn = k_perm[:, None] * torch.einsum("pij,pj->pi", Finv, dyn)
    src = src + eng.p2g(
        torch.einsum("pki,pi->pk", GRAD, Fk_dyn) * ((J_n1 * rho_f_n1 / g) * p.vol0)[:, None])

    dpw_dt_nodes = src / C_safe
    if pw_dirichlet_mask is not None:
        dpw_dt_nodes = torch.where(pw_dirichlet_mask, torch.zeros_like(dpw_dt_nodes), dpw_dt_nodes)
    dpw_dt_p = eng.g2p(N, dpw_dt_nodes)

    # --- corrector ---
    d_dis_smooth = eng.g2p(N, d_dis_nodes)
    p_out = _advance(
        p, act, cs, (F_n1, dFdt_n1, J_n1, dJdt_n1), fluid, d_dis_smooth,
        v_pred + gamma * dt * a_p, a_p, pw_pred + gamma * dt * dpw_dt_p, dpw_dt_p,
        p.lme_lambda if sf["lam"] is None else sf["lam"])
    nnz, lost = global_sums(cfg, count_nnz(mask), lost)
    return p_out, dict(nnz=nnz, lost=lost)


def _slot_geometry(p, box):
    C, nc = box.capacity, box.n_cells
    return (ft.to_channel_leading(p.x, C, nc), ft.to_channel_leading(p.lme_lambda, C, nc),
            ft.to_channel_leading(p.active.to(p.x.dtype), C, nc))


def _pack_scalar(col: Tensor, d: int) -> Tensor:
    """A scalar node field in column 0 of a d-vector field (the gradient
    kernel's input; its gradient is row 0 of the result)."""
    return torch.cat([col[:, None], torch.zeros((col.shape[0], d - 1), dtype=col.dtype,
                                                device=col.device)], dim=1)


def _upw_step_fused(p, grid, mats, mix, cfg, body_accel, pw_dirichlet_mask=None,
                    pw_dirichlet_value=None):
    """Fused-kernel explicit two-phase step (LME): the windowed step's
    physics through 3 scatters and 5 gathers; no (Ns, K, ·) edge tensor."""
    box, params = cfg.active_box, cfg.lme_params
    dt, gamma, d = cfg.dt, cfg.gamma, p.dim
    C, nc = box.capacity, box.n_cells
    act = p.active
    K_f, rho_f0, phi_s0, phi_f0, k_perm, soil = _mixture_fields(p, mats, mix)
    g = cfg.gravity_g
    x_t, lam_t, act_t = _slot_geometry(p, box)

    def tcl(a):
        return ft.to_channel_leading(a, C, nc)

    # --- scatter #1 (solves λ): mass, compressibility, Δu/v momenta, θ ---
    comp_density = (p.J * p.phi_f * p.rho_f / torch.clamp(K_f, min=1e-30)) * p.vol0
    pw_pred = p.pw + (1.0 - gamma) * dt * p.dpw_dt
    d_dis_p = dt * p.v + 0.5 * dt * dt * p.a
    v_pred = p.v + (1.0 - gamma) * dt * p.a
    chans = [p.mass[:, None], comp_density[:, None], p.mass[:, None] * d_dis_p,
             p.mass[:, None] * v_pred, (comp_density * pw_pred)[:, None]]
    nodes1, lam_new, nnz = ft.fused_scatter(grid, box, params, x_t, lam_t, act_t,
                                            tcl(torch.cat(chans, dim=1)), solve=True)
    # halo strip: owned-complete scatters, ghost-filled gathers
    xadd, fill = halo_ops(cfg)
    nodes1 = xadd(nodes1)
    m_safe = torch.clamp(nodes1[:, 0], min=cfg.mass_tol)
    C_safe = torch.clamp(nodes1[:, 1], min=cfg.mass_tol)
    d_dis_nodes = nodes1[:, 2:2 + d] / m_safe[:, None]
    v_nodes = nodes1[:, 2 + d:2 + 2 * d] / m_safe[:, None]
    pw_nodes = nodes1[:, 2 + 2 * d] / C_safe

    if grid.dirichlet_mask is not None:
        v_nodes = torch.where(grid.dirichlet_mask, grid.dirichlet_value, v_nodes)
        d_dis_nodes = torch.where(grid.dirichlet_mask, grid.dirichlet_value * dt, d_dis_nodes)
    if pw_dirichlet_mask is not None:
        pw_nodes = torch.where(pw_dirichlet_mask, pw_dirichlet_value, pw_nodes)

    def gather(gN=None, g_grad=None):
        return ft.fused_gather(
            grid, box, params, x_t, lam_new, act_t,
            gN=None if gN is None else fill(gN).contiguous(),
            g_grad=None if g_grad is None else fill(g_grad).contiguous())

    # --- gather A: smoothed Δu and θ at the particles, ∇Δu ---
    gA, grad_du = gather(gN=torch.cat([d_dis_nodes, pw_nodes[:, None]], dim=1),
                         g_grad=d_dis_nodes)
    d_dis_smooth, pw_gathered = gA[:, :d], gA[:, d]
    # --- gather B: ∇v (for dF/dt); gather C: ∇θ (θ in row 0) ---
    _, grad_v = gather(g_grad=v_nodes)
    _, grad_pw_full = gather(g_grad=_pack_scalar(pw_nodes, d))
    grad_pw = grad_pw_full[:, 0, :]

    eye = torch.eye(d, dtype=p.x.dtype, device=p.x.device)
    DF = grad_du + eye
    F_n1 = tn.bmm(DF, p.F)
    J_n1 = torch.clamp(tn.det(F_n1), min=1e-8)
    dFdt_n1 = kin.rate_deformation_gradient_n1(grad_v, p.F, DF, p.dFdt)
    dJdt_n1 = J_n1 * tn.trace(tn.bmm(grad_v, tn.inv(DF)))

    pw_cauchy = torch.where(act, pw_gathered / J_n1, p.pw)
    theta_p = pw_cauchy * J_n1
    fluid = _fluid_state(p, pw_cauchy, J_n1, K_f, rho_f0, phi_s0, phi_f0)
    rho_f_n1 = fluid[0]
    cs = _stress(mats, cfg, p, soil, F_n1, DF, dFdt_n1)

    # --- scatter #2: mixture internal forces (G·∇N) + jacobian-rate channel.
    # Idle slots hold F = 0 (local_rebin zeroes them) and the kernels mask
    # by multiplying (0·NaN = NaN): every slot input made through an
    # inverse is zeroed on idle slots with ``where``. ---
    zero = torch.zeros((), dtype=p.x.dtype, device=p.x.device)
    sel3 = act[:, None, None]
    tau_tot = cs.tau - theta_p[:, None, None] * eye
    G_f = torch.where(sel3, -tn.bmm(tau_tot * p.vol0[:, None, None], tn.inv_transpose(DF)), zero)
    rate = torch.where(act, -(rho_f_n1 * dJdt_n1 * p.vol0), zero)
    nodes2, _, _ = ft.fused_scatter(grid, box, params, x_t, lam_new, act_t, tcl(rate),
                                    G_t=tcl(G_f.reshape(-1, d * d)), solve=False)
    nodes2 = xadd(nodes2)
    src = nodes2[:, 0]
    accel_nodes = body_accel[None, :] + nodes2[:, 1:1 + d] / m_safe[:, None]
    if grid.dirichlet_mask is not None:
        accel_nodes = torch.where(grid.dirichlet_mask, zero, accel_nodes)

    # --- gather D: accelerations ---
    a_p, _ = gather(gN=accel_nodes)

    # --- scatter #3: Darcy + fluid inertia as one G row, GRAD_A·w =
    # ∇N_A·(F_n·w) with w = k·F⁻¹·(∇θ/g + (Jρ_f/g)(a − b)) ---
    Finv = tn.inv(torch.where(sel3, F_n1, eye))
    dyn = a_p - body_accel[None, :]
    w_vec = k_perm[:, None] * (tn.bmv(Finv, grad_pw) / g
                               + tn.bmv(Finv, dyn) * (J_n1 * rho_f_n1 / g)[:, None])
    u_vec = torch.where(act[:, None], tn.bmv(p.F, w_vec) * p.vol0[:, None], zero)
    G_src = torch.cat([u_vec[:, None, :], torch.zeros((p.count, d - 1, d), dtype=u_vec.dtype,
                                                      device=u_vec.device)], dim=1)
    nodes3, _, _ = ft.fused_scatter(grid, box, params, x_t, lam_new, act_t,
                                    tcl(torch.zeros_like(p.mass)),
                                    G_t=tcl(G_src.reshape(-1, d * d)), solve=False)
    src = src + xadd(nodes3)[:, 1]

    dpw_dt_nodes = src / C_safe
    if pw_dirichlet_mask is not None:
        dpw_dt_nodes = torch.where(pw_dirichlet_mask, zero, dpw_dt_nodes)

    # --- gather E: θ̇ ---
    gE, _ = gather(gN=dpw_dt_nodes[:, None])
    dpw_dt_p = gE[:, 0]

    p_out = _advance(
        p, act, cs, (F_n1, dFdt_n1, J_n1, dJdt_n1), fluid, d_dis_smooth,
        v_pred + gamma * dt * a_p, a_p, pw_pred + gamma * dt * dpw_dt_p, dpw_dt_p,
        ft.from_channel_leading(lam_new))
    lost = torch.zeros((), dtype=torch.int32, device=p.x.device)
    if cfg.rebin_mode == "local":
        p_out, lost = windowed.local_rebin(p_out, grid, box)
    nnz, lost = global_sums(cfg, nnz, lost)
    return p_out, dict(nnz=nnz, lost=lost)


def _theta_ref(mats, mix):
    """Characteristic stress: the P-wave modulus λ + 2G averaged over the
    whole mixture table."""
    soil = mix.soil_id.long()
    lam_m, G_m = lame_parameters(mats.E[soil], mats.nu[soil])
    return torch.mean(lam_m + 2.0 * G_m)


def _dirichlet_dofs(grid, has_mass, theta_n_nodes, pw_dirichlet_mask, pw_dirichlet_value, like):
    """Free dofs and prescribed increments of dU and dθ; ``pw_dirichlet_value``
    prescribes the TOTAL nodal θ, the unknown is the increment θ̄ − θₙ."""
    d = like.shape[1]
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    if grid.dirichlet_mask is not None:
        free_u = has_mass & ~grid.dirichlet_mask
        dU_dirichlet = torch.where(grid.dirichlet_mask, grid.dirichlet_value, zero)
    else:
        free_u = has_mass
        dU_dirichlet = torch.zeros((grid.n_nodes, d), dtype=like.dtype, device=like.device)
    if pw_dirichlet_mask is not None:
        free_t = has_mass[:, 0] & ~pw_dirichlet_mask
        dth_dirichlet = torch.where(pw_dirichlet_mask, pw_dirichlet_value - theta_n_nodes, zero)
    else:
        free_t = has_mass[:, 0]
        dth_dirichlet = torch.zeros((grid.n_nodes,), dtype=like.dtype, device=like.device)
    return free_u, dU_dirichlet, free_t, dth_dirichlet


def _scaled_newton(residual_rows, free_u, free_t, diag_u, diag_t, h_ref, theta_ref, n_nodes, d,
                   like, cfg):
    """Newton-GMRES on the nondimensionalised residual: each row block over
    its Jacobi diagonal times a characteristic unknown (h for dU, the P-wave
    modulus for dθ), and the matching column scaling as ``M_inv``.  The
    root is unchanged."""
    zero = torch.zeros((), dtype=like.dtype, device=like.device)

    def residual(z):
        R_u, R_t = residual_rows(z)
        R_u = torch.where(free_u, R_u / (diag_u * h_ref), zero)
        R_t = torch.where(free_t, R_t / (diag_t * theta_ref), zero)
        return torch.cat([R_u, R_t[:, None]], dim=-1)

    def M_inv(r):
        return torch.cat([r[:, :d] * h_ref, (r[:, d] * theta_ref)[:, None]], dim=-1)

    return solvers.newton_krylov(
        residual, torch.zeros((n_nodes, d + 1), dtype=like.dtype, device=like.device),
        M_inv=M_inv, tol=cfg.newton_tol, maxiter=cfg.newton_maxiter, cg_tol=cfg.krylov_tol,
        cg_maxiter=cfg.krylov_maxiter, linear="gmres", threshold_mode="rel",
        axis_name=None if getattr(cfg, "halo", None) is None else cfg.halo.comm)


def _scales(diag_K, m_nodes, C_nodes, darcy_diag, free_u, free_t, nm, cfg):
    one = torch.ones((), dtype=diag_K.dtype, device=diag_K.device)
    diag_u = diag_K[:, None] + nm.alpha_1 * m_nodes[:, None]
    diag_u = torch.where(free_u, torch.clamp(diag_u, min=1e-30), one)
    # θ rows: storage/(γΔt) + the Darcy stencil
    diag_t = C_nodes / (cfg.gamma * cfg.dt) + darcy_diag
    diag_t = torch.where(free_t, torch.clamp(diag_t, min=1e-30), one)
    return diag_u, diag_t


def _implicit_diag(res, nnz, lost, cfg):
    nnz, lost = global_sums(cfg, nnz, lost)
    return dict(nnz=nnz, lost=lost, newton_iters=res.iters, newton_residual=res.residual_norm,
                cg_iters=res.linear_iters, converged=res.converged)


def upw_newmark_step(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    mix: MixtureTable,
    cfg: UpwImplicitConfig,
    body_accel: Tensor,  # (d,)
    pw_dirichlet_mask: Optional[Tensor] = None,  # (n_nodes,) bool
    pw_dirichlet_value: Optional[Tensor] = None,  # (n_nodes,) total nodal θ
):
    """One monolithic implicit Newmark-β step of the u-pw mixture.  Returns
    (particles, diagnostics): ``nnz``, ``lost``, ``newton_iters`` and
    ``cg_iters`` (ints; the latter counts GMRES iterations),
    ``newton_residual``, ``converged``.

    Residual rows (z = (dU, dθ)): u rows Σ_p V0·(τ' − θ_{n+1}·I)·∇N¹ +
    m·(α₁dU − α₂u̇ₙ − α₃üₙ − b); θ rows Σ_p N·[(φ_f·ρ_f/K_f)·θ̇_{n+1} +
    ρ_f·dJ/dt]·V0 − (1/g)·Σ_p GRAD_A·[F⁻¹kF⁻ᵀ·GRADθ_{n+1} +
    J·ρ_f·F⁻¹k·(a_{n+1} − b)]·V0, with θ̇_{n+1} = (dθ − (1−γ)Δt·θ̇ₙ)/(γΔt)."""
    _check_supported(cfg, p, grid)
    if cfg.transfer == "fused":
        return _upw_newmark_step_fused(p, grid, mats, mix, cfg, body_accel, pw_dirichlet_mask,
                                       pw_dirichlet_value)
    d = p.dim
    n_nodes = grid.n_nodes
    dt, gamma = cfg.dt, cfg.gamma
    nm = newmark_parameters(cfg.beta, cfg.gamma, dt)
    g = cfg.gravity_g
    p, lost = _bin_windowed(p, grid, cfg)
    act = p.active
    K_f, rho_f0, phi_s0, phi_f0, k_perm, soil = _mixture_fields(p, mats, mix)

    sf, offsets = shapefun_eval(cfg, grid, p)
    N, dN, mask = sf["N"], sf["dN"], sf["mask"] & act[:, None]
    lost = lost + found_lost(sf, act)
    eng = make_engine(cfg, grid, sf, offsets, mask)

    m_nodes = eng.p2g(N * p.mass[:, None])
    m_safe = torch.clamp(m_nodes, min=cfg.mass_tol)
    has_mass = (m_nodes > cfg.mass_tol)[:, None]
    comp_density = (p.phi_f * p.rho_f / torch.clamp(K_f, min=1e-30)) * p.vol0
    C_nodes = eng.p2g(N * comp_density[:, None])

    def project(field_p):
        mom = (N * p.mass[:, None])[..., None] * field_p[:, None, :]
        return eng.p2g(mom) / m_safe[:, None]

    Un_dt = project(p.v)
    Un_dt2 = project(p.a)
    # nodal θ at n (compressibility-weighted recovery, as the explicit step)
    C_safe = torch.clamp(C_nodes, min=cfg.mass_tol)
    theta_n_nodes = eng.p2g(N * comp_density[:, None] * p.pw[:, None]) / C_safe

    free_u, dU_dirichlet, free_t, dth_dirichlet = _dirichlet_dofs(
        grid, has_mass, theta_n_nodes, pw_dirichlet_mask, pw_dirichlet_value, p.x)

    vel_const_nodes = (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    grad_vel_const = kin.disp_gradient(eng.edge_gather(vel_const_nodes), dN)
    eye = torch.eye(d, dtype=p.x.dtype, device=p.x.device)

    lam_p, G_p = lame_parameters(mats.E[soil], mats.nu[soil])
    stiff_scale = (lam_p + 2.0 * G_p) * p.vol0
    diag_K = eng.p2g(stiff_scale[:, None] * torch.sum(dN * dN, dim=-1))
    darcy_diag = eng.p2g((k_perm * p.vol0 / abs(g))[:, None] * torch.sum(dN * dN, dim=-1))
    diag_u, diag_t = _scales(diag_K, m_nodes, C_nodes, darcy_diag, free_u, free_t, nm, cfg)
    h_ref = torch.tensor(grid.spacing, dtype=p.x.dtype, device=p.x.device)
    theta_ref = _theta_ref(mats, mix)

    def local_state(dU, dth):
        grad_du = kin.disp_gradient(eng.edge_gather(dU), dN)
        DF = grad_du + eye
        F_n1 = tn.bmm(DF, p.F)
        J_n1 = torch.clamp(tn.det(F_n1), min=1e-8)
        dFdt_n1 = kin.rate_deformation_gradient_n1(nm.alpha_4 * grad_du + grad_vel_const, p.F,
                                                    DF, p.dFdt)
        dJdt_n1 = J_n1 * tn.trace(tn.bmm(dFdt_n1, tn.inv(F_n1)))  # J·tr(Ḟ F⁻¹)
        theta_n1_p = eng.g2p(N, theta_n_nodes + dth)
        dth_dt_p = (eng.g2p(N, dth) - (1.0 - gamma) * dt * p.dpw_dt) / (gamma * dt)
        cs = _stress(mats, cfg, p, soil, F_n1, DF, dFdt_n1)
        return DF, F_n1, J_n1, dFdt_n1, dJdt_n1, theta_n1_p, dth_dt_p, cs

    def residual_rows(z):
        dU = torch.where(free_u, z[:, :d], dU_dirichlet)
        dth = torch.where(free_t, z[:, d], dth_dirichlet)
        DF, F_n1, J_n1, _, dJdt_n1, theta_n1_p, dth_dt_p, cs = local_state(dU, dth)
        # u rows: mixture equilibrium
        tau_tot = cs.tau - theta_n1_p[:, None, None] * eye
        dN1 = kin.push_forward_dN(dN, DF)
        fi = torch.einsum("pij,pkj->pki", tau_tot * p.vol0[:, None, None], dN1)
        a_n1_nodes = nm.alpha_1 * dU - nm.alpha_2 * Un_dt - nm.alpha_3 * Un_dt2
        R_u = eng.p2g(fi) + m_nodes[:, None] * (a_n1_nodes - body_accel[None, :])
        # θ rows: storage rate + jacobian rate
        rho_f_n1 = rho_f0 * torch.exp((theta_n1_p / J_n1 - p.pw0) / torch.clamp(K_f, min=1e-30))
        phi_f_n1 = 1.0 - (1.0 - phi_f0) / J_n1
        rate = ((phi_f_n1 * rho_f_n1 / torch.clamp(K_f, min=1e-30)) * dth_dt_p
                + rho_f_n1 * dJdt_n1)
        R_t = eng.p2g(N * (rate * p.vol0)[:, None])
        # Darcy + fluid-inertia flow, −(1/g)·GRAD_A·[...]·V0
        th_edges = eng.edge_gather((theta_n_nodes + dth)[:, None])[..., 0]
        grad_th = torch.einsum("pk,pki->pi", th_edges, dN)
        GRAD_th = torch.einsum("pji,pj->pi", p.F, grad_th)
        Finv = tn.inv(F_n1)
        FkFt = k_perm[:, None, None] * torch.einsum("pij,pkj->pik", Finv, Finv)
        flow_vec = torch.einsum("pij,pj->pi", FkFt, GRAD_th)
        dyn = eng.g2p(N, a_n1_nodes) - body_accel[None, :]
        Fk_dyn = k_perm[:, None] * torch.einsum("pij,pj->pi", Finv, dyn)
        flow_vec = flow_vec + (J_n1 * rho_f_n1)[:, None] * Fk_dyn
        GRAD = torch.einsum("pji,pkj->pki", p.F, dN)
        R_t = R_t - (1.0 / g) * eng.p2g(
            torch.einsum("pki,pi->pk", GRAD, flow_vec) * p.vol0[:, None])
        return R_u, R_t

    res = _scaled_newton(residual_rows, free_u, free_t, diag_u, diag_t, h_ref, theta_ref,
                         n_nodes, d, p.x, cfg)
    dU = torch.where(free_u, res.x[:, :d], dU_dirichlet)
    dth = torch.where(free_t, res.x[:, d], dth_dirichlet)
    dU_dt = nm.alpha_4 * dU + (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    dU_dt2 = nm.alpha_1 * dU - nm.alpha_2 * Un_dt - (nm.alpha_3 + 1.0) * Un_dt2

    DF, F_n1, J_n1, dFdt_n1, dJdt_n1, theta_n1_p, dth_dt_p, cs = local_state(dU, dth)
    fluid = _fluid_state(p, theta_n1_p / J_n1, J_n1, K_f, rho_f0, phi_s0, phi_f0)
    a_blend = cfg.alpha_blend
    dv = eng.g2p(N, dU_dt + (1.0 - a_blend) * Un_dt)
    p_out = _advance(
        p, act, cs, (F_n1, dFdt_n1, J_n1, dJdt_n1), fluid, eng.g2p(N, dU),
        a_blend * p.v + dv, p.a + eng.g2p(N, dU_dt2), theta_n1_p, dth_dt_p,
        p.lme_lambda if sf["lam"] is None else sf["lam"])
    return p_out, _implicit_diag(res, count_nnz(mask), lost, cfg)


def _upw_newmark_step_fused(p, grid, mats, mix, cfg, body_accel, pw_dirichlet_mask=None,
                            pw_dirichlet_value=None):
    """Fused-kernel implicit u-pw step (LME): the windowed step's physics
    with every transfer of the Newton-GMRES loop through the kernels'
    linear wrappers (launch formula in the module docstring); λ is solved
    once by the first scatter and frozen through the loop."""
    box, params = cfg.active_box, cfg.lme_params
    d = p.dim
    n_nodes = grid.n_nodes
    dt, gamma = cfg.dt, cfg.gamma
    nm = newmark_parameters(cfg.beta, cfg.gamma, dt)
    g = cfg.gravity_g
    C, nc = box.capacity, box.n_cells
    act = p.active
    sel3 = act[:, None, None]
    eye = torch.eye(d, dtype=p.x.dtype, device=p.x.device)
    zero = torch.zeros((), dtype=p.x.dtype, device=p.x.device)
    K_f, rho_f0, phi_s0, phi_f0, k_perm, soil = _mixture_fields(p, mats, mix)
    x_t, lam_t, act_t = _slot_geometry(p, box)

    def tcl(a):
        return ft.to_channel_leading(a, C, nc)

    # --- scatter #1 (solves λ): mass, storativity, θ momentum, v and a
    # momenta, and the stiffness scale, the LAST channel, which gnorm
    # weighs: Σ s·|∇N|² ---
    lam_p, G_p = lame_parameters(mats.E[soil], mats.nu[soil])
    stiff_scale = (lam_p + 2.0 * G_p) * p.vol0
    comp_density = (p.phi_f * p.rho_f / torch.clamp(K_f, min=1e-30)) * p.vol0
    chans = [p.mass[:, None], comp_density[:, None], (comp_density * p.pw)[:, None],
             p.mass[:, None] * p.v, p.mass[:, None] * p.a, stiff_scale[:, None]]
    nodes1, lam_f, nnz = ft.fused_scatter(grid, box, params, x_t, lam_t, act_t,
                                          tcl(torch.cat(chans, dim=1)), solve=True, gnorm=True)
    # halo strip: owned-complete scatters, ghost-filled gathers (the
    # tangents of the J·v too)
    xadd, fill = halo_ops(cfg)
    nodes1 = xadd(nodes1)
    m_nodes = nodes1[:, 0]
    m_safe = torch.clamp(m_nodes, min=cfg.mass_tol)
    has_mass = (m_nodes > cfg.mass_tol)[:, None]
    C_nodes = nodes1[:, 1]
    theta_n_nodes = nodes1[:, 2] / torch.clamp(C_nodes, min=cfg.mass_tol)
    Un_dt = nodes1[:, 3:3 + d] / m_safe[:, None]
    Un_dt2 = nodes1[:, 3 + d:3 + 2 * d] / m_safe[:, None]
    diag_K = nodes1[:, -1]

    # --- scatter #2: the Darcy stencil diagonal (θ-row scaling), column 1
    # of a solve=False gnorm scatter of one channel ---
    darcy_w = torch.where(act, k_perm * p.vol0 / abs(g), zero)
    nodes2, _, _ = ft.fused_scatter(grid, box, params, x_t, lam_f, act_t, tcl(darcy_w),
                                    solve=False, gnorm=True)
    darcy_diag = xadd(nodes2)[:, 1]

    free_u, dU_dirichlet, free_t, dth_dirichlet = _dirichlet_dofs(
        grid, has_mass, theta_n_nodes, pw_dirichlet_mask, pw_dirichlet_value, p.x)
    diag_u, diag_t = _scales(diag_K, m_nodes, C_nodes, darcy_diag, free_u, free_t, nm, cfg)
    h_ref = torch.tensor(grid.spacing, dtype=p.x.dtype, device=p.x.device)
    theta_ref = _theta_ref(mats, mix)

    # --- fixed fields: N-samples of (α₂u̇ₙ + α₃üₙ, θₙ) with ∇(velocity
    # constant), and ∇θₙ ---
    vel_const_nodes = (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    gc0, grad_vel_const = ft.fused_gather(
        grid, box, params, x_t, lam_f, act_t,
        gN=fill(torch.cat([nm.alpha_2 * Un_dt + nm.alpha_3 * Un_dt2, theta_n_nodes[:, None]],
                          dim=1)).contiguous(),
        g_grad=fill(vel_const_nodes).contiguous())
    const_a_p, th_n_p = gc0[:, :d], gc0[:, d]
    _, grad_th_const = ft.fused_gather(grid, box, params, x_t, lam_f, act_t,
                                       g_grad=fill(_pack_scalar(theta_n_nodes, d)).contiguous())
    grad_th_const = grad_th_const[:, 0, :]

    # --- the linear transfers of a residual at the frozen λ ---
    geo = (grid, box, params, x_t, lam_f, act_t, 0)

    def g_all(zm):
        zm = fill(zm)
        outN, grad_du = ft.GatherNGrad.apply(zm, geo)
        grad_dth = ft.GatherGrad.apply(_pack_scalar(zm[:, d], d), geo)[:, 0, :]
        return outN, grad_du, grad_dth

    def s_all(rate_ch, G_mix, u_vec):
        n1 = ft.ScatterNG.apply(torch.cat([rate_ch[:, None], G_mix.reshape(-1, d * d)], dim=1),
                                geo)
        G_flow = torch.cat([u_vec[:, None, :], torch.zeros((u_vec.shape[0], d - 1, d),
                                                           dtype=u_vec.dtype,
                                                           device=u_vec.device)], dim=1)
        n2 = ft.ScatterG.apply(G_flow, geo)
        # one halo add for both scatters
        both = xadd(torch.cat([n1, n2], dim=1))
        n1, n2 = both[:, :n1.shape[1]], both[:, n1.shape[1]:]
        return n1[:, 0], n1[:, 1:1 + d], n2[:, 1]

    def local_state(zm):
        outN, grad_du, grad_dth = g_all(zm)
        g_dth = outN[:, d]
        DF = grad_du + eye
        F_n1 = tn.bmm(DF, p.F)
        J_n1 = torch.clamp(tn.det(F_n1), min=1e-8)
        dFdt_n1 = kin.rate_deformation_gradient_n1(nm.alpha_4 * grad_du + grad_vel_const, p.F,
                                                    DF, p.dFdt)
        Finv = tn.inv(torch.where(sel3, F_n1, eye))
        dJdt_n1 = J_n1 * tn.trace(tn.bmm(dFdt_n1, Finv))
        theta_n1_p = th_n_p + g_dth
        dth_dt_p = (g_dth - (1.0 - gamma) * dt * p.dpw_dt) / (gamma * dt)
        cs = _stress(mats, cfg, p, soil, F_n1, DF, dFdt_n1)
        return (DF, F_n1, J_n1, dFdt_n1, dJdt_n1, theta_n1_p, dth_dt_p, cs, outN[:, :d],
                grad_dth, Finv)

    def masked(z):
        dU = torch.where(free_u, z[:, :d], dU_dirichlet)
        dth = torch.where(free_t, z[:, d], dth_dirichlet)
        return dU, dth, torch.cat([dU, dth[:, None]], dim=1)

    def residual_rows(z):
        dU, dth, zm = masked(z)
        (DF, F_n1, J_n1, _, dJdt_n1, theta_n1_p, dth_dt_p, cs, g_dU, grad_dth,
         Finv) = local_state(zm)
        # u rows: mixture internal forces, G = V0·(τ' − θ·I)·ΔF⁻ᵀ
        tau_tot = cs.tau - theta_n1_p[:, None, None] * eye
        G_mix = tn.bmm(tau_tot * p.vol0[:, None, None], tn.inv_transpose(torch.where(sel3, DF, eye)))
        G_mix = torch.where(sel3, G_mix, zero)
        # θ rows: storage rate + jacobian rate
        rho_f_n1 = rho_f0 * torch.exp((theta_n1_p / J_n1 - p.pw0) / torch.clamp(K_f, min=1e-30))
        phi_f_n1 = 1.0 - (1.0 - phi_f0) / J_n1
        rate = ((phi_f_n1 * rho_f_n1 / torch.clamp(K_f, min=1e-30)) * dth_dt_p
                + rho_f_n1 * dJdt_n1)
        rate_ch = torch.where(act, rate * p.vol0, zero)
        # θ rows: Darcy + fluid-inertia flow as one ∇N contraction,
        # GRAD_A·w = ∇N_A·(F_n·w) with w = k·F⁻¹·(F⁻ᵀ·GRADθ + Jρ_f(a − b))
        GRAD_th = tn.bmv(p.F.transpose(-1, -2), grad_th_const + grad_dth)
        dyn = nm.alpha_1 * g_dU - const_a_p - body_accel[None, :]
        w_vec = k_perm[:, None] * (
            tn.bmv(Finv, tn.bmv(Finv.transpose(-1, -2), GRAD_th))
            + tn.bmv(Finv, dyn) * (J_n1 * rho_f_n1)[:, None])
        u_vec = torch.where(act[:, None], tn.bmv(p.F, w_vec) * p.vol0[:, None], zero)
        R_rate, R_u_int, flow_sum = s_all(rate_ch, G_mix, u_vec)
        R_u = R_u_int + m_nodes[:, None] * (nm.alpha_1 * dU - nm.alpha_2 * Un_dt
                                            - nm.alpha_3 * Un_dt2 - body_accel[None, :])
        return R_u, R_rate - (1.0 / g) * flow_sum

    res = _scaled_newton(residual_rows, free_u, free_t, diag_u, diag_t, h_ref, theta_ref,
                         n_nodes, d, p.x, cfg)
    dU, dth, zm = masked(res.x)
    dU_dt = nm.alpha_4 * dU + (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    dU_dt2 = nm.alpha_1 * dU - nm.alpha_2 * Un_dt - (nm.alpha_3 + 1.0) * Un_dt2

    DF, F_n1, J_n1, dFdt_n1, dJdt_n1, theta_n1_p, dth_dt_p, cs, _, _, _ = local_state(zm)
    fluid = _fluid_state(p, theta_n1_p / J_n1, J_n1, K_f, rho_f0, phi_s0, phi_f0)
    a_blend = cfg.alpha_blend
    gout, _ = ft.fused_gather(
        grid, box, params, x_t, lam_f, act_t,
        gN=fill(torch.cat([dU, dU_dt + (1.0 - a_blend) * Un_dt, dU_dt2], dim=1)).contiguous())
    p_out = _advance(
        p, act, cs, (F_n1, dFdt_n1, J_n1, dJdt_n1), fluid, gout[:, :d],
        a_blend * p.v + gout[:, d:2 * d], p.a + gout[:, 2 * d:3 * d], theta_n1_p, dth_dt_p,
        ft.from_channel_leading(lam_f))
    lost = torch.zeros((), dtype=torch.int32, device=p.x.device)
    if cfg.rebin_mode == "local":
        p_out, lost = windowed.local_rebin(p_out, grid, box)
    return p_out, _implicit_diag(res, nnz, lost, cfg)


def run(p, grid, mats, mix, cfg, n_steps, body_accel=None, pw_dirichlet_mask=None,
        pw_dirichlet_value=None):
    """Explicit time loop from any particle order (binned once by
    ``to_slot_layout``).  Returns (particles, dict(nnz, lost)), one entry a
    step stacked on the device at the end: the loop never waits on the
    host."""
    _check_supported(cfg, p, grid)
    if body_accel is None:
        body_accel = torch.zeros((p.dim,), dtype=p.x.dtype, device=p.x.device)
    if cfg.transfer != "scatter":
        p = to_slot_layout(p, grid, cfg.active_box)
    hist = {"nnz": [], "lost": []}
    for _ in range(n_steps):
        p, diag = upw_step(p, grid, mats, mix, cfg, body_accel, pw_dirichlet_mask,
                           pw_dirichlet_value)
        for key in hist:
            hist[key].append(diag[key])
    return p, {key: torch.stack(vals) for key, vals in hist.items()}
