"""Explicit Newmark predictor-corrector MPM step (single-phase -u).

Counterpart of ``nlpartsol_tpu/formulations/explicit.py``:

  per step:
    local search + shape functions              — one fused evaluation
    lumped mass P2G
    particle predictor  Δu_p = Δt·v + Δt²/2·a;  v += (1−γ)Δt·a
    P2G displacement increment (mass-weighted) + diagonal solve
    Dirichlet on nodal increments
    ΔF → F_{n+1} → J → stress
    internal + traction forces
    lumped equilibrium  a_A = b + f_A/m_A, reactions on fixed dofs
    G2P accel/displacement + corrector  v += γΔt·a, x += Δu

Transfers run through the slot-layout engines: 'windowed' (plain tensor
code, ops/windowed.py — the reference of the kernels) or 'fused' (the CUDA
kernels of ops/fused_transfer.py; the JAX package calls it 'pallas'), in 2D
and in 3D, or through 'scatter' (segment sums over the (Np, K) pattern in
particle order, ops/transfer.py::ScatterEngine: no slot layout, no
re-bin).  The 3D step is the JAX package's without its TPU kernel-layout
view cache (``make_views3``): the CUDA kernels read the slot arrays as they
are.
Plain functions: Particles × nodal inputs → Particles.  Diagnostics stay
device tensors; nothing in a step waits on the host.

The stress entering the internal forces is scaled by (1 − damage_{n+1})
on every engine, with or without a fracture driver.  The nonlocal fracture
drivers (``damage='eigenerosion'``/``'eigensoftening'``, models/fracture.py)
run on the slot layout of the windowed and fused engines, between the
constitutive update and the internal forces; the scatter engine refuses
them (``ValueError``, as in the JAX package).

Multi-device (parallel/domain.py): with ``halo`` (a ``HaloSpec`` of the
rank's strip) the windowed engine is the halo engine and the fused kernels
run on the strip with its valid plane bounds, each scatter completed by a
halo add and each gather fed by a ghost fill; ``rebin_mode='none'`` leaves
the re-bin to the sharded driver's migration; ``axis_name`` (a
``parallel.collectives.Comm``) sums the diagnostics over the group, and on
the windowed and scatter engines without a halo sums every P2G (particles
split over ranks, the grid replicated); the fracture drivers' Beps sums
take a particle halo across the seams.
On an unstructured ``FEMesh`` (shapefun/femesh.py) the step runs on the
scatter engine only; 'windowed' and 'fused' raise ``ValueError``.
``transfer='binned'`` is on the do-not-port list (ROADMAP.md queue 2) and
raises ``NotImplementedError``.  The schemes 'FE' and 'Generalized-alpha'
are formulations/integrators.py's steps.
Every material kind runs, on every engine (item 12a).  ``shapefun='fem'``,
``'gimp'`` and ``'alme'`` run on the windowed and scatter engines; the fused
kernels compute LME only and refuse them with ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import dispatch as con
from ..models import fracture
from ..models.materials import MaterialTable
from ..ops import fused_transfer as ft
from ..ops import tensor as tn
from ..ops import windowed
from ..ops.sparse import nnz as count_nnz
from ..shapefun import alme, lme
from ..types import Grid, Particles
from . import kinematics as kin
from .common import (binned_refused, check_background, check_rebin_mode, check_shapefun,
                     found_lost, global_sums, halo_ops, make_engine, shapefun_eval)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ExplicitConfig:
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
    # nonlocal fracture driver: None | 'eigenerosion' | 'eigensoftening'
    # (windowed or fused: the Beps sums run on the slot layout), and the
    # static cell reach of the largest Beps radius (fracture.beps_reach)
    damage: Optional[str] = None
    beps_reach: int = 1
    # F-bar volumetric-locking control (the cell is the patch)
    fbar: bool = False
    # multi-device: the group of the diagnostics' sums (and, without a
    # halo, of every P2G: particles split, grid replicated), a
    # parallel.collectives.Comm; and the rank's strip (parallel.domain
    # HaloSpec/HaloSpec2): grid and active_box are then local templates
    axis_name: Optional[object] = None
    halo: Optional[object] = None
    # particles already in slot layout (the sharded drivers re-bin by their
    # migration): the windowed engine skips its own binning
    prebinned: bool = False
    # fused transfer: re-bin particles to cells every k-th step only.  The
    # kernel window widens by a 1-cell drift margin, so correctness needs
    # max drift ≤ 1 cell between re-binnings: rebin_every ≤ 1/CFL.
    rebin_every: int = 1
    # fused rebin mode:
    #   'local'  — end-of-step neighbour compaction (windowed.local_rebin,
    #       sort-free); with rebin_every = k > 1 the compaction fires every
    #       k-th step and margin-1 kernels tolerate the ≤ 1 cell of drift
    #       (requires particle speed ≤ c/(k·CFL); violations are counted
    #       loudly in the 'lost' diagnostic)
    #   'global' — sort-based binning at step start (required with tractions)
    #   'none'   — no re-bin in the step: the sharded drivers restore the slot
    #       invariant by their migration (parallel/domain.py)
    rebin_mode: str = "local"
    # 'NPC-FS' for this step; 'FE' and 'Generalized-alpha' select
    # formulations/integrators.py in the driver (with ga_rb, the
    # Generalized-alpha spectral radius)
    scheme: str = "NPC-FS"
    ga_rb: float = 0.6

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def _check_supported(cfg: ExplicitConfig, p: Particles, grid):
    check_background(cfg, grid)

    if p.dim not in (2, 3):
        raise ValueError(f"explicit steps run in 2D and 3D, not {p.dim}D")
    check_rebin_mode(cfg)
    if cfg.halo is not None and cfg.transfer == "fused" and cfg.rebin_mode != "none":
        raise ValueError("halo-sharded fused steps re-bin by the driver's "
                         "domain.migrate_local after the step: use rebin_mode='none'")
    if cfg.halo is not None and cfg.transfer == "scatter":
        raise ValueError("a halo strip runs on the windowed or fused engine")
    if cfg.damage not in (None, "eigenerosion", "eigensoftening"):
        raise ValueError(f"unknown damage driver {cfg.damage}")
    if cfg.scheme != "NPC-FS":
        raise ValueError(
            f"scheme '{cfg.scheme}' is not this step's: use "
            "formulations.integrators.forward_euler_step / generalized_alpha_step "
            "(driver.run_simulation dispatches on the scheme)")
    check_shapefun(cfg)
    if cfg.transfer == "binned":
        raise binned_refused()
    if cfg.transfer not in ("windowed", "fused", "scatter"):
        raise ValueError(f"unknown transfer {cfg.transfer}")
    if cfg.transfer == "scatter":
        if cfg.damage is not None:
            raise ValueError("fracture drivers require windowed transfer")
        if cfg.fbar:
            raise ValueError("fbar requires windowed transfer")
    elif cfg.active_box is None:
        raise ValueError(f"{cfg.transfer} transfer requires cfg.active_box")
    if cfg.rebin_every < 1:
        raise ValueError("rebin_every must be >= 1")
    if cfg.damage is not None and cfg.rebin_every != 1:
        # the Beps cell-offset sweep assumes each particle sits in its slot
        # cell, which only a re-bin every step keeps
        raise ValueError("fracture drivers require rebin_every = 1")


def _bin_to_slots(p, grid, box, traction, traction_area):
    """Sort-based binning at step start; tractions follow their particles."""
    binning = windowed.bin_particles(grid, box, p.x, p.active)
    if traction is not None:
        idx = torch.clamp(binning.slot_particle, max=traction.shape[0] - 1).long()
        traction = torch.where(
            binning.valid[:, None], traction[idx], torch.zeros_like(traction[idx])
        )
        traction_area = torch.where(
            binning.valid, traction_area[idx], torch.zeros_like(traction_area[idx])
        )
    return windowed.permute_to_slots(p, binning), binning.lost, traction, traction_area


def _kinematics_and_stress(p, mats, cfg, box, DF, act):
    """ΔF → F_{n+1}, J, Ḟ, stress (shared by both engines)."""
    dt, d = cfg.dt, p.dim
    eye = torch.eye(d, dtype=DF.dtype, device=DF.device)
    zero = torch.zeros((), dtype=DF.dtype, device=DF.device)
    F_n1 = tn.bmm(DF, p.F)
    J_n1 = tn.det(F_n1)
    J_n1 = torch.where(J_n1 > 0.0, J_n1, zero)  # negative-J clamp
    if cfg.fbar:
        J_patch = kin.cell_patch_jacobian(box, p.J, J_n1, p.vol0, act)
        alpha_fb = mats.alpha_fbar[p.mat_id.long()]
        F_n1 = kin.fbar_deformation_gradient(F_n1, J_n1, J_patch * p.J, alpha_fb)
        J_n1 = tn.det(F_n1)
        J_n1 = torch.where(J_n1 > 0.0, J_n1, zero)
        # zeroed slots have F = 0: invert the identity there, never 0
        DF = tn.bmm(F_n1, tn.inv(torch.where((p.J > 0)[:, None, None], p.F, eye)))
    dt_DF = (DF - eye) / dt
    dFdt_n1 = kin.rate_deformation_gradient_n1(dt_DF, p.F, DF, p.dFdt)
    # emptied and padding slots hold F = 0: the models see the identity
    # there (the fluids invert F, Hencky and Mooney-Rivlin take its log), so
    # nothing they return is non-finite; active particles are untouched
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
    return DF, F_n1, J_n1, dFdt_n1, cs


def _damage(p, grid, mats, cfg, act, cs, J_n1, F_n1):
    """(damage, strain_f) at n+1 — the driver's update, or the state's own —
    and the stress that enters the internal forces, τ·(1 − damage_{n+1})."""
    damage_n1, strain_f_n1 = p.damage, p.strain_f
    if cfg.damage is not None:
        damage_n1, strain_f_n1 = fracture.damage_update(
            p, grid, cfg.active_box, cfg.damage, mats, act, cs, J_n1, F_n1, cfg.beps_reach,
            halo=cfg.halo)
    return damage_n1, strain_f_n1, cs.tau * (1.0 - damage_n1)[:, None, None]


def _advance(p, act, cs, F_n1, J_n1, dFdt_n1, x_new, v_new, a_p, d_dis, lam, damage,
             strain_f, lme_beta):
    sel = act[:, None]
    rho_new = p.mass / (p.vol0 * torch.clamp(J_n1, min=1e-12))
    return p.replace(
        x=torch.where(sel, x_new, p.x),
        v=torch.where(sel, v_new, p.v),
        a=torch.where(sel, a_p, p.a),
        dis=p.dis + torch.where(sel, d_dis, torch.zeros_like(d_dis)),
        rho=rho_new,
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
        damage=damage,
        strain_f=strain_f,
        lme_lambda=lam,
        lme_beta=lme_beta,
    )


def _energies(p, act, v_new, cs):
    zero = torch.zeros((), dtype=v_new.dtype, device=v_new.device)
    ke = 0.5 * torch.sum(torch.where(act[:, None], p.mass[:, None] * v_new * v_new, zero))
    se = torch.sum(torch.where(act, cs.W * p.vol0, zero))
    return ke, se


def explicit_step(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ExplicitConfig,
    body_accel: Tensor,  # (d,) gravity/body acceleration this step
    traction: Optional[Tensor] = None,  # (Np, d) nominal traction t̄
    traction_area: Optional[Tensor] = None,  # (Np,) reference area A0_p
    rebin: Optional[bool] = None,  # re-bin this step (fused, rebin_every > 1)
):
    """One explicit step.  Returns (particles_{n+1}, diagnostics)."""
    _check_supported(cfg, p, grid)
    if cfg.transfer == "fused":
        return _explicit_step_fused(
            p, grid, mats, cfg, body_accel, traction, traction_area, rebin
        )
    dt = cfg.dt
    gamma = cfg.gamma

    if cfg.transfer == "windowed" and not cfg.prebinned:
        p, lost, traction, traction_area = _bin_to_slots(
            p, grid, cfg.active_box, traction, traction_area
        )
    else:
        lost = torch.zeros((), dtype=torch.int32, device=p.x.device)

    act = p.active

    # --- shape functions (fused local search + N + ∇N) ---
    sf, offsets = shapefun_eval(cfg, grid, p)
    N, dN, mask = sf["N"], sf["dN"], sf["mask"] & act[:, None]
    lost = lost + found_lost(sf, act)
    eng = make_engine(cfg, grid, sf, offsets, mask)

    # --- lumped mass ---
    m_nodes = eng.p2g(N * p.mass[:, None])
    m_safe = torch.clamp(m_nodes, min=cfg.mass_tol)[:, None]

    # --- particle predictor ---
    d_dis_p = dt * p.v + 0.5 * dt * dt * p.a
    v_pred = p.v + (1.0 - gamma) * dt * p.a

    # --- P2G displacement increment, mass-weighted recovery ---
    mom = (N * p.mass[:, None])[..., None] * d_dis_p[:, None, :]  # (Np,K,d)
    d_dis_nodes = eng.p2g(mom) / m_safe

    # --- Dirichlet on nodal increments ---
    if grid.dirichlet_mask is not None:
        d_dis_nodes = torch.where(grid.dirichlet_mask, grid.dirichlet_value, d_dis_nodes)

    # --- local compatibility: ΔF, F_{n+1}, J, then the constitutive update ---
    du_edges = eng.edge_gather(d_dis_nodes)
    DF = kin.incremental_deformation_gradient(du_edges, dN)
    DF, F_n1, J_n1, dFdt_n1, cs = _kinematics_and_stress(
        p, mats, cfg, cfg.active_box, DF, act
    )
    # --- nonlocal damage: scales the stress entering the internal forces ---
    damage_n1, strain_f_n1, tau_eff = _damage(p, grid, mats, cfg, act, cs, J_n1, F_n1)

    # --- internal forces: f_A = −Σ_p V0 τ ∇N^{n+1}  ---
    dN1 = kin.push_forward_dN(dN, DF)
    f_int_contrib = -(dN1 @ (tau_eff * p.vol0[:, None, None]).transpose(-1, -2))
    forces = eng.p2g(f_int_contrib)

    # --- traction (Neumann) forces: f_A += Σ_p N A0 t̄ ---
    if traction is not None:
        tr = (N * traction_area[:, None])[..., None] * traction[:, None, :]
        forces = forces + eng.p2g(tr)

    # --- lumped equilibrium + reactions ---
    accel_nodes = body_accel[None, :] + forces / m_safe
    if grid.dirichlet_mask is not None:
        zero = torch.zeros_like(forces)
        reactions = torch.where(grid.dirichlet_mask, forces, zero)
        accel_nodes = torch.where(grid.dirichlet_mask, zero, accel_nodes)
    else:
        reactions = torch.zeros_like(forces)

    # --- G2P + corrector ---
    a_p = eng.g2p(N, accel_nodes)
    d_dis_p_smooth = eng.g2p(N, d_dis_nodes)
    v_new = v_pred + gamma * dt * a_p
    x_new = p.x + d_dis_p_smooth

    lme_beta = alme.update_beta(p.lme_beta, DF) if cfg.shapefun == "alme" else p.lme_beta
    p_out = _advance(p, act, cs, F_n1, J_n1, dFdt_n1, x_new, v_new, a_p,
                     d_dis_p_smooth, p.lme_lambda if sf["lam"] is None else sf["lam"],
                     damage_n1, strain_f_n1, lme_beta)
    ke, se = _energies(p, act, v_new, cs)
    nnz, ke, se, lost = global_sums(cfg, count_nnz(mask), ke, se, lost)
    diag = dict(
        nnz=nnz,
        reactions=reactions,
        kinetic_energy=ke,
        strain_energy=se,
        lost=lost,
    )
    return p_out, diag


def _explicit_step_fused(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ExplicitConfig,
    body_accel: Tensor,
    traction: Optional[Tensor] = None,
    traction_area: Optional[Tensor] = None,
    rebin: Optional[bool] = None,
):
    """Fused-kernel variant of the explicit step (LME, 2D or 3D).
    Physics identical to the windowed path; the particle↔grid transfers run
    through ops/fused_transfer.py so no (Ns, K, ·) edge tensor ever reaches
    device memory: two scatters and two gathers a step."""
    box = cfg.active_box
    dt, gamma, d = cfg.dt, cfg.gamma, p.dim
    C, nc = box.capacity, box.n_cells
    params = cfg.lme_params
    local_mode = cfg.rebin_mode == "local" and traction is None
    lost = torch.zeros((), dtype=torch.int32, device=p.x.device)
    # halo strip: scatters complete the owned planes by the neighbours' halo
    # adds, gathers fill the ghost planes first; the kernels mask phantom
    # planes by the strip grid's valid bounds
    xadd, fill = halo_ops(cfg)
    # With rebin_every == 1 the kernel window needs no drift margin and the
    # re-bin runs every step; with rebin_every = k > 1 a 1-cell margin
    # widens the window and the re-bin fires only on rebin steps (k·CFL ≤ 1
    # keeps drift ≤ 1 cell between firings).  Under 'none' the sharded
    # driver's migration fires every k-th step (its halo is widened to
    # match: domain.decompose(margin=1)).
    margin = 0 if cfg.rebin_every == 1 else 1
    if cfg.rebin_mode == "none":
        local_mode = False
    elif local_mode:
        # particles arrive on the slot invariant (binned to their cells by
        # to_slot_layout / the last end-of-step local_rebin)
        pass
    elif cfg.rebin_every > 1 and rebin is not None:
        if traction is not None:
            raise ValueError("tractions require rebin_every=1")
        if rebin:
            p, lost, _, _ = _bin_to_slots(p, grid, box, None, None)
    else:
        p, lost, traction, traction_area = _bin_to_slots(
            p, grid, box, traction, traction_area
        )
    act = p.active

    x_t = ft.to_channel_leading(p.x, C, nc)
    lam_t = ft.to_channel_leading(p.lme_lambda, C, nc)
    act_t = ft.to_channel_leading(act.to(p.x.dtype), C, nc)

    # --- scatter #1 (solves λ): lumped mass + momentum increment [+ traction]
    d_dis_p = dt * p.v + 0.5 * dt * dt * p.a
    v_pred = p.v + (1.0 - gamma) * dt * p.a
    chans = [p.mass[:, None], p.mass[:, None] * d_dis_p]
    if traction is not None:
        chans.append(traction_area[:, None] * traction)
    fN = ft.to_channel_leading(torch.cat(chans, dim=1), C, nc)
    nodes1, lam_new, nnz = ft.fused_scatter(
        grid, box, params, x_t, lam_t, act_t, fN, solve=True, margin=margin
    )
    nodes1 = xadd(nodes1)
    m_nodes = nodes1[:, 0]
    m_safe = torch.clamp(m_nodes, min=cfg.mass_tol)[:, None]
    d_dis_nodes = nodes1[:, 1 : 1 + d] / m_safe
    traction_forces = nodes1[:, 1 + d : 1 + 2 * d] if traction is not None else None

    if grid.dirichlet_mask is not None:
        d_dis_nodes = torch.where(grid.dirichlet_mask, grid.dirichlet_value, d_dis_nodes)

    # --- gather #1: smoothed Δu + displacement gradient (→ ΔF) ---
    d_dis_nodes_f = fill(d_dis_nodes).contiguous()
    d_dis_smooth, grad_du = ft.fused_gather(
        grid, box, params, x_t, lam_new, act_t,
        gN=d_dis_nodes_f, g_grad=d_dis_nodes_f, margin=margin,
    )
    DF = grad_du + torch.eye(d, dtype=grad_du.dtype, device=grad_du.device)
    DF, F_n1, J_n1, dFdt_n1, cs = _kinematics_and_stress(p, mats, cfg, box, DF, act)
    # --- nonlocal damage on the slot arrays of ``p`` (not the kernels'
    # channel-leading copies); no kernel call ---
    damage_n1, strain_f_n1, tau_eff = _damage(p, grid, mats, cfg, act, cs, J_n1, F_n1)

    # --- scatter #2: internal forces f_A = −Σ V0·τ_eff·∇N¹ = Σ G·∇N with
    # G = −V0·τ_eff·DF⁻ᵀ (push-forward folded into the matrix) ---
    G = -tn.bmm(tau_eff * p.vol0[:, None, None], tn.inv_transpose(DF))
    G_t = ft.to_channel_leading(G.reshape(-1, d * d), C, nc)
    dummy = ft.to_channel_leading(torch.zeros_like(p.mass), C, nc)
    nodes2, _, _ = ft.fused_scatter(
        grid, box, params, x_t, lam_new, act_t, dummy, G_t=G_t,
        solve=False, margin=margin,
    )
    forces = xadd(nodes2)[:, 1 : 1 + d]
    if traction_forces is not None:
        forces = forces + traction_forces

    accel_nodes = body_accel[None, :] + forces / m_safe
    if grid.dirichlet_mask is not None:
        zero = torch.zeros_like(forces)
        reactions = torch.where(grid.dirichlet_mask, forces, zero)
        accel_nodes = torch.where(grid.dirichlet_mask, zero, accel_nodes)
    else:
        reactions = torch.zeros_like(forces)

    # --- gather #2: accelerations ---
    a_p, _ = ft.fused_gather(
        grid, box, params, x_t, lam_new, act_t, gN=fill(accel_nodes).contiguous(),
        margin=margin,
    )
    v_new = v_pred + gamma * dt * a_p
    x_new = p.x + d_dis_smooth

    p_out = _advance(p, act, cs, F_n1, J_n1, dFdt_n1, x_new, v_new, a_p,
                     d_dis_smooth, ft.from_channel_leading(lam_new), damage_n1, strain_f_n1,
                     p.lme_beta)
    ke, se = _energies(p, act, v_new, cs)
    if local_mode and (rebin is None or rebin):
        # restore the slot invariant (no sort); with rebin_every = k > 1
        # only the steps that run() flags pay the re-bin — the
        # margin-widened kernels tolerate ≤ 1 cell of drift in between
        p_out, lost = windowed.local_rebin(p_out, grid, box)
    nnz, ke, se, lost = global_sums(cfg, nnz, ke, se, lost)
    diag = dict(
        nnz=nnz,
        reactions=reactions,
        kinetic_energy=ke,
        strain_energy=se,
        lost=lost,
    )
    return p_out, diag


def to_slot_layout(
    p: Particles, grid: Grid, box: windowed.ActiveBox, allow_lost: bool = False
) -> Particles:
    """Convert an arbitrary particle set to slot layout (do once before a
    windowed or fused run).

    Raises when active particles do not fit the box (outside its cell range
    or overflowing ``capacity``) unless ``allow_lost=True`` — silent mass
    loss is never the default; size capacity with
    ``windowed.required_capacity`` or ``windowed.default_box``.  This set-up
    check is the one place that reads a device value back to the host."""
    binning = windowed.bin_particles(grid, box, p.x, p.active)
    lost = int(binning.lost.item())
    if lost > 0 and not allow_lost:
        need = windowed.required_capacity(grid, box, p.x, p.active)
        raise ValueError(
            f"to_slot_layout: {lost} active particles dropped by the ActiveBox "
            f"(cdims={box.cdims}, offset={box.offset}, capacity={box.capacity}; "
            f"this configuration needs capacity >= {need} or a larger box). "
            f"Pass allow_lost=True only if dropping is intended."
        )
    return windowed.permute_to_slots(p, binning)


def run(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ExplicitConfig,
    n_steps: int,
    body_accel=None,
):
    """Time loop.  Returns (particles, diagnostics) with one entry per step
    of ``kinetic_energy``, ``strain_energy``, ``nnz`` and ``lost``, stacked
    on the device at the end: the loop itself never waits on the host.

    With the fused engine, ``rebin_mode='local'`` and ``rebin_every = k > 1``
    dividing ``n_steps``, the loop is k-periodic: k−1 plain steps, then one
    step that re-bins."""
    _check_supported(cfg, p, grid)
    if body_accel is None:
        body_accel = torch.zeros((p.dim,), dtype=p.x.dtype, device=p.x.device)
    if cfg.transfer != "scatter":
        p = to_slot_layout(p, grid, cfg.active_box)

    k = cfg.rebin_every
    periodic = (
        cfg.transfer == "fused" and cfg.rebin_mode == "local" and k > 1
        and n_steps % k == 0
    )
    keys = ("kinetic_energy", "strain_energy", "nnz", "lost")
    hist = {key: [] for key in keys}
    for i in range(n_steps):
        if periodic:
            rebin = i % k == k - 1
        else:
            rebin = (i % k == 0) if k > 1 else None
        p, diag = explicit_step(p, grid, mats, cfg, body_accel, rebin=rebin)
        for key in keys:
            hist[key].append(diag[key])
    return p, {key: torch.stack(vals) for key, vals in hist.items()}
