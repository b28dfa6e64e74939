"""Drucker-Prager finite-strain plasticity (Sanavia backward-Euler) with
classical + apex return regions and Ortiz power hardening — batched.

Counterpart of ``nlpartsol_tpu/models/druckerprager.py``: plane-strain / 3D
cone parameters α_F, α_Q, β from the friction and dilatancy angles; trial
volumetric/deviatoric split with a reference pressure; yield
Φ = J2 − 2G·dγ − 3α_F(p − 3Kα_Q dγ) − βκ; a pressure limit separating the
classical and apex regions; apex return with dγ₁ = J2/2G and Newton on dγ₂;
κ(ε) = κ₀(1 + ε/ε₀)^{1/m}; ε updated with √(1 + 3α_Q²).

Branch selection (elastic/classical/apex) is fully masked; both Newton loops
run their fixed count on every particle, updates frozen by ``where(live, …)``,
with no read back to the host.  The implicit steps' tangent is the
forward-mode derivative of this update through ``spectral.trial_update``,
both Newton loops and the branch selection included; the JAX function's
assembled ``C_ep`` is not computed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import config
from .materials import bulk_shear
from .spectral import hencky_from_wm1, trial_update, wm1_from_hencky

Tensor = torch.Tensor


class DruckerPragerOut(NamedTuple):
    tau: Tensor
    tau_zz: Tensor
    bemi: Tensor
    bemi_zz: Tensor
    eps: Tensor
    kappa: Tensor
    W: Tensor
    failed: Tensor


def cone_parameters(friction_angle_deg, dilatancy_angle_deg, dim: int):
    """(α_F, α_Q, β): plane-strain fit for d=2, triaxial-compression fit for
    d=3."""
    rf = torch.deg2rad(friction_angle_deg)
    rq = torch.deg2rad(dilatancy_angle_deg)
    s23 = math.sqrt(2.0 / 3.0)
    if dim == 2:
        tf, tq = torch.tan(rf), torch.tan(rq)
        alpha_F = s23 * tf / torch.sqrt(3.0 + 4.0 * tf * tf)
        alpha_Q = s23 * tq / torch.sqrt(3.0 + 4.0 * tq * tq)
        beta = s23 * 3.0 / torch.sqrt(3.0 + 4.0 * tf * tf)
    else:
        sf, sq = torch.sin(rf), torch.sin(rq)
        alpha_F = s23 * 2.0 * sf / (3.0 - sf)
        alpha_Q = s23 * 2.0 * sq / (3.0 - sq)
        beta = s23 * 6.0 * torch.cos(rf) / (3.0 - sf)
    return alpha_F, alpha_Q, beta


def _kappa_fn(kappa0, exp_m, eps, eps0):
    base = torch.clamp(1.0 + eps / eps0, min=1e-12)
    return kappa0 * base ** (1.0 / exp_m)


def _d_kappa_fn(kappa0, exp_m, eps, eps0):
    base = torch.clamp(1.0 + eps / eps0, min=1e-12)
    return (kappa0 / (exp_m * eps0)) * base ** (1.0 / exp_m - 1.0)


def drucker_prager(
    bemi,
    bemi_zz,
    DF,
    eps,
    kappa,
    *,
    E,
    nu,
    kappa0,
    friction_angle,
    dilatancy_angle,
    exponent_ortiz,
    plastic_strain_0,
    J2_degradated,
    p_ref=0.0,
    n_iter: int = 15,
    tol: float = 1e-10,
    ref_vol_compat: bool = False,
) -> DruckerPragerOut:
    """Batched stress update.  ``ref_vol_compat=True`` takes the reference
    solver's trial bulk term K·tr(E)/3 (a response 3× too soft) in place of
    K·tr(E): only the golden tests of its constitutive harness use it."""
    d = bemi.shape[-1]
    K, G = bulk_shear(E, nu)
    alpha_F, alpha_Q, beta = cone_parameters(friction_angle, dilatancy_angle, d)
    ads = torch.sqrt(1.0 + 3.0 * alpha_Q * alpha_Q)
    alpha_F_safe = torch.where(alpha_F == 0.0, torch.ones_like(alpha_F), alpha_F)

    def principal(wm1, K, G, alpha_F, alpha_Q, beta, ads, alpha_F_safe, eps, kappa, kappa0,
                  exponent_ortiz, plastic_strain_0, J2_degradated, p_ref):
        Eh_tr = hencky_from_wm1(wm1)

        trEh = torch.sum(Eh_tr, dim=-1)
        K_vol = K / 3.0 if ref_vol_compat else K
        T_vol = (p_ref + K_vol * trEh)[..., None] * torch.ones_like(Eh_tr)
        T_dev = 2.0 * G[..., None] * (Eh_tr - (trEh / 3.0)[..., None])
        # "pressure" = −mean stress
        pressure = -(p_ref + K_vol * trEh)
        J2 = torch.sqrt(torch.sum(T_dev * T_dev, dim=-1))
        one, zero = torch.ones_like(J2), torch.zeros_like(J2)

        kappa_n = kappa

        def yield_classical(dg, kap):
            return (
                J2
                - 2.0 * G * dg
                - 3.0 * alpha_F * (pressure - 3.0 * K * alpha_Q * dg)
                - beta * kap
            )

        PHI_0 = yield_classical(0.0, kappa_n)
        plastic = PHI_0 > config.TOL_NR
        PHI0_safe = torch.where(PHI_0 == 0.0, one, PHI_0)

        has_dev = J2 > config.TOL_NR
        J2_safe = torch.where(has_dev, J2, one)
        n_dir = torch.where(has_dev[..., None], T_dev / J2_safe[..., None], torch.zeros_like(T_dev))

        d_kappa_n = _d_kappa_fn(kappa0, exponent_ortiz, eps, plastic_strain_0)
        p_limit = (
            3.0 * alpha_Q * K / (2.0 * G) * J2
            + beta / (3.0 * alpha_F_safe) * ((J2 / (2.0 * G)) * d_kappa_n * ads + kappa_n)
        )
        apex = plastic & (-pressure >= p_limit)
        classical = plastic & ~apex

        # ---- classical radial return (masked Newton) ----
        dg_c, eps_c, kap_c, dkap_c, PHI = zero, eps, kappa_n, d_kappa_n, PHI_0
        for _ in range(n_iter):
            live = classical & (torch.abs(PHI / PHI0_safe) >= tol)
            d_PHI = 9.0 * K * alpha_F * alpha_Q - 2.0 * G - beta * dkap_c * ads
            dg_n = dg_c - PHI / d_PHI
            eps_n1 = eps + dg_n * ads
            kap_n1 = _kappa_fn(kappa0, exponent_ortiz, eps_n1, plastic_strain_0)
            dkap_n1 = _d_kappa_fn(kappa0, exponent_ortiz, eps_n1, plastic_strain_0)
            PHI_n1 = yield_classical(dg_n, kap_n1)
            dg_c = torch.where(live, dg_n, dg_c)
            eps_c = torch.where(live, eps_n1, eps_c)
            kap_c = torch.where(live, kap_n1, kap_c)
            dkap_c = torch.where(live, dkap_n1, dkap_c)
            PHI = torch.where(live, PHI_n1, PHI)

        # ---- apex return (masked Newton on dγ₂) ----
        dg1 = J2 / (2.0 * G)

        def yield_apex(dg_k):
            rad = torch.sqrt(dg1 * dg1 + 3.0 * alpha_Q * alpha_Q * dg_k * dg_k)
            return (
                beta / (3.0 * alpha_F_safe) * (kappa_n + d_kappa_n * rad)
                - pressure
                + 3.0 * K * alpha_Q * dg_k
            )

        dg2, dead, PHI = zero, torch.zeros_like(plastic), yield_apex(dg1)
        for _ in range(n_iter):
            dg_k = dg1 + dg2
            live = apex & ~dead & (torch.abs(PHI / PHI0_safe) >= tol)
            rad = torch.sqrt(dg1 * dg1 + 3.0 * alpha_Q * alpha_Q * dg_k * dg_k)
            d_PHI = 3.0 * alpha_Q * K + 3.0 * d_kappa_n * beta * alpha_Q**2 * dg_k / (
                3.0 * alpha_F_safe * torch.where(rad == 0.0, one, rad)
            )
            flat = torch.abs(d_PHI) < tol
            dg2_n = dg2 - PHI / torch.where(flat, one, d_PHI)
            # negative dγ₂ ⇒ collapse to zero and stop
            went_neg = dg2_n < 0.0
            dg2_n = torch.where(went_neg, zero, dg2_n)
            PHI_n1 = yield_apex(dg1 + dg2_n)
            dg2 = torch.where(live, dg2_n, dg2)
            dead = dead | (live & went_neg) | (live & flat)
            PHI = torch.where(live, PHI_n1, PHI)
        # if dγ₂ went negative, dγ_k = 0 entirely
        dg_a = torch.where(dead & (dg2 == 0.0), zero, dg1 + dg2)
        eps_a = eps + dg_a * ads
        kap_a = _kappa_fn(kappa0, exponent_ortiz, eps_a, plastic_strain_0)

        # ---- select branch, build stress & plastic strain increment ----
        cl, ap = classical[..., None], apex[..., None]
        T_el = T_vol + T_dev
        T_cl = T_vol + T_dev + (dg_c * 3.0 * K * alpha_Q)[..., None] - (
            2.0 * G * dg_c
        )[..., None] * n_dir
        T_ap = T_vol + (dg_a * 3.0 * K * alpha_Q)[..., None] * torch.ones_like(T_vol)
        T_ppal = torch.where(cl, T_cl, torch.where(ap, T_ap, T_el))
        dE_p = torch.where(
            cl,
            dg_c[..., None] * (alpha_Q[..., None] + n_dir),
            torch.where(
                ap,
                (dg_a * alpha_Q)[..., None] + dg1[..., None] * n_dir,
                torch.zeros_like(n_dir),
            ),
        )
        eps_out = torch.where(classical, eps_c, torch.where(apex, eps_a, eps))
        kappa_out = torch.where(classical, kap_c, torch.where(apex, kap_a, kappa_n))

        Eh_corr = Eh_tr - dE_p
        W = 0.5 * torch.sum(T_ppal * Eh_corr, dim=-1)

        # failure flag: fully degraded strength (read by the damage drivers)
        failed = plastic & (kappa_out <= J2_degradated)
        return (wm1_from_hencky(Eh_corr), T_ppal), (eps_out, kappa_out, W, failed)

    ((bemi_new, bemi_zz_new), (tau, tau_zz)), (eps_out, kappa_out, W, failed) = trial_update(
        bemi, bemi_zz, DF, principal, K, G, alpha_F, alpha_Q, beta, ads, alpha_F_safe, eps,
        kappa, kappa0, exponent_ortiz, plastic_strain_0, J2_degradated, p_ref)
    return DruckerPragerOut(tau, tau_zz, bemi_new, bemi_zz_new, eps_out, kappa_out, W, failed)
