"""Von Mises (J2) finite-strain plasticity with Voce isotropic + linear
kinematic hardening — batched, branch-free radial return.

Counterpart of ``nlpartsol_tpu/models/vonmises.py``:
  trial b_e spectrum → principal Hencky strains
  κ_iso(ε) = σy + θHε + (K∞−K0)(1−e^{−δε}),  κ_kin(ε) = (1−θ)Hε
  Φ = J2 − √(2/3)(κ_iso,k + κ_kin,k − κ_kin,n) − 2G·dγ
  scalar Newton on dγ, flow n = dev/|dev|,
  corrector b_e = Σ exp(2(E_h − dγ n)) v⊗v.

The Newton loop runs its fixed count on every particle, updates frozen by
``where(live, …)``; nothing is read back to the host.  The implicit steps'
tangent is the forward-mode derivative of this update through
``spectral.trial_update`` (exact at coincident and diagonal spectra); the
JAX function's assembled ``C_ep`` is not computed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .materials import bulk_shear
from .spectral import hencky_from_wm1, trial_update, wm1_from_hencky

Tensor = torch.Tensor

SQ23 = 0.8164965809277260  # sqrt(2/3)


class VonMisesOut(NamedTuple):
    tau: Tensor  # (..., d, d) Kirchhoff stress
    tau_zz: Tensor
    bemi: Tensor  # corrected elastic left Cauchy-Green − I
    bemi_zz: Tensor
    eps: Tensor  # equivalent plastic strain
    back_stress: Tensor  # (..., 3) principal back stress
    W: Tensor


def _kappa(sigma_y, eps, H, theta, K0, Kinf, delta):
    k_iso = sigma_y + theta * H * eps + (Kinf - K0) * (1.0 - torch.exp(-delta * eps))
    k_kin = (1.0 - theta) * H * eps
    return k_iso, k_kin


def _d_kappa(eps, H, theta, K0, Kinf, delta):
    d_iso = theta * H + delta * (Kinf - K0) * torch.exp(-delta * eps)
    d_kin = (1.0 - theta) * H
    return d_iso, d_kin


def von_mises(
    bemi,
    bemi_zz,
    DF,
    eps,
    back_stress,
    *,
    E,
    nu,
    sigma_y,
    H,
    theta,
    K0,
    Kinf,
    delta,
    n_iter: int = 12,
    tol: float = 1e-10,
    ref_vol_compat: bool = False,
) -> VonMisesOut:
    """Batched stress update.  All material args broadcast over the batch.
    ``ref_vol_compat=True`` takes the reference solver's trial bulk term
    K·tr(E)/3 (a response 3× too soft) and its plastic branch's −T_vol in
    place of K·tr(E) and +T_vol: only the golden tests of its constitutive
    harness use it."""
    K, G = bulk_shear(E, nu)

    def principal(wm1, K, G, eps, back_stress, sigma_y, H, theta, K0, Kinf, delta):
        Eh_tr = hencky_from_wm1(wm1)  # (..., 3)

        trEh = torch.sum(Eh_tr, dim=-1)
        # volumetric stress σ_m = K·tr(E) per principal component
        K_vol = K / 3.0 if ref_vol_compat else K
        T_vol = (K_vol * trEh)[..., None] * torch.ones_like(Eh_tr)
        T_dev = 2.0 * G[..., None] * (Eh_tr - (trEh / 3.0)[..., None]) - back_stress
        J2 = torch.sqrt(torch.sum(T_dev * T_dev, dim=-1))

        k_iso_n, k_kin_n = _kappa(sigma_y, eps, H, theta, K0, Kinf, delta)
        PHI_0 = J2 - SQ23 * k_iso_n
        plastic = PHI_0 > 0.0

        one = torch.ones_like(J2)
        J2_safe = torch.where(J2 > 0.0, J2, one)
        n_dir = T_dev / J2_safe[..., None]
        PHI0_safe = torch.where(PHI_0 == 0, one, PHI_0)

        # masked scalar Newton on dγ (radial return)
        d_gamma, eps_k, PHI = torch.zeros_like(J2), eps, PHI_0
        for _ in range(n_iter):
            live = plastic & (torch.abs(PHI / PHI0_safe) >= tol)
            d_iso, d_kin = _d_kappa(eps_k, H, theta, K0, Kinf, delta)
            d_PHI = -2.0 * G * (1.0 + (d_iso + d_kin) / (3.0 * G))
            d_gamma_new = d_gamma - PHI / d_PHI
            eps_new = eps + SQ23 * d_gamma_new
            k_iso_k, k_kin_k = _kappa(sigma_y, eps_new, H, theta, K0, Kinf, delta)
            PHI_new = J2 - SQ23 * (k_iso_k + k_kin_k - k_kin_n) - 2.0 * G * d_gamma_new
            d_gamma = torch.where(live, d_gamma_new, d_gamma)
            eps_k = torch.where(live, eps_new, eps_k)
            PHI = torch.where(live, PHI_new, PHI)
        d_gamma = torch.where(plastic, d_gamma, torch.zeros_like(d_gamma))
        eps_out = torch.where(plastic, eps_k, eps)

        _, k_kin_k = _kappa(sigma_y, eps_out, H, theta, K0, Kinf, delta)
        d_K_kin = k_kin_k - k_kin_n

        # principal stress: elastic vol + dev (with −back); plastic re-adds
        # the back stress and subtracts the plastic corrector
        T_vol_pl = -T_vol if ref_vol_compat else T_vol
        T_elastic = T_vol + T_dev
        T_plastic = T_vol_pl + T_dev + back_stress - (2.0 * G * d_gamma)[..., None] * n_dir
        pl = plastic[..., None]
        T_ppal = torch.where(pl, T_plastic, T_elastic)

        back_out = torch.where(pl, back_stress + SQ23 * d_K_kin[..., None] * n_dir, back_stress)

        dE_p = torch.where(pl, d_gamma[..., None] * n_dir, torch.zeros_like(n_dir))
        Eh_corr = Eh_tr - dE_p
        W = 0.5 * torch.sum(T_ppal * Eh_corr, dim=-1)
        return (wm1_from_hencky(Eh_corr), T_ppal), (eps_out, back_out, W)

    ((bemi_new, bemi_zz_new), (tau, tau_zz)), (eps_out, back_out, W) = trial_update(
        bemi, bemi_zz, DF, principal, K, G, eps, back_stress, sigma_y, H, theta, K0, Kinf,
        delta)
    return VonMisesOut(tau, tau_zz, bemi_new, bemi_zz_new, eps_out, back_out, W)
