"""Finite-strain hyperelastic models — batched over particles.

Counterpart of ``nlpartsol_tpu/models/hyperelastic.py`` (Kirchhoff-stress
convention, plane-strain zz channel carried separately):

* Neo-Hookean (Wriggers):  τ = λ/2 (J²−1) I + G (b − I)
* Saint-Venant-Kirchhoff:  S = λ tr(E) I + 2 G E, τ = F S Fᵀ
* Hencky: principal logarithmic strains of b, T_ppal = (λ 1⊗1 + 2G I) E_h
* compressible Mooney-Rivlin (the energy-consistent completion of the
  reference's stub; see :func:`mooney_rivlin`)
* linear elastic (small strain, for the elastic bar oracle problems)

float32 design: the models work on the displacement gradient A = F − I via
the cancellation-free identities in ops.tensor (det(I+A)−1, b−I = A+Aᵀ+AAᵀ,
C−I = A+Aᵀ+AᵀA, x−log1p(x)); computing b−I, C−I or ln J directly from F
loses all significance at small strain in f32.

Takes ``(F, E, nu)`` where F is (..., d, d) and the material parameters are
broadcastable leading-dim tensors; returns ``(tau, tau_zz, W)``.
"""

from __future__ import annotations

import torch

from ..ops import tensor as tn
from .materials import lame_parameters


def neo_hookean(F: torch.Tensor, E: torch.Tensor, nu: torch.Tensor):
    d = F.shape[-1]
    lam, G = lame_parameters(E, nu)
    eye = torch.eye(d, dtype=F.dtype, device=F.device)
    A = F - eye
    e = tn.det_minus_one(A)  # J − 1  (plane strain: F_zz = 1)
    J = 1.0 + e
    bmi = tn.bmi_from_disp_grad(A)  # b − I
    c0 = 0.5 * lam * e * (J + 1.0)  # λ/2 (J²−1), cancellation-free
    tau = c0[..., None, None] * eye + G[..., None, None] * bmi
    tau_zz = c0  # b_zz = 1 in plane strain
    # W = λ/4 (J²−1) − (λ/2+G) ln J + G/2 (I1−3), regrouped stably:
    #   λ/4 [(J²−1) − 2 lnJ] + G [ (|A|²/2 − (e − trA)) + (e − lnJ) ]
    slp = tn.sub_log1p(e)
    normA2 = torch.sum(A * A, dim=(-2, -1))
    quad = 0.5 * normA2 - (e - tn.trace(A))  # = ½|A|² − I2(A) − I3(A)
    W = 0.25 * lam * (e * e + 2.0 * slp) + G * (quad + slp)
    return tau, tau_zz, W


def saint_venant_kirchhoff(F: torch.Tensor, E_mod: torch.Tensor, nu: torch.Tensor):
    d = F.shape[-1]
    lam, G = lame_parameters(E_mod, nu)
    eye = torch.eye(d, dtype=F.dtype, device=F.device)
    Egr = 0.5 * tn.cmi_from_disp_grad(F - eye)  # ½(C − I), cancellation-free
    trE = tn.trace(Egr)  # E_zz = 0 in plane strain
    S = (lam * trE)[..., None, None] * eye + 2.0 * G[..., None, None] * Egr
    tau = tn.bmm_t(tn.bmm(F, S), F)
    tau_zz = lam * trE  # S_zz = λ tr(E); F_zz = 1
    W = 0.5 * lam * trE * trE + G * torch.sum(Egr * Egr, dim=(-2, -1))
    return tau, tau_zz, W


def hencky(F: torch.Tensor, E_mod: torch.Tensor, nu: torch.Tensor):
    d = F.shape[-1]
    lam, G = lame_parameters(E_mod, nu)
    eye = torch.eye(d, dtype=F.dtype, device=F.device)
    bmi = tn.bmi_from_disp_grad(F - eye)

    def principal(wm1, lam, G):  # eigenvalues of b, minus 1, exactly
        Eh = 0.5 * torch.log1p(torch.clamp(wm1, min=-1.0 + 1e-12))
        trEh = torch.sum(Eh, dim=-1)  # zz adds 0 in plane strain (b_zz = 1)
        T_ppal = lam[..., None] * trEh[..., None] + 2.0 * G[..., None] * Eh
        return (T_ppal,), (lam * trEh, 0.5 * torch.sum(T_ppal * Eh, dim=-1))

    # through isotropic_map: a forward-mode J·v exact at coincident and
    # diagonal spectra (ops/tensor.py)
    (tau,), _, (tau_zz, W) = tn.isotropic_map(bmi, principal, lam, G)
    return tau, tau_zz, W


def mooney_rivlin(F: torch.Tensor, E_mod: torch.Tensor, nu: torch.Tensor,
                  mu1: torch.Tensor, mu2: torch.Tensor):
    """Compressible Mooney-Rivlin:

      W = μ₁/2 (I1 − 3) − μ₂/2 (I2/I3 − 3) + K/2 ln²J − (μ₁+μ₂) lnJ,
      K = E/(3(1−2ν)),

    stress-free at F = I, with the exact Kirchhoff stress τ = F·(2 ∂W/∂C)·Fᵀ:

      τ = μ₁ b − (μ₂/I3)(I1 b − b²) + (μ₂ I2/I3 + K lnJ − μ₁ − μ₂) I.

    Plane strain: b_zz = 1 enters the invariants; τ_zz is carried
    separately."""
    d = F.shape[-1]
    K = E_mod / (3.0 * (1.0 - 2.0 * nu))
    eye = torch.eye(d, dtype=F.dtype, device=F.device)
    A = F - eye
    e = tn.det_minus_one(A)  # J − 1
    J = 1.0 + e
    lnJ = torch.log1p(e)
    b = tn.bmi_from_disp_grad(A) + eye
    trb = tn.trace(b)
    bb = tn.bmm(b, b)
    if d == 2:
        I1 = trb + 1.0
        detb2 = b[..., 0, 0] * b[..., 1, 1] - b[..., 0, 1] * b[..., 1, 0]
        I2 = detb2 + trb  # zz eigenvalue is 1
        I3 = detb2
    else:
        I1 = trb
        I2 = 0.5 * (I1 * I1 - tn.trace(bb))
        I3 = J * J
    I3s = torch.clamp(I3, min=1e-12)
    c_iso = mu2 / I3s
    c_vol = mu2 * I2 / I3s + K * lnJ - mu1 - mu2
    tau = (
        mu1[..., None, None] * b
        - c_iso[..., None, None] * (I1[..., None, None] * b - bb)
        + c_vol[..., None, None] * eye
    )
    # zz: b_zz = 1, (b²)_zz = 1
    tau_zz = mu1 - c_iso * (I1 - 1.0) + c_vol
    W = (
        0.5 * mu1 * (I1 - 3.0)
        - 0.5 * mu2 * (I2 / I3s - 3.0)
        + 0.5 * K * lnJ * lnJ
        - (mu1 + mu2) * lnJ
    )
    return tau, tau_zz, W


def linear_elastic(F: torch.Tensor, E_mod: torch.Tensor, nu: torch.Tensor):
    d = F.shape[-1]
    lam, G = lame_parameters(E_mod, nu)
    eye = torch.eye(d, dtype=F.dtype, device=F.device)
    eps = tn.sym(F - eye)
    tre = tn.trace(eps)
    tau = (lam * tre)[..., None, None] * eye + 2.0 * G[..., None, None] * eps
    tau_zz = lam * tre
    W = 0.5 * lam * tre * tre + G * torch.sum(eps * eps, dim=(-2, -1))
    return tau, tau_zz, W
