"""Compressible fluids: Newtonian (Macdonald-type barotropic EOS) and
Bingham (Papanastasiou regularisation).

Counterpart of ``nlpartsol_tpu/models/fluid.py``:
  Newtonian  p(J) = J (p0 + (K/n)(J^{-n} − 1)),
             τ = −p I + 2 J μ d − (2/3) J μ tr(d) I,  d = sym(L),  L = Ḟ F⁻¹
  Bingham    p(J) = p0 + (K/n)(J^{-n} − 1),
             μ(d) = μ0 + (τ_y/γ̇)(1 − e^{−m γ̇}),  γ̇ = sqrt(2 d:d),
             τ = J(−p I + 2 μ d − (2/Ndim) μ tr(d) I)
Both invert F: callers pass the identity on inactive slots (F = 0 there).
"""

from __future__ import annotations

import torch

from ..ops import tensor as tn

Tensor = torch.Tensor


def spatial_velocity_gradient(dFdt: Tensor, F: Tensor) -> Tensor:
    """L = Ḟ F⁻¹."""
    return tn.bmm(dFdt, tn.inv(F))


def bingham_fluid(F, dFdt, *, p0, mu0, tau_y, m_pap, n, K):
    """Bingham plastic with Papanastasiou regularisation.  τ_y rides the
    material table's kappa0, m_pap is fluidity_param.  The deviator uses
    2/Ndim (the reference's in-plane deviator), unlike the Newtonian
    model's 2/3."""
    d = F.shape[-1]
    J = tn.det(F)
    pressure = p0 + (K / n) * (J ** (-n) - 1.0)
    E = tn.sym(spatial_velocity_gradient(dFdt, F))
    trE = tn.trace(E)
    # γ̇ includes the zz channel only through tr in 3D; plane strain d_zz=0.
    # At a zero rate the sqrt is where-safe and μ takes its limit μ0 + τ_y·m
    # (d = 0 there, so τ does not change): the tangent 2μ·dd is finite and
    # equals the limit a central difference sees
    g2 = 2.0 * torch.sum(E * E, dim=(-2, -1))
    moving = g2 > 0.0
    gdot = torch.where(moving, torch.sqrt(torch.where(moving, g2, torch.ones_like(g2))),
                       torch.zeros_like(g2))
    gdot_s = torch.clamp(gdot, min=1e-12)
    mu = mu0 + torch.where(moving, (tau_y / gdot_s) * (1.0 - torch.exp(-m_pap * gdot)),
                           tau_y * m_pap)
    c0 = J * mu
    eye = torch.eye(d, dtype=F.dtype, device=F.device)
    tau = (
        -(J * pressure)[..., None, None] * eye
        + 2.0 * c0[..., None, None] * E
        - (2.0 / d) * (c0 * trE)[..., None, None] * eye
    )
    # plane strain zz: d_zz = 0 but the volumetric F^{-T} terms act on the
    # unit zz entry, so τ_zz = −Jp − (2/N)Jμ tr(d)
    tau_zz = -J * pressure - (2.0 / d) * c0 * trE
    return tau, tau_zz, torch.zeros_like(J)


def newtonian_fluid(F, dFdt, *, p0, mu, n, K):
    d = F.shape[-1]
    J = tn.det(F)
    pressure = J * (p0 + (K / n) * (J ** (-n) - 1.0))
    c0 = J * mu
    E = tn.sym(spatial_velocity_gradient(dFdt, F))
    trE = tn.trace(E)  # plane strain: L_zz = 0
    eye = torch.eye(d, dtype=F.dtype, device=F.device)
    tau = (
        -pressure[..., None, None] * eye
        + 2.0 * c0[..., None, None] * E
        - (2.0 / 3.0) * (c0 * trE)[..., None, None] * eye
    )
    tau_zz = -pressure - (2.0 / 3.0) * c0 * trE
    return tau, tau_zz, torch.zeros_like(J)
