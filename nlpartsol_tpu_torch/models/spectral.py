"""Shared spectral machinery of the principal-space plasticity models.

Counterpart of ``nlpartsol_tpu/models/spectral.py``.  Von Mises,
Drucker-Prager and the Borja family share one skeleton: the trial elastic
left Cauchy-Green tensor b_e^tr = ΔF · b_e · ΔFᵀ, its eigendecomposition, a
return mapping on the three principal Hencky strains, then stress and the
corrected b_e rebuilt on the (unchanged) trial eigenvectors.  In plane
strain the third principal value is the stored zz channel.

The state is stored as the *deviation* b_e − I (``Particles.bemi``), zero at
rest, so that in float32 the principal Hencky strains come out of ``log1p``
on exactly computed deviations:
  b_e^tr − I = ΔF (b_e − I) ΔFᵀ + (ΔF ΔFᵀ − I)
with the last term expanded cancellation-free from ΔA = ΔF − I.
"""

from __future__ import annotations

import torch

from ..ops import tensor as tn

Tensor = torch.Tensor


def trial_bemi(bemi: Tensor, bemi_zz: Tensor, DF: Tensor):
    """Spectrum of the trial elastic b, in deviation form.

    Args:
      bemi: (..., d, d) b_e − I at t=n.
      bemi_zz: (...,) out-of-plane b_e − 1 (plane strain; ignored for d=3).
      DF: (..., d, d) incremental deformation gradient.

    Returns:
      wm1: (..., 3) principal values of (b_e^tr − I); index 2 = zz for d=2.
      V:   (..., d, d) in-plane eigenvectors (columns).
    """
    d = bemi.shape[-1]
    dA = DF - torch.eye(d, dtype=DF.dtype, device=DF.device)
    bemi_tr = tn.bmm_t(tn.bmm(DF, bemi), DF) + tn.bmi_from_disp_grad(dA)
    wm1, V = tn.sym_eig(bemi_tr)
    if d == 2:
        wm1 = torch.cat([wm1, bemi_zz[..., None]], dim=-1)
    return wm1, V


def hencky_from_wm1(wm1: Tensor) -> Tensor:
    """Principal Hencky strains E_h = ½ ln(w) = ½ log1p(w − 1)."""
    return 0.5 * torch.log1p(torch.clamp(wm1, min=-1.0 + 1e-12))


def wm1_from_hencky(Eh: Tensor) -> Tensor:
    """w − 1 = expm1(2 E_h) (the corrector's inverse map)."""
    return torch.expm1(2.0 * Eh)


def rebuild(vals3: Tensor, V: Tensor):
    """Reassemble a symmetric tensor from 3 principal values and the trial
    eigenvectors.  Because Σ_A v_A v_Aᵀ = I, feeding principal *deviations*
    returns the tensor's deviation from identity — so this one function
    serves both the stress (absolute) and bemi (deviation) reconstructions.

    Returns ((..., d, d) in-plane part, (...,) zz value)."""
    d = V.shape[-1]
    inplane = tn.sym_from_eig(vals3[..., :d], V)
    zz = vals3[..., 2]
    return inplane, zz
