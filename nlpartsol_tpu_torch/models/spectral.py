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

:func:`trial_update` runs a model's principal-space map through
``ops.tensor.isotropic_map``, so that its forward-mode J·v (the implicit
steps' tangent) is exact at coincident and diagonal spectra, where forward
mode through the eigenvectors is not (ROADMAP.md queue 3).
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
    wm1, V = tn.sym_eig(_trial_tensor(bemi, DF))
    if d == 2:
        wm1 = torch.cat([wm1, bemi_zz[..., None]], dim=-1)
    return wm1, V


def _trial_tensor(bemi: Tensor, DF: Tensor) -> Tensor:
    d = bemi.shape[-1]
    dA = DF - torch.eye(d, dtype=DF.dtype, device=DF.device)
    return tn.bmm_t(tn.bmm(DF, bemi), DF) + tn.bmi_from_disp_grad(dA)


def trial_update(bemi: Tensor, bemi_zz: Tensor, DF: Tensor, principal, *args):
    """A return mapping on the trial spectrum, rebuilt on its eigenvectors.

    ``principal(wm1, *args)`` takes the principal values of b_e^tr − I,
    (…, 3) (index 2 = zz for d=2), and the model's parameters and history,
    and returns ``(vals, extra)``: ``vals`` a tuple of principal arrays
    (…, 3) to rebuild (the stress, the corrected b_e − I), ``extra`` a tuple
    of per-particle outputs.  It may be called with a leading axis of copies
    (``ops.tensor.isotropic_map``), against which ``args`` must broadcast.
    Returns ``([(in-plane, zz), …] one pair per entry of vals, extra)``: the
    same arithmetic as :func:`trial_bemi`, the map and :func:`rebuild`.  The
    history carries no tangent."""
    d = bemi.shape[-1]
    if tn.tangent_of(bemi) is not None:
        raise ValueError("the b_e history must carry no forward-mode tangent")

    def fn(w, bemi_zz, *args):
        if d == 2:
            w = torch.cat([w, bemi_zz[..., None].expand(*w.shape[:-1], 1)], dim=-1)
        return principal(w, *args)

    tensors, vals, extra = tn.isotropic_map(_trial_tensor(bemi, DF), fn, bemi_zz, *args,
                                            key=tn.map_key(principal) + (d,))
    return [(T, v[..., 2]) for T, v in zip(tensors, vals)], extra


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
