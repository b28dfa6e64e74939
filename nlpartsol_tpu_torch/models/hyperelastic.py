"""Finite-strain hyperelastic models — batched over particles.

Counterpart of ``nlpartsol_tpu/models/hyperelastic.py`` (Kirchhoff-stress
convention, plane-strain zz channel carried separately).  Ported so far:

* Neo-Hookean (Wriggers):  τ = λ/2 (J²−1) I + G (b − I)

float32 design: the model works on the displacement gradient A = F − I via
the cancellation-free identities in ops.tensor (det(I+A)−1, b−I = A+Aᵀ+AAᵀ,
x−log1p(x)); computing b−I or ln J directly from F loses all significance at
small strain in f32.

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
