"""Constitutive dispatch.

Counterpart of ``nlpartsol_tpu/models/dispatch.py``: a static loop over the
*model kinds present in the material table*; each model runs batched over
all particles and the results are blended with masks.  Handled so far:
``NEO_HOOKEAN`` and ``SOLID_RIGID``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import hyperelastic, materials as M

Tensor = torch.Tensor

_KIND_LABEL = {code: name for name, code in M.KIND_NAMES.items()}


class StressState(NamedTuple):
    """Per-particle constitutive state (in/out)."""

    tau: Tensor
    tau_zz: Tensor
    bemi: Tensor
    bemi_zz: Tensor
    eps: Tensor
    kappa: Tensor
    back_stress: Tensor
    W: Tensor
    failed: Tensor  # Drucker-Prager particle failure flag


def stress_integration(
    *,
    F_n1: Tensor,  # (Np, d, d) total deformation gradient at n+1
    DF: Tensor,  # (Np, d, d) incremental deformation gradient
    dFdt_n1: Tensor,  # (Np, d, d) rate of F at n+1
    bemi: Tensor,
    bemi_zz: Tensor,
    eps: Tensor,
    kappa: Tensor,
    back_stress: Tensor,
    mat_id: Tensor,  # (Np,) int32
    mats: M.MaterialTable,
    kinds: tuple,  # static tuple of model codes present
) -> StressState:
    """Batched stress update for every particle."""
    mid = mat_id.long()

    def g(name):
        return getattr(mats, name)[mid]

    npart = F_n1.shape[0]
    out = StressState(
        tau=torch.zeros_like(F_n1),
        tau_zz=torch.zeros_like(eps),
        bemi=bemi,
        bemi_zz=bemi_zz,
        eps=eps,
        kappa=kappa,
        back_stress=back_stress,
        W=torch.zeros_like(eps),
        failed=torch.zeros((npart,), dtype=torch.bool, device=F_n1.device),
    )

    kind_p = mats.kind[mid]

    def blend(out, sel, tau, tau_zz, W, **extra):
        sel1 = sel[:, None]
        sel2 = sel[:, None, None]
        upd = dict(
            tau=torch.where(sel2, tau, out.tau),
            tau_zz=torch.where(sel, tau_zz, out.tau_zz),
            W=torch.where(sel, W, out.W),
        )
        for k, v in extra.items():
            cur = getattr(out, k)
            m = sel if v.ndim == 1 else (sel1 if v.ndim == 2 else sel2)
            upd[k] = torch.where(m, v, cur)
        return out._replace(**upd)

    for kind in kinds:
        sel = kind_p == kind
        if kind == M.NEO_HOOKEAN:
            tau, tzz, W = hyperelastic.neo_hookean(F_n1, g("E"), g("nu"))
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.SOLID_RIGID:
            # Rigid: zero stress, no state evolution.
            pass
        elif kind in _KIND_LABEL:
            raise NotImplementedError(
                f"material kind {kind} ({_KIND_LABEL[kind]}) is not ported yet: "
                "ROADMAP.md queue 1, 'Remaining models'"
            )
        else:
            raise ValueError(f"unknown material kind: {kind}")

    return out
