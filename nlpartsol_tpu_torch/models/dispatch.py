"""Constitutive dispatch.

Counterpart of ``nlpartsol_tpu/models/dispatch.py``: a static loop over the
*model kinds present in the material table*; each model runs batched over
all particles and the results are blended with masks.  Every kind of the
material table is handled; an unknown code raises ``ValueError``.

A model runs on every particle, whatever its kind, and ``where`` keeps its
result only where the kind matches: so every model must stay finite on any
state the step hands it (the step passes the identity as F on inactive
slots, whose F is 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import hyperelastic, materials as M
from .borja import borja_frictional
from .druckerprager import drucker_prager
from .fluid import bingham_fluid, newtonian_fluid
from .vonmises import von_mises

Tensor = torch.Tensor

_BORJA_YIELD = {
    M.MATSUOKA_NAKAI: "matsuoka-nakai",
    M.LADE_DUNCAN: "lade-duncan",
    M.MODIFIED_LADE_DUNCAN: "modified-lade-duncan",
}


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
        elif kind == M.SAINT_VENANT_KIRCHHOFF:
            tau, tzz, W = hyperelastic.saint_venant_kirchhoff(F_n1, g("E"), g("nu"))
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.HENCKY:
            tau, tzz, W = hyperelastic.hencky(F_n1, g("E"), g("nu"))
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.LINEAR_ELASTIC:
            tau, tzz, W = hyperelastic.linear_elastic(F_n1, g("E"), g("nu"))
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.MOONEY_RIVLIN:
            tau, tzz, W = hyperelastic.mooney_rivlin(
                F_n1, g("E"), g("nu"), g("mu1_mr"), g("mu2_mr")
            )
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.BINGHAM_FLUID:
            tau, tzz, W = bingham_fluid(
                F_n1,
                dFdt_n1,
                p0=g("reference_pressure"),
                mu0=g("viscosity"),
                tau_y=g("kappa0"),
                m_pap=g("fluidity_param"),
                n=g("n_macdonald"),
                K=g("compressibility"),
            )
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.NEWTONIAN_FLUID:
            tau, tzz, W = newtonian_fluid(
                F_n1,
                dFdt_n1,
                p0=g("reference_pressure"),
                mu=g("viscosity"),
                n=g("n_macdonald"),
                K=g("compressibility"),
            )
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.VON_MISES:
            r = von_mises(
                bemi, bemi_zz, DF, eps, back_stress,
                E=g("E"),
                nu=g("nu"),
                sigma_y=g("kappa0"),
                H=g("hardening_modulus"),
                theta=g("theta_voce"),
                K0=g("K0_voce"),
                Kinf=g("Kinf_voce"),
                delta=g("delta_voce"),
            )
            out = blend(out, sel, r.tau, r.tau_zz, r.W, bemi=r.bemi, bemi_zz=r.bemi_zz,
                        eps=r.eps, back_stress=r.back_stress)
        elif kind == M.DRUCKER_PRAGER:
            r = drucker_prager(
                bemi, bemi_zz, DF, eps, kappa,
                E=g("E"),
                nu=g("nu"),
                kappa0=g("kappa0"),
                friction_angle=g("friction_angle"),
                dilatancy_angle=g("dilatancy_angle"),
                exponent_ortiz=g("exponent_ortiz"),
                plastic_strain_0=g("plastic_strain_0"),
                J2_degradated=g("J2_degradated"),
            )
            out = blend(out, sel, r.tau, r.tau_zz, r.W, bemi=r.bemi, bemi_zz=r.bemi_zz,
                        eps=r.eps, kappa=r.kappa, failed=r.failed)
        elif kind in _BORJA_YIELD:
            r = borja_frictional(
                bemi, bemi_zz, DF, eps, kappa,
                yield_kind=_BORJA_YIELD[kind],
                pa=g("atmospheric_pressure"),
                E=g("E"),
                nu=g("nu"),
                m=g("m_frictional"),
                phi=g("phi_frictional"),
                a1=g("a1_borja"),
                a2=g("a2_borja"),
                a3=g("a3_borja"),
                alpha=g("alpha_borja"),
            )
            out = blend(out, sel, r.tau, r.tau_zz, r.W, bemi=r.bemi, bemi_zz=r.bemi_zz,
                        eps=r.eps, kappa=r.kappa)
        elif kind == M.SOLID_RIGID:
            # Rigid: zero stress, no state evolution.
            pass
        else:
            raise ValueError(f"unknown material kind: {kind}")

    return out
