"""Material parameter table.

Counterpart of ``nlpartsol_tpu/models/materials.py``: a struct-of-arrays
table indexed by ``Particles.mat_id`` — every parameter is an ``(Nmat,)``
tensor so per-particle lookup is one gather.  Model dispatch is by integer
``kind``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .. import config
from ..types import Record

Tensor = torch.Tensor

# Model kind codes (the reference solver's Type strings)
SOLID_RIGID = 0
LINEAR_ELASTIC = 1
SAINT_VENANT_KIRCHHOFF = 2
NEO_HOOKEAN = 3  # "Neo-Hookean-Wriggers"
HENCKY = 4
NEWTONIAN_FLUID = 5  # "Newtonian-Fluid-Compressible"
VON_MISES = 6
DRUCKER_PRAGER = 7
MATSUOKA_NAKAI = 8
LADE_DUNCAN = 9
MODIFIED_LADE_DUNCAN = 10
BINGHAM_FLUID = 11
MOONEY_RIVLIN = 12

KIND_NAMES = {
    "Solid-Rigid": SOLID_RIGID,
    "LE": LINEAR_ELASTIC,
    "Linear-Elastic": LINEAR_ELASTIC,
    "Saint-Venant-Kirchhoff": SAINT_VENANT_KIRCHHOFF,
    "Neo-Hookean-Wriggers": NEO_HOOKEAN,
    "Hencky": HENCKY,
    "Newtonian-Fluid-Compressible": NEWTONIAN_FLUID,
    "Von-Mises": VON_MISES,
    "Drucker-Prager": DRUCKER_PRAGER,
    "Matsuoka-Nakai": MATSUOKA_NAKAI,
    "Lade-Duncan": LADE_DUNCAN,
    "Modified-Lade-Duncan": MODIFIED_LADE_DUNCAN,
    "Bingham-Fluid": BINGHAM_FLUID,
    "Mooney-Rivlin": MOONEY_RIVLIN,
}

_DEFAULTS = dict(
    kind=NEO_HOOKEAN,
    rho0=1000.0,
    E=1e7,
    nu=0.3,
    kappa0=0.0,
    hardening_modulus=0.0,
    theta_voce=1.0,
    K0_voce=0.0,
    Kinf_voce=0.0,
    delta_voce=0.0,
    exponent_ortiz=1.0,
    plastic_strain_0=0.0,
    cohesion=0.0,
    friction_angle=30.0,
    dilatancy_angle=30.0,
    atmospheric_pressure=0.0,
    J2_degradated=0.0,
    m_frictional=0.0,
    c0_frictional=0.0,
    phi_frictional=30.0,
    psi_frictional=30.0,
    a1_borja=0.0,
    a2_borja=0.0,
    a3_borja=0.0,
    alpha_borja=0.0,
    viscosity=1e-3,
    n_macdonald=1.0,
    compressibility=0.0,
    reference_pressure=0.0,
    fluidity_param=100.0,
    mu1_mr=0.0,
    mu2_mr=0.0,
    Ceps=1.0,
    Gf=0.0,
    ft=0.0,
    heps=0.0,
    wcrit=0.0,
    alpha_fbar=0.0,
)

# (Nmat,)-tensor-per-parameter material table: one field per key of
# _DEFAULTS, in that order (kind is int32, the rest the solver dtype).
MaterialTable = dataclasses.make_dataclass(
    "MaterialTable",
    [(name, Tensor) for name in _DEFAULTS],
    bases=(Record,),
    frozen=True,
    namespace={
        "count": property(lambda self: self.kind.shape[0]),
        "kinds_present": lambda self: tuple(sorted(set(self.kind.tolist()))),
    },
)
MaterialTable.__doc__ = "(Nmat,)-tensor-per-parameter material table."


def material(**kw) -> dict:
    """One material row; unknown keys rejected, missing keys defaulted.
    ``kind`` may be a reference Type string or an int code."""
    bad = set(kw) - set(_DEFAULTS)
    if bad:
        raise ValueError(f"unknown material parameters: {sorted(bad)}")
    row = dict(_DEFAULTS)
    row.update(kw)
    if isinstance(row["kind"], str):
        row["kind"] = KIND_NAMES[row["kind"]]
    return row


def material_table(rows: Sequence[dict], device="cuda") -> MaterialTable:
    dt = config.dtype()
    cols = {}
    for name in _DEFAULTS:
        vals = [r[name] for r in rows]
        cols[name] = torch.tensor(
            vals, dtype=torch.int32 if name == "kind" else dt, device=device
        )
    return MaterialTable(**cols)


def lame_parameters(E, nu):
    """(lambda, G) from (E, nu) as used throughout the models."""
    G = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return lam, G


def bulk_shear(E, nu):
    K = E / (3.0 * (1.0 - 2.0 * nu))
    G = E / (2.0 * (1.0 + nu))
    return K, G
