"""CFL time-step control (counterpart of
``nlpartsol_tpu/formulations/courant.py``).

Δt = CFL · h / c_max with c the material celerity; the velocity-augmented
variant is provided for completeness.
"""

from __future__ import annotations

import math

import torch


def courant_dt(cfl: float, h: float, cel: float) -> float:
    """Static Δt."""
    return cfl * h / cel


def courant_dt_dynamic(cfl: float, h: float, cel: float, vel: torch.Tensor) -> torch.Tensor:
    """Velocity-augmented Δt."""
    cmax = cel + torch.max(torch.abs(vel))
    return cfl * h / cmax


def celerity(E: float, rho: float) -> float:
    """1D elastic wave speed sqrt(E/ρ)."""
    return math.sqrt(E / rho)
