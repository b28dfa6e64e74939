"""Nonlocal fracture: Eigenerosion and Eigensoftening with Beps
particle-neighbourhoods.

Counterpart of ``nlpartsol_tpu/models/fracture.py``:

* Eigenerosion (Pandolfi–Ortiz): per-particle energy-release rate from the
  Beps-neighbourhood volume average of W, binary erosion when G_p > Gf.
* Eigensoftening: a nonlocal equivalent tensile stress against ft triggers
  a cohesive softening law on the largest principal Almansi strain.
* Beps: the particles within Ceps·ΔX of p.

The Beps sums run on the windowed slot layout without lists or gathers:
for each cell offset of the (2R+1)^d neighbourhood the shifted slot block
is pairwise-distance-masked against the local block and reduced, one dense
(cells, C, C) contraction per offset.  Plain tensor code, as in the JAX
package (no Pallas kernel there either).

The two documented deviations of the JAX module from the C reference are
kept: the tension gate uses the LARGEST principal stress (ascending
eigenvalues, index −1), and the eigensoftening neighbour sum accumulates
m_q·T1_q over the neighbourhood.

Every per-particle value entering a neighbour sum is selected with
``torch.where`` (never multiplied by a mask), so a non-finite value on an
idle slot never reaches a sum.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import tensor as tn
from ..ops.windowed import ActiveBox, require_grid
from ..types import Grid

Tensor = torch.Tensor


def almansi_strain(F: Tensor) -> Tensor:
    """Eulerian Almansi strain e = ½(I − b⁻¹), b = F·Fᵀ."""
    d = F.shape[-1]
    b = tn.bmm_t(F, F)
    return 0.5 * (torch.eye(d, dtype=F.dtype, device=F.device) - tn.inv(b))


def max_principal(sym_t: Tensor, zz: Tensor = None) -> Tensor:
    """Largest principal value of a symmetric tensor (and of the plane-strain
    zz component, when given)."""
    w, _ = tn.sym_eig(sym_t)
    w_max = w[..., -1]
    if zz is not None:
        w_max = torch.maximum(w_max, zz)
    return w_max


def _shift(arr: Tensor, off, cshape) -> Tensor:
    """out[c] = arr[c + off] over the leading cell axes, zero outside."""
    out = torch.zeros_like(arr)
    dst, src = [], []
    for o, n in zip(off, cshape):
        o = int(o)
        dst.append(slice(max(0, -o), min(n, n - o)))
        src.append(slice(max(0, o), min(n, n + o)))
    if all(s.start < s.stop for s in dst):
        out[tuple(dst)] = arr[tuple(src)]
    return out


def neighbor_offsets(dim: int, reach: int) -> np.ndarray:
    """The (2·reach+1)^dim cell offsets of the Beps sweep, C-order."""
    rng = list(range(-reach, reach + 1))
    return np.stack(np.meshgrid(*([rng] * dim), indexing="ij"), -1).reshape(-1, dim)


def _neighbor_pair_sums(
    grid: Grid,
    box: ActiveBox,
    x_slots: Tensor,  # (Ns, d) positions in slot layout
    valid: Tensor,  # (Ns,) bool
    values: dict,  # name -> (Ns,) per-particle values to sum over neighbours
    radius: Tensor,  # (Ns,) per-particle interaction radius
    reach: int = 1,  # static cell reach of the largest radius
):
    """Σ_q value_q over the neighbours q with |x_p − x_q| ≤ radius_p (q
    includes p itself), one cell offset at a time with dense pairwise masks.
    Returns a dict of (Ns,) sums in slot layout."""
    d = grid.dim
    C = box.capacity
    cshape = tuple(box.cdims)
    nd = len(cshape)

    def to_cellmajor(a):
        # capacity-major slots (C, cells…) → internal (cells…, C) view
        v = a.reshape((C,) + cshape + tuple(a.shape[1:]))
        return torch.movedim(v, 0, nd)

    xs = to_cellmajor(x_slots)  # (cells…, C, d)
    vmask = to_cellmajor(valid)
    rad2 = to_cellmajor(radius) ** 2
    vals = {k: to_cellmajor(v) for k, v in values.items()}
    zero = torch.zeros((), dtype=x_slots.dtype, device=x_slots.device)
    out = {k: torch.zeros(cshape + (C,), dtype=x_slots.dtype, device=x_slots.device)
           for k in values}

    for off in neighbor_offsets(d, reach):
        xq = _shift(xs, off, cshape)  # (cells…, C, d)
        vq = _shift(vmask, off, cshape)
        # pairwise distances between the local slots (axis -2 ≡ p) and the
        # shifted ones (axis -1 ≡ q): (cells…, C, C)
        diff = xs[..., :, None, :] - xq[..., None, :, :]
        dist2 = torch.sum(diff * diff, dim=-1)
        within = (dist2 <= rad2[..., :, None]) & vq[..., None, :] & vmask[..., :, None]
        for k in vals:
            vq_k = _shift(vals[k], off, cshape)
            out[k] = out[k] + torch.sum(torch.where(within, vq_k[..., None, :], zero), dim=-1)
    # internal (cells…, C) view → capacity-major flat slots
    return {k: torch.movedim(v, nd, 0).reshape(-1) for k, v in out.items()}


def beps_reach(Ceps: float) -> int:
    """Static cell reach for the Beps radius Ceps·ΔX (cell size = ΔX)."""
    return int(math.ceil(float(Ceps)))


class DamageOut(NamedTuple):
    damage: Tensor
    strain_f: Tensor


def eigenerosion(
    grid: Grid,
    box: ActiveBox,
    *,
    x,
    active,
    damage_n,
    W,
    J_n1,
    vol0,
    stress,
    stress_zz,
    Ceps,
    Gf,
    reach: int,
) -> DamageOut:
    """Pandolfi–Ortiz eigenerosion on slot-layout particle arrays."""
    dx = grid.spacing
    zero = torch.zeros((), dtype=vol0.dtype, device=vol0.device)
    V = vol0 * J_n1
    intact = damage_n < 1.0
    sums = _neighbor_pair_sums(
        grid, box, x, active,
        {"V": torch.where(active, V, zero), "VW": torch.where(active & intact, V * W, zero)},
        radius=Ceps * dx * torch.ones_like(V),
        reach=reach,
    )
    G_p = (Ceps * dx / torch.clamp(sums["V"], min=1e-30)) * sums["VW"]
    tension = max_principal(stress, stress_zz) > 0.0
    erode = intact & tension & (G_p > Gf)
    damage_n1 = torch.where(erode, torch.ones_like(damage_n), damage_n)
    return DamageOut(damage=damage_n1, strain_f=torch.zeros_like(damage_n1))


def eigensoftening(
    grid: Grid,
    box: ActiveBox,
    *,
    x,
    active,
    damage_n,
    strain_f_n,
    mass,
    F_n1,
    stress,
    stress_zz,
    ft,
    heps,
    wcrit,
    Ceps,
    reach: int,
) -> DamageOut:
    """Nonlocal cohesive eigensoftening on slot-layout particle arrays.
    Idle slots (F = 0 once emptied) take the Almansi strain of the identity,
    so nothing non-finite is computed there."""
    dx = grid.spacing
    zero = torch.zeros((), dtype=mass.dtype, device=mass.device)
    T1 = max_principal(stress, stress_zz)
    intact = damage_n < 1.0
    sums = _neighbor_pair_sums(
        grid, box, x, active,
        {"m": torch.where(active, mass, zero), "mT": torch.where(active & intact, mass * T1, zero)},
        radius=Ceps * dx * torch.ones_like(mass),
        reach=reach,
    )
    Teps = sums["mT"] / torch.clamp(sums["m"], min=1e-30)

    eye = torch.eye(F_n1.shape[-1], dtype=F_n1.dtype, device=F_n1.device)
    e1 = max_principal(almansi_strain(torch.where(active[:, None, None], F_n1, eye)))
    # Phase 1: an un-failed particle under tension crosses ft ⇒ record the
    # failure strain.  Phase 2: with a recorded strain, damage grows with the
    # cohesive law (heps/wcrit).
    trigger = (damage_n == 0.0) & (T1 > 0.0) & (Teps > ft) & (strain_f_n == 0.0)
    strain_f_n1 = torch.where(trigger, e1, strain_f_n)
    softening = (damage_n < 1.0) & (strain_f_n > 0.0)
    dmg_soft = torch.clamp((e1 - strain_f_n) * heps / wcrit, 0.0, 1.0)
    damage_n1 = torch.where(softening, torch.maximum(dmg_soft, damage_n), damage_n)
    return DamageOut(damage=damage_n1, strain_f=strain_f_n1)


def damage_update(p, grid, box, damage, mats, act, cs, J_n1, F_n1, reach, halo=None):
    """The configured driver's (damage, strain_f) at n+1 from the slot-layout
    state ``p`` and the constitutive result ``cs`` (the JAX package's
    ``explicit._damage_update``).  With ``halo`` (a rank's strip,
    parallel/domain.py) the Beps sums run on slot arrays extended by
    ``reach`` ghost cell planes a seam, filled from the neighbours, so a
    neighbourhood across a seam is whole."""
    require_grid(grid, "the Beps sums of a fracture driver")
    if halo is not None:
        return _damage_update_halo(p, grid, box, damage, mats, act, cs, J_n1, F_n1, reach,
                                   halo)
    mid = p.mat_id.long()
    if damage == "eigenerosion":
        return eigenerosion(
            grid, box, x=p.x, active=act, damage_n=p.damage, W=cs.W, J_n1=J_n1,
            vol0=p.vol0, stress=cs.tau, stress_zz=cs.tau_zz, Ceps=mats.Ceps[mid],
            Gf=mats.Gf[mid], reach=reach,
        )
    if damage == "eigensoftening":
        return eigensoftening(
            grid, box, x=p.x, active=act, damage_n=p.damage, strain_f_n=p.strain_f,
            mass=p.mass, F_n1=F_n1, stress=cs.tau, stress_zz=cs.tau_zz, ft=mats.ft[mid],
            heps=mats.heps[mid], wcrit=mats.wcrit[mid], Ceps=mats.Ceps[mid], reach=reach,
        )
    raise ValueError(f"unknown damage driver {damage}")


def _damage_update_halo(p, grid, box, damage, mats, act, cs, J_n1, F_n1, reach, halo):
    from ..parallel import domain

    d = p.dim
    n = act.shape[0]
    mid = p.mat_id.long()
    arrs = dict(
        x=p.x, active=act.to(p.x.dtype), damage=p.damage, strain_f=p.strain_f,
        vol0=p.vol0, mass=p.mass, W=cs.W, J=J_n1, stress=cs.tau.reshape(n, d * d),
        stress_zz=cs.tau_zz, F=F_n1.reshape(n, d * d), Ceps=mats.Ceps[mid], Gf=mats.Gf[mid],
        ft=mats.ft[mid], heps=mats.heps[mid], wcrit=mats.wcrit[mid],
    )
    ext, ext_box = domain.slot_plane_halo(arrs, halo, box, reach, grid.spacing)
    ne = ext["x"].shape[0]
    eact = ext["active"] > 0.5
    if damage == "eigenerosion":
        out = eigenerosion(
            grid, ext_box, x=ext["x"], active=eact, damage_n=ext["damage"], W=ext["W"],
            J_n1=ext["J"], vol0=ext["vol0"], stress=ext["stress"].reshape(ne, d, d),
            stress_zz=ext["stress_zz"], Ceps=ext["Ceps"], Gf=ext["Gf"], reach=reach,
        )
    elif damage == "eigensoftening":
        out = eigensoftening(
            grid, ext_box, x=ext["x"], active=eact, damage_n=ext["damage"],
            strain_f_n=ext["strain_f"], mass=ext["mass"], F_n1=ext["F"].reshape(ne, d, d),
            stress=ext["stress"].reshape(ne, d, d), stress_zz=ext["stress_zz"], ft=ext["ft"],
            heps=ext["heps"], wcrit=ext["wcrit"], Ceps=ext["Ceps"], reach=reach,
        )
    else:
        raise ValueError(f"unknown damage driver {damage}")
    return DamageOut(damage=domain.slot_plane_restrict(out.damage, halo, box, reach),
                     strain_f=domain.slot_plane_restrict(out.strain_f, halo, box, reach))
