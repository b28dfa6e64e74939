"""Carry state across from numpy.

The system has no weights: its state is the particle SoA, the grid and the
material table.  These functions build the port's records from plain numpy
arrays — e.g. the fields of the JAX package's objects pulled out with
``np.asarray`` — and back.  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .formulations.dem import DEMConfig
from .formulations.explicit import ExplicitConfig
from .formulations.implicit import ImplicitConfig
from .formulations.up import UpConfig
from .formulations.upw import MixtureTable, UpwConfig, UpwImplicitConfig
from .models.materials import MaterialTable
from .ops.windowed import ActiveBox
from .shapefun.lme import LMEParams
from .types import Grid, Particles

_TRANSFER_NAMES = {"pallas": "fused"}


def _fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


def _from_dict(cls, arrays: dict, device):
    names = _fields(cls)
    missing = [n for n in names if n not in arrays]
    extra = [n for n in arrays if n not in names]
    if missing or extra:
        raise ValueError(
            f"{cls.__name__}: missing fields {missing}, unknown fields {extra}"
        )
    return cls(**{n: torch.as_tensor(np.array(arrays[n]), device=device) for n in names})


def particles_from_numpy(arrays: dict, device="cuda") -> Particles:
    """Particles from a dict with one numpy array per field (dtypes kept)."""
    return _from_dict(Particles, arrays, device)


def particles_to_numpy(p: Particles) -> dict:
    return {n: getattr(p, n).detach().cpu().numpy() for n in _fields(Particles)}


def materials_from_numpy(arrays: dict, device="cuda") -> MaterialTable:
    """MaterialTable from a dict with one (Nmat,) numpy array per parameter."""
    return _from_dict(MaterialTable, arrays, device)


def mixture_from_numpy(arrays: dict, device="cuda") -> MixtureTable:
    """MixtureTable from a dict with one (Nmix,) numpy array per field."""
    return _from_dict(MixtureTable, arrays, device)


def _bound(v):
    """valid_lo / valid_hi: None, a scalar (axis 0 only) or a (d,) array."""
    if v is None:
        return None
    a = np.asarray(v).reshape(-1)
    return int(a[0]) if a.shape[0] == 1 else tuple(int(b) for b in a)


def grid_from_numpy(
    dims,
    spacing,
    origin,
    active=None,
    dirichlet_mask=None,
    dirichlet_value=None,
    valid_lo=None,
    valid_hi=None,
    device="cuda",
) -> Grid:
    def opt(a):
        return None if a is None else torch.as_tensor(np.array(a), device=device)

    return Grid(
        dims=tuple(int(n) for n in dims),
        spacing=float(spacing),
        origin=tuple(float(o) for o in origin),
        active=opt(active),
        dirichlet_mask=opt(dirichlet_mask),
        dirichlet_value=opt(dirichlet_value),
        valid_lo=_bound(valid_lo),
        valid_hi=_bound(valid_hi),
    )


def _config_from_fields(cls, fields: dict, waiting: dict):
    """A port config from the static fields of the JAX package's config
    (``dataclasses.asdict``-style dict, nested ``lme_params`` and
    ``active_box`` as dicts or objects with the same attribute names).  The
    transfer name ``'pallas'`` becomes ``'fused'``; fields the port does not
    have (``waiting``: name → default) must hold their defaults."""

    def sub(sub_cls, v):
        if v is None or isinstance(v, sub_cls):
            return v
        get = v.get if isinstance(v, dict) else lambda k: getattr(v, k)
        return sub_cls(**{n: get(n) for n in _fields(sub_cls)})

    kw = dict(fields)
    kw["lme_params"] = sub(LMEParams, kw.get("lme_params")) or LMEParams()
    box = sub(ActiveBox, kw.get("active_box"))
    if box is not None:
        box = box.replace(offset=tuple(box.offset), cdims=tuple(box.cdims))
    kw["active_box"] = box
    default_transfer = {f.name: f.default for f in dataclasses.fields(cls)}["transfer"]
    kw["transfer"] = _TRANSFER_NAMES.get(kw.get("transfer"), kw.get("transfer", default_transfer))
    kw["kinds"] = tuple(kw.get("kinds", (3,)))
    own = set(_fields(cls))
    for name in [n for n in kw if n not in own]:
        if name not in waiting:
            raise ValueError(f"config_from_fields: unknown field '{name}'")
        if kw[name] != waiting[name]:
            raise NotImplementedError(
                f"config field '{name}'={kw[name]!r} is not ported yet (see ROADMAP.md)"
            )
        del kw[name]
    return cls(**kw)


def config_from_fields(fields: dict) -> ExplicitConfig:
    """ExplicitConfig from the static fields of the JAX package's
    ExplicitConfig (see :func:`_config_from_fields`)."""
    # options of the reference that the port has not reached yet
    waiting = {"alme_params": None, "beps_reach": 1, "ga_rb": 0.6, "prebinned": False}
    return _config_from_fields(ExplicitConfig, fields, waiting)


def implicit_config_from_fields(fields: dict) -> ImplicitConfig:
    """ImplicitConfig from the static fields of the JAX package's
    ImplicitConfig (see :func:`_config_from_fields`); its ``'pallas'``
    transfer is the port's ``'fused'``."""
    waiting = {"alme_params": None, "beps_reach": 1}
    return _config_from_fields(ImplicitConfig, fields, waiting)


def upw_config_from_fields(fields: dict) -> UpwConfig:
    """UpwConfig from the static fields of the JAX package's UpwConfig (see
    :func:`_config_from_fields`)."""
    return _config_from_fields(UpwConfig, fields, {"alme_params": None, "prebinned": False})


def upw_implicit_config_from_fields(fields: dict) -> UpwImplicitConfig:
    """UpwImplicitConfig from the static fields of the JAX package's
    UpwImplicitConfig (see :func:`_config_from_fields`)."""
    return _config_from_fields(UpwImplicitConfig, fields,
                               {"alme_params": None, "prebinned": False})


def up_config_from_fields(fields: dict) -> UpConfig:
    """UpConfig from the static fields of the JAX package's UpConfig (see
    :func:`_config_from_fields`)."""
    return _config_from_fields(UpConfig, fields, {"alme_params": None, "prebinned": False})


def dem_config_from_fields(fields: dict) -> DEMConfig:
    """DEMConfig from the static fields of the JAX package's DEMConfig (see
    :func:`_config_from_fields`)."""
    return _config_from_fields(DEMConfig, fields, {"alme_params": None, "prebinned": False})
