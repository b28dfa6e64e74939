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
from .shapefun.alme import ALMEParams
from .shapefun.femesh import FEMesh
from .shapefun.lme import LMEParams
from .parallel import domain
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


# the FEMesh fields that are host values (kind, the bin grids' geometry, the
# length scales), not arrays
_FEMESH_STATIC = ("kind", "bin_origin", "bin_spacing", "bin_dims", "spacing", "h_avg",
                  "nbin_origin", "nbin_spacing", "nbin_dims")


def femesh_from_numpy(fields: dict, device="cuda") -> FEMesh:
    """The port's FEMesh from every field of the JAX package's: the arrays
    as numpy (dtypes kept), the static fields (kind, bin grids, spacing,
    h_avg) as host values; None stays None."""
    names = _fields(FEMesh)
    missing = [n for n in names if n not in fields]
    extra = [n for n in fields if n not in names]
    if missing or extra:
        raise ValueError(f"FEMesh: missing fields {missing}, unknown fields {extra}")

    def one(name, v):
        if v is None or name == "kind":
            return v
        if name in _FEMESH_STATIC:
            return tuple(v) if isinstance(v, (tuple, list)) else float(v)
        return torch.as_tensor(np.array(v), device=device)

    return FEMesh(**{n: one(n, fields[n]) for n in names})


def _config_from_fields(cls, fields: dict):
    """A port config from the static fields of the JAX package's config
    (``dataclasses.asdict``-style dict, nested ``lme_params``,
    ``alme_params`` and ``active_box`` as dicts or objects with the same
    attribute names).  The transfer name ``'pallas'`` becomes ``'fused'``;
    a field the port's config does not have raises ``ValueError``."""

    def sub(sub_cls, v):
        if v is None or isinstance(v, sub_cls):
            return v
        get = v.get if isinstance(v, dict) else lambda k: getattr(v, k)
        return sub_cls(**{n: get(n) for n in _fields(sub_cls)})

    kw = dict(fields)
    kw["lme_params"] = sub(LMEParams, kw.get("lme_params")) or LMEParams()
    if "alme_params" in kw:
        kw["alme_params"] = sub(ALMEParams, kw["alme_params"])
    box = sub(ActiveBox, kw.get("active_box"))
    if box is not None:
        box = box.replace(offset=tuple(box.offset), cdims=tuple(box.cdims))
    kw["active_box"] = box
    default_transfer = {f.name: f.default for f in dataclasses.fields(cls)}["transfer"]
    kw["transfer"] = _TRANSFER_NAMES.get(kw.get("transfer"), kw.get("transfer", default_transfer))
    kw["kinds"] = tuple(kw.get("kinds", (3,)))
    unknown = [n for n in kw if n not in set(_fields(cls))]
    if unknown:
        raise ValueError(f"config_from_fields: unknown field '{unknown[0]}'")
    return cls(**kw)


def config_from_fields(fields: dict) -> ExplicitConfig:
    """ExplicitConfig from the static fields of the JAX package's
    ExplicitConfig (see :func:`_config_from_fields`)."""
    return _config_from_fields(ExplicitConfig, fields)


def implicit_config_from_fields(fields: dict) -> ImplicitConfig:
    """ImplicitConfig from the static fields of the JAX package's
    ImplicitConfig (see :func:`_config_from_fields`); its ``'pallas'``
    transfer is the port's ``'fused'``."""
    return _config_from_fields(ImplicitConfig, fields)


def upw_config_from_fields(fields: dict) -> UpwConfig:
    """UpwConfig from the static fields of the JAX package's UpwConfig (see
    :func:`_config_from_fields`)."""
    return _config_from_fields(UpwConfig, fields)


def upw_implicit_config_from_fields(fields: dict) -> UpwImplicitConfig:
    """UpwImplicitConfig from the static fields of the JAX package's
    UpwImplicitConfig (see :func:`_config_from_fields`)."""
    return _config_from_fields(UpwImplicitConfig, fields)


def up_config_from_fields(fields: dict) -> UpConfig:
    """UpConfig from the static fields of the JAX package's UpConfig (see
    :func:`_config_from_fields`)."""
    return _config_from_fields(UpConfig, fields)


def dem_config_from_fields(fields: dict) -> DEMConfig:
    """DEMConfig from the static fields of the JAX package's DEMConfig (see
    :func:`_config_from_fields`)."""
    return _config_from_fields(DEMConfig, fields)


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _box(b) -> ActiveBox:
    return ActiveBox(offset=tuple(int(v) for v in _get(b, "offset")),
                     cdims=tuple(int(v) for v in _get(b, "cdims")),
                     capacity=int(_get(b, "capacity")))


def _template_grid(g, device) -> Grid:
    def opt(name):
        v = _get(g, name)
        return None if v is None else np.asarray(v)

    return grid_from_numpy(_get(g, "dims"), _get(g, "spacing"), _get(g, "origin"),
                           active=opt("active"), dirichlet_mask=opt("dirichlet_mask"),
                           dirichlet_value=opt("dirichlet_value"), valid_lo=opt("valid_lo"),
                           valid_hi=opt("valid_hi"), device=device)


def decomp_from_fields(dec, comm=None, device="cuda") -> "domain.Decomp":
    """The port's 1-D :class:`~.parallel.domain.Decomp` from the JAX
    package's (its fields as attributes or dict keys; its axis name becomes
    ``comm``, the group of this process)."""
    sp = _get(dec, "spec")
    spec = domain.HaloSpec(n_shards=int(_get(sp, "n_shards")), wlo=int(_get(sp, "wlo")),
                           whi=int(_get(sp, "whi")), bc=int(_get(sp, "bc")),
                           ln=int(_get(sp, "ln")), comm=comm)
    return domain.Decomp(spec=spec, global_grid=_template_grid(_get(dec, "global_grid"), device),
                         global_box=_box(_get(dec, "global_box")),
                         local_grid=_template_grid(_get(dec, "local_grid"), device),
                         local_box=_box(_get(dec, "local_box")),
                         mig_capacity=int(_get(dec, "mig_capacity")),
                         margin=int(_get(dec, "margin")))


def decomp2_from_fields(dec, comm=None, device="cuda") -> "domain.Decomp2":
    """The port's :class:`~.parallel.domain.Decomp2` from the JAX package's
    2-D decomposition (see :func:`decomp_from_fields`)."""
    sp = _get(dec, "spec")

    def tup(name):
        return tuple(int(v) for v in _get(sp, name))

    spec = domain.HaloSpec2(shards=tup("shards"), wlo=tup("wlo"), whi=tup("whi"), bc=tup("bc"),
                            ln=tup("ln"), comm=comm)
    return domain.Decomp2(spec=spec, global_grid=_template_grid(_get(dec, "global_grid"), device),
                          global_box=_box(_get(dec, "global_box")),
                          local_grid=_template_grid(_get(dec, "local_grid"), device),
                          local_box=_box(_get(dec, "local_box")), margin=int(_get(dec, "margin")))
