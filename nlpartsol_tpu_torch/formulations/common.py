"""Shared step machinery: shape-function dispatch + transfer-engine build
(counterpart of ``nlpartsol_tpu/formulations/common.py``)."""

from __future__ import annotations

import torch

from ..ops import transfer
from ..shapefun import fem, lme
from ..types import Grid


def shapefun_eval(cfg, grid, p):
    """Evaluate the configured shape functions.  Returns (sf dict,
    offsets (K, d) static numpy array)."""
    if not isinstance(grid, Grid):
        raise NotImplementedError(
            "unstructured background meshes are not ported yet: ROADMAP.md "
            "queue 1, 'Other shape functions, engines and integrators'"
        )
    check_shapefun(cfg)
    if cfg.shapefun == "lme":
        sf = lme.evaluate(grid, p.x, p.lme_lambda, cfg.lme_params)
        return sf, lme.offsets_for(grid.dim, cfg.lme_params)
    return fem.evaluate(grid, p.x), fem.offsets_for(grid.dim)


def check_shapefun(cfg):
    """'lme' on both engines; 'fem' on the windowed engine only, since the
    fused kernels compute the LME basis (as the JAX package's do)."""
    if cfg.shapefun in ("gimp", "alme"):
        raise NotImplementedError(
            f"shapefun '{cfg.shapefun}' is not ported yet: ROADMAP.md queue 1, "
            "item 13, 'Other shape functions, engines and integrators'"
        )
    if cfg.shapefun not in ("lme", "fem"):
        raise ValueError(f"unknown shapefun {cfg.shapefun}")
    if cfg.shapefun != "lme" and cfg.transfer == "fused":
        raise ValueError(
            f"the fused transfer implements LME only, not shapefun '{cfg.shapefun}': "
            "use transfer='windowed'"
        )


def make_engine(cfg, grid, sf, offsets, mask):
    if cfg.transfer == "fused":
        # Steps that dispatch to the fused kernels do so BEFORE calling
        # make_engine; any step reaching here with 'fused' has no fused path.
        raise ValueError(
            f"{type(cfg).__name__} has no fused transfer path; use "
            "transfer='windowed' (same physics, slot-layout engine)"
        )
    if cfg.transfer == "windowed":
        if cfg.active_box is None:
            raise ValueError("windowed transfer requires cfg.active_box")
        return transfer.WindowedEngine(grid, cfg.active_box, offsets, mask)
    if cfg.transfer == "scatter":
        return transfer.ScatterEngine(grid, sf["node_ids"], mask)
    if cfg.transfer == "binned":
        raise NotImplementedError(
            "transfer 'binned' is not ported yet: ROADMAP.md queue 1, item 13, "
            "'Other shape functions, engines and integrators'"
        )
    raise ValueError(f"unknown transfer {cfg.transfer}")


def found_lost(sf, act):
    """Particles a background mesh could not locate (``found`` flag) —
    counted into the ``lost`` diagnostic so loss is loud, never silent."""
    if sf.get("found") is not None:
        return torch.sum(act & ~sf["found"], dtype=torch.int32)
    return torch.zeros((), dtype=torch.int32, device=act.device)
