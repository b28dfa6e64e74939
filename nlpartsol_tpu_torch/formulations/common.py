"""Shared step machinery: shape-function dispatch + transfer-engine build
(counterpart of ``nlpartsol_tpu/formulations/common.py``).

A step's background is a structured :class:`~..types.Grid` or an
unstructured :class:`~..shapefun.femesh.FEMesh`; a mesh has no slot layout,
so it runs on the scatter engine only (:func:`check_background`)."""

from __future__ import annotations

import torch

from ..ops import transfer, windowed
from ..shapefun import alme, fem, femesh, gimp, lme
from ..types import Grid

def check_background(cfg, grid):
    """A FEMesh takes ``transfer='scatter'`` only: the other engines need a
    Grid's cells (``windowed.require_grid``); anything that is neither a
    Grid nor a FEMesh is refused."""
    if not isinstance(grid, (Grid, femesh.FEMesh)):
        raise TypeError(f"the background must be a Grid or a FEMesh, not {type(grid).__name__}")
    if cfg.transfer != "scatter":
        windowed.require_grid(grid, f"transfer '{cfg.transfer}'")


def binned_refused():
    """The error of ``transfer='binned'``: the JAX package's bin-pair engine
    is on the do-not-port list (ROADMAP.md queue 2)."""
    return NotImplementedError(
        "transfer 'binned' (the JAX package's bin-pair engine) is on the do-not-port "
        "list, ROADMAP.md queue 2: use transfer='scatter' on a FEMesh")


def shapefun_eval(cfg, grid, p):
    """Evaluate the configured shape functions.  Returns (sf dict,
    offsets (K, d) static numpy array, None on a FEMesh)."""
    check_background(cfg, grid)
    if isinstance(grid, femesh.FEMesh):
        # isoparametric elements or meshfree LME over the node cloud; the
        # scatter engine routes P2G/G2P through the node_ids pattern
        if cfg.shapefun == "fem":
            return femesh.evaluate(grid, p.x), None
        if cfg.shapefun == "lme":
            return femesh.evaluate_lme(grid, p.x, p.lme_lambda, cfg.lme_params), None
        raise ValueError("unstructured background meshes support shapefun='fem' or 'lme'")
    check_shapefun(cfg)
    if cfg.shapefun == "lme":
        sf = lme.evaluate(grid, p.x, p.lme_lambda, cfg.lme_params)
        return sf, lme.offsets_for(grid.dim, cfg.lme_params)
    if cfg.shapefun == "fem":
        return fem.evaluate(grid, p.x), fem.offsets_for(grid.dim)
    if cfg.shapefun == "gimp":
        # l_p ≤ h is checked once by the driver, not in every step
        lp = gimp.voxel_halfwidth(p.vol0, grid.dim)
        return gimp.evaluate(grid, p.x, lp), gimp.offsets_for(grid.dim)
    sf = alme.evaluate(grid, p.x, p.lme_lambda, p.lme_beta, cfg.alme_params)
    return sf, alme.offsets_for(grid.dim, cfg.alme_params)


def check_shapefun(cfg):
    """'lme' on every engine; 'fem', 'gimp' and 'alme' on the windowed and
    scatter engines only, since the fused kernels compute the LME basis (as
    the JAX package's do)."""
    if cfg.shapefun not in ("lme", "fem", "gimp", "alme"):
        raise ValueError(f"unknown shapefun {cfg.shapefun}")
    if cfg.shapefun == "alme" and getattr(cfg, "alme_params", None) is None:
        raise ValueError("shapefun 'alme' needs cfg.alme_params (shapefun.alme.ALMEParams)")
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
        if getattr(cfg, "halo", None) is not None:
            # a rank's strip of a block-partitioned grid (parallel/domain.py);
            # grid and active_box are the local templates
            return transfer.HaloEngine(grid, cfg.active_box, offsets, mask, cfg.halo)
        return transfer.WindowedEngine(grid, cfg.active_box, offsets, mask, cfg.axis_name)
    if cfg.transfer == "scatter":
        return transfer.ScatterEngine(grid, sf["node_ids"], mask, cfg.axis_name)
    if cfg.transfer == "binned":
        raise binned_refused()
    raise ValueError(f"unknown transfer {cfg.transfer}")


def found_lost(sf, act):
    """Particles a FEMesh could not locate (``found`` flag) — counted into
    the ``lost`` diagnostic, so run_simulation's loss check fires instead
    of the particles freezing silently."""
    if sf.get("found") is not None:
        return torch.sum(act & ~sf["found"], dtype=torch.int32)
    return torch.zeros((), dtype=torch.int32, device=act.device)


def _same(f):
    return f


def halo_ops(cfg):
    """(complete, fill) of the fused steps' node fields on a rank's strip
    (``cfg.halo``, parallel/domain.py): the halo add after a scatter, the
    ghost-plane fill before a gather; identities without a halo."""
    halo = getattr(cfg, "halo", None)
    if halo is None:
        return _same, _same
    from ..parallel import domain

    return (lambda f: domain.halo_exchange_add(f, halo)), (lambda f: domain.halo_fill(f, halo))


def global_sums(cfg, *scalars):
    """A step's diagnostics summed over ``cfg.axis_name``'s group (one
    all-reduce for all of them); as they are on one device."""
    if getattr(cfg, "axis_name", None) is None:
        return scalars
    from ..parallel.collectives import all_sum

    return tuple(all_sum(list(scalars), cfg.axis_name))


def check_rebin_mode(cfg, modes=("local", "global", "none")):
    """'none' (the sharded drivers re-bin by their migration) is the fused
    engine's under a halo."""
    if cfg.rebin_mode not in modes:
        raise ValueError(f"unknown rebin_mode {cfg.rebin_mode}")
