"""Simulation driver: runs a SimulationSetup end-to-end with outputs.

Counterpart of ``nlpartsol_tpu/driver.py`` (the analog of the reference's
per-scheme driver functions dispatched from driver-nl-partsol.c:349-379):
the same arguments, defaults, output schedule and history keys.  It owns
the time loop, feeds per-step curve values (Dirichlet, gravity, tractions)
into the step, and writes VTK/CSV results every ``out_every`` steps.

The JAX package's transfer name ``'pallas'`` is the port's ``'fused'`` (the
CUDA kernels); ``transfer='auto'`` picks it for every eligible deck by the
JAX package's rule (:func:`make_step_config`), the windowed engine
otherwise.

The JAX loop runs ``lax.scan`` chunks between output events; here a Python
loop over the steps of a chunk, with nothing read back to the host inside
it: per-step Dirichlet values are an ``einsum`` of the stacked curve table's
column with the group masks on the device, traction tables are indexed
through the stable particle id ``pid``, and ``lost``, the energies and the
Newton diagnostics are stacked on the device and read once per chunk.

Nonlocal fracture (``Fracture-Modulus``) runs on the explicit NPC-FS and
Newmark-β schemes of the -u formulation, on the windowed or fused engine,
at a re-bin every step (the Beps sweep assumes particles in their slot
cells).  uGIMP decks are checked once for l_p ≤ h; aLME decks take their
``ALMEParams`` from the deck's shape-function block and start from β₀ where
the state carries none (the JAX driver leaves ``alme_params`` unset).

An unstructured background (a ``FEMesh`` from a non-Cartesian GiD mesh)
has no slot layout: every route runs on the scatter engine there, as in the
JAX driver, with dt from the mesh's smallest element edge, no default box,
and the particles no element holds counted as lost.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from . import config
from .formulations.courant import courant_dt
from .formulations.explicit import ExplicitConfig, explicit_step, to_slot_layout
from .formulations.implicit import ImplicitConfig, implicit_step
from .io import csv_out, vtk
from .io.builder import SimulationSetup
from .io.checkpoint import load_checkpoint, save_checkpoint
from .models import fracture as fracture_mod
from .ops import windowed
from .shapefun import alme as alme_mod
from .shapefun import gimp as gimp_mod
from .shapefun import lme as lme_mod
from .shapefun.femesh import FEMesh
from .types import Grid
from .utils import profiling

EXPLICIT_SCHEMES = {"NPC-FS", "Verlet"}
# momentum-form forward Euler and Generalized-alpha run through the
# windowed engine with their own step functions (U-Forward-Euler.c:19,
# U-Generalized-Alpha.c:18; dispatched from driver-nl-partsol.c:349-379)
FE_SCHEMES = {"FE", "Forward-Euler"}
GA_SCHEMES = {"Generalized-alpha"}
IMPLICIT_SCHEMES = {"Newmark-beta-Finite-Strains", "Newmark-beta"}
STATIC_SCHEMES = {"Static"}
DEM_SCHEMES = {"Discrete-Energy-Momentum"}


def make_step_config(setup: SimulationSetup, transfer: str = "scatter", active_box=None,
                     dt=None):
    """The step configuration of the deck's scheme and formulation.
    ``transfer``: 'auto' (the fused kernels where eligible, else the
    windowed engine), 'fused', 'windowed' or 'scatter'."""
    sp = setup.solver
    if isinstance(setup.grid, FEMesh):
        transfer = "scatter"  # no slot layout on unstructured meshes
    if transfer == "auto":
        # fused kernels whenever the step is eligible (the check below
        # falls back to the windowed engine otherwise)
        transfer = "fused"
    if dt is None:
        if sp.cel <= 0:
            raise ValueError("solver Cel (celerity) required to compute dt")
        dt = courant_dt(sp.cfl, setup.grid.spacing, sp.cel)
    shp_kw = {}
    if setup.shapefun == "lme":
        shp_kw["lme_params"] = lme_mod.LMEParams(**setup.shapefun_params)
    if setup.shapefun == "alme":
        shp_kw["alme_params"] = alme_params_of(setup)
    formulation = setup.formulation
    fused_formulations = (
        # -u: explicit + implicit + static + DEM; -upw: explicit + implicit
        # two-phase; -up: implicit/static mixed
        formulation == "u"
        and sp.scheme in (EXPLICIT_SCHEMES | IMPLICIT_SCHEMES | STATIC_SCHEMES | DEM_SCHEMES)
    ) or (
        formulation == "upw" and sp.scheme in EXPLICIT_SCHEMES | IMPLICIT_SCHEMES
    ) or (
        formulation == "up" and sp.scheme in IMPLICIT_SCHEMES | STATIC_SCHEMES
    )
    if transfer == "fused" and (
        not fused_formulations
        or setup.shapefun != "lme"
        or setup.grid.dim not in (2, 3)
        # the fused kernels implement the plain Newton λ-solve only; the
        # Nelder-Mead guarded wrapper routes to the windowed engine
        or str(setup.shapefun_params.get("wrapper", "Newton-Raphson"))
        .lower().replace("_", "-") == "nelder-mead"
    ):
        transfer = "windowed"
    common = dict(
        dt=dt,
        shapefun=setup.shapefun,
        kinds=setup.kinds,
        transfer=transfer,
        active_box=active_box,
        **shp_kw,
    )
    if setup.fracture is not None:
        # the JAX package's checks of a fracture deck, then its route
        if formulation != "u":
            raise ValueError("Fracture-Modulus is wired into the displacement (-u) "
                             "formulations only")
        if sp.scheme in DEM_SCHEMES | FE_SCHEMES | GA_SCHEMES:
            raise ValueError(f"scheme {sp.scheme!r} has no fracture hooks; use the "
                             "explicit or Newmark-beta schemes")
        if transfer == "scatter":
            raise ValueError("fracture drivers need the slot-layout Beps sums: use "
                             "transfer='windowed' or 'fused' on a structured grid")
        ceps_max = float(setup.materials.Ceps.max())
        if ceps_max <= 0:
            raise ValueError("Fracture-Modulus active but no material defines Ceps > 0")
        common.update(damage=setup.fracture, beps_reach=fracture_mod.beps_reach(ceps_max))
    if formulation in ("up", "upw") and sp.scheme in FE_SCHEMES | GA_SCHEMES:
        raise ValueError(
            f"scheme {sp.scheme!r} is a single-phase (-u) integrator; the "
            "mixture formulations support the explicit Verlet and "
            "Newmark-beta schemes only (driver-nl-partsol.c:426-492)"
        )
    if formulation == "up":
        from .formulations.up import UpConfig

        return UpConfig(beta=sp.beta, gamma=sp.gamma, newton_tol=sp.tol,
                        newton_maxiter=sp.max_iter, quasi_static=sp.scheme in STATIC_SCHEMES,
                        **common)
    if formulation == "upw":
        from .formulations.upw import UpwConfig, UpwImplicitConfig

        if sp.scheme in EXPLICIT_SCHEMES:
            return UpwConfig(gamma=sp.gamma, **common)
        return UpwImplicitConfig(beta=sp.beta, gamma=sp.gamma, newton_tol=sp.tol,
                                 newton_maxiter=sp.max_iter, **common)
    if sp.scheme in DEM_SCHEMES:
        from .formulations.dem import DEMConfig

        if setup.neumann:
            raise ValueError(
                "Discrete-Energy-Momentum does not support Neumann traction "
                "loads (dem_step has no traction path); use the Newmark-beta "
                "or explicit schemes"
            )
        return DEMConfig(newton_tol=sp.tol, newton_maxiter=sp.max_iter, **common)
    if sp.scheme in FE_SCHEMES | GA_SCHEMES:
        # forward_euler_step / generalized_alpha_step have no fused path
        if transfer == "fused":
            common["transfer"] = "windowed"
        return ExplicitConfig(
            scheme="FE" if sp.scheme in FE_SCHEMES else "Generalized-alpha",
            ga_rb=sp.rb,
            **common,
        )
    if sp.scheme in EXPLICIT_SCHEMES:
        extra = {}
        if (transfer == "fused" and not setup.neumann and setup.fracture is None
                and setup.grid.dim == 2):
            # (fracture keeps rebin_every = 1, which the step requires: the
            # Beps cell-offset sweep assumes particles sit in their slot cell)
            # adaptive amortised re-bin: start from the largest safe period
            # for the current particle speeds (2x safety margin);
            # run_simulation shrinks it at chunk boundaries as speeds grow,
            # and drift violations in between are counted (local_rebin's lost)
            extra["rebin_every"] = safe_rebin_period(setup.particles.v, setup.grid.spacing, dt)
        return ExplicitConfig(gamma=0.5, **extra, **common)
    if sp.scheme in IMPLICIT_SCHEMES:
        return ImplicitConfig(beta=sp.beta, gamma=sp.gamma, newton_tol=sp.tol,
                              newton_maxiter=sp.max_iter, **common)
    if sp.scheme in STATIC_SCHEMES:
        return ImplicitConfig(quasi_static=True, newton_tol=sp.tol,
                              newton_maxiter=sp.max_iter, **common)
    raise ValueError(f"unknown scheme: {sp.scheme}")


def alme_params_of(setup: SimulationSetup) -> alme_mod.ALMEParams:
    """The deck's aLME parameters (the shape-function block's keys that
    ``ALMEParams`` has)."""
    names = {f.name for f in dataclasses.fields(alme_mod.ALMEParams)}
    return alme_mod.ALMEParams(**{k: v for k, v in setup.shapefun_params.items()
                                  if k in names})


def safe_rebin_period(v, spacing, dt, k_max: int = 16) -> int:
    """Largest power-of-two re-bin period k such that the fastest particle
    drifts at most half a cell between re-binnings (margin-1 kernels
    tolerate 1 cell; the 2x factor absorbs within-period acceleration).
    Powers of two tile the driver's sub-chunks {128, k, 1} exactly.
    k ∈ [1, k_max].  A tensor ``v`` is read once (one host sync)."""
    if isinstance(v, torch.Tensor):
        vmax = float(torch.max(torch.abs(v))) if v.numel() else 0.0
    else:
        vmax = float(np.max(np.abs(np.asarray(v)))) if np.size(v) else 0.0
    if vmax * dt <= 0.0:
        k = k_max
    else:
        k = max(1, min(k_max, int(spacing / (2.0 * vmax * dt))))
    return 1 << (k.bit_length() - 1)


def _step_function(setup, cfg):
    """(step(p, grid, body, traction, t_area, rebin), is_implicit)."""
    mats = setup.materials
    if setup.formulation == "up":
        from .formulations.up import up_step

        return (lambda p, g, body, tr, ta, rebin: up_step(p, g, mats, cfg, body, tr, ta)), True
    if setup.formulation == "upw":
        from .formulations.upw import UpwImplicitConfig, upw_newmark_step, upw_step

        implicit = isinstance(cfg, UpwImplicitConfig)
        fn = upw_newmark_step if implicit else upw_step
        return (lambda p, g, body, tr, ta, rebin: fn(p, g, mats, setup.mixtures, cfg, body)), \
            implicit
    from .formulations.dem import DEMConfig

    if isinstance(cfg, DEMConfig):
        from .formulations.dem import dem_step

        return (lambda p, g, body, tr, ta, rebin: dem_step(p, g, mats, cfg, body)), True
    if isinstance(cfg, ExplicitConfig) and cfg.scheme in FE_SCHEMES:
        from .formulations.integrators import forward_euler_step

        return (lambda p, g, body, tr, ta, rebin:
                forward_euler_step(p, g, mats, cfg, body, tr, ta)), False
    if isinstance(cfg, ExplicitConfig) and cfg.scheme in GA_SCHEMES:
        from .formulations.integrators import generalized_alpha_step

        return (lambda p, g, body, tr, ta, rebin:
                generalized_alpha_step(p, g, mats, cfg, body, cfg.ga_rb, tr, ta)), False
    if isinstance(cfg, ImplicitConfig):
        return (lambda p, g, body, tr, ta, rebin:
                implicit_step(p, g, mats, cfg, body, tr, ta)), True

    def explicit(p, g, body, tr, ta, rebin):
        kw = {} if rebin is None else dict(rebin=rebin)
        return explicit_step(p, g, mats, cfg, body, tr, ta, **kw)

    return explicit, False


def _stack_groups(groups, rows, width, d, device):
    """(G, rows, d) masks and (G, width) curve tables (each curve held at its
    last value) of [(ids, comp, curve)] groups, on the device."""
    masks = np.zeros((len(groups), rows, d), np.float32)
    cl = max(len(c) for _, _, c in groups)
    curves = np.zeros((len(groups), cl))
    for gidx, (ids, comp, curve) in enumerate(groups):
        masks[gidx, ids, comp] = 1.0
        curves[gidx, : len(curve)] = curve
        curves[gidx, len(curve):] = curve[-1]
    dt = config.dtype()
    return (torch.as_tensor(masks, dtype=dt, device=device),
            torch.as_tensor(curves, dtype=dt, device=device))


def run_simulation(
    setup: SimulationSetup,
    transfer: str = "auto",
    active_box=None,
    write_outputs: bool = True,
    n_steps: Optional[int] = None,
    progress: bool = True,
    check_lost: bool = True,
    profile_dir: Optional[str] = None,
    print_convergence: bool = False,
    backup_every: Optional[int] = None,
    resume: Optional[str] = None,
):
    """Run the configured simulation on the device of ``setup.particles``;
    returns (particles, history dict).

    ``backup_every``: write a resumable checkpoint (io/checkpoint.py) to
    ``<out_dir>/backup.npz`` every N steps (overrides the deck's
    ``Out-backup`` key; 0/None = deck value).  ``resume``: path to such a
    snapshot, written by either package — the run continues the ORIGINAL
    schedule from the saved step (the reference's i0/InitialTimeStep
    semantics, Read_GramsTime.c:140, with the state actually loaded).
    ``profile_dir``: a ``torch.profiler`` trace of the run written there.
    """
    device = setup.particles.x.device
    resume_state = None
    if resume:
        resume_state = load_checkpoint(resume, device=device)
        setup.particles = resume_state[0]

    if isinstance(setup.grid, FEMesh):
        # unstructured T3/Q4/T4/H8 background: no cell-window slot layout,
        # the transfers go through the scatter engine
        transfer = "scatter"
    if transfer == "auto":
        transfer = "fused"
    if transfer in ("windowed", "fused") and active_box is None:
        # auto-size: full-grid box, capacity = current max per cell × 2
        active_box = windowed.default_box(setup.grid, setup.particles.x.cpu().numpy(),
                                          setup.particles.active.cpu().numpy())
    cfg = make_step_config(setup, transfer=transfer, active_box=active_box)
    step, is_implicit = _step_function(setup, cfg)

    grid = setup.grid
    p = setup.particles
    if transfer in ("windowed", "fused"):
        p = to_slot_layout(p, grid, active_box, allow_lost=not check_lost)
    if setup.shapefun == "gimp":
        # the uGIMP window of half-width 2 assumes l_p ≤ h
        gimp_mod.check_halfwidth(gimp_mod.voxel_halfwidth(p.vol0, p.dim), grid.spacing)
    if setup.shapefun == "alme" and not bool(torch.any(p.lme_beta != 0)):
        # a state without β starts from the isotropic β₀ = γ/h²·I
        p = p.replace(lme_beta=alme_mod.init_lme_beta(
            p.count, cfg.alme_params, grid.spacing, p.dim, device=device,
            dtype=p.x.dtype))
    n = setup.solver.n_steps if n_steps is None else n_steps
    d = p.dim
    n_nodes = grid.n_nodes
    dt = cfg.dt
    zero_i = torch.zeros((), dtype=torch.int32, device=device)
    zero_f = torch.zeros((), dtype=config.dtype(), device=device)

    # per-step curve tables on the device, read by index inside the loop
    d_masks = d_curves = t_masks = t_curves = area0 = g_table = None
    if setup.dirichlet_nodes:
        d_masks, d_curves = _stack_groups(setup.dirichlet_nodes, n_nodes, d, d, device)
    if setup.neumann:
        # reference: A0 = V0 / thickness in 2D (U-Newmark-beta.c:1440-1444)
        base_vol = setup.particles.vol0.cpu().numpy()
        area0_np = np.zeros(setup.particles.count, np.float64)
        for ids, _, _ in setup.neumann:
            area0_np[ids] = base_vol[ids]
        area0 = torch.as_tensor(area0_np, dtype=config.dtype(), device=device)
        t_masks, t_curves = _stack_groups(setup.neumann, setup.particles.count, d, d, device)
    if setup.gravity is not None:
        g_table = torch.as_tensor(setup.gravity, dtype=config.dtype(), device=device)

    csv_events = list(setup.csv_events or [])
    node_ids = {eidx: torch.as_tensor(ev["ids"], device=device).long()
                for eidx, ev in enumerate(csv_events) if ev["kind"] == "nodes"}
    recorders = [csv_out.PathRecorder(ev["ids"], ev["fields"]) if ev["kind"] == "particles"
                 else csv_out.NodeRecorder(ev["ids"]) for ev in csv_events]

    def one_step(pp, i, rebin):
        g = grid
        if d_curves is not None:
            ci = min(i, d_curves.shape[1] - 1)
            g = grid.replace(dirichlet_value=torch.einsum("g,gnd->nd", d_curves[:, ci], d_masks))
        if g_table is not None:
            body = g_table[min(i, g_table.shape[0] - 1)]
        else:
            body = torch.zeros((d,), dtype=config.dtype(), device=device)
        traction = t_area = None
        if t_curves is not None:
            ci = min(i, t_curves.shape[1] - 1)
            traction = torch.einsum("g,gpd->pd", t_curves[:, ci], t_masks)
            # the tables are in ORIGINAL seeding order and the carry is in
            # slot order: map them through the stable particle identity pid
            pid = torch.clamp(pp.pid, max=traction.shape[0] - 1).long()
            traction = torch.where(pp.active[:, None], traction[pid], zero_f)
            t_area = torch.where(pp.active, area0[pid], zero_f)
        pp, diag = step(pp, g, body, traction, t_area, rebin)
        out = dict(
            lost=diag.get("lost", zero_i),
            kinetic_energy=diag.get("kinetic_energy", zero_f),
            strain_energy=diag.get("strain_energy", zero_f),
            newton_iters=diag.get("newton_iters", 0),
            newton_residual=diag.get("newton_residual", zero_f),
            cg_iters=diag.get("cg_iters", 0),
            converged=diag.get("converged", True),
        )
        react = diag.get("reactions")
        if react is None:
            react = torch.zeros((n_nodes, d), dtype=config.dtype(), device=device)
        for eidx, ids in node_ids.items():
            # nodal-path CSV events: reactions at the recorded node ids
            out[f"react_{eidx}"] = react[ids]
        return pp, react, out

    def run_chunk(pp, j0, L, k):
        """L steps from step j0; with k > 1 the re-bin flags are static and
        the sub-chunk ends freshly re-binned (k−1 plain steps + one re-bin
        step per period, or one re-bin on the last step of a tail L ≤ k)."""
        if k > 1 and L % k != 0:
            assert L <= k, f"sub-chunk of {L} steps exceeds rebin period {k}"
        outs, react = [], None
        for s in range(L):
            if k <= 1:
                rebin = None
            elif L % k == 0:
                rebin = s % k == k - 1
            else:
                rebin = s == L - 1
            pp, react, out = one_step(pp, j0 + s, rebin)
            outs.append(out)
        return pp, react, outs

    history = {"t": [], "kinetic_energy": [], "strain_energy": [], "newton_iters": []}
    os.makedirs(setup.out_dir, exist_ok=True)

    def consume(i_first, outs):
        """One read of the chunk's stacked diagnostics; a loss raises."""
        lost = torch.stack([o["lost"] for o in outs]).cpu().numpy()
        if check_lost and lost.max() > 0:
            i_bad = i_first + int(np.argmax(lost > 0))
            where = ("left every element of the unstructured mesh"
                     if isinstance(grid, FEMesh) else
                     "dropped by the transfer ActiveBox (overflowed cell capacity or "
                     "left the box); re-run with a larger box/capacity "
                     "(windowed.required_capacity)")
            raise RuntimeError(
                f"step {i_bad}: {int(lost.max())} active particles {where}. "
                f"Pass check_lost=False if particles legitimately exit the domain."
            )
        ke = torch.stack([o["kinetic_energy"] for o in outs]).cpu().numpy()
        se = torch.stack([o["strain_energy"] for o in outs]).cpu().numpy()
        if is_implicit and print_convergence:
            res = torch.stack([torch.as_tensor(o["newton_residual"]) for o in outs]).cpu()
            conv = torch.stack([torch.as_tensor(o["converged"]) for o in outs]).cpu()
        for k, o in enumerate(outs):
            i = i_first + k
            history["t"].append((i + 1) * dt)
            if is_implicit:
                history["newton_iters"].append(int(o["newton_iters"]))
                if print_convergence:
                    # reference __monitor (U-Newmark-beta.c:2076-2152):
                    # per-step Newton iteration count, residual norm, reason
                    print(
                        f"  [NR] step {i}: iters={int(o['newton_iters'])} "
                        f"ksp={int(o['cg_iters'])} |R|={float(res[k]):.6e} "
                        f"{'CONVERGED' if bool(conv[k]) else 'DIVERGED'}",
                        flush=True,
                    )
            history["kinetic_energy"].append(float(ke[k]))
            history["strain_energy"].append(float(se[k]))

    stages = profiling.StageTimer()
    prof_ctx = profiling.trace(profile_dir) if profile_dir else contextlib.nullcontext()

    t0 = time.time()
    i0 = setup.solver.i0
    i_end = i0 + n
    backup_every = (int(setup.backup_every or 0) if backup_every is None
                    else int(backup_every))
    if resume_state is not None:
        # continue the ORIGINAL schedule from the saved step (i0 semantics)
        step0 = resume_state[1]
        if not (i0 <= step0 <= i_end):
            raise ValueError(
                f"resume checkpoint at step {step0} outside the schedule "
                f"[{i0}, {i_end}] (i0={i0}, N={n})"
            )
        i0 = step0
        n = i_end - i0
        if n == 0:
            if progress:
                print("resume: schedule already complete")
            return p, history
    # chunk bounds at every output event (VTK multiples of out_every, each
    # backup, each CSV event's schedule) so every emission sees the exact
    # post-step state
    bounds = {i_end - 1}
    bounds.update(s for s in range(i0, i_end) if s % setup.out_every == 0)
    if backup_every:
        bounds.update(s for s in range(i0, i_end) if (s + 1) % backup_every == 0)
    for ev in csv_events:
        bounds.update(
            s
            for s in range(max(i0, ev["i_start"]), min(i_end, ev["i_end"] + 1))
            if (s - ev["i_start"]) % ev["i_step"] == 0
        )
    i = i0
    with prof_ctx:
        for b in sorted(bounds):
            if b < i:
                continue
            t_chunk0 = time.time()
            # fixed-length sub-chunks {128, k, 1}, each ending freshly
            # re-binned (the JAX package's schedule, whose scan programs
            # compile once per length)
            with stages("step_chunks", sync=p.x):
                j = i
                outs = []
                kk = max(1, int(getattr(cfg, "rebin_every", 1)))
                while j <= b:
                    L = b - j + 1
                    s_len = (128 if (L >= 128 and 128 % kk == 0)
                             else (kk if L >= kk else 1))
                    p, react, out_s = run_chunk(p, j, s_len, kk)
                    outs += out_s
                    j += s_len
            history.setdefault("chunk_wall_s", []).append((time.time() - t_chunk0, b - i + 1))
            with stages("host_consume"):
                consume(i, outs)
                # adaptive re-bin period: shrink k when particle speeds grew
                # past the half-cell-per-period bound (the chunk boundary is
                # already a host sync)
                if getattr(cfg, "rebin_every", 1) > 1:
                    # floor at 2: k = 1 would swap in margin-0 kernels whose
                    # windows assume the exact slot invariant, which
                    # in-flight drifted particles violate
                    k_safe = max(2, safe_rebin_period(
                        p.v, setup.grid.spacing, dt, k_max=cfg.rebin_every))
                    if k_safe < cfg.rebin_every:
                        if progress:
                            print(f"  [rebin] period {cfg.rebin_every} -> {k_safe} "
                                  "(particle speeds grew)", flush=True)
                        cfg = cfg.replace(rebin_every=k_safe)
                        step, _ = _step_function(setup, cfg)
            i = b + 1
            last = b
            if backup_every and (last + 1) % backup_every == 0:
                # rolling resumable snapshot, written whatever write_outputs
                # says: state persistence, not a result
                with stages("backup"):
                    save_checkpoint(os.path.join(setup.out_dir, "backup.npz"), p, last + 1)
            if write_outputs and (last % setup.out_every == 0):
                with stages("vtk_output"):
                    vtk.write_particles_vtk(
                        os.path.join(setup.out_dir, f"particles_{last:06d}.vtk"),
                        p,
                        **(dict(fields=setup.vtk_fields) if setup.vtk_fields is not None
                           else {}),
                    )
                    # nodal mesh + reactions beside the particle cloud, as
                    # the reference writes them (WriteVtk.c:53-100); a
                    # structured grid only, as in the JAX driver
                    if isinstance(grid, Grid):
                        vtk.write_grid_vtk(
                            os.path.join(setup.out_dir, f"nodes_{last:06d}.vtk"),
                            grid,
                            point_data={"REACTIONS": react},
                        )
            for eidx, (ev, rec) in enumerate(zip(csv_events, recorders)):
                due = (
                    ev["i_start"] <= last <= ev["i_end"]
                    and (last - ev["i_start"]) % ev["i_step"] == 0
                )
                if not due:
                    continue
                with stages("csv_output"):
                    if ev["kind"] == "particles":
                        rec.record((last + 1) * dt, p)
                    else:
                        rec.record((last + 1) * dt, outs[-1][f"react_{eidx}"])
            if progress:
                print(f"  step {last}/{i_end} t={i * dt:.4e}", flush=True)

    if write_outputs:
        for eidx, (ev, rec) in enumerate(zip(csv_events, recorders)):
            path = os.path.join(setup.out_dir, ev["dir"], f"{ev['kind']}_path_{eidx}.csv")
            rec.write(path, dim=d)

    wall = time.time() - t0
    history["rebin_every"] = int(getattr(cfg, "rebin_every", 1))
    history["stage_timings"] = stages.summary()
    history["wall_s"] = wall
    history["steps_per_s"] = n / max(wall, 1e-12)
    if progress:
        print(f"done: {n} steps in {wall:.1f}s")
        print(stages.report())
    return p, history
