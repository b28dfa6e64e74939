#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``nlpartsol_tpu_torch/csrc`` (one ``nvcc`` per
source, all started together) and drives the port's paths — the 2D and
the 3D explicit LME step, the 2D and 3D implicit Newmark step, the 2D
explicit and implicit soil-water mixture (u-pw) step, the 2D mixed u-p and
Discrete Energy-Momentum (DEM) steps, the explicit step with every
constitutive model in 2D and 3D, the implicit and u-pw steps with the
return mappings and Hencky, and nonlocal fracture on the explicit
(2D, 3D) and implicit steps, on the fused kernels; uGIMP and aLME on the
windowed engine; the scatter engine on every step that takes it;
unstructured T3/Q4/T4/H8 background meshes with FEM and meshfree LME; the
deck entry point; the halo-sharded grid across ranks of this script that
share the card — on the card.  Each phase
prints one JSON line; any failure ends the run with a non-zero exit code.
Without a CUDA device the script fails at once.

Phases (each 2D phase has a 3D twin with the suffix ``3d``):
  device     card, nvidia-smi name and power limit, torch and CUDA versions
  build      nvcc build + load of the kernels
  kernels    every kernel variant against its plain PyTorch version on a
             small grid (random positions and fields from a numpy seed):
             2D 128² (also a ragged 37×53 box of capacity 3 and a 24² box),
             3D 32³ (``kernels3d``, also ragged 21³ and 37³ boxes of
             capacity 3), margins 0 and 1, valid bounds
  main_path  the JAX package's benchmark problem through ``to_slot_layout``
             + ``run``, with launch counts: 2D (bench.py) 512² nodes, 262,144
             particles, capacity-6 box of 260² cells, k=16 local rebin, 16
             warm-up + 32 timed steps; 3D (scripts/bench3d.py,
             ``main_path3d``) 96³ nodes, 110,592 particles, capacity-2 box of
             52³ cells, per-step local rebin, 4 + 16 steps; LME γ=3,
             Neo-Hookean
  parity     the same steps from the same state through the fused kernels
             and the port's windowed engine on the card (2D 16, 3D 8),
             matched by pid: rel_dx < 1e-3, rel_dv < 1e-2
  roofline   each kernel at the main path's shapes against its plain
             version: time, plain time, bound; in 3D also at margin 1
             (rows ``…@margin1``, on no path: the window a re-bin period
             k > 1 would need); with ``implicit`` also the implicit step's
             four call variants at its shapes (rows ``…@implicit``)
  implicit   scripts/bench_implicit.py's step on the fused kernels: 2D
             256² nodes, 65,536 particles, capacity-6 box of 132² cells;
             3D (``implicit3d``) the 96³ problem of main_path3d; dt = 2h/c,
             Newton-CG (Jacobi, cg_maxiter 60, newton_maxiter 10,
             Eisenstat-Walker), local re-bin every step; 1 warm-up + 5
             timed steps (3D 3), every step converged and nothing lost,
             launches held to the formula of formulations/implicit.py, host
             syncs per step, one profiled step (device busy share, share in
             the four kernels)
  implicit_parity
             2 implicit steps from the same state through the fused kernels
             and the port's windowed engine on the card, matched by pid:
             rel_dx < 1e-3, rel_dv < 1e-2, equal Newton iterations (3D:
             ``implicit_parity3d``)
  upw        scripts/bench_upw.py's explicit soil-water mixture step on the
             fused kernels: 512² nodes, 262,144 particles, capacity-6 box of
             260² cells, Neo-Hookean soil and compressible water, LME γ=3,
             dt = 0.25·h/c_mix, local re-bin every step; 4 warm-up + 16
             timed steps, 3 scatters and 5 gathers a step
  upw_parity 8 explicit u-pw steps from the same state through the fused
             kernels and the windowed engine on the card, by pid: rel_dx <
             1e-3, rel_dv < 1e-2, pw within 1e-4 of its largest magnitude;
             and tests/test_upw.py's column, 25 steps, at the JAX package's
             limits there (x 1e-6, pw 1e-5 of its largest magnitude, φ_f
             1e-6)
  upw_implicit
             bench_upw.py --implicit's step: 256² nodes, 65,536 particles,
             capacity-6 box of 132² cells, dt 20× the explicit one,
             Newton-GMRES on the row- and column-scaled residual; 1 warm-up
             + 1 timed step (the script times 8), every Newton loop ended by
             its tolerance or stall rule (``converged`` reported), nothing
             lost, launches held to the formula of
             formulations/upw.py, host syncs, 5 J·v under the profiler (a
             whole step is some 600,000 kernels: minutes of profiling)
  upw_implicit_parity
             1 implicit u-pw step on both engines on the card at 128² (GMRES
             at 5 cycles a solve, ``UPW_PARITY_KRYLOV_MAXITER``), by pid:
             rel_dx < 1e-3, rel_dv < 1e-2, pw within 1e-2 of its largest
             magnitude, equal Newton iterations; with ``roofline`` the u-pw
             steps' call variants at their shapes (rows ``…@upw``,
             ``…@upw_implicit``)
  up         the mixed u-p step on the fused kernels at the width of
             ``implicit`` (256² nodes, 65,536 particles, capacity-6 box of
             132² cells), Neo-Hookean E 1e7, ν 0.3, LME γ=3, dt = 2h/c,
             UpConfig's Newton-GMRES defaults, a local re-bin every step; 1
             warm-up + 1 timed step, each Newton loop ended by its tolerance
             or stall rule (``converged`` reported), nothing lost, launches
             held to the formula of formulations/up.py, host syncs, host ms
             per residual and per J·v, 5 J·v under the profiler, and one
             J·v against a float64 central difference at 32² (float64 on CPU
             tensors: the plain versions and this torch build's forward mode),
             and the card's float32 J·v through the kernels against the plain
             versions' float32 J·v at the same x and v (``JV_F32_LIMIT``)
  up_parity  1 u-p step on both engines on the card at 64², by pid:
             rel_dx < 1e-3, rel_dv < 1e-2, the λ gap over its largest
             magnitude within 1e-2 in root mean square and 1e-1 at its
             largest (``BENCH_PARITY``: the float32 spread of this problem,
             where the JAX package's own engines stay), equal Newton
             iterations; and
             tests/test_upw.py's column, 5 steps, at test_up_pallas_parity's
             limits (x 1e-6, λ 1e-2·max(1, |λ|))
  dem        the DEM step (discrete gradient, forward mode over the
             reverse-mode ∂W/∂F) on the fused kernels, the problem of ``up``
             at dt = h/c, DEMConfig's Newton-CG defaults; as ``up``, with
             the launch formula of formulations/dem.py, the grid-energy
             identity |ΔKE_grid + ΔW| / KE_grid per step, and one whole step
             under the profiler
  dem_parity 2 DEM steps on both engines at 128², by pid: rel_dx < 1e-3,
             rel_dv < 1e-2, equal Newton iterations, the fused energy
             identity below 6e-4 (``BENCH_PARITY``); and tests/test_dem.py's
             bar, 3 steps, at the JAX test's limits (x 1e-6, v 1e-5,
             identity 5e-4); with ``roofline`` the u-p and DEM steps' call
             variants at their shapes (rows ``…@up``, ``…@dem``)
  models_fn  each constitutive model (von Mises, Drucker-Prager, the Borja
             frictional family, Hencky, Mooney-Rivlin, linear elastic, the
             Newtonian and Bingham fluids) on 65,536 states a kind from a
             numpy seed, 2D and 3D, in float32 on the card against the same
             function in float32 on the CPU (every 8th state): per output the
             largest, 99th-percentile and median row error over the output's
             largest magnitude within ``MODELS_FN_TOL``; rows whose trial yield
             value lies within ``YIELD_BAND`` of zero counted and left out
  models     the main path's problem (bench.py's 512², 262,144 particles,
             k=16 local re-bin) in a rigid frame of held nodes with one strip
             of the block along x per kind of ``MODEL_STRIPS`` (the frictional
             strips confined), dt = 0.25·h/c for the fastest wave speed;
             4 warm-up + 16 timed steps, 2 scatters and 2 gathers a step,
             lost 0, every active field and diagnostic finite, each plastic
             kind's yielded share within ``PLASTIC_SHARE``
  models_parity
             8 of those steps from the same state on the fused and the
             windowed engine on the card, by pid: rel_dx < 1e-3, rel_dv <
             1e-2, per kind the eps gap over its largest value within
             ``MODELS_EPS_GAP``
  models3d   the same for scripts/bench3d.py's 96³ problem (110,592
             particles, a re-bin every step) with Hencky, von Mises,
             Drucker-Prager and Matsuoka-Nakai: 2 warm-up + 4 timed steps,
             then 4 steps of parity (line ``models_parity3d``)
  implicit_models
             the return mappings on the implicit step: bench_implicit.py's
             256² problem (65,536 particles, capacity-6 box of 132² cells,
             dt = 2h/c) with strips of von Mises, Drucker-Prager,
             Matsuoka-Nakai and Hencky (``IMPLICIT_MODEL_KINDS``) in the
             models phases' rigid frame, the frictional strip confined, on
             the fused kernels, Newton tolerance 1e-4
             (``IMPLICIT_MODELS_NEWTON_TOL``: the plastic strips' float32
             floor); 1 warm-up + 1 timed step: converged, lost 0,
             finite, launches equal to the formula of
             formulations/implicit.py (one G-scatter more a step for the
             frame's reactions), each plastic kind yielded somewhere; Newton
             and CG iterations, host ms per residual and per J·v;
             ``implicit_models3d``: the 96³ problem with Drucker-Prager and
             Hencky strips
  implicit_models_parity
             2 of those steps at 64² on the fused kernels and the windowed
             engine, by pid: rel_dx < 1e-3, rel_dv < 1e-2, equal Newton
             iterations, per kind the eps gap within ``MODELS_EPS_GAP``
  upw_models the u-pw steps with a Drucker-Prager soil (``UPW_SOIL``): the
             explicit 512² step, 4 + 16 steps, 3 scatters and 5 gathers a
             step, parity over 4 steps against the windowed
             engine (pw within 1e-4); one implicit step at 128², dt 5× the
             explicit one (GMRES at 5 cycles a solve), on the fused kernels (launches held to
             formulations/upw.py's formula) and on
             the windowed engine (pw within 1e-2, equal Newton iterations,
             ``converged`` reported); the soil yielded on both
  models_jv  the stress update's J·v for every kind (``JV_KINDS``), 2D and
             3D, 4,096 states a kind at tests/test_torch_tangent.py's three
             state families (general, diagonal, rest): finite, within
             ``JV_TOL`` of a float64 central difference on the card (rows
             that straddle a branch counted, not compared) and of the CPU's
             float32 J·v on every 8th state
  deck       the user's entry point at the main path's width: bench.py's
             problem written as a deck (``DECK``), ``build_simulation`` and
             ``run_simulation(transfer='auto')`` for 48 steps with VTK every
             32: fused at k = 16, lost 0, 2 scatters and 2 gathers a step,
             the VTK files written, parity by pid against ``explicit.run``
             (``DECK_PARITY``); build, chunk, VTK and GiD-reader seconds
  decks      one small deck per route of the driver through ``cli.main``
             (``DECK_ROUTES``: the engine of the JAX rule, launches exactly on
             the fused routes, finite fields, lost 0; fracture from the
             deck's Fracture-Modulus key on the fused and windowed explicit
             and the Newmark-β routes, at a re-bin every step; uGIMP; aLME
             with β finite and pulled back; an unstructured T3 background,
             FEM and LME, on the scatter engine; Newmark-β with
             Drucker-Prager, Static with von Mises, -upw Newmark-β with a
             Drucker-Prager soil, -up with Hencky, DEM with Hencky), then
             the reference binary's DEM goldens through the port's builder
             in float64
  fracture   eigenerosion, then eigensoftening, on the main path's problem
             (bench.py's 512², 262,144 particles) with a central band of 2×8
             cells pre-stretched to F_xx = 1.3 and the halves pulled apart
             (``FRACTURE_BAND``), Ceps 1.5 (reach 2), fused at a re-bin
             every step in a capacity-6 box of 264² cells; 4 warm-up + 16
             timed steps a driver: 2 scatters and 2 gathers a step, lost 0,
             finite fields, the band's eroded or triggered share within
             ``FRACTURE_BAND_SHARE`` and nothing touched beyond 2·Ceps·h of
             it; ms a step, the Beps sums' ms and kernels a call (CUDA
             events, torch.profiler), the re-bin's share; the card's Beps
             sums against a float64 brute force on every 64th particle;
             parity over 8 steps against the windowed engine by pid
             (``FRACTURE_PARITY``); ``fracture3d``: the same on
             main_path3d's 96³ problem, 2 + 4 steps, parity over 4
  fracture_implicit
             eigenerosion on the implicit 256² problem with the band (no
             pull) at dt = 0.25·h/c, fused, 1 + 2 steps: converged, the
             staggered update fired, launches held to the formula of
             formulations/implicit.py; parity at 128² over 2 steps against
             the windowed engine with equal Newton counts
  shapefuns  uGIMP and aLME on the explicit step at 512² on the windowed
             engine (their driver route), 2 + 8 steps: lost 0, finite, no
             kernel launched, aLME's β pulled back; parity at 128² over 4
             steps against the scatter engine, by pid
  scatter    the scatter engine (``transfer='scatter'``) at 128² against the
             windowed engine by pid (rel_dx < 1e-3, rel_dv < 1e-2, equal
             Newton counts): the explicit, implicit, u-pw explicit, u-pw
             implicit (1 step), Forward-Euler and Generalized-α steps, 2
             steps each; and a traction deck through ``run_simulation``
             with the particles stored shuffled
  femesh     scripts/bench_femesh.py's problem on an unstructured mesh
             (shapefun/femesh.py, the scatter engine; no kernel): the 192²
             perturbed T3 mesh (37,249 nodes, 73,728 triangles), 221,184
             particles, Neo-Hookean E 1e7, ν 0.3, meshfree LME γ=3 over the
             node cloud, dt = 0.25·(smallest edge)/c, 2 warm-up + 10 timed
             steps; then FEM T3 on the same mesh: ms a step, nnz, nnz/s, K,
             Emax, peak memory, host build seconds, lost 0, and where a step's
             time goes (shape functions, one P2G and one G2P)
  femesh3d   the port's 3D case: a perturbed H8 mesh of 32³ elements,
             262,144 Gauss-point particles, FEM H8 and LME (the LME
             candidate bytes printed first), then its 6-tets-a-hex T4 split,
             196,608 particles, FEM; 1 + 4 steps each, reported as femesh
  femesh_parity
             a Q4 FEMesh on the unperturbed 128² node grid of ``scatter``
             against the structured grid on the windowed engine, 8 steps from
             the same particles, by pid (rel_dx < 1e-3, rel_dv < 1e-2), FEM
             and LME; tests/test_femesh.py's T3 bar to a quarter period (error
             < 0.12, FEM and LME) and its 3 implicit steps, converged
  femesh_scatter
             every step that takes a FEMesh (Forward-Euler, Generalized-α,
             quasi-static, u-pw explicit and implicit, u-p, DEM) on the T3 bar,
             2 steps each: finite, lost 0, Newton loops converged
  probes     the lane-roll probes: a roll sum checked exactly against
             torch.roll, and timed beside its multiply-add twin at 4 shapes
  sharded    the halo-sharded grid (parallel/domain.py) on bench.py's
             problem: S = 1 in this process, 16 + 32 steps beside
             main_path's ms/step; S = 2 ranks (processes of this script,
             ``--sharded-rank``, on the one card: a gloo group whose halo
             planes, migration buffers and all-reduces are staged through
             host memory), k = 16 seam migration at margin 1, 16 parity
             steps then 32 timed: by pid against the single-device fused
             run of ``parity``, rel_dx < 1e-3, rel_dv < 1e-2, nnz equal a
             step, lost 0, 2 K1 + 2 K2 a step on each rank; each line
             reports backend, ranks, ranks_per_device and bytes_staged,
             host syncs, exchanges and all-reduces a step
  sharded3d  the same for main_path3d's 96³ (k = 1): 8 parity + 16 timed
  sharded_implicit
             the implicit 256² step on S = 2, 1 step: converged, Newton and
             CG counts equal across ranks, Newton equal to the single-device
             step's, rel_dx, rel_dv as above
  sharded_upw
             bench_upw.py's explicit 512² through sharded_upw_run (4 + 8
             steps, pw within 1e-4 of its largest value) and the Newmark
             step at 64² with the halo in the rank's own loop (1 step at
             twice the explicit dt, GMRES at 2 cycles a solve: pw within
             1e-2, Newton equal to the single-device step's)
  sharded_fracture
             eigenerosion on the fracture phase's 512² band, which the seam
             crosses, k = 1, 4 steps: at most 4 particles with another
             damage, the strain_f gate, rel_dx, rel_dv
  sharded2d  2×2 ranks: the 512² explicit step (a re-bin every step, 8
             steps) and the implicit 256² step (1), each by pid against its
             single-device fused run
  multihost  on the S = 2 run: ``gather_particles`` on every rank equals
             ``unshard_particles`` of the strips; the shards' VTK files
             together hold the gathered cloud
  large      (if time allows) the fused path alone at the bigger size: 3D
             160³ nodes / 512,000 particles (``large3d``), 2D 2048² nodes /
             4,194,304 particles
  profile    (only when asked: ``--phases main_path,profile`` or
             ``main_path3d,profile3d``) where the main path's steps spend
             their time: plain and re-bin step times, device-busy share,
             kernels per step
  tiles      (only when asked: ``--phases tiles`` or ``tiles3d``) the main
             path's two scatter calls timed with each candidate cell tile
             of ``fused_transfer.TILE``, each checked against the first

The line ``{"kernels": [...]}`` lists every kernel with its launches on
its path (counts set to 0 just before the path's timed run and read just
after), error against its plain version, times and bound; the line before
it is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

T_START = time.perf_counter()
# launches by kernel variant of the paths that print no rows of their own:
# {path: (the row tag of the path with the same call variants, counts)},
# read into those rows of the "kernels" line as ``launches_by_path``
PATH_LAUNCHES = {}
# main_path's ms/step of this run, for the deck phase's line
REPORT = {}

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and device-memory rate.  Bounds are stated against these.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Tolerances between a kernel and its plain version — those the JAX package
# holds between its own engines.  Atomic sums come in another order each run
# and the kernel's Newton tolerance is relative to the support radius (the
# plain version's to the largest masked distance), so nothing is bitwise.
TOL_N = dict(rtol=2e-5, atol=1e-6)      # N-weighted sums (atol × field scale)
TOL_GRAD = dict(rtol=3e-4, atol=3e-5)   # ∇N-weighted sums (atol × field scale)
# λ ~ 1/h; a Newton stop at ‖r‖ ≤ 1e-6·R leaves it uncertain by J⁻¹r ≈ 2e-5/h
TOL_LAM = dict(rtol=1e-3, atol=1e-4)    # λ (atol × 1/h)


def say(**kw):
    """One JSON line; a phase's line ends with the seconds since the start."""
    if "phase" in kw:
        kw["elapsed_s"] = time.perf_counter() - T_START
    print(json.dumps(kw), flush=True)


class PhaseError(RuntimeError):
    pass


def compare(name, got, ref, rtol, atol, scale=None):
    """Max abs / scaled error of ``got`` against ``ref``; raises when any
    entry is outside ``atol·scale + rtol·|ref|``."""
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape:
        raise PhaseError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise PhaseError(f"{name}: non-finite values")
    if scale is None:
        scale = float(ref.abs().max()) or 1.0
    err = (got - ref).abs()
    worst = float((err - rtol * ref.abs()).max())
    out = dict(max_abs=float(err.max()), max_rel=float(err.max()) / scale,
               rtol=rtol, atol=atol * scale)
    if worst > atol * scale:
        raise PhaseError(f"{name}: outside tolerance {out}")
    return out


def cuda_ms(fn, reps, flush=None):
    """Median time of ``fn()`` in ms over ``reps`` launches, each between its
    own pair of CUDA events; ``flush`` (a big buffer) is rewritten before
    each launch so the launch finds the L2 cache cold, as in a step."""
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(phase="device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)
    return kind, smi


SOURCES = ("lme_transfer2d", "lme_transfer3d", "roll_probe")


def phase_build():
    from nlpartsol_tpu_torch.ops import cuda_build, fused_transfer as ft, roll_probe

    t0 = time.perf_counter()
    cuda_build.build_all(SOURCES)  # one nvcc per source, all at once
    ft._library(2), ft._library(3), roll_probe._library()
    say(phase="build", seconds=time.perf_counter() - t0, sources=[s + ".cu" for s in SOURCES])


def _slot_problem(seed, dim, n_side, lo_cell, n_cell, capacity, per_cell, drift, device):
    """Random particles in a box of ``n_cell``^dim cells (or of the cells
    per axis ``n_cell`` gives) starting at cell ``lo_cell``, binned to slots
    (overflow dropped), then moved by up to ``drift`` cells."""
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
    from nlpartsol_tpu_torch.ops import windowed
    from nlpartsol_tpu_torch.types import Grid, make_particles

    rng = np.random.default_rng(seed)
    h = 1.0 / (n_side - 1)
    grid = Grid(dims=(n_side,) * dim, spacing=h, origin=(0.0,) * dim)
    cdims = tuple(n_cell) if isinstance(n_cell, tuple) else (n_cell,) * dim
    n = per_cell * int(np.prod(cdims))
    x = ((lo_cell + 1) + (np.asarray(cdims) - 2) * rng.random((n, dim))) * h
    p = make_particles(
        x.astype(np.float32),
        mass=rng.uniform(0.5, 2.0, n).astype(np.float32),
        vol0=np.full(n, h ** dim / per_cell, np.float32),
        device=device,
    )
    box = windowed.ActiveBox(offset=(lo_cell,) * dim, cdims=cdims, capacity=capacity)
    p = to_slot_layout(p, grid, box, allow_lost=True)
    if drift:
        dx = torch.as_tensor(
            drift * h * (2.0 * rng.random((p.count, dim)) - 1.0), dtype=torch.float32,
            device=device)
        p = p.replace(x=p.x + dx)
    return rng, grid, box, p


# The kernel variants of phases ``kernels`` (2D: 128² grid, 100² cells ×
# capacity 6, 3 particles a cell) and ``kernels3d`` (32³ grid, 24³ cells ×
# capacity 2, 1 particle a cell): scatter cases (label, margin, G, gnorm,
# valid bounds, seed[, options]) and gather cases (label, margin, N,
# gradient, seed[, options]).  Valid bounds: None, or how many planes inside
# the box's ends they cut.  Scatters carry cN = d+1 channels (mass,
# mass·velocity) unless an option says ``cN`` (the rest random), gathers d;
# the option ``problem`` replaces the dimension's problem.  The later cases
# of each list hold the redesigned kernels: a ragged box against the
# scatter's cell tiles (2D 37×53, 3D 21³ cells, capacity 3, 2 particles a
# cell, so slots of rank > 0 carry particles), margin 1 with valid bounds,
# the largest shared footprint (cN = 8, G and gnorm at margin 1: 2D 11, 3D
# 12 channels), in 2D a 24² box (36 tiles of 2×8, below MIN_TILES), in 3D a
# ragged 37³ box at capacity 3 (large enough to keep the 8×4×4 tile, 3
# slots a thread; the 24³ and 21³ boxes get 2×4×4 tiles), gathers of the
# gradient alone, at margin 0 and of 5 channels (the step gathers d).  The
# last cases are the implicit step's wide calls at margin 0: its first
# scatter with gnorm (2D 6 channels, 8 with tractions; 3D 8 and 11) and its
# last N-gather (2D 6, 3D 9 channels); then the u-pw steps' calls (2D): the
# explicit λ solve of 7 channels, the implicit one of 8 with gnorm, the
# fixed-λ gnorm scatter of one channel (the Darcy diagonal), the fixed-λ
# scatter of a G row 0 beside a zero channel (the flow row), and the gather
# of 3 channels with the gradient of their first 2 (options ``solve``,
# ``zero_fN``, ``G_row0``, ``grad_of_N``); then the u-p steps' λ solve with
# tractions (2D 9 channels, 3D 12: the cap) and their gather of one channel
# with the gradient of two others.
RAGGED2 = dict(problem=(64, 4, (37, 53), 3, 2))
SMALL2 = dict(problem=(32, 2, 24, 2, 1))
RAGGED3 = dict(problem=(32, 4, 21, 3, 2))
RAGGED3_LARGE = dict(problem=(48, 5, 37, 3, 2))
KERNEL_CASES = {
    2: dict(problem=(128, 14, 100, 6, 3), grid="128x128", box="100x100 cells x capacity 6",
            scatter=[("solve,cN=3,margin=0", 0, False, False, None, 1),
                     ("solve,cN=3,margin=1", 1, False, False, None, 2),
                     ("solve,cN=3,G,margin=1", 1, True, False, None, 3),
                     ("solve,cN=3,gnorm,margin=1", 1, False, True, None, 4),
                     ("solve,cN=3,G,margin=0,valid_lo/hi", 0, True, False, 1, 5),
                     ("solve,cN=3,G,margin=0,ragged 37x53 x C3", 0, True, False, None, 8,
                      RAGGED2),
                     ("solve,cN=3,G,margin=1,valid_lo/hi", 1, True, False, 0, 9),
                     ("solve,cN=8,G,gnorm,margin=1", 1, True, True, None, 10, dict(cN=8)),
                     ("solve,cN=3,G,margin=1,small 24^2 box", 1, True, False, None, 26,
                      SMALL2),
                     ("solve,cN=6,gnorm,margin=0 (implicit)", 0, False, True, None, 31,
                      dict(cN=6)),
                     ("solve,cN=8,gnorm,margin=0 (implicit, tractions)", 0, False, True, None,
                      32, dict(cN=8)),
                     ("solve,cN=7,margin=0 (upw)", 0, False, False, None, 37, dict(cN=7)),
                     ("solve,cN=8,gnorm,margin=0 (upw implicit)", 0, False, True, None, 38,
                      dict(cN=8)),
                     ("fixed lam,cN=1,gnorm,margin=0 (upw implicit Darcy diagonal)", 0, False,
                      True, None, 39, dict(cN=1, solve=False)),
                     ("fixed lam,cN=1 zero,G row 0,margin=0 (upw flow row)", 0, True, False,
                      None, 40, dict(cN=1, solve=False, zero_fN=True, G_row0=True)),
                     ("solve,cN=9,gnorm,margin=0 (u-p, tractions)", 0, False, True, None, 42,
                      dict(cN=9))],
            gather=[("cN=2+grad,margin=1", 1, True, True, 6),
                    ("cN=2,margin=1", 1, True, False, 7),
                    ("grad,margin=0", 0, False, True, 27),
                    ("cN=2+grad,margin=0", 0, True, True, 28),
                    ("cN=2+grad,margin=1,ragged 37x53 x C3", 1, True, True, 29, RAGGED2),
                    ("cN=5+grad,margin=0", 0, True, True, 30, dict(cN=5)),
                    ("cN=6,margin=0 (implicit)", 0, True, False, 33, dict(cN=6)),
                    ("cN=3+grad of its first 2 columns,margin=0 (upw)", 0, True, True, 41,
                     dict(cN=3, grad_of_N=True)),
                    ("cN=1+grad of 2 other columns,margin=0 (u-p)", 0, True, True, 43,
                     dict(cN=1))]),
    3: dict(problem=(32, 4, 24, 2, 1), grid="32x32x32", box="24^3 cells x capacity 2",
            scatter=[("solve,cN=4,margin=0", 0, False, False, None, 11),
                     ("solve,cN=4,margin=1", 1, False, False, None, 12),
                     ("solve,cN=4,G,margin=1", 1, True, False, None, 13),
                     ("solve,cN=4,gnorm,margin=1", 1, False, True, None, 14),
                     ("solve,cN=4,G,margin=0,valid_lo/hi", 0, True, False, 1, 15),
                     ("solve,cN=4,G,margin=0,ragged 21^3 x C3", 0, True, False, None, 20,
                      RAGGED3),
                     ("solve,cN=4,G,margin=1,valid_lo/hi", 1, True, False, 0, 21),
                     ("solve,cN=8,G,gnorm,margin=1", 1, True, True, None, 22, dict(cN=8)),
                     ("solve,cN=4,G,margin=1,ragged 37^3 x C3", 1, True, False, None, 25,
                      RAGGED3_LARGE),
                     ("solve,cN=8,gnorm,margin=0 (implicit)", 0, False, True, None, 34,
                      dict(cN=8)),
                     ("solve,cN=11,gnorm,margin=0 (implicit, tractions)", 0, False, True, None,
                      35, dict(cN=11)),
                     ("solve,cN=12,gnorm,margin=0 (u-p, tractions: the channel cap)", 0, False,
                      True, None, 44, dict(cN=12))],
            gather=[("cN=3+grad,margin=1", 1, True, True, 16),
                    ("cN=3,margin=1", 1, True, False, 17),
                    ("grad,margin=0", 0, False, True, 18),
                    ("cN=3+grad,margin=0", 0, True, True, 19),
                    ("cN=3+grad,margin=1,ragged 21^3 x C3", 1, True, True, 23, RAGGED3),
                    ("cN=5+grad,margin=0", 0, True, True, 24, dict(cN=5)),
                    ("cN=9,margin=0 (implicit)", 0, True, False, 36, dict(cN=9))]),
}


def phase_kernels(device, dim):
    """Every variant of the ``dim``-D kernels against its plain version:
    scatter solve / G / gnorm, gather N / grad, margins 0 and 1, and one
    case with valid node bounds."""
    from nlpartsol_tpu_torch.ops import fused_transfer as ft
    from nlpartsol_tpu_torch.shapefun import lme

    params = lme.LMEParams(gamma=3.0)
    spec = KERNEL_CASES[dim]
    cases = []

    def problem(seed, margin, opts):
        return _slot_problem(seed, dim, *opts.get("problem", spec["problem"]), 0.9 * margin,
                             device)

    def slot_inputs(p, box):
        C, nc = box.capacity, box.n_cells
        return (ft.to_channel_leading(p.x, C, nc),
                ft.to_channel_leading(p.lme_lambda, C, nc),
                ft.to_channel_leading(p.active.float(), C, nc))

    def rand(rng, *shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=device)

    def scatter_case(label, margin, has_G, gnorm, bounds, seed, opts=None):
        rng, grid, box, p = problem(seed, margin, opts or {})
        if bounds is not None:
            # valid node planes end ``bounds`` planes inside the box's ends
            # (the particles sit one cell inside it, and drift up to 0.9
            # cells at margin 1), cutting planes out of every edge particle's
            # window; axis 1 is cut one plane further out
            lo, hi = box.offset[0] + bounds, box.offset[0] + box.cdims[0] - bounds
            rest = (dim - 2)
            grid = grid.replace(valid_lo=(lo, lo - 1) + (lo,) * rest,
                                valid_hi=(hi, hi + 1) + (hi,) * rest)
        C, nc = box.capacity, box.n_cells
        opts = opts or {}
        x_t, lam_t, act_t = slot_inputs(p, box)
        solve = opts.get("solve", True)
        if not solve:
            # a fixed-λ call runs at the λ the step's first scatter solved
            _, lam_t, _ = ft._scatter_plain(grid, box, params, x_t, lam_t, act_t,
                                            ft.to_channel_leading(p.mass, C, nc), None, True,
                                            margin, False)
        vel = rand(rng, p.count, dim)
        cN = opts.get("cN", dim + 1)
        chans = torch.cat([p.mass[:, None], p.mass[:, None] * vel,
                           rand(rng, p.count, max(cN - dim - 1, 0))], dim=1)[:, :cN]
        if opts.get("zero_fN"):
            chans = torch.zeros_like(chans)
        fN = ft.to_channel_leading(chans.contiguous(), C, nc)
        G_t = None
        if has_G:
            G = rand(rng, p.count, dim, dim)
            if opts.get("G_row0"):  # a vector in row 0 of G, the rest zero
                G[:, 1:, :] = 0.0
            G_t = ft.to_channel_leading(G.reshape(-1, dim * dim), C, nc)
        args = (grid, box, params, x_t, lam_t, act_t, fN)
        kw = dict(G_t=G_t, solve=solve, margin=margin, gnorm=gnorm)
        nodes, lam, nnz = ft.fused_scatter(*args, **kw)
        torch.cuda.synchronize()
        r_nodes, r_lam, r_nnz = ft._scatter_plain(*args, G_t, solve, margin, gnorm)
        out = dict(kernel=f"lme_scatter{dim}d", case=label, slots=box.n_slots,
                   active=int(p.active.sum()))
        if opts.get("zero_fN") and float(nodes[:, :cN].abs().max()) != 0.0:
            raise PhaseError(f"{label}: a zero channel scattered non-zero sums")
        out["N"] = compare(label + ":N", nodes[:, :cN], r_nodes[:, :cN], **TOL_N)
        if has_G or gnorm:
            out["grad"] = compare(label + ":grad", nodes[:, cN:], r_nodes[:, cN:], **TOL_GRAD)
        act = p.active
        out["lam"] = compare(
            label + ":lam", ft.from_channel_leading(lam)[act],
            ft.from_channel_leading(r_lam)[act], scale=1.0 / grid.spacing, **TOL_LAM)
        if int(nnz) != int(r_nnz):
            raise PhaseError(f"{label}: nnz {int(nnz)} != {int(r_nnz)}")
        out["nnz"] = int(nnz)
        out["ms"] = cuda_ms(lambda: ft.fused_scatter(*args, **kw), 5)
        out["plain_ms"] = cuda_ms(lambda: ft._scatter_plain(*args, G_t, solve, margin, gnorm), 2)
        cases.append(out)

    def gather_case(label, margin, with_N, with_grad, seed, opts=None):
        rng, grid, box, p = problem(seed, margin, opts or {})
        C, nc = box.capacity, box.n_cells
        x_t, lam_t, act_t = slot_inputs(p, box)
        dummy = ft.to_channel_leading(p.mass, C, nc)
        # gathers run at the λ the step's scatter solved
        _, lam_t, _ = ft._scatter_plain(grid, box, params, x_t, lam_t, act_t, dummy,
                                        None, True, margin, False)
        field = rand(rng, grid.n_nodes, dim)
        # the N-gather reads the gradient's field, or a field of its own
        # with the option ``cN``; with ``grad_of_N`` the gradient is that of
        # the N-field's first d columns, a separate tensor (the u-pw steps'
        # [dU | θ] with ∇dU: the kernel's reuse of the N-sums for a gradient
        # of the same field must not fire)
        cN = (opts or {}).get("cN")
        gN = rand(rng, grid.n_nodes, cN) if cN else field
        if (opts or {}).get("grad_of_N"):
            field = gN[:, :dim].contiguous()
        args = (grid, box, params, x_t, lam_t, act_t)
        kw = dict(gN=gN if with_N else None, g_grad=field if with_grad else None,
                  margin=margin)
        got = ft.fused_gather(*args, **kw)
        torch.cuda.synchronize()
        ref = ft._gather_plain(*args, kw["gN"], kw["g_grad"], margin)
        out = dict(kernel=f"lme_gather{dim}d", case=label)
        inactive = ~p.active
        for key, i, wanted, tol in (("N", 0, with_N, TOL_N), ("grad", 1, with_grad, TOL_GRAD)):
            if not wanted:
                if got[i] is not None:
                    raise PhaseError(f"{label}: unexpected {key} output")
                continue
            out[key] = compare(f"{label}:{key}", got[i], ref[i], **tol)
            if float(got[i][inactive].abs().max()) != 0.0:
                raise PhaseError(f"{label}: inactive slots not zero")
        out["ms"] = cuda_ms(lambda: ft.fused_gather(*args, **kw), 5)
        out["plain_ms"] = cuda_ms(
            lambda: ft._gather_plain(*args, kw["gN"], kw["g_grad"], margin), 2)
        cases.append(out)

    for case in spec["scatter"]:
        scatter_case(*case)
    for case in spec["gather"]:
        gather_case(*case)
    say(phase="kernels" if dim == 2 else "kernels3d", grid=spec["grid"], box=spec["box"],
        cases=cases)


# The JAX package's benchmark problems (2D: bench.py; 3D: scripts/bench3d.py),
# rebuilt in numpy at their widths: particles per cell and axis, slot
# capacity, re-bin period, and the depth chip_smoke.py runs them to (main
# path warm-up and timed steps, parity steps).  ``large`` is each one's
# optional bigger size.
PROBLEMS = {
    2: dict(n_side=512, ppc=2, capacity=6, rebin_every=16, warm=16, steps=32,
            parity_steps=16, large=dict(n_side=2048, warm=16, steps=16)),
    3: dict(n_side=96, ppc=1, capacity=2, rebin_every=1, warm=4, steps=16,
            parity_steps=8, large=dict(n_side=160, warm=4, steps=8)),
}


def _suffix(dim):
    return "" if dim == 2 else "3d"


def build_problem(dim, n_side, device, seed=0):
    """Particles ppc^dim per cell over the central half of an ``n_side``^dim
    grid, small random velocities from numpy ``seed``; the box two cells
    wider than the particles on every side."""
    from nlpartsol_tpu_torch.formulations.explicit import ExplicitConfig
    from nlpartsol_tpu_torch.models import materials as M
    from nlpartsol_tpu_torch.ops import windowed
    from nlpartsol_tpu_torch.shapefun import lme
    from nlpartsol_tpu_torch.types import Grid, make_particles

    spec = PROBLEMS[dim]
    ppc = spec["ppc"]
    h = 1.0 / (n_side - 1)
    grid = Grid(dims=(n_side,) * dim, spacing=h, origin=(0.0,) * dim)
    lo_cell, hi_cell = n_side // 4, 3 * n_side // 4
    ncell = hi_cell - lo_cell
    idx = np.meshgrid(*[np.arange(ncell)] * dim, *[np.arange(ppc)] * dim, indexing="ij")
    x = np.stack(
        [(lo_cell + idx[a] + (idx[dim + a] + 0.5) / ppc) * h for a in range(dim)], axis=-1,
    ).reshape(-1, dim).astype(np.float32)
    vol = (h / ppc) ** dim
    rho = 1000.0
    rng = np.random.default_rng(seed)
    p = make_particles(
        x,
        mass=np.full(len(x), rho * vol, np.float32),
        vol0=np.full(len(x), vol, np.float32),
        v=(0.01 * rng.standard_normal(x.shape)).astype(np.float32),
        device=device,
    )
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=1e7, nu=0.3, rho0=rho)], device=device
    )
    box = windowed.ActiveBox(
        offset=(n_side // 4 - 2,) * dim, cdims=(n_side // 2 + 4,) * dim,
        capacity=spec["capacity"],
    )
    cel = np.sqrt(1e7 / rho)
    cfg = ExplicitConfig(
        dt=0.25 * h / cel,
        shapefun="lme",
        lme_params=lme.LMEParams(gamma=3.0),
        kinds=(M.NEO_HOOKEAN,),
        transfer="fused",
        active_box=box,
        rebin_mode="local",
        rebin_every=spec["rebin_every"],
    )
    return grid, p, mats, cfg, h


def _timed_run(p, grid, mats, cfg, steps):
    from nlpartsol_tpu_torch.formulations.explicit import run
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    ft.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_out, diag = run(p, grid, mats, cfg, steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return p_out, diag, seconds, dict(ft.launch_counts)


def _check_state(label, p, diag):
    act = p.active
    for name in ("x", "v", "F"):
        if not bool(torch.isfinite(getattr(p, name)[act]).all()):
            raise PhaseError(f"{label}: non-finite {name}")
    lost = int(diag["lost"].sum())
    if lost != 0:
        raise PhaseError(f"{label}: {lost} particles lost")
    return lost


def phase_main_path(device, dim):
    """The ``dim``-D benchmark problem through ``to_slot_layout`` + ``run``:
    warm-up steps, then timed steps with the launch counts set to 0 just
    before and read just after (two scatters and two gathers a step)."""
    from nlpartsol_tpu_torch.formulations.explicit import run

    spec = PROBLEMS[dim]
    warm, steps = spec["warm"], spec["steps"]
    label = "main_path" + _suffix(dim)
    grid, p0, mats, cfg, h = build_problem(dim, spec["n_side"], device)
    p1, _ = run(p0, grid, mats, cfg, warm)
    torch.cuda.reset_peak_memory_stats()
    p2, diag, seconds, counts = _timed_run(p1, grid, mats, cfg, steps)
    lost = _check_state(label, p2, diag)
    REPORT[label] = 1e3 * seconds / steps
    n_active = int(p2.active.sum())
    if n_active != p0.count:
        raise PhaseError(f"{label}: {n_active} active particles of {p0.count}")
    total_nnz = int(diag["nnz"].long().sum())
    want = {f"lme_scatter{dim}d:solve": steps, f"lme_scatter{dim}d:G": steps,
            f"lme_gather{dim}d:N+grad": steps, f"lme_gather{dim}d:N": steps}
    if counts != want:
        raise PhaseError(f"{label}: launch counts {counts}, expected {want}")
    say(phase=label, grid="x".join(map(str, grid.dims)), particles=p0.count,
        slots=cfg.active_box.n_slots, warmup_steps=warm, steps=steps,
        ms_per_step=1e3 * seconds / steps, total_nnz=total_nnz,
        nnz_per_step=total_nnz / steps, nnz_per_particle=total_nnz / steps / p0.count,
        nnz_per_s=total_nnz / seconds, lost=lost, launches=counts, finite=True,
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        kinetic_energy=float(diag["kinetic_energy"][-1]),
        strain_energy=float(diag["strain_energy"][-1]))
    return grid, p0, p2, mats, cfg, h, counts


def _by_pid_fields(pp, names):
    """Particle ids and the named fields of the active particles, by pid."""
    act = pp.active
    pid = pp.pid[act]
    o = torch.argsort(pid)
    return pid[o], [getattr(pp, n)[act][o] for n in names]


def _parity(pf, pw, h, label, names=("x", "v")):
    """Largest position difference over h and velocity difference over the
    largest speed, between two runs matched by pid over active particles
    (then the fields of ``names`` beyond x and v, by pid)."""
    pid_f, got = _by_pid_fields(pf, names)
    pid_w, ref = _by_pid_fields(pw, names)
    if pid_f.shape != pid_w.shape or not bool((pid_f == pid_w).all()):
        raise PhaseError(f"{label}: particle sets differ")
    (xf, vf), (xw, vw) = got[:2], ref[:2]
    rel_dx = float((xf - xw).abs().max()) / h
    v_scale = max(float(vw.abs().max()), 1e-12)
    return (rel_dx, float((vf - vw).abs().max()) / v_scale, *zip(got[2:], ref[2:]))


def phase_parity(grid, p0, mats, cfg, h):
    """The same steps from the same state through the fused kernels and the
    port's windowed engine (full window, plain tensor code, binning every
    step), matched by pid."""
    from nlpartsol_tpu_torch.formulations.explicit import run

    dim = grid.dim
    label = "parity" + _suffix(dim)
    steps = PROBLEMS[dim]["parity_steps"]
    pf, diag_f = run(p0, grid, mats, cfg, steps)
    _check_state(label + ":fused", pf, diag_f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pw, diag_w = run(p0, grid, mats, cfg.replace(transfer="windowed", rebin_every=1), steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _check_state(label + ":windowed", pw, diag_w)
    rel_dx, rel_dv = _parity(pf, pw, h, label)
    ok = rel_dx < 1e-3 and rel_dv < 1e-2
    # the single-device fused run the sharded phases are held to
    SHARED["explicit" + _suffix(dim)] = (grid, p0, mats, cfg, h, _by_pid_numpy(pf),
                                         [int(n) for n in diag_f["nnz"].long()])
    say(phase=label, steps=steps, rel_dx=rel_dx, rel_dv=rel_dv,
        limit_dx=1e-3, limit_dv=1e-2, nnz_fused=int(diag_f["nnz"].long().sum()),
        nnz_windowed=int(diag_w["nnz"].long().sum()),
        windowed_ms_per_step=1e3 * seconds / steps,
        windowed_peak_device_bytes=torch.cuda.max_memory_allocated(), ok=ok)
    if not ok:
        raise PhaseError(f"{label}: rel_dx {rel_dx}, rel_dv {rel_dv}")


# Operations the functions need on this run's inputs, whatever the kernels
# compute again (they re-test the window and re-evaluate f and exp in every
# sweep; none of that is charged twice).  An exp and a division count as one
# each.  Once per active slot and window offset, the edge test: 2D 11; 3D 15
# (node position 3 mul + 3 add, r 3, r² 5, the radius compare 1).  Once per
# valid edge and evaluation of the basis at a new λ (each Newton iteration
# that ran, or the one evaluation at fixed λ): f = −β·r² + λ·r (2D 5, 3D 7),
# exp 1, the moments (2D six, 14; 3D ten, 19: S0 1, e·l 3 and S1 3, S2 6 mul
# + 6 add; Z alone 1).  Once per valid edge: a shape value N 2, a gradient
# (2D 10; 3D 21: l − r 3, J⁻¹·a 15, ×(−N) 3), one N-weighted channel 2
# (multiply + add), the G product with its adds (2D 8, 3D 18), a
# gradient-weighted gather (2D 8, 3D 18: 9 mul + 9 add), a gnorm term
# s·|∇N|² with its add (2D 5, 3D 7).
OPS = {
    2: dict(test=11, f=5, mom=14, n=2, dn=10, ch=2, g=8, grad=8, gn=5),
    3: dict(test=15, f=7, mom=19, n=2, dn=21, ch=2, g=18, grad=18, gn=7),
}
# the TPU kernels each CUDA kernel replaces: (file:line of the pallas_call,
# and of the other layout's call for 3D)
REPLACES = {
    "lme_scatter2d": ("nlpartsol_tpu/ops/pallas_transfer.py:624", None),
    "lme_gather2d": ("nlpartsol_tpu/ops/pallas_transfer.py:815", None),
    "lme_scatter3d": ("nlpartsol_tpu/ops/pallas_transfer3d.py:1176",
                      "nlpartsol_tpu/ops/pallas_transfer3d.py:741"),
    "lme_gather3d": ("nlpartsol_tpu/ops/pallas_transfer3d.py:1427",
                     "nlpartsol_tpu/ops/pallas_transfer3d.py:1038"),
}


def _bound(n_bytes, n_ops):
    t_b, t_o = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOPS
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def phase_roofline(grid, p1, mats, cfg, counts):
    """Each kernel at the shapes (and on the state) the main path gives it,
    against its plain version: error, time, plain time, bound.  In 3D the
    four calls are also timed at margin 1 (rows ``…@margin1``, 432 window
    offsets): the window a re-bin period k > 1 would need.  The 3D main path
    (k = 1) runs none of them, so their launches are those of their own
    timed run."""
    d = grid.dim
    main = 0 if cfg.rebin_every == 1 else 1
    margins = [main] + ([1] if d == 3 and main == 0 else [])
    rows, stats = [], []
    for margin in margins:
        stats.append(_roofline_rows(grid, p1, cfg, counts if margin == main else None,
                                    margin, rows))
    say(phase="roofline" + _suffix(d), slots=cfg.active_box.n_slots,
        active=int(p1.active.sum()), margins=stats,
        peaks=dict(f32_flops=PEAK_F32_FLOPS, bytes_per_s=PEAK_BYTES_PER_S))
    return rows


def _kernel_row(rows, name, key, d, fn_kernel, fn_plain, checks, n_bytes, n_ops, launches,
                flush, **extra):
    """Check one kernel call against its plain version, time both (median of
    10 and 2 launches, L2 flushed before each) and append its row of the
    ``"kernels"`` line; ``launches`` is a number, or None for the count of
    this row's own timed run.  Returns the kernel's output."""
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    got, ref = fn_kernel(), fn_plain()
    torch.cuda.synchronize()
    err = 0.0
    for label, pick, tol in checks:
        err = max(err, compare(f"{name}:{label}", pick(got), pick(ref), **tol)["max_abs"])
    del ref
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    replaces, also = REPLACES[key.split(":")[0]]
    ft.reset_launch_counts()
    ms = cuda_ms(fn_kernel, 10, flush)
    rows.append(dict(
        name=name, route="cuda", source=f"nlpartsol_tpu_torch/csrc/lme_transfer{d}d.cu",
        replaces=replaces, **({"also_replaces": also} if also else {}),
        launches=launches if launches is not None else ft.launch_counts[key],
        max_abs_err=err, ms=ms, plain_ms=cuda_ms(fn_plain, 2, flush),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        bytes=n_bytes, operations=n_ops, **extra))
    return got


def _slot_bytes(p, box, n_nodes):
    """Bytes of one float32 channel over the active slots, the idle slots
    (the function needs only ``active`` of an idle slot, and in the scatter
    its λ, which passes through), all slots, and all nodes."""
    n_active = int(p.active.sum())
    return 4 * n_active, 4 * (box.n_slots - n_active), 4 * box.n_slots, 4 * n_nodes


def _roofline_rows(grid, p, cfg, counts, margin, rows, path_tag=""):
    """The four calls of a step at ``margin``, appended to ``rows``;
    ``counts`` are the main path's launches (or, with ``path_tag``, those of
    the path it names), or None off the path."""
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    d = grid.dim
    ops_of = OPS[d]
    box, params = cfg.active_box, cfg.lme_params
    C, nc = box.capacity, box.n_cells
    dt = cfg.dt
    x_t = ft.to_channel_leading(p.x, C, nc)
    lam_t = ft.to_channel_leading(p.lme_lambda, C, nc)
    act_t = ft.to_channel_leading(p.active.float(), C, nc)
    d_dis = dt * p.v + 0.5 * dt * dt * p.a
    fN = ft.to_channel_leading(torch.cat([p.mass[:, None], p.mass[:, None] * d_dis], 1), C, nc)
    cN = d + 1
    base = (grid, box, params, x_t)
    n_offs = len(ft._geom(grid, params, margin).offsets)
    n_active = int(p.active.sum())
    b_act, b_idle, b_all, b_nodes = _slot_bytes(p, box, grid.n_nodes)
    tests = n_active * n_offs * ops_of["test"]
    per_eval = ops_of["f"] + 1 + ops_of["mom"]
    # 1 GiB: rewriting it keeps the card busy longer than the host needs to
    # queue the next launch, so the events bracket device time only
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=p.x.device)
    scatter, gather = f"lme_scatter{d}d", f"lme_gather{d}d"
    tag = path_tag if counts is not None else f"@margin{margin}"
    off_path = {}
    if counts is None:
        off_path = dict(path=f"none: the {d}D main path runs margin 0 (k = 1); "
                             "launches are those of this row's timed run")

    def row(key, fn_kernel, fn_plain, checks, n_bytes, n_ops):
        return _kernel_row(rows, key + tag, key, d, fn_kernel, fn_plain, checks, n_bytes, n_ops,
                           counts[key] if counts is not None else None, flush, **off_path)

    # per slot: x and λ in, λ out (d each), active 1
    slot_io = 3 * d + 1
    # scatter #1: λ solve + mass and momentum increment
    _, _, cnt = ft.scatter_cuda(grid, box, params, x_t, lam_t, act_t, fN, solve=True,
                                margin=margin)
    nnz, iters = (int(v) for v in cnt)
    # the last iteration's exponentials are those of the emitted basis
    ops = tests + iters * (nnz / n_active) * per_eval + nnz * (ops_of["n"] + cN * ops_of["ch"])
    nodes1, lam_new, _ = row(
        f"{scatter}:solve",
        lambda: ft.fused_scatter(*base, lam_t, act_t, fN, solve=True, margin=margin),
        lambda: ft._scatter_plain(*base, lam_t, act_t, fN, None, True, margin, False),
        [("nodes", lambda o: o[0], TOL_N)],
        (slot_io + cN) * b_act + (2 * d + 1) * b_idle + cN * b_nodes, ops)
    m_safe = torch.clamp(nodes1[:, 0], min=cfg.mass_tol)[:, None]
    d_dis_nodes = nodes1[:, 1:1 + d] / m_safe

    # scatter #2: internal forces Σ G·∇N at fixed λ (G = −V0·τ of this state)
    G_t = ft.to_channel_leading((-p.vol0[:, None, None] * p.stress).reshape(-1, d * d), C, nc)
    dummy = ft.to_channel_leading(torch.zeros_like(p.mass), C, nc)
    per_edge = per_eval + ops_of["n"] + ops_of["dn"] + ops_of["ch"] + ops_of["g"]
    nodes2, _, _ = row(
        f"{scatter}:G",
        lambda: ft.fused_scatter(*base, lam_new, act_t, dummy, G_t=G_t, solve=False,
                                 margin=margin),
        lambda: ft._scatter_plain(*base, lam_new, act_t, dummy, G_t, False, margin, False),
        [("forces", lambda o: o[0][:, 1:], TOL_GRAD)],
        (slot_io + 1 + d * d) * b_act + (2 * d + 1) * b_idle + (1 + d) * b_nodes,
        tests + nnz * per_edge)
    accel = (nodes2[:, 1:1 + d] / m_safe).contiguous()

    # gather #1: smoothed Δu and its gradient (per slot: x, λ, active in)
    per_edge = per_eval + ops_of["n"] + ops_of["dn"] + d * ops_of["ch"] + ops_of["grad"]
    row(f"{gather}:N+grad",
        lambda: ft.fused_gather(*base, lam_new, act_t, gN=d_dis_nodes, g_grad=d_dis_nodes,
                                margin=margin),
        lambda: ft._gather_plain(*base, lam_new, act_t, d_dis_nodes, d_dis_nodes, margin),
        [("N", lambda o: o[0], TOL_N), ("grad", lambda o: o[1], TOL_GRAD)],
        (2 * d + 1) * b_act + b_idle + d * b_nodes + (d + d * d) * b_all,
        tests + nnz * per_edge)

    # gather #2: accelerations
    per_edge = ops_of["f"] + 1 + 1 + ops_of["n"] + d * ops_of["ch"]
    row(f"{gather}:N",
        lambda: ft.fused_gather(*base, lam_new, act_t, gN=accel, margin=margin),
        lambda: ft._gather_plain(*base, lam_new, act_t, accel, None, margin),
        [("N", lambda o: o[0], TOL_N)],
        (2 * d + 1) * b_act + b_idle + d * b_nodes + d * b_all, tests + nnz * per_edge)
    return dict(margin=margin, window_offsets=n_offs, nnz=nnz,
                newton_iterations_per_active_slot=iters / n_active)


# The implicit Newmark step (scripts/bench_implicit.py's configuration): the
# problems of ``PROBLEMS`` at its width — 2D bench.build_problem(256, ppc=2),
# 65,536 particles in a capacity-6 box of 132² cells; 3D scripts/bench3d.py's
# 96³, 110,592 particles, capacity 2, 52³ cells — with dt = 2h/c, Jacobi-
# preconditioned Newton-CG (cg_maxiter 60, newton_maxiter 10, Eisenstat-
# Walker forcing) on the fused kernels and a local re-bin after every step;
# warm-up and timed steps, and the steps of the parity leg.
IMPLICIT = {
    2: dict(n_side=256, warm=1, steps=1, parity_steps=2),  # steps 5 → 1 (time limit)
    3: dict(n_side=96, warm=1, steps=1, parity_steps=2),  # steps 3 → 1 (time limit)
}


def build_implicit(dim, device, n_side=None):
    from nlpartsol_tpu_torch.formulations.implicit import ImplicitConfig

    spec = IMPLICIT[dim]
    grid, p, mats, cfg_e, h = build_problem(dim, n_side or spec["n_side"], device)
    cfg = ImplicitConfig(
        dt=2.0 * h / np.sqrt(1e7 / 1000.0), lme_params=cfg_e.lme_params, kinds=cfg_e.kinds,
        active_box=cfg_e.active_box, cg_maxiter=60, newton_maxiter=10, forcing="ew",
        transfer="fused")
    return grid, p, mats, cfg, h


def _implicit_steps(label, p, grid, mats, cfg, steps, timed=None):
    """``steps`` implicit steps; each must converge and lose nothing.
    Returns the particles and the per-step (newton, cg, nnz, residual) and, with
    ``timed`` (a list), each step's host time in ms (synchronised)."""
    from nlpartsol_tpu_torch.formulations.implicit import implicit_step

    body = torch.zeros(grid.dim, dtype=p.x.dtype, device=p.x.device)
    hist = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, dg = implicit_step(p, grid, mats, cfg, body)
        torch.cuda.synchronize()
        if timed is not None:
            timed.append(1e3 * (time.perf_counter() - t0))
        if not bool(dg["converged"]):
            raise PhaseError(f"{label}: step {i} did not converge "
                             f"(residual {float(dg['newton_residual'])})")
        _check_state(label, p, dict(lost=dg["lost"]))
        hist.append((dg["newton_iters"], dg["cg_iters"], int(dg["nnz"]),
                     float(dg["newton_residual"])))
    return p, hist


def _residual_costs(step_without_newton, reps=10, profile_label=None):
    """Host ms of one residual of the Newton loop and of one J·v (forward
    mode, primal and tangent), each synchronised, and ‖R₀‖, at the step's
    first iterate: the residual is taken from ``solvers.newton_krylov``'s
    arguments in a step that runs no Newton iteration
    (``step_without_newton()``).  With ``profile_label``, also ``reps`` J·v
    under torch.profiler (``profiled_jv``: device time and busy share of the
    J·v loop, which is nearly all of a GMRES step; a whole such step has
    several hundred thousand kernels, and the profiler takes minutes over
    them)."""
    from nlpartsol_tpu_torch.ops import solvers

    seen, real = {}, solvers.newton_krylov

    def spy(residual, x0, **kw):
        seen.update(residual=residual, x0=x0)
        return real(residual, x0, **kw)

    solvers.newton_krylov = spy
    try:
        step_without_newton()
    finally:
        solvers.newton_krylov = real
    R, x0 = seen["residual"], seen["x0"]
    v = torch.full_like(x0, 1e-6)

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    out = dict(residual_ms=host_ms(lambda: R(x0)), jv_ms=host_ms(lambda: solvers.jvp(R, x0, v)),
               r0_norm=float(torch.linalg.vector_norm(R(x0))))
    if profile_label is not None:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                solvers.jvp(R, x0, v)
            torch.cuda.synchronize()
        out["profiled_jv"] = dict(reps=reps, **_profiled_step(
            prof, reps * out["jv_ms"], profile_label))
    return out


def phase_implicit(device, dim):
    """The implicit step on the fused kernels: warm-up, then timed steps with
    the launch counts and host syncs set to 0 just before and read just
    after, launches held to the formula of formulations/implicit.py, then
    one profiled step (device time by kernel) and the host time of one
    residual and of one J·v."""
    from torch.profiler import ProfilerActivity, profile

    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
    from nlpartsol_tpu_torch.formulations.implicit import implicit_step
    from nlpartsol_tpu_torch.ops import fused_transfer as ft
    from nlpartsol_tpu_torch.ops import solvers

    spec = IMPLICIT[dim]
    label = "implicit" + _suffix(dim)
    grid, p0, mats, cfg, h = build_implicit(dim, device)
    p1, _ = _implicit_steps(label, to_slot_layout(p0, grid, cfg.active_box), grid, mats, cfg,
                            spec["warm"])
    torch.cuda.reset_peak_memory_stats()
    ft.reset_launch_counts()
    solvers.reset_host_syncs()
    times = []
    p2, hist = _implicit_steps(label, p1, grid, mats, cfg, spec["steps"], times)
    counts, syncs = dict(ft.launch_counts), dict(solvers.host_syncs)
    steps = spec["steps"]
    n_tot = sum(h[0] for h in hist)
    l_tot = sum(h[1] for h in hist)
    sc, ga = f"lme_scatter{dim}d", f"lme_gather{dim}d"
    want = {f"{sc}:solve+gnorm": steps, f"{ga}:grad": 3 * steps + 7 * n_tot + 2 * l_tot,
            f"{sc}:G": steps + 7 * n_tot + 2 * l_tot, f"{ga}:N": steps}
    if counts != want:
        raise PhaseError(f"{label}: launch counts {counts}, expected {want}")
    seconds = 1e-3 * sum(times)
    total_nnz = sum(h[2] for h in hist)
    peak = torch.cuda.max_memory_allocated()

    # one more step under torch.profiler: device time, and its share in the
    # four transfer kernels; busy share against the timed steps' median
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _implicit_steps(label, p2, grid, mats, cfg, 1)
        torch.cuda.synchronize()
    costs = _residual_costs(lambda: implicit_step(
        p2, grid, mats, cfg.replace(newton_maxiter=0),
        torch.zeros(grid.dim, dtype=p2.x.dtype, device=p2.x.device)))

    say(phase=label, grid="x".join(map(str, grid.dims)), particles=p0.count,
        slots=cfg.active_box.n_slots, dt=cfg.dt, warmup_steps=spec["warm"], steps=steps,
        ms_per_step=1e3 * seconds / steps, step_ms=times, nnz_per_step=total_nnz / steps,
        nnz_per_s=total_nnz / seconds,
        newton_iters=[h[0] for h in hist], cg_iters=[h[1] for h in hist],
        newton_residual=[h[3] for h in hist], r0_norm_next_step=costs["r0_norm"],
        converged=True, lost=0, host_syncs_per_step=sum(syncs.values()) / steps,
        host_syncs=syncs, launches=counts, launches_expected=want, peak_device_bytes=peak,
        host_ms_per_residual=costs["residual_ms"], host_ms_per_jv=costs["jv_ms"],
        profiled_step=_profiled_step(prof, float(np.median(times)), label))
    return grid, p1, mats, cfg, h, counts, steps


def _profiled_step(prof, host_ms, label):
    """Device time of a profiled step (CUDA events only), its share in the
    transfer kernels, its busy share against ``host_ms``, and its top
    kernels."""

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    total_us = sum(dev_us(e) for e in kernels)
    if total_us <= 0:
        raise PhaseError(f"{label}: torch.profiler recorded no device time")
    lme_us = sum(dev_us(e) for e in kernels if "lme_" in e.key)
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return dict(device_ms=1e-3 * total_us, device_busy_share=1e-3 * total_us / host_ms,
                lme_kernel_ms=1e-3 * lme_us, lme_kernel_share=lme_us / total_us,
                device_kernels=sum(e.count for e in kernels),
                top=[dict(name=e.key[:60], count=e.count, device_ms=1e-3 * dev_us(e))
                     for e in top])


def phase_implicit_parity(grid, p1, mats, cfg, h):
    """The same implicit steps from the same state through the fused kernels
    and the port's windowed engine on the card, matched by pid; Newton
    iterations must be equal, CG totals are reported side by side."""
    dim = grid.dim
    label = "implicit_parity" + _suffix(dim)
    steps = IMPLICIT[dim]["parity_steps"]
    pf, hist_f = _implicit_steps(label + ":fused", p1, grid, mats, cfg, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    pw, hist_w = _implicit_steps(label + ":windowed", p1, grid, mats,
                                 cfg.replace(transfer="windowed"), steps, times)
    rel_dx, rel_dv = _parity(pf, pw, h, label)
    newton_f, newton_w = [h[0] for h in hist_f], [h[0] for h in hist_w]
    ok = rel_dx < 1e-3 and rel_dv < 1e-2 and newton_f == newton_w
    say(phase=label, steps=steps, rel_dx=rel_dx, rel_dv=rel_dv, limit_dx=1e-3, limit_dv=1e-2,
        newton_fused=newton_f, newton_windowed=newton_w,
        cg_fused=[h[1] for h in hist_f], cg_windowed=[h[1] for h in hist_w],
        nnz_fused=[h[2] for h in hist_f], nnz_windowed=[h[2] for h in hist_w],
        windowed_ms_per_step=float(np.mean(times)),
        windowed_peak_device_bytes=torch.cuda.max_memory_allocated(), ok=ok)
    if not ok:
        raise PhaseError(f"{label}: rel_dx {rel_dx}, rel_dv {rel_dv}, Newton "
                         f"{newton_f} vs {newton_w}")


def phase_implicit_roofline(grid, p, mats, cfg, counts, steps):
    """The implicit step's four call variants at its shapes and on its state,
    against their plain versions (margin 0): the λ solve with gnorm (mass,
    momenta, stiffness scale), the gradient gather and the G-scatter of each
    residual, the last N-gather of 3·d channels; launches from the timed
    run, and per step."""
    from nlpartsol_tpu_torch.models.materials import lame_parameters
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    d = grid.dim
    ops_of = OPS[d]
    box, params = cfg.active_box, cfg.lme_params
    C, nc = box.capacity, box.n_cells
    x_t, lam_t, act_t = (ft.to_channel_leading(a, C, nc)
                         for a in (p.x, p.lme_lambda, p.active.float()))
    base = (grid, box, params, x_t)
    n_offs = len(ft._geom(grid, params, 0).offsets)
    n_active = int(p.active.sum())
    b_act, b_idle, b_all, b_nodes = _slot_bytes(p, box, grid.n_nodes)
    tests = n_active * n_offs * ops_of["test"]
    per_eval = ops_of["f"] + 1 + ops_of["mom"]
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=p.x.device)
    scatter, gather = f"lme_scatter{d}d", f"lme_gather{d}d"
    rows = []

    def row(key, fn_kernel, fn_plain, checks, n_bytes, n_ops):
        return _kernel_row(rows, f"{key}@implicit", key, d, fn_kernel, fn_plain, checks, n_bytes,
                           n_ops, counts[key], flush, launches_per_step=counts[key] / steps,
                           path=f"implicit{_suffix(d)}")

    slot_io = 3 * d + 1
    mid = p.mat_id.long()
    lam_p, G_p = lame_parameters(mats.E[mid], mats.nu[mid])
    stiff = (lam_p + 2.0 * G_p) * p.vol0
    fN = ft.to_channel_leading(
        torch.cat([p.mass[:, None], p.mass[:, None] * p.v, p.mass[:, None] * p.a, stiff[:, None]],
                  1), C, nc)
    cN = 2 * d + 2
    _, _, cnt = ft.scatter_cuda(grid, box, params, x_t, lam_t, act_t, fN, solve=True, gnorm=True)
    nnz, iters = (int(v) for v in cnt)
    ops = (tests + iters * (nnz / n_active) * per_eval
           + nnz * (ops_of["n"] + ops_of["dn"] + ops_of["gn"] + cN * ops_of["ch"]))
    nodes1, lam_new, _ = row(
        f"{scatter}:solve+gnorm",
        lambda: ft.fused_scatter(*base, lam_t, act_t, fN, solve=True, gnorm=True),
        lambda: ft._scatter_plain(*base, lam_t, act_t, fN, None, True, 0, True),
        [("nodes", lambda o: o[0][:, :cN], TOL_N), ("gnorm", lambda o: o[0][:, cN:], TOL_GRAD)],
        (slot_io + cN) * b_act + (2 * d + 1) * b_idle + (cN + 1) * b_nodes, ops)
    vel = (nodes1[:, 1:1 + d] / torch.clamp(nodes1[:, :1], min=cfg.mass_tol)).contiguous()

    per_edge = per_eval + ops_of["n"] + ops_of["dn"] + ops_of["grad"]
    row(f"{gather}:grad",
        lambda: ft.fused_gather(*base, lam_new, act_t, g_grad=vel),
        lambda: ft._gather_plain(*base, lam_new, act_t, None, vel, 0),
        [("grad", lambda o: o[1], TOL_GRAD)],
        (2 * d + 1) * b_act + b_idle + d * b_nodes + d * d * b_all, tests + nnz * per_edge)

    G_t = ft.to_channel_leading((p.vol0[:, None, None] * p.stress).reshape(-1, d * d), C, nc)
    zero = ft.to_channel_leading(torch.zeros_like(p.mass), C, nc)
    per_edge = per_eval + ops_of["n"] + ops_of["dn"] + ops_of["ch"] + ops_of["g"]
    row(f"{scatter}:G",
        lambda: ft.fused_scatter(*base, lam_new, act_t, zero, G_t=G_t, solve=False),
        lambda: ft._scatter_plain(*base, lam_new, act_t, zero, G_t, False, 0, False),
        [("forces", lambda o: o[0][:, 1:], TOL_GRAD)],
        (slot_io + 1 + d * d) * b_act + (2 * d + 1) * b_idle + (1 + d) * b_nodes,
        tests + nnz * per_edge)

    fields = torch.cat([vel, 2.0 * vel, -vel], 1).contiguous()
    per_edge = ops_of["f"] + 1 + 1 + ops_of["n"] + 3 * d * ops_of["ch"]
    row(f"{gather}:N",
        lambda: ft.fused_gather(*base, lam_new, act_t, gN=fields),
        lambda: ft._gather_plain(*base, lam_new, act_t, fields, None, 0),
        [("N", lambda o: o[0], TOL_N)],
        (2 * d + 1) * b_act + b_idle + 3 * d * b_nodes + 3 * d * b_all, tests + nnz * per_edge)
    say(phase="roofline_implicit" + _suffix(d), slots=box.n_slots, active=n_active,
        window_offsets=n_offs, nnz=nnz, newton_iterations_per_active_slot=iters / n_active,
        rows=[dict(name=r["name"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                   launches_per_step=r["launches_per_step"]) for r in rows])
    return rows


# The soil-water mixture (u-pw) steps: scripts/bench_upw.py's problems,
# rebuilt in numpy at their widths — bench.build_problem(n, ppc=2) with the
# box of ``build_problem`` (2D: offset n/4 − 2, n/2 + 4 cells, capacity 6),
# Neo-Hookean soil (E 1e7, ν 0.3, ρ 2700) and compressible water (ρ 1000,
# K_f 2.2e7), φ_s0 0.6, φ_f0 0.4, k 1e-5, gravity (0, −9.81), LME γ=3, fused
# engine: explicit 512², dt = 0.25·h/c_mix with c_mix = √((K_f/φ_f0)/1700),
# local re-bin every step; implicit 256², dt 20× that, Newton-GMRES.  Depth:
# warm-up and timed steps, parity steps (the script times 16 explicit and 8
# implicit steps).
UPW = dict(n_side=512, warm=4, steps=16, parity_steps=8)
# timed steps 3 → 1 (u-p's and DEM's 2 → 1) to keep the whole script inside its
# limit with the unstructured phases (PERF.md §5: host-bound, 15-25 s a step);
# parity steps 2 → 1 (u-p's 2 → 1) and warm-up steps 1 → 0 (u-p's and DEM's) with
# the implicit-models phases
UPW_IMPLICIT = dict(n_side=256, warm=0, steps=1, parity_steps=1, parity_n_side=128)
# per explicit step: 3 scatters and 5 gathers, by launch key
UPW_LAUNCHES = {"lme_scatter2d:solve": 1, "lme_scatter2d:G": 2, "lme_gather2d:N+grad": 1,
                "lme_gather2d:grad": 2, "lme_gather2d:N": 2}
C_MIX = float(np.sqrt((2.2e7 / 0.4) / 1700.0))


def build_upw(device, implicit, n_side=None, soil=None):
    """bench_upw.py's problem; ``soil`` (a material row without E, ν, ρ)
    replaces its Neo-Hookean soil, started at κ = κ0."""
    from nlpartsol_tpu_torch.formulations import upw
    from nlpartsol_tpu_torch.models import materials as M

    spec = UPW_IMPLICIT if implicit else UPW
    grid, p, _, cfg_e, h = build_problem(2, n_side or spec["n_side"], device)
    soil = soil or dict(kind="Neo-Hookean-Wriggers")
    mats = M.material_table(
        [M.material(E=1e7, nu=0.3, rho0=2700.0, **soil),
         M.material(kind="Newtonian-Fluid-Compressible", rho0=1000.0, compressibility=2.2e7)],
        device=device)
    mix = upw.make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=1e-5)], device=device)
    p = upw.init_mixture_state(p, mats, mix)
    p = p.replace(kappa=torch.full_like(p.kappa, float(mats.kappa0[0])))
    dt = 0.25 * h / C_MIX
    common = dict(lme_params=cfg_e.lme_params, kinds=tuple(sorted({cfg_e.kinds[0],
                                                                  int(mats.kind[0])})),
                  transfer="fused", active_box=cfg_e.active_box)
    cfg = (upw.UpwImplicitConfig(dt=20 * dt, **common) if implicit
           else upw.UpwConfig(dt=dt, **common))
    return grid, p, mats, mix, cfg, h


def _upw_body(p):
    return torch.tensor([0.0, -9.81], dtype=p.x.dtype, device=p.x.device)


def _check_upw(label, p, lost):
    act = p.active
    for name in ("x", "v", "F", "pw"):
        if not bool(torch.isfinite(getattr(p, name)[act]).all()):
            raise PhaseError(f"{label}: non-finite {name}")
    if int(lost) != 0:
        raise PhaseError(f"{label}: {int(lost)} particles lost")


def phase_upw(device):
    """The explicit u-pw step through ``upw.run`` (``to_slot_layout`` + a
    loop with no host read): warm-up, then timed steps with the launch
    counts set to 0 just before and read just after (3 scatters and 5
    gathers a step)."""
    from nlpartsol_tpu_torch.formulations import upw
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    grid, p0, mats, mix, cfg, h = build_upw(device, implicit=False)
    body = _upw_body(p0)
    p1, _ = upw.run(p0, grid, mats, mix, cfg, UPW["warm"], body)
    steps = UPW["steps"]
    torch.cuda.reset_peak_memory_stats()
    ft.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2, diag = upw.run(p1, grid, mats, mix, cfg, steps, body)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(ft.launch_counts)
    _check_upw("upw", p2, diag["lost"].sum())
    if int(p2.active.sum()) != p0.count:
        raise PhaseError(f"upw: {int(p2.active.sum())} active particles of {p0.count}")
    want = {k: n * steps for k, n in UPW_LAUNCHES.items()}
    if counts != want:
        raise PhaseError(f"upw: launch counts {counts}, expected {want}")
    total_nnz = int(diag["nnz"].long().sum())
    pw = p2.pw[p2.active]
    say(phase="upw", grid="x".join(map(str, grid.dims)), particles=p0.count,
        slots=cfg.active_box.n_slots, dt=cfg.dt, warmup_steps=UPW["warm"], steps=steps,
        ms_per_step=1e3 * seconds / steps, nnz_per_step=total_nnz / steps,
        nnz_per_s=total_nnz / seconds, lost=0, launches=counts,
        launches_per_step={k: v / steps for k, v in counts.items()},
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        pw_min=float(pw.min()), pw_max=float(pw.max()), finite=True)
    return grid, p0, p2, mats, mix, cfg, h, counts


def _upw_parity(pf, pw_, h, label, pw_tol):
    """rel_dx (over h), rel_dv (over the largest speed) and the pore
    pressure's largest difference over its largest magnitude, by pid."""
    rel_dx, rel_dv, (pf_, pww) = _parity(pf, pw_, h, label, ("x", "v", "pw"))
    pw_scale = max(float(pww.abs().max()), 1e-30)
    rel_dpw = float((pf_ - pww).abs().max()) / pw_scale
    ok = rel_dx < 1e-3 and rel_dv < 1e-2 and rel_dpw < pw_tol
    return dict(rel_dx=rel_dx, rel_dv=rel_dv, rel_dpw=rel_dpw, pw_scale=pw_scale,
                limit_dx=1e-3, limit_dv=1e-2, limit_dpw=pw_tol), ok


def column_problem(device):
    """tests/test_upw.py::column_setup rebuilt in numpy: 2×10 cells of h =
    0.1, 2×2 particles a cell, bottom fixed in y, no x motion, Neo-Hookean
    soil (E 1e7, ν 0.3, ρ 2700) and water (ρ 1000, K_f 2.2e9), k = 1e-5;
    the box over the whole grid at capacity 8, LME γ=3, dt = 0.2·h/c_mix
    (test_upw.py::test_upw_pallas_parity)."""
    from nlpartsol_tpu_torch.formulations import upw
    from nlpartsol_tpu_torch.models import materials as M
    from nlpartsol_tpu_torch.ops import windowed
    from nlpartsol_tpu_torch.shapefun import lme
    from nlpartsol_tpu_torch.types import Grid, make_particles

    nx, ny, h, ppc = 2, 10, 0.1, 2
    dims = (nx + 1, ny + 1)
    ids = np.arange(dims[0] * dims[1]).reshape(dims)
    fixed = np.zeros((ids.size, 2), bool)
    fixed[ids[:, 0], 1] = True
    fixed[:, 0] = True
    grid = Grid(dims=dims, spacing=h, origin=(0.0, 0.0),
                dirichlet_mask=torch.as_tensor(fixed, device=device),
                dirichlet_value=torch.zeros((ids.size, 2), device=device))
    i, j, a, b = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(ppc), np.arange(ppc),
                             indexing="ij")
    x = np.stack([(i + (a + 0.5) / ppc) * h, (j + (b + 0.5) / ppc) * h], -1).reshape(-1, 2)
    vol = (h / ppc) ** 2
    p = make_particles(x.astype(np.float32), mass=np.full(len(x), vol, np.float32),
                       vol0=np.full(len(x), vol, np.float32), device=device)
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=1e7, nu=0.3, rho0=2700.0),
         M.material(kind="Newtonian-Fluid-Compressible", rho0=1000.0, compressibility=2.2e9)],
        device=device)
    mix = upw.make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=1e-5)], device=device)
    cfg = upw.UpwConfig(dt=0.2 * h / float(np.sqrt((2.2e9 / 0.4) / 1700.0)),
                        lme_params=lme.LMEParams(gamma=3.0), kinds=(M.NEO_HOOKEAN,),
                        transfer="fused", active_box=windowed.full_box(grid, capacity=8))
    return grid, upw.init_mixture_state(p, mats, mix), mats, mix, cfg, h


def phase_upw_parity(grid, p0, mats, mix, cfg, h):
    """The same explicit u-pw steps from the same state through the fused
    kernels and the windowed engine on the card, matched by pid.  The 512²
    problem, 8 steps: rel_dx < 1e-3, rel_dv < 1e-2 (bench.py's gate between
    engines) and pw within 1e-4 of its largest magnitude; tests/test_upw.py's
    column, 25 steps: x within 1e-6, pw within 1e-5 of its largest
    magnitude, φ_f within 1e-6 (the JAX package's limits between its
    engines on that problem, test_upw.py:369-373).  On the 512² problem the
    strain increments are a few 1e-6, near float32's resolution of F, and
    the pore pressure carries that rounding: the two engines differ by
    about 1e-5 of it in float32 and by 4e-16 in float64 (PERF.md, PR 6)."""
    from nlpartsol_tpu_torch.formulations import upw

    steps = UPW["parity_steps"]
    body = _upw_body(p0)
    pf, diag_f = upw.run(p0, grid, mats, mix, cfg, steps, body)
    _check_upw("upw_parity:fused", pf, diag_f["lost"].sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pw_, diag_w = upw.run(p0, grid, mats, mix, cfg.replace(transfer="windowed"), steps, body)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _check_upw("upw_parity:windowed", pw_, diag_w["lost"].sum())
    out, ok = _upw_parity(pf, pw_, h, "upw_parity", 1e-4)
    # the JAX package's own parity problem and limits
    cg, cp, cm, cmix, ccfg, ch = column_problem(p0.x.device)
    cbody = _upw_body(cp)
    col = {}
    for transfer in ("fused", "windowed"):
        q, dq = upw.run(cp, cg, cm, cmix, ccfg.replace(transfer=transfer), 25, cbody)
        _check_upw(f"upw_parity:column:{transfer}", q, dq["lost"].sum())
        col[transfer] = _by_pid_fields(q, ("x", "pw", "phi_f"))
    (pid_f, (xf, pwf, ff)), (pid_w, (xw, pww, fw)) = col["fused"], col["windowed"]
    if not bool((pid_f == pid_w).all()):
        raise PhaseError("upw_parity:column: particle sets differ")
    pw_scale = max(float(pww.abs().max()), 1.0)
    column = dict(steps=25, particles=cp.count, dx=float((xf - xw).abs().max()),
                  rel_dpw=float((pwf - pww).abs().max()) / pw_scale,
                  dphi_f=float((ff - fw).abs().max()), pw_scale=pw_scale,
                  limits=dict(dx=1e-6, rel_dpw=1e-5, dphi_f=1e-6))
    col_ok = (column["dx"] <= 1e-6 and column["rel_dpw"] <= 1e-5 and column["dphi_f"] <= 1e-6
              and pw_scale > 1.0)
    say(phase="upw_parity", steps=steps, **out, nnz_fused=int(diag_f["nnz"].long().sum()),
        nnz_windowed=int(diag_w["nnz"].long().sum()), windowed_ms_per_step=1e3 * seconds / steps,
        windowed_peak_device_bytes=torch.cuda.max_memory_allocated(), column=column,
        ok=ok and col_ok)
    if not (ok and col_ok):
        raise PhaseError(f"upw_parity: {out}, column {column}")


def upw_implicit_launches(steps, n, L, K):
    """The launches of ``steps`` fused implicit u-pw steps with n Newton
    iterations, L GMRES iterations and K GMRES convergence checks in all:
    the formula of formulations/upw.py's docstring."""
    R = steps + 5 * n
    V = n + K + 21 * L // 20
    return {"lme_scatter2d:solve+gnorm": steps, "lme_scatter2d:gnorm": steps,
            "lme_gather2d:N+grad": 2 * steps + R + 2 * V, "lme_gather2d:grad": 2 * steps + R + 2 * V,
            "lme_scatter2d:G": 2 * R + 4 * V, "lme_gather2d:N": steps}


def _upw_implicit_steps(label, p, grid, mats, mix, cfg, steps, timed=None):
    """``steps`` implicit u-pw steps; each must end its Newton loop by the
    reference's rules and lose nothing.  Returns the particles and per step
    (Newton, GMRES, nnz, residual, GMRES convergence checks, converged)."""
    from nlpartsol_tpu_torch.formulations import upw
    from nlpartsol_tpu_torch.ops import solvers

    body = _upw_body(p)
    hist = []
    for i in range(steps):
        k0 = solvers.host_syncs["krylov"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, dg = upw.upw_newmark_step(p, grid, mats, mix, cfg, body)
        torch.cuda.synchronize()
        if timed is not None:
            timed.append(1e3 * (time.perf_counter() - t0))
        # the reference's own stopping rules end the loop (tolerance, or a
        # stall at the float32 floor) before newton_maxiter; whether the
        # stall meets its converged rule (‖R‖ ≤ 1e-2·‖R₀‖) is reported: on
        # this problem the JAX package's step stalls above it as the port's
        # does (PERF.md, PR 6)
        if dg["newton_iters"] >= cfg.newton_maxiter or not np.isfinite(
                float(dg["newton_residual"])):
            raise PhaseError(f"{label}: step {i} ran out of Newton iterations "
                             f"(residual {float(dg['newton_residual'])})")
        _check_upw(label, p, dg["lost"])
        hist.append((dg["newton_iters"], dg["cg_iters"], int(dg["nnz"]),
                     float(dg["newton_residual"]), solvers.host_syncs["krylov"] - k0,
                     bool(dg["converged"])))
    return p, hist


def phase_upw_implicit(device):
    """The implicit u-pw step on the fused kernels: a warm-up step, then
    timed steps with the launch counts and host syncs set to 0 just before
    and read just after, launches held to the formula of
    formulations/upw.py, host ms per residual and per J·v, and 5 J·v
    under the profiler (device time and busy share of the J·v loop)."""
    from nlpartsol_tpu_torch.formulations import upw
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
    from nlpartsol_tpu_torch.ops import fused_transfer as ft
    from nlpartsol_tpu_torch.ops import solvers

    spec = UPW_IMPLICIT
    grid, p0, mats, mix, cfg, h = build_upw(device, implicit=True)
    p1, _ = _upw_implicit_steps("upw_implicit", to_slot_layout(p0, grid, cfg.active_box), grid,
                                mats, mix, cfg, spec["warm"])
    torch.cuda.reset_peak_memory_stats()
    ft.reset_launch_counts()
    solvers.reset_host_syncs()
    times = []
    steps = spec["steps"]
    p2, hist = _upw_implicit_steps("upw_implicit", p1, grid, mats, mix, cfg, steps, times)
    counts, syncs = dict(ft.launch_counts), dict(solvers.host_syncs)
    n_tot, l_tot = sum(x[0] for x in hist), sum(x[1] for x in hist)
    want = upw_implicit_launches(steps, n_tot, l_tot, syncs.get("krylov", 0))
    if counts != want:
        raise PhaseError(f"upw_implicit: launch counts {counts}, expected {want}")
    seconds = 1e-3 * sum(times)
    total_nnz = sum(x[2] for x in hist)
    peak = torch.cuda.max_memory_allocated()
    costs = _residual_costs(lambda: upw.upw_newmark_step(
        p2, grid, mats, mix, cfg.replace(newton_maxiter=0), _upw_body(p2)), reps=5,
        profile_label="upw_implicit")

    say(phase="upw_implicit", grid="x".join(map(str, grid.dims)), particles=p0.count,
        slots=cfg.active_box.n_slots, dt=cfg.dt, warmup_steps=spec["warm"], steps=steps,
        depth_cut=f"1 warm-up + {steps} timed step(s) (scripts/bench_upw.py --implicit times 8)",
        ms_per_step=1e3 * seconds / steps, step_ms=times, nnz_per_step=total_nnz / steps,
        nnz_per_s=total_nnz / seconds, newton_iters=[x[0] for x in hist],
        gmres_iters=[x[1] for x in hist], gmres_checks=[x[4] for x in hist],
        newton_residual=[x[3] for x in hist], converged=[x[5] for x in hist], lost=0,
        host_syncs_per_step=sum(syncs.values()) / steps, host_syncs=syncs, launches=counts,
        launches_expected=want, peak_device_bytes=peak,
        host_ms_per_residual=costs["residual_ms"], host_ms_per_jv=costs["jv_ms"],
        profiled_jv=costs["profiled_jv"])
    return grid, p1, p2, mats, mix, cfg, h, counts, steps


def phase_upw_implicit_parity(device):
    """The same implicit u-pw steps from the same state on the fused kernels
    and on the windowed engine on the card, matched by pid: rel_dx < 1e-3,
    rel_dv < 1e-2, pw within 1e-2 of its largest magnitude
    (tests/test_upw.py:282-285), equal Newton iterations; GMRES totals
    reported beside them.  At 128² (the problem of ``upw_implicit`` at half
    the width): the windowed engine takes 36-46 s a step there, about 4×
    that at 256²."""
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout

    steps = UPW_IMPLICIT["parity_steps"]
    grid, p0, mats, mix, cfg, h = build_upw(device, implicit=True,
                                            n_side=UPW_IMPLICIT["parity_n_side"])
    cfg = cfg.replace(krylov_maxiter=UPW_PARITY_KRYLOV_MAXITER)
    p1 = to_slot_layout(p0, grid, cfg.active_box)
    pf, hist_f = _upw_implicit_steps("upw_implicit_parity:fused", p1, grid, mats, mix, cfg, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    pw_, hist_w = _upw_implicit_steps("upw_implicit_parity:windowed", p1, grid, mats, mix,
                                      cfg.replace(transfer="windowed"), steps, times)
    out, ok = _upw_parity(pf, pw_, h, "upw_implicit_parity", 1e-2)
    newton_f, newton_w = [x[0] for x in hist_f], [x[0] for x in hist_w]
    ok = ok and newton_f == newton_w
    say(phase="upw_implicit_parity", steps=steps, grid="x".join(map(str, grid.dims)), **out,
        newton_fused=newton_f, newton_windowed=newton_w, gmres_fused=[x[1] for x in hist_f],
        gmres_windowed=[x[1] for x in hist_w], nnz_fused=[x[2] for x in hist_f],
        nnz_windowed=[x[2] for x in hist_w], windowed_ms_per_step=float(np.mean(times)),
        windowed_peak_device_bytes=torch.cuda.max_memory_allocated(), ok=ok)
    if not ok:
        raise PhaseError(f"upw_implicit_parity: {out}, Newton {newton_f} vs {newton_w}")


# upw_models: the u-pw steps with a Drucker-Prager soil (started at κ0; the
# strength low enough that the soil yields in the phase's steps): the
# explicit 512² step as ``upw`` runs it, with ``upw_parity``'s 8 steps
# against the windowed engine, and one implicit step at upw_implicit_parity's
# 128² on both engines
UPW_SOIL = dict(kind="Drucker-Prager", kappa0=100.0, friction_angle=30.0, dilatancy_angle=10.0,
                exponent_ortiz=2.0, plastic_strain_0=0.01)
# the implicit leg at 5× the explicit step (``upw_implicit`` takes 20×): at
# 20× the plastic soil's loop ends by the stall rule after 7 Newton
# iterations and 1,040 GMRES on both engines (on an H100 80GB HBM3 at 700 W), the
# phase's largest cost
UPW_MODELS = dict(parity_steps=4, implicit_steps=1, implicit_dt_factor=5.0)
# GMRES of the 128² implicit u-pw parity legs (upw_implicit_parity,
# upw_models): 5 cycles a solve (was UpwImplicitConfig's 10, krylov_maxiter
# 200), a cut of depth that pays for the sharded phases; on this problem the
# Newton loop ends by its stall rule either way
UPW_PARITY_KRYLOV_MAXITER = 100


def _yielded(p, eps0=0.0):
    act = p.active
    return float((p.eps[act] > eps0).double().mean())


def phase_upw_models(device):
    """The explicit and implicit u-pw steps with a Drucker-Prager soil on
    the fused kernels (launches counted from 0 over the timed steps, held to
    the formulas of formulations/upw.py), the soil's yielded share above 0,
    and parity with the windowed engine by pid."""
    from nlpartsol_tpu_torch.formulations import upw
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
    from nlpartsol_tpu_torch.ops import fused_transfer as ft
    from nlpartsol_tpu_torch.ops import solvers

    t_phase = time.perf_counter()
    grid, p0, mats, mix, cfg, h = build_upw(device, implicit=False, soil=UPW_SOIL)
    body = _upw_body(p0)
    p1, _ = upw.run(p0, grid, mats, mix, cfg, UPW["warm"], body)
    steps = UPW["steps"]
    ft.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2, diag = upw.run(p1, grid, mats, mix, cfg, steps, body)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(ft.launch_counts)
    _check_upw("upw_models", p2, diag["lost"].sum())
    want = {k: n * steps for k, n in UPW_LAUNCHES.items()}
    if counts != want:
        raise PhaseError(f"upw_models: launch counts {counts}, expected {want}")
    PATH_LAUNCHES["upw_models"] = ("upw", counts)
    explicit = dict(grid="x".join(map(str, grid.dims)), particles=p0.count, dt=cfg.dt,
                    warmup_steps=UPW["warm"], steps=steps, ms_per_step=1e3 * seconds / steps,
                    launches=counts, lost=0, yielded_share=_yielded(p2))
    # parity over upw_parity's steps from the same state
    par = UPW_MODELS["parity_steps"]
    pf, df = upw.run(p0, grid, mats, mix, cfg, par, body)
    pw_, dw = upw.run(p0, grid, mats, mix, cfg.replace(transfer="windowed"), par, body)
    for q, d, tag in ((pf, df, "fused"), (pw_, dw, "windowed")):
        _check_upw(f"upw_models:parity:{tag}", q, d["lost"].sum())
    out, ok = _upw_parity(pf, pw_, h, "upw_models:parity", 1e-4)
    explicit["parity"] = dict(steps=par, **out)
    del p1, p2, pf, pw_
    torch.cuda.empty_cache()

    # the implicit step at 128², fused then windowed from the same state
    grid, p0, mats, mix, cfg, h = build_upw(device, implicit=True,
                                            n_side=UPW_IMPLICIT["parity_n_side"], soil=UPW_SOIL)
    cfg = cfg.replace(dt=UPW_MODELS["implicit_dt_factor"] * 0.25 * h / C_MIX,
                      krylov_maxiter=UPW_PARITY_KRYLOV_MAXITER)
    p1 = to_slot_layout(p0, grid, cfg.active_box)
    isteps = UPW_MODELS["implicit_steps"]
    ft.reset_launch_counts()
    solvers.reset_host_syncs()
    times = []
    pf, hist_f = _upw_implicit_steps("upw_models:implicit:fused", p1, grid, mats, mix, cfg,
                                     isteps, times)
    counts, syncs = dict(ft.launch_counts), dict(solvers.host_syncs)
    want = upw_implicit_launches(isteps, sum(x[0] for x in hist_f), sum(x[1] for x in hist_f),
                                 syncs.get("krylov", 0))
    if counts != want:
        raise PhaseError(f"upw_models: implicit launch counts {counts}, expected {want}")
    PATH_LAUNCHES[f"upw_models_implicit@{UPW_IMPLICIT['parity_n_side']}"] = ("upw_implicit",
                                                                            counts)
    times_w = []
    pw_, hist_w = _upw_implicit_steps("upw_models:implicit:windowed", p1, grid, mats, mix,
                                      cfg.replace(transfer="windowed"), isteps, times_w)
    out_i, ok_i = _upw_parity(pf, pw_, h, "upw_models:implicit", 1e-2)
    newton_f, newton_w = [x[0] for x in hist_f], [x[0] for x in hist_w]
    ok_i = ok_i and newton_f == newton_w
    implicit = dict(grid="x".join(map(str, grid.dims)), particles=p0.count, dt=cfg.dt,
                    steps=isteps, ms_per_step=float(np.mean(times)),
                    windowed_ms_per_step=float(np.mean(times_w)), newton_fused=newton_f,
                    newton_windowed=newton_w, gmres_fused=[x[1] for x in hist_f],
                    gmres_windowed=[x[1] for x in hist_w],
                    converged=[x[5] for x in hist_f], launches=counts,
                    yielded_share=_yielded(pf), parity=out_i)
    yielded = explicit["yielded_share"] > 0.0 and implicit["yielded_share"] > 0.0
    say(phase="upw_models", soil=UPW_SOIL, explicit=explicit, implicit=implicit,
        phase_seconds=time.perf_counter() - t_phase, ok=ok and ok_i and yielded)
    if not (ok and ok_i and yielded):
        raise PhaseError(f"upw_models: explicit {explicit}, implicit {implicit}")


def _recorded_calls(fn):
    """Run ``fn()`` with every fused_scatter / fused_gather call recorded in
    order: (launch key it counted under, kind, args, kwargs)."""
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    calls, real = [], dict(scatter=ft.fused_scatter, gather=ft.fused_gather)

    def recorder(kind):
        def call(*args, **kw):
            before = dict(ft.launch_counts)
            out = real[kind](*args, **kw)
            key = next(k for k, n in ft.launch_counts.items() if n != before.get(k, 0))
            calls.append((key, kind, args, kw))
            return out
        return call

    ft.fused_scatter, ft.fused_gather = recorder("scatter"), recorder("gather")
    try:
        fn()
    finally:
        ft.fused_scatter, ft.fused_gather = real["scatter"], real["gather"]
    torch.cuda.synchronize()
    return calls


# The calls of one u-pw step in the order the step makes them: (label, launch
# key); rows of ``phase_upw_roofline``.
UPW_CALLS = [("solve: m, C, Δu and v momenta, θ (7 channels)", "lme_scatter2d:solve"),
             ("N+grad: [Δu | θ] with ∇Δu", "lme_gather2d:N+grad"),
             ("grad: ∇v", "lme_gather2d:grad"),
             ("grad: ∇θ (θ in row 0)", "lme_gather2d:grad"),
             ("G: jacobian-rate channel + mixture forces", "lme_scatter2d:G"),
             ("N: accelerations", "lme_gather2d:N"),
             ("G: zero channel + flow row", "lme_scatter2d:G"),
             ("N: θ̇", "lme_gather2d:N")]
# the implicit step's calls with newton_maxiter = 0 (set-up, r₀, the local
# state at the iterate, the last N-gather).  The residual's gathers read the
# iterate z = 0 there, so the gathers' rows take the set-up calls of the same
# variants on non-zero fields; the G-scatters' rows take r₀'s
UPW_IMPLICIT_CALLS = [("solve+gnorm: m, C, θ, v and a momenta, stiffness (8 channels)",
                       "lme_scatter2d:solve+gnorm"),
                      ("gnorm, fixed λ: Darcy weight (1 channel)", "lme_scatter2d:gnorm"),
                      ("N+grad: [α₂u̇ₙ + α₃üₙ | θₙ] with ∇(velocity constant)",
                       "lme_gather2d:N+grad"),
                      ("grad: ∇θₙ (θₙ in row 0)", "lme_gather2d:grad"),
                      (None, "lme_gather2d:N+grad"),
                      (None, "lme_gather2d:grad"),
                      ("G: rate channel + mixture G (residual)", "lme_scatter2d:G"),
                      ("G: zero channel + flow row (residual)", "lme_scatter2d:G"),
                      (None, "lme_gather2d:N+grad"),
                      (None, "lme_gather2d:grad"),
                      ("N: dU, v and a increments (6 channels)", "lme_gather2d:N")]


def phase_upw_roofline(grid, p, mats, mix, cfg, counts, steps, implicit):
    """Each call of the u-pw step at its shapes and on its state (recorded
    from one step on the path's last state) against its plain version."""
    from nlpartsol_tpu_torch.formulations import upw

    body = _upw_body(p)
    if implicit:
        calls = _recorded_calls(lambda: upw.upw_newmark_step(
            p, grid, mats, mix, cfg.replace(newton_maxiter=0), body))
        return _calls_roofline(grid, p, cfg, counts, steps, calls, UPW_IMPLICIT_CALLS,
                               "upw_implicit")
    calls = _recorded_calls(lambda: upw.upw_step(p, grid, mats, mix, cfg, body))
    return _calls_roofline(grid, p, cfg, counts, steps, calls, UPW_CALLS, "upw")


def _calls_roofline(grid, p, cfg, counts, steps, calls, spec, path, sum_abs_scale=False):
    """Each recorded call of a step (``spec``: its (label, launch key) in
    the order the step makes them; a None label: a call timed by the row of
    its variant's first labelled call) at its shapes and on its state,
    against its plain version: error, time, plain time, bound; launches from
    the path's timed run (a key with several rows is split evenly between
    them).  A gather whose recorded fields are all zero (a residual at the
    iterate z = 0) gets fields from a numpy seed instead, rows
    ``… (seeded fields)``.  With ``sum_abs_scale`` a scatter's N-weighted
    channels are held to TOL_N against the largest Σ N·|f| (the plain
    version on |f|) instead of the largest |Σ N·f|: float32 sums err in
    proportion to the sum of their terms' magnitudes, and a residual's
    channel, such as u-p's (p̄ − λ)·V0 at a converged state, cancels to far
    below them."""
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    d = grid.dim
    ops_of = OPS[d]
    box, params = cfg.active_box, cfg.lme_params
    tag = "@" + path
    got_keys = [key for key, _, _, _ in calls]
    if got_keys != [key for _, key in spec]:
        raise PhaseError(f"{path} roofline: calls {got_keys}, expected {[k for _, k in spec]}")
    n_offs = len(ft._geom(grid, params, 0).offsets)
    n_active = int(p.active.sum())
    b_act, b_idle, b_all, b_nodes = _slot_bytes(p, box, grid.n_nodes)
    tests = n_active * n_offs * ops_of["test"]
    per_eval = ops_of["f"] + 1 + ops_of["mom"]
    slot_io = 3 * d + 1
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=p.x.device)
    rows = []
    per_key = {}
    for label, key in spec:
        if label is not None:
            per_key[key] = per_key.get(key, 0) + 1
    # every call of a step runs at margin 0 on the same positions: one nnz
    _, _, cnt = ft.scatter_cuda(*calls[0][2], **calls[0][3])
    nnz = int(cnt[0])
    for (label, key), (_, kind, args, kw) in zip(spec, calls):
        if label is None:
            continue
        if kind == "scatter":
            G_t, solve, gnorm = kw.get("G_t"), kw.get("solve", True), kw.get("gnorm", False)
            cN = args[6].shape[0]
            if solve:
                iters = int(ft.scatter_cuda(*args, **kw)[2][1])
                ops = tests + iters * (nnz / n_active) * per_eval
            else:
                ops = tests + nnz * per_eval
            ops += nnz * (ops_of["n"] + cN * ops_of["ch"])
            if G_t is not None or gnorm:
                ops += nnz * ops_of["dn"]
            ops += nnz * ((ops_of["g"] if G_t is not None else 0) + (ops_of["gn"] if gnorm else 0))
            cout = cN + (d if G_t is not None else 0) + (1 if gnorm else 0)
            n_bytes = ((slot_io + cN + (d * d if G_t is not None else 0)) * b_act
                       + (2 * d + 1) * b_idle + cout * b_nodes)
            tol_n = TOL_N
            if sum_abs_scale:
                abs_nodes = ft._scatter_plain(*args[:6], args[6].abs(), None, solve, 0, False)[0]
                tol_n = dict(TOL_N, scale=float(abs_nodes.max()) or 1.0)
            checks = [("nodes", lambda o, cN=cN: o[0][:, :cN], tol_n)]
            if cout > cN:
                checks.append(("grad", lambda o, cN=cN: o[0][:, cN:], TOL_GRAD))

            def fn_kernel(a=args, k=kw):
                return ft.fused_scatter(*a, **k)

            def fn_plain(a=args, G_t=G_t, solve=solve, gnorm=gnorm):
                return ft._scatter_plain(*a, G_t, solve, 0, gnorm)
        else:
            gN, g_grad = kw.get("gN"), kw.get("g_grad")
            if not any(bool(a.abs().max() > 0) for a in (gN, g_grad) if a is not None):
                rng = np.random.default_rng(len(rows))
                gN, g_grad = (None if a is None else torch.as_tensor(
                    rng.standard_normal(tuple(a.shape)), dtype=a.dtype, device=a.device)
                    for a in (gN, g_grad))
                kw = dict(kw, gN=gN, g_grad=g_grad)
                label += " (seeded fields)"
            cN = 0 if gN is None else gN.shape[1]
            if g_grad is not None:
                per_edge = per_eval + ops_of["n"] + ops_of["dn"] + cN * ops_of["ch"] + ops_of["grad"]
            else:
                per_edge = ops_of["f"] + 1 + 1 + ops_of["n"] + cN * ops_of["ch"]
            ops = tests + nnz * per_edge
            n_bytes = ((2 * d + 1) * b_act + b_idle
                       + (cN + (d if g_grad is not None else 0)) * b_nodes
                       + (cN + (d * d if g_grad is not None else 0)) * b_all)
            checks = []
            if gN is not None:
                checks.append(("N", lambda o: o[0], TOL_N))
            if g_grad is not None:
                checks.append(("grad", lambda o: o[1], TOL_GRAD))

            def fn_kernel(a=args, k=kw):
                return ft.fused_gather(*a, **k)

            def fn_plain(a=args, gN=gN, g_grad=g_grad):
                return ft._gather_plain(*a, gN, g_grad, 0)
        launches = counts[key] // per_key[key]  # each row's call: once per key call
        _kernel_row(rows, f"{key}{tag} ({label})", key, d, fn_kernel, fn_plain, checks, n_bytes,
                    ops, launches, flush, launches_per_step=launches / steps, path=path)
    say(phase="roofline_" + path, slots=box.n_slots, active=n_active,
        window_offsets=n_offs,
        rows=[dict(name=r["name"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                   launches_per_step=r["launches_per_step"]) for r in rows])
    return rows


# The mixed u-p step and the DEM step (this port's configuration; no repo
# script times either): scripts/bench_implicit.py's problem, as
# ``build_implicit(2, …)`` builds it — 256² nodes, 65,536 particles, a
# capacity-6 box of 132² cells — Neo-Hookean E 1e7, ν 0.3, ρ 1000, LME γ=3,
# the fused engine with a local re-bin every step, no body force.  u-p:
# UpConfig's defaults (Newton tol 1e-5 relative, at most 20 iterations,
# GMRES(20) to 1e-7 in at most 10 cycles) at dt = 2h/c, as the bench uses;
# DEM: discrete gradient, DEMConfig's defaults (Newton tol 1e-6, CG) at dt =
# h/c, as tests/test_dem.py:127 uses.  Depth: warm-up and timed steps; the
# parity legs at ``parity_n_side``².
UP = dict(n_side=256, warm=0, steps=1, parity_steps=1, parity_n_side=64, column_steps=1)
DEM = dict(n_side=256, warm=0, steps=1, parity_steps=2, parity_n_side=128)
C_SOLID = float(np.sqrt(1e7 / 1000.0))


def build_up_dem(device, kind, n_side=None):
    """The u-p (``kind='up'``) or DEM problem at ``n_side``² (default: the
    phase's width), in slot layout."""
    from nlpartsol_tpu_torch.formulations.dem import DEMConfig
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
    from nlpartsol_tpu_torch.formulations.up import UpConfig

    spec = UP if kind == "up" else DEM
    grid, p, mats, cfg_e, h = build_problem(2, n_side or spec["n_side"], device)
    common = dict(lme_params=cfg_e.lme_params, kinds=cfg_e.kinds, transfer="fused",
                  active_box=cfg_e.active_box)
    cfg = (UpConfig(dt=2.0 * h / C_SOLID, **common) if kind == "up"
           else DEMConfig(dt=1.0 * h / C_SOLID, **common))
    return grid, to_slot_layout(p, grid, cfg.active_box), mats, cfg, h


def up_launches(steps, n, L, K):
    """The launches of ``steps`` fused u-p steps with n Newton iterations, L
    GMRES iterations and K GMRES convergence checks in all: the formula of
    formulations/up.py's docstring."""
    R = steps + 5 * n
    V = n + K + 21 * L // 20
    return {"lme_scatter2d:solve+gnorm": steps, "lme_gather2d:grad": steps,
            "lme_gather2d:N+grad": steps + R + 2 * V, "lme_scatter2d:G": R + 2 * V,
            "lme_gather2d:N": steps}


def dem_launches(steps, n, L):
    """The launches of ``steps`` fused DEM steps with n Newton and L CG
    iterations in all: the formula of formulations/dem.py's docstring."""
    return {"lme_scatter2d:solve+gnorm": steps, "lme_gather2d:grad": 3 * steps + 7 * n + 2 * L,
            "lme_scatter2d:G": steps + 7 * n + 2 * L, "lme_gather2d:N": steps}


def _up_dem_steps(label, kind, p, grid, mats, cfg, steps, timed=None):
    """``steps`` u-p or DEM steps; each Newton loop must end by its
    tolerance or its stall rule (before ``newton_maxiter``, finite), and
    nothing may be lost.  Returns the particles and per step (Newton,
    Krylov, nnz, residual, Krylov checks, converged, and for DEM the
    grid-energy identity |ΔKE_grid + ΔW| / KE_grid)."""
    from nlpartsol_tpu_torch.formulations.dem import dem_step
    from nlpartsol_tpu_torch.formulations.up import up_step
    from nlpartsol_tpu_torch.ops import solvers

    body = torch.zeros(grid.dim, dtype=p.x.dtype, device=p.x.device)
    step = up_step if kind == "up" else dem_step
    hist = []
    for i in range(steps):
        k0 = solvers.host_syncs["krylov"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, dg = step(p, grid, mats, cfg, body)
        torch.cuda.synchronize()
        if timed is not None:
            timed.append(1e3 * (time.perf_counter() - t0))
        if dg["newton_iters"] >= cfg.newton_maxiter or not np.isfinite(
                float(dg["newton_residual"])):
            raise PhaseError(f"{label}: step {i} ran out of Newton iterations "
                             f"(residual {float(dg['newton_residual'])})")
        _check_state(label, p, dict(lost=dg["lost"]))
        ident = None
        if kind == "dem":
            ident = abs(float(dg["grid_energy_increment"])) / float(dg["grid_kinetic_energy"])
        hist.append((dg["newton_iters"], dg["cg_iters"], int(dg["nnz"]),
                     float(dg["newton_residual"]), solvers.host_syncs["krylov"] - k0,
                     bool(dg["converged"]), ident))
    return p, hist


JV_N_SIDE = 32  # the J·v check's problem: the phase's at 32² (CPU float64 is slow)
# The card's float32 J·v against the plain versions' float32 J·v on CPU
# tensors at the same x and v, over the float64 J·v's largest entry: about
# five times the largest of three readings on the card (u-p 6.1e-7, DEM
# 3.6e-6; PERF.md §6).
JV_F32_LIMIT = dict(up=3e-6, dem=2e-5)


def _jv_check(label, kind, device):
    """One J·v of the fused step's Newton loop, on the phase's problem at
    ``JV_N_SIDE``² from its first state, at the iterate x₀ + a seeded
    perturbation (u-p: 1e-3 of the column scaling; DEM: 5 % of the largest
    nodal speed).  In float64 on CPU tensors (the plain versions and this
    machine's torch build's forward mode, for DEM over the reverse-mode
    ∂W/∂F) against a float64 central difference of the same residual, within
    1e-6 relative; in float32 on the card (the kernels' tangent launches)
    against the plain versions' float32 J·v on CPU tensors at the same x and
    v, within ``JV_F32_LIMIT`` of the float64 J·v's largest entry.  Each
    float32 J·v's gap to the float64 one is reported beside it: DEM's
    discrete-gradient correction (ΔW − ½S:ΔC)/|ΔC|² cancels in float32 on
    either device."""
    from nlpartsol_tpu_torch.formulations.dem import dem_step
    from nlpartsol_tpu_torch.formulations.up import up_step
    from nlpartsol_tpu_torch.ops import solvers

    step = up_step if kind == "up" else dem_step
    grid, p, mats, cfg, _ = build_up_dem(device, kind, n_side=JV_N_SIDE)

    def residual_of(pp, gg, mm):
        seen, real = {}, solvers.newton_krylov

        def spy(residual, x0, **kw):
            seen.update(residual=residual, x0=x0, M_inv=kw["M_inv"])
            return real(residual, x0, **kw)

        solvers.newton_krylov = spy
        try:
            step(pp, gg, mm, cfg.replace(newton_maxiter=0),
                 torch.zeros(gg.dim, dtype=pp.x.dtype, device=pp.x.device))
        finally:
            solvers.newton_krylov = real
        return seen

    def on_cpu(dtype):
        return lambda a: a.to("cpu", dtype) if a.is_floating_point() else a.to("cpu")

    cpu = {dt: residual_of(*(r.map_tensors(on_cpu(dt)) for r in (p, grid, mats)))
           for dt in (torch.float64, torch.float32)}
    ref = cpu[torch.float64]
    R, x0 = ref["residual"], ref["x0"]
    rng = np.random.default_rng(11)
    dx, v = (torch.as_tensor(rng.standard_normal(tuple(x0.shape))) for _ in range(2))
    if kind == "up":  # unknowns at the scale of the column scaling (h, θ_ref)
        x, v = x0 + ref["M_inv"](1e-3 * dx), ref["M_inv"](v)
    else:  # velocities: 5 % of the largest nodal speed
        x = x0 + 0.05 * float(x0.abs().max()) * dx
    jv64 = solvers.jvp(R, x, v)[1]
    s = 1e-6 if kind == "dem" else 1e-5
    fd = (R(x + s * v) - R(x - s * v)) / (2 * s)
    fd_scale = float(fd.abs().max())

    def jv32(residual, dev):
        return solvers.jvp(residual, x.to(dev, torch.float32),
                           v.to(dev, torch.float32))[1].double().cpu()

    jv_card = jv32(residual_of(p, grid, mats)["residual"], p.x.device)
    jv_cpu = jv32(cpu[torch.float32]["residual"], "cpu")
    lim32 = JV_F32_LIMIT[kind]
    out = dict(grid=f"{JV_N_SIDE}x{JV_N_SIDE}", fd_scale=fd_scale,
               err_f64_cpu=float(((jv64 - fd).abs() - 1e-6 * fd.abs()).max()) / fd_scale,
               err_f32_card_vs_cpu=float((jv_card - jv_cpu).abs().max()) / fd_scale,
               err_f32_card=float((jv_card - jv64).abs().max()) / fd_scale,
               err_f32_cpu=float((jv_cpu - jv64).abs().max()) / fd_scale, limit_f64=1e-6,
               limit_f32_card_vs_cpu=lim32)
    if not (fd_scale > 0 and out["err_f64_cpu"] <= 1e-6
            and out["err_f32_card_vs_cpu"] <= lim32):
        raise PhaseError(f"{label}: J·v against the central difference {out}")
    return out


def phase_up_dem(device, kind):
    """The u-p or DEM step on the fused kernels: a warm-up step, then timed
    steps with the launch counts and host syncs set to 0 just before and
    read just after, launches held to the module's formula, host ms per
    residual and per J·v, the profiler over 5 J·v (u-p: its step is
    about 700 of them) or over one step (DEM), and one J·v against a float64
    central difference."""
    from torch.profiler import ProfilerActivity, profile

    from nlpartsol_tpu_torch.formulations.dem import dem_step
    from nlpartsol_tpu_torch.formulations.up import up_step
    from nlpartsol_tpu_torch.ops import fused_transfer as ft
    from nlpartsol_tpu_torch.ops import solvers

    spec = UP if kind == "up" else DEM
    grid, p0, mats, cfg, h = build_up_dem(device, kind)
    p1, _ = _up_dem_steps(kind, kind, p0, grid, mats, cfg, spec["warm"])
    torch.cuda.reset_peak_memory_stats()
    ft.reset_launch_counts()
    solvers.reset_host_syncs()
    times = []
    steps = spec["steps"]
    p2, hist = _up_dem_steps(kind, kind, p1, grid, mats, cfg, steps, times)
    counts, syncs = dict(ft.launch_counts), dict(solvers.host_syncs)
    n_tot, l_tot = sum(x[0] for x in hist), sum(x[1] for x in hist)
    want = (up_launches(steps, n_tot, l_tot, syncs.get("krylov", 0)) if kind == "up"
            else dem_launches(steps, n_tot, l_tot))
    if counts != want:
        raise PhaseError(f"{kind}: launch counts {counts}, expected {want}")
    seconds = 1e-3 * sum(times)
    total_nnz = sum(x[2] for x in hist)
    peak = torch.cuda.max_memory_allocated()
    step = up_step if kind == "up" else dem_step
    body = torch.zeros(grid.dim, dtype=p2.x.dtype, device=p2.x.device)
    costs = _residual_costs(lambda: step(p2, grid, mats, cfg.replace(newton_maxiter=0), body),
                            reps=5, profile_label=kind if kind == "up" else None)
    if kind == "dem":  # a step of about 23,000 kernels: profile it whole
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _up_dem_steps(kind, kind, p2, grid, mats, cfg, 1)
            torch.cuda.synchronize()
        costs["profiled_step"] = _profiled_step(prof, float(np.median(times)), kind)
        extra = dict(energy_identity=[x[6] for x in hist], cg_iters=[x[1] for x in hist])
    else:
        extra = dict(gmres_iters=[x[1] for x in hist], gmres_checks=[x[4] for x in hist],
                     lambda_max=float(p2.pw[p2.active].abs().max()))
    say(phase=kind, grid="x".join(map(str, grid.dims)), particles=int(p0.active.sum()),
        slots=cfg.active_box.n_slots, dt=cfg.dt, warmup_steps=spec["warm"], steps=steps,
        ms_per_step=1e3 * seconds / steps, step_ms=times, nnz_per_step=total_nnz / steps,
        nnz_per_s=total_nnz / seconds, newton_iters=[x[0] for x in hist],
        newton_residual=[x[3] for x in hist], converged=[x[5] for x in hist], lost=0,
        host_syncs_per_step=sum(syncs.values()) / steps, host_syncs=syncs, launches=counts,
        launches_expected=want, peak_device_bytes=peak,
        host_ms_per_residual=costs["residual_ms"], host_ms_per_jv=costs["jv_ms"],
        **{k: costs[k] for k in ("profiled_jv", "profiled_step") if k in costs},
        jv_check=_jv_check(kind, kind, device), **extra)
    return grid, p2, mats, cfg, counts, steps


# Parity limits of λ (u-p) and of the fused grid-energy identity (DEM) on
# the bench problem, where float32 fixes neither to the JAX tests' 1e-2 and
# 5e-4 (PERF.md §6).  λ: the random velocities load it weakly (λ ≈
# 455 at 64²) and rounding moves it.  On the card the windowed engine
# repeats to the bit and the fused one (atomic sums) does not: over 35 runs
# at 64² its largest per-particle gap ranged 8.4e-3-5.7e-2 of max|λ|, and
# over 28 of them the root mean square 2.4e-3-7.3e-3 (this phase and
# tests/torch_up_dem_probe.py card-spread).  The JAX package's
# own windowed and 'pallas' steps differ by 2.1e-2 (largest) and 4.2e-3
# (rms) at 64² (CPU, tests/torch_up_dem_probe.py jax-engines up 64); ten
# times the GMRES budget leaves the port's gap at 32² where it was (CPU).
# So the rms is held to 1e-2 and the largest gap to 1e-1.  Identity: the
# JAX engines reach 5.76e-4 and 5.78e-4 on the second step at 128² (CPU,
# jax-engines dem 128), the port's fused engine 5.81e-4-5.86e-4 in six card
# runs.  The JAX tests' own limits hold on their own problems, the column
# and the bar, beside it.
BENCH_PARITY = dict(dlambda=1e-1, dlambda_rms=1e-2, energy_identity=6e-4)


def phase_up_dem_parity(device, kind):
    """The same u-p or DEM steps from the same state on the fused kernels and
    on the windowed engine on the card at ``parity_n_side``², matched by pid:
    rel_dx < 1e-3, rel_dv < 1e-2, equal Newton iterations; u-p: the λ gap
    over its largest magnitude, its root mean square and its largest entry
    within ``BENCH_PARITY``, and tests/test_upw.py's column
    (the box over its grid at capacity 8, dt 2e-3, gravity) for 5 steps at
    the JAX package's limits there (x 1e-6, λ 1e-2·max(1, |λ|),
    test_upw.py:325-327); DEM: the fused grid-energy identity below
    ``BENCH_PARITY``, and test_dem.py's bar (LME γ=3, capacity 8, dt = h/c,
    with its SVK test's sine velocity) for 3 steps at the JAX test's limits
    (x 1e-6, v 1e-5, identity 5e-4, test_dem.py:148-152)."""
    label = kind + "_parity"
    spec = UP if kind == "up" else DEM
    steps = spec["parity_steps"]
    grid, p1, mats, cfg, h = build_up_dem(device, kind, n_side=spec["parity_n_side"])
    pf, hist_f = _up_dem_steps(label + ":fused", kind, p1, grid, mats, cfg, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    pw_, hist_w = _up_dem_steps(label + ":windowed", kind, p1, grid, mats,
                                cfg.replace(transfer="windowed"), steps, times)
    names = ("x", "v", "pw") if kind == "up" else ("x", "v")
    rel_dx, rel_dv, *more = _parity(pf, pw_, h, label, names)
    newton_f, newton_w = [x[0] for x in hist_f], [x[0] for x in hist_w]
    out = dict(rel_dx=rel_dx, rel_dv=rel_dv, limit_dx=1e-3, limit_dv=1e-2)
    ok = rel_dx < 1e-3 and rel_dv < 1e-2 and newton_f == newton_w
    if kind == "up":
        (lf, lw), = more
        l_scale = max(float(lw.abs().max()), 1e-30)
        gap = (lf - lw).abs() / l_scale
        out.update(rel_dlambda=float(gap.max()), rms_dlambda=float((gap ** 2).mean().sqrt()),
                   lambda_scale=l_scale, limit_dlambda=BENCH_PARITY["dlambda"],
                   limit_rms_dlambda=BENCH_PARITY["dlambda_rms"])
        ok = (ok and out["rel_dlambda"] < BENCH_PARITY["dlambda"]
              and out["rms_dlambda"] < BENCH_PARITY["dlambda_rms"])
        out["column"] = _up_column_parity(device)
        ok = ok and out["column"]["ok"]
    else:
        ident = max(x[6] for x in hist_f)
        out.update(energy_identity_fused=ident,
                   limit_energy_identity=BENCH_PARITY["energy_identity"],
                   energy_identity_windowed=max(x[6] for x in hist_w))
        ok = ok and ident < BENCH_PARITY["energy_identity"]
        out["bar"] = _dem_bar_parity(device)
        ok = ok and out["bar"]["ok"]
    say(phase=label, steps=steps, grid="x".join(map(str, grid.dims)), **out,
        newton_fused=newton_f, newton_windowed=newton_w, krylov_fused=[x[1] for x in hist_f],
        krylov_windowed=[x[1] for x in hist_w], converged_fused=[x[5] for x in hist_f],
        nnz_fused=[x[2] for x in hist_f], nnz_windowed=[x[2] for x in hist_w],
        windowed_ms_per_step=float(np.mean(times)),
        windowed_peak_device_bytes=torch.cuda.max_memory_allocated(), ok=ok)
    if not ok:
        raise PhaseError(f"{label}: {out}, Newton {newton_f} vs {newton_w}")


def _up_column_parity(device):
    """tests/test_upw.py::test_up_pallas_parity on the card: the column of
    ``column_problem`` (its soil and fluid table, mixture densities),
    ``UP["column_steps"]`` u-p steps (5 before the time limit pressed) on each engine from the
    same state, by pid."""
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
    from nlpartsol_tpu_torch.formulations.up import UpConfig, up_step

    grid, p, mats, _, ccfg, _ = column_problem(device)
    cfg = UpConfig(dt=2e-3, lme_params=ccfg.lme_params, kinds=ccfg.kinds, transfer="fused",
                   active_box=ccfg.active_box)
    body = _upw_body(p)
    res = {}
    for transfer in ("fused", "windowed"):
        q = to_slot_layout(p, grid, cfg.active_box)
        for i in range(UP["column_steps"]):
            q, dq = up_step(q, grid, mats, cfg.replace(transfer=transfer), body)
            _check_state(f"up_parity:column:{transfer}", q, dict(lost=dq["lost"]))
        res[transfer] = (_by_pid_fields(q, ("x", "pw")), bool(dq["converged"]))
    ((pid_f, (xf, lf)), conv_f), ((pid_w, (xw, lw)), conv_w) = res["fused"], res["windowed"]
    if not bool((pid_f == pid_w).all()):
        raise PhaseError("up_parity:column: particle sets differ")
    l_scale = max(1.0, float(lw.abs().max()))
    out = dict(steps=UP["column_steps"], particles=p.count, dx=float((xf - xw).abs().max()),
               dlambda=float((lf - lw).abs().max()), lambda_scale=l_scale,
               limits=dict(dx=1e-6, dlambda=1e-2 * l_scale), converged=[conv_f, conv_w])
    out["ok"] = (out["dx"] <= 1e-6 and out["dlambda"] <= 1e-2 * l_scale and conv_f and conv_w)
    return out


def _dem_bar_parity(device):
    """tests/test_dem.py::test_dem_pallas_parity_and_energy on the card:
    test_explicit.py's bar (20×2 cells of h = 0.05, 2×2 particles a cell,
    ends fixed in x, every node in y), Neo-Hookean E 1e7, ν 0.3, ρ 1000,
    with the sine velocity of amplitude 0.05 of test_dem.py's SVK test (the
    JAX test starts at rest), 3 DEM steps on each engine, by pid."""
    from nlpartsol_tpu_torch.formulations.dem import DEMConfig, dem_step
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
    from nlpartsol_tpu_torch.models import materials as M
    from nlpartsol_tpu_torch.ops import windowed
    from nlpartsol_tpu_torch.shapefun import lme
    from nlpartsol_tpu_torch.types import Grid, make_particles

    nx, ny, h, ppc = 20, 2, 0.05, 2
    dims = (nx + 1, ny + 1)
    ids = np.arange(dims[0] * dims[1]).reshape(dims)
    fixed = np.zeros((ids.size, 2), bool)
    fixed[ids[0, :], 0] = fixed[ids[-1, :], 0] = True
    fixed[:, 1] = True
    grid = Grid(dims=dims, spacing=h, origin=(0.0, 0.0),
                dirichlet_mask=torch.as_tensor(fixed, device=device),
                dirichlet_value=torch.zeros((ids.size, 2), device=device))
    i, j, a, b = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(ppc), np.arange(ppc),
                             indexing="ij")
    x = np.stack([(i + (a + 0.5) / ppc) * h, (j + (b + 0.5) / ppc) * h], -1).reshape(-1, 2)
    vol = (h / ppc) ** 2
    vx = 0.05 * np.sin(np.pi * x[:, 0])
    p = make_particles(x.astype(np.float32), mass=np.full(len(x), 1000.0 * vol, np.float32),
                       vol0=np.full(len(x), vol, np.float32),
                       v=np.stack([vx, np.zeros_like(vx)], -1).astype(np.float32), device=device)
    mats = M.material_table([M.material(kind="Neo-Hookean-Wriggers", E=1e7, nu=0.3, rho0=1000.0)],
                            device=device)
    cfg = DEMConfig(dt=h / C_SOLID, lme_params=lme.LMEParams(gamma=3.0), kinds=(M.NEO_HOOKEAN,),
                    transfer="fused", active_box=windowed.full_box(grid, capacity=8))
    body = torch.zeros(2, dtype=torch.float32, device=device)
    res = {}
    for transfer in ("fused", "windowed"):
        q, ident, newton = to_slot_layout(p, grid, cfg.active_box), 0.0, []
        for _ in range(3):
            q, dq = dem_step(q, grid, mats, cfg.replace(transfer=transfer), body)
            _check_state(f"dem_parity:bar:{transfer}", q, dict(lost=dq["lost"]))
            ident = max(ident, abs(float(dq["grid_energy_increment"]))
                        / float(dq["grid_kinetic_energy"]))
            newton.append(dq["newton_iters"])
        res[transfer] = (_by_pid_fields(q, ("x", "v")), ident, newton)
    ((pid_f, (xf, vf)), ident_f, newton_f), ((pid_w, (xw, vw)), ident_w, newton_w) = (
        res["fused"], res["windowed"])
    if not bool((pid_f == pid_w).all()):
        raise PhaseError("dem_parity:bar: particle sets differ")
    out = dict(steps=3, particles=p.count, dx=float((xf - xw).abs().max()),
               dv=float((vf - vw).abs().max()), energy_identity_fused=ident_f,
               energy_identity_windowed=ident_w, newton_fused=newton_f,
               newton_windowed=newton_w, limits=dict(dx=1e-6, dv=1e-5, energy_identity=5e-4))
    out["ok"] = (out["dx"] <= 1e-6 and out["dv"] <= 1e-5 and ident_f < 5e-4
                 and newton_f == newton_w)
    return out


# The calls of one u-p / DEM step with newton_maxiter = 0 (set-up, r₀, the
# state at the iterate, the last N-gather), in order: (label, launch key);
# rows of ``_calls_roofline``.  The u-p residual's gather reads the iterate
# z = 0 there (seeded fields); the DEM gradient gathers of dU and of V − Vₙ
# after the loop are the variant of r₀'s.
UP_CALLS = [("solve+gnorm: m, V0, v and a momenta, stiffness (7 channels)",
             "lme_scatter2d:solve+gnorm"),
            ("grad: ∇ of the velocity constant", "lme_gather2d:grad"),
            ("N+grad: N of dλ (1 channel) with ∇dU (residual)", "lme_gather2d:N+grad"),
            ("G: [(p̄ − λ)·V0 | G] (residual)", "lme_scatter2d:G"),
            (None, "lme_gather2d:N+grad"),
            ("N: dU, v and a increments (6 channels)", "lme_gather2d:N")]
DEM_CALLS = [("solve+gnorm: m, m·v, stiffness·Δt/2 (4 channels)", "lme_scatter2d:solve+gnorm"),
             ("grad: ∇dU (residual)", "lme_gather2d:grad"),
             ("G: zero channel + V0·P*·F_nᵀ (residual)", "lme_scatter2d:G"),
             (None, "lme_gather2d:grad"),
             (None, "lme_gather2d:grad"),
             ("N: dU and V − Vₙ (4 channels)", "lme_gather2d:N")]


def phase_up_dem_roofline(grid, p, mats, cfg, counts, steps, kind):
    """Each call of the u-p or DEM step at its shapes and on the path's last
    state against its plain version (rows ``…@up``, ``…@dem``)."""
    from nlpartsol_tpu_torch.formulations.dem import dem_step
    from nlpartsol_tpu_torch.formulations.up import up_step

    step = up_step if kind == "up" else dem_step
    body = torch.zeros(grid.dim, dtype=p.x.dtype, device=p.x.device)
    calls = _recorded_calls(lambda: step(p, grid, mats, cfg.replace(newton_maxiter=0), body))
    return _calls_roofline(grid, p, cfg, counts, steps, calls,
                           UP_CALLS if kind == "up" else DEM_CALLS, kind, sum_abs_scale=True)


# ---------------------------------------------------------------------------
# The constitutive models on the explicit step (phases ``models_fn``,
# ``models``, ``models_parity``, ``models3d``)
# ---------------------------------------------------------------------------

SOLID = dict(E=1e7, nu=0.3, rho0=1000.0)
FLUID = dict(rho0=1000.0, viscosity=1.0, compressibility=2.2e6, n_macdonald=7.0)
# the frictional family's hardening κ̂_φ = a1·Λ (a2 = a3 = 0), its strips
# confined by CONFINEMENT and started on that law at Λ0 = κ0/a1
BORJA = dict(SOLID, a1_borja=5.0, a3_borja=0.0, alpha_borja=0.162, phi_frictional=0.0)
CONFINEMENT = 1e5  # Pa: isotropic prestress of the frictional strips
# The frame holds every node outside the block and its outer FRAME_LAYERS
# node layers: a node whose support the block's edge cuts would carry the
# unbalanced force of a prestressed skin, unload it and leave the frictional
# corners in tension, where their float32 Newton scatters (PERF.md §6).
FRAME_LAYERS = 3
# One strip of the particle block along x per kind, in this order.  The
# strengths put each plastic kind's yielded share inside PLASTIC_SHARE:
# von Mises' σy and Drucker-Prager's κ0 are the medians, over each strip, of
# the largest trial measure an elastic run of the phase's steps reaches
# (tests/torch_models_probe.py calibrate, on the card at 512² and 96³); the
# frictional κ0 of ``MODEL_KAPPA0`` (narrow cones on soft hardening) are
# read from the card's plastic runs at four scalings (card-shares), since
# yielding strips soften the waves that the elastic calibration counts
# (PERF.md §4).
MODEL_STRIPS = {
    2: (("Von-Mises", dict(SOLID, kappa0=530.0, hardening_modulus=1e5, theta_voce=1.0)),
        ("Drucker-Prager", dict(SOLID, kappa0=490.0, friction_angle=30.0, dilatancy_angle=10.0,
                                exponent_ortiz=2.0, plastic_strain_0=0.01)),
        ("Matsuoka-Nakai", BORJA),
        ("Lade-Duncan", BORJA),
        ("Modified-Lade-Duncan", dict(BORJA, m_frictional=0.2, atmospheric_pressure=-1e5)),
        ("Hencky", SOLID),
        ("Mooney-Rivlin", dict(SOLID, mu1_mr=2.0e6, mu2_mr=1.846e6)),
        ("Linear-Elastic", SOLID),
        ("Newtonian-Fluid-Compressible", FLUID),
        ("Bingham-Fluid", dict(FLUID, kappa0=10.0, fluidity_param=100.0))),
    3: (("Hencky", SOLID),
        ("Von-Mises", dict(SOLID, kappa0=670.0, hardening_modulus=1e5, theta_voce=1.0)),
        ("Drucker-Prager", dict(SOLID, kappa0=225.0, friction_angle=30.0, dilatancy_angle=10.0,
                                exponent_ortiz=2.0, plastic_strain_0=0.01)),
        ("Matsuoka-Nakai", BORJA)),
}
MODEL_KAPPA0 = {2: {"Matsuoka-Nakai": 1e-2, "Lade-Duncan": 5e-4, "Modified-Lade-Duncan": 5e-4},
                3: {"Matsuoka-Nakai": 2e-3}}
PLASTIC_KINDS = ("Von-Mises", "Drucker-Prager", "Matsuoka-Nakai", "Lade-Duncan",
                 "Modified-Lade-Duncan")
FRICTIONAL_KINDS = ("Matsuoka-Nakai", "Lade-Duncan", "Modified-Lade-Duncan")
PLASTIC_SHARE = (0.05, 0.95)  # each plastic kind's share of yielded particles
MODELS = {2: dict(warm=4, steps=16, parity_steps=8), 3: dict(warm=2, steps=4, parity_steps=4)}
# the eps gap between the engines over its largest value, by kind
MODELS_EPS_GAP = 1e-2


def _initial_model_state(name, row, n, dim):
    """bemi, bemi_zz, eps, kappa of a strip at rest: the frictional strips
    confined by CONFINEMENT and on their hardening law at κ0 (MODEL_KAPPA0);
    Drucker-Prager at κ = κ0; every other kind at the zero state."""
    bemi, bzz = np.zeros((n, dim, dim), np.float32), np.zeros(n, np.float32)
    eps, kappa = np.zeros(n, np.float32), np.zeros(n, np.float32)
    if name in FRICTIONAL_KINDS:
        K = row["E"] / (3.0 * (1.0 - 2.0 * row["nu"]))
        w = np.expm1(-2.0 * CONFINEMENT / (3.0 * K))  # b_e − 1 of E_h = −p/3K
        bemi[:] = w * np.eye(dim, dtype=np.float32)
        bzz[:] = w if dim == 2 else 0.0
        kappa[:] = MODEL_KAPPA0[dim][name]
        eps[:] = kappa / row["a1_borja"]
    elif name == "Drucker-Prager":
        kappa[:] = row["kappa0"]
    return bemi, bzz, eps, kappa


def build_models(dim, n_side, device, frame=True, strips=None):
    """The main path's problem (bench.py's in 2D, scripts/bench3d.py's in
    3D) with one strip of the particle block along x per kind of
    ``strips`` (default ``MODEL_STRIPS``), held in a rigid frame
    (FRAME_LAYERS; ``frame=False`` leaves bench.py's free surfaces);
    dt = 0.25·h/c for the fastest wave speed among the kinds.  Returns the
    problem and the initial eps of each strip."""
    from nlpartsol_tpu_torch.models import materials as M

    grid, p, _, cfg, h = build_problem(dim, n_side, device)
    strips = MODEL_STRIPS[dim] if strips is None else strips
    rows = [M.material(kind=name, **params) for name, params in strips]
    mats = M.material_table(rows, device=device)
    x0 = p.x[:, 0].cpu().numpy()
    lo, hi = x0.min(), x0.max()
    sid = np.minimum(((x0 - lo) / (hi - lo) * len(strips)).astype(np.int64), len(strips) - 1)
    n = p.count
    state = [np.zeros((n, dim, dim), np.float32)] + [np.zeros(n, np.float32) for _ in range(3)]
    eps0 = []
    for i, ((name, _), row) in enumerate(zip(strips, rows)):
        sel = sid == i
        init = _initial_model_state(name, row, int(sel.sum()), dim)
        for arr, val in zip(state, init):
            arr[sel] = val
        eps0.append(float(init[2][0]) if len(init[2]) else 0.0)
    dev = p.x.device
    p = p.replace(mat_id=torch.as_tensor(sid, dtype=torch.int32, device=dev),
                  **{k: torch.as_tensor(v, device=dev)
                     for k, v in zip(("bemi", "bemi_zz", "eps", "kappa"), state)})
    if frame:
        lo_node, hi_node = n_side // 4 + FRAME_LAYERS, 3 * n_side // 4 - FRAME_LAYERS
        idx = np.indices(grid.dims).reshape(dim, -1).T
        held = np.any((idx < lo_node) | (idx > hi_node), axis=1)
        grid = grid.replace(
            dirichlet_mask=torch.as_tensor(np.repeat(held[:, None], dim, axis=1), device=dev),
            dirichlet_value=torch.zeros((grid.n_nodes, dim), dtype=p.x.dtype, device=dev))
    speeds = [np.sqrt(r["compressibility"] / r["rho0"]) if "Fluid" in name
              else np.sqrt(r["E"] / r["rho0"]) for (name, _), r in zip(strips, rows)]
    cfg = cfg.replace(kinds=tuple(sorted({r["kind"] for r in rows})),
                      dt=0.25 * h / max(speeds))
    return grid, p, mats, cfg, h, eps0


MODEL_FIELDS = ("x", "v", "F", "stress", "stress_zz", "bemi", "bemi_zz", "eps", "kappa",
                "back_stress", "W")


def _check_models_state(label, p, diag):
    """Every active field finite, every diagnostic finite, nothing lost."""
    act = p.active
    for name in MODEL_FIELDS:
        if not bool(torch.isfinite(getattr(p, name)[act]).all()):
            raise PhaseError(f"{label}: non-finite {name} on an active particle")
    for key, val in diag.items():
        if not bool(torch.isfinite(val.double()).all()):
            raise PhaseError(f"{label}: non-finite diagnostic {key}")
    lost = int(diag["lost"].sum())
    if lost != 0:
        raise PhaseError(f"{label}: {lost} particles lost")


def _plastic_shares(p, eps0, strips):
    """Per kind: the share of its active particles whose eps grew."""
    act = p.active
    shares = {}
    for i, (name, _) in enumerate(strips):
        sel = act & (p.mat_id == i)
        grew = (p.eps[sel] > eps0[i]).double()
        shares[name] = float(grew.mean()) if grew.numel() else float("nan")
    return shares


def phase_models(device, dim):
    """Every kind of ``MODEL_STRIPS`` on the main path's problem, through
    ``to_slot_layout`` + ``run`` on the fused kernels: warm-up steps, then
    timed steps with the launch counts set to 0 just before and read just
    after; each plastic kind must yield on 5-95 % of its particles."""
    from nlpartsol_tpu_torch.formulations.explicit import run
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    spec = MODELS[dim]
    label = "models" + _suffix(dim)
    grid, p0, mats, cfg, h, eps0 = build_models(dim, PROBLEMS[dim]["n_side"], device)
    p1, diag = run(p0, grid, mats, cfg, spec["warm"])
    _check_models_state(label + ":warm-up", p1, diag)
    ft.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2, diag = run(p1, grid, mats, cfg, spec["steps"])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(ft.launch_counts)
    _check_models_state(label, p2, diag)
    steps = spec["steps"]
    want = {f"lme_scatter{dim}d:solve": steps, f"lme_scatter{dim}d:G": steps,
            f"lme_gather{dim}d:N+grad": steps, f"lme_gather{dim}d:N": steps}
    if counts != want:
        raise PhaseError(f"{label}: launch counts {counts}, expected {want}")
    strips = MODEL_STRIPS[dim]
    shares = _plastic_shares(p2, eps0, strips)
    lo, hi = PLASTIC_SHARE
    outside = {k: v for k, v in shares.items() if k in PLASTIC_KINDS and not lo <= v <= hi}
    total_nnz = int(diag["nnz"].long().sum())
    say(phase=label, grid="x".join(map(str, grid.dims)), particles=p0.count,
        kinds=[name for name, _ in strips], dt=cfg.dt, warmup_steps=spec["warm"], steps=steps,
        ms_per_step=1e3 * seconds / steps, host_ms_per_step=1e3 * host_s / steps,
        nnz_per_s=total_nnz / seconds, launches=counts, lost=0, finite=True,
        plastic_share=shares, plastic_share_limits=PLASTIC_SHARE,
        kinetic_energy=float(diag["kinetic_energy"][-1]),
        strain_energy=float(diag["strain_energy"][-1]))
    if outside:
        raise PhaseError(f"{label}: plastic share outside {PLASTIC_SHARE}: {outside}")
    return grid, p0, mats, cfg, h


def phase_models_parity(grid, p0, mats, cfg, h):
    """The same steps from the same state through the fused kernels and the
    windowed engine on the card, by pid: rel_dx < 1e-3, rel_dv < 1e-2, and
    per kind the eps gap over its largest value within MODELS_EPS_GAP."""
    from nlpartsol_tpu_torch.formulations.explicit import run

    dim = grid.dim
    label = "models_parity" + _suffix(dim)
    steps = MODELS[dim]["parity_steps"]
    pf, diag_f = run(p0, grid, mats, cfg, steps)
    _check_models_state(label + ":fused", pf, diag_f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pw, diag_w = run(p0, grid, mats, cfg.replace(transfer="windowed", rebin_every=1), steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _check_models_state(label + ":windowed", pw, diag_w)
    rel_dx, rel_dv, (mid_f, mid_w), (eps_f, eps_w) = _parity(
        pf, pw, h, label, names=("x", "v", "mat_id", "eps"))
    if not bool((mid_f == mid_w).all()):
        raise PhaseError(f"{label}: material ids differ by pid")
    gaps = {}
    for i, (name, _) in enumerate(MODEL_STRIPS[dim]):
        sel = mid_w == i
        scale = max(float(eps_w[sel].abs().max()), 1e-30)
        gaps[name] = float((eps_f[sel] - eps_w[sel]).abs().max()) / scale
    ok = rel_dx < 1e-3 and rel_dv < 1e-2 and max(gaps.values()) < MODELS_EPS_GAP
    say(phase=label, steps=steps, rel_dx=rel_dx, rel_dv=rel_dv, limit_dx=1e-3,
        limit_dv=1e-2, eps_gap=gaps, limit_eps_gap=MODELS_EPS_GAP,
        windowed_ms_per_step=1e3 * seconds / steps, ok=ok)
    if not ok:
        raise PhaseError(f"{label}: rel_dx {rel_dx}, rel_dv {rel_dv}, eps gaps {gaps}")


# The implicit step with the return mappings (its J·v is forward mode
# through them, with the spectral tangent of ops/tensor.py::isotropic_map):
# bench_implicit.py's problem (``IMPLICIT``) with these kinds' strips of
# MODEL_STRIPS in the models phases' rigid frame (the frictional strips
# confined), dt = 2h/c
IMPLICIT_MODEL_KINDS = {2: ("Von-Mises", "Drucker-Prager", "Matsuoka-Nakai", "Hencky"),
                        3: ("Drucker-Prager", "Hencky")}
IMPLICIT_MODELS = {2: dict(warm=1, steps=1, parity_n_side=64, parity_steps=2),
                   3: dict(warm=1, steps=1)}
# Newton tolerance of these phases: with the plastic strips the residual's
# float32 floor is 1.0-1.6e-5 of ‖R₀‖ on both engines at 64², so at the
# default 1e-5 each loop ends by the stall rule after a count that rounding
# sets (6 or 7 a step, unequal between the engines); at 1e-4 each ends by
# its tolerance, 3 iterations a step on both (an H100 80GB HBM3 at 700 W,
# tests/torch_implicit_models_probe.py newton-tol)
IMPLICIT_MODELS_NEWTON_TOL = 1e-4


def build_implicit_models(dim, device, n_side=None):
    """``build_models`` on bench_implicit.py's problem with the strips of
    IMPLICIT_MODEL_KINDS, and the implicit phases' Newton-CG settings."""
    from nlpartsol_tpu_torch.formulations.implicit import ImplicitConfig

    strips = tuple(s for s in MODEL_STRIPS[dim] if s[0] in IMPLICIT_MODEL_KINDS[dim])
    grid, p, mats, cfg_e, h, eps0 = build_models(dim, n_side or IMPLICIT[dim]["n_side"],
                                                 device, strips=strips)
    cfg = ImplicitConfig(
        dt=2.0 * h / np.sqrt(1e7 / 1000.0), lme_params=cfg_e.lme_params, kinds=cfg_e.kinds,
        active_box=cfg_e.active_box, cg_maxiter=60, newton_maxiter=10, forcing="ew",
        newton_tol=IMPLICIT_MODELS_NEWTON_TOL, transfer="fused")
    return grid, p, mats, cfg, h, eps0, strips


def _implicit_launches(dim, steps, n, L, dirichlet):
    """The launch formula of formulations/implicit.py's docstring (one more
    G-scatter a step for the reactions of a Dirichlet mask)."""
    sc, ga = f"lme_scatter{dim}d", f"lme_gather{dim}d"
    return {f"{sc}:solve+gnorm": steps, f"{ga}:grad": 3 * steps + 7 * n + 2 * L,
            f"{sc}:G": steps * (1 + int(dirichlet)) + 7 * n + 2 * L, f"{ga}:N": steps}


def phase_implicit_models(device, dim):
    """The implicit step with plastic and Hencky strips on the fused
    kernels: warm-up, then timed steps with the launch counts and host syncs
    set to 0 just before and read just after; every step converged, nothing
    lost, every active field finite, launches held to the formula, each
    plastic kind yielded somewhere; host ms of one residual and one J·v."""
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
    from nlpartsol_tpu_torch.formulations.implicit import implicit_step
    from nlpartsol_tpu_torch.ops import fused_transfer as ft
    from nlpartsol_tpu_torch.ops import solvers

    spec = IMPLICIT_MODELS[dim]
    label = "implicit_models" + _suffix(dim)
    t_phase = time.perf_counter()
    grid, p0, mats, cfg, h, eps0, strips = build_implicit_models(dim, device)
    p1, _ = _implicit_steps(label + ":warm-up", to_slot_layout(p0, grid, cfg.active_box), grid,
                            mats, cfg, spec["warm"])
    ft.reset_launch_counts()
    solvers.reset_host_syncs()
    times = []
    p2, hist = _implicit_steps(label, p1, grid, mats, cfg, spec["steps"], times)
    counts, syncs = dict(ft.launch_counts), dict(solvers.host_syncs)
    steps = spec["steps"]
    n_tot, l_tot = sum(h_[0] for h_ in hist), sum(h_[1] for h_ in hist)
    want = _implicit_launches(dim, steps, n_tot, l_tot, grid.dirichlet_mask is not None)
    if counts != want:
        raise PhaseError(f"{label}: launch counts {counts}, expected {want}")
    _check_models_state(label, p2, dict(lost=torch.zeros((), dtype=torch.int32)))
    shares = _plastic_shares(p2, eps0, strips)
    costs = _residual_costs(lambda: implicit_step(
        p2, grid, mats, cfg.replace(newton_maxiter=0),
        torch.zeros(grid.dim, dtype=p2.x.dtype, device=p2.x.device)), reps=2)
    seconds = 1e-3 * sum(times)
    say(phase=label, grid="x".join(map(str, grid.dims)), particles=p0.count,
        kinds=[name for name, _ in strips], dt=cfg.dt, warmup_steps=spec["warm"], steps=steps,
        ms_per_step=1e3 * seconds / steps, step_ms=times,
        newton_iters=[h_[0] for h_ in hist], cg_iters=[h_[1] for h_ in hist],
        newton_residual=[h_[3] for h_ in hist], converged=True, lost=0, finite=True,
        launches=counts, launches_expected=want, host_syncs=syncs,
        host_ms_per_residual=costs["residual_ms"], host_ms_per_jv=costs["jv_ms"],
        plastic_share=shares, phase_seconds=time.perf_counter() - t_phase)
    unyielded = {k: v for k, v in shares.items() if k in PLASTIC_KINDS and not v > 0.0}
    if unyielded:
        raise PhaseError(f"{label}: plastic kinds that never yielded: {unyielded}")
    PATH_LAUNCHES[label] = ("implicit", counts)


def phase_implicit_models_parity(device):
    """IMPLICIT_MODELS' parity steps at its smaller width from the same state
    through the fused kernels and the windowed engine on the card, by pid:
    rel_dx < 1e-3, rel_dv < 1e-2, equal Newton iterations, per kind the eps
    gap over its largest value within MODELS_EPS_GAP."""
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout

    spec = IMPLICIT_MODELS[2]
    label = "implicit_models_parity"
    grid, p0, mats, cfg, h, _, strips = build_implicit_models(2, device, spec["parity_n_side"])
    p1 = to_slot_layout(p0, grid, cfg.active_box)
    steps = spec["parity_steps"]
    pf, hist_f = _implicit_steps(label + ":fused", p1, grid, mats, cfg, steps)
    pw, hist_w = _implicit_steps(label + ":windowed", p1, grid, mats,
                                 cfg.replace(transfer="windowed"), steps)
    for pp, tag in ((pf, "fused"), (pw, "windowed")):
        _check_models_state(f"{label}:{tag}", pp, dict(lost=torch.zeros((), dtype=torch.int32)))
    rel_dx, rel_dv, (mid_f, mid_w), (eps_f, eps_w) = _parity(
        pf, pw, h, label, names=("x", "v", "mat_id", "eps"))
    if not bool((mid_f == mid_w).all()):
        raise PhaseError(f"{label}: material ids differ by pid")
    gaps = {}
    for i, (name, _) in enumerate(strips):
        sel = mid_w == i
        scale = max(float(eps_w[sel].abs().max()), 1e-30)
        gaps[name] = float((eps_f[sel] - eps_w[sel]).abs().max()) / scale
    newton_f, newton_w = [h_[0] for h_ in hist_f], [h_[0] for h_ in hist_w]
    ok = (rel_dx < 1e-3 and rel_dv < 1e-2 and newton_f == newton_w
          and max(gaps.values()) < MODELS_EPS_GAP)
    say(phase=label, grid="x".join(map(str, grid.dims)), steps=steps, rel_dx=rel_dx,
        rel_dv=rel_dv, limit_dx=1e-3, limit_dv=1e-2, newton_fused=newton_f,
        newton_windowed=newton_w, cg_fused=[h_[1] for h_ in hist_f],
        cg_windowed=[h_[1] for h_ in hist_w], eps_gap=gaps, limit_eps_gap=MODELS_EPS_GAP, ok=ok)
    if not ok:
        raise PhaseError(f"{label}: rel_dx {rel_dx}, rel_dv {rel_dv}, Newton {newton_f} vs "
                         f"{newton_w}, eps gaps {gaps}")


MODELS_FN_ROWS = 65536
# the CPU float32 reference runs on every 8th of them (each row's update is
# independent of the others; the whole set costs the CPU most of a minute)
MODELS_FN_CPU_STRIDE = 8
# a row whose trial yield value lies within this share of its principal
# trial stress of zero may take the other branch under rounding: counted,
# not compared
YIELD_BAND = 1e-5
# card float32 against CPU float32 on the same inputs, per output, as a
# share of the output's largest magnitude over the compared rows: four times
# the CPU's own float32 against float64 spread on these inputs, the largest
# over 2D and 3D (tests/torch_models_probe.py fn-spread; floor 1e-6)
MODELS_FN_TOL = {
    "Von-Mises": dict(max=2e-2, q99=5e-4),
    "Drucker-Prager": dict(max=4e-2, q99=2e-5),
    # the frictional family's float32 Newton scatters on a few rows
    # (PERF.md §6): held at its 99th percentile and median
    "Matsuoka-Nakai": dict(q99=2e-5, median=3e-6),
    "Lade-Duncan": dict(q99=3e-4, median=3e-6),
    "Modified-Lade-Duncan": dict(q99=3e-4, median=6e-6),
    "Hencky": dict(max=3e-4, q99=1e-6),
    "Mooney-Rivlin": dict(max=1e-5, q99=1e-6),
    "Linear-Elastic": dict(max=1e-6, q99=1e-6),
    "Newtonian-Fluid-Compressible": dict(max=2e-6, q99=1e-6),
    "Bingham-Fluid": dict(max=2e-6, q99=1e-6),
}


def _model_fn_inputs(name, row, dim, n, seed):
    """``n`` states of one kind from numpy ``seed``: strains spread over
    five decades, elastic and plastic (and for Drucker-Prager and the
    frictional family tensile, apex) states; the last sixteenth of the rows
    at rest (equal eigenvalues), the sixteenth before it with F = ΔF = 0."""
    rng = np.random.default_rng(seed)
    eye = np.eye(dim)

    def spread(lo, hi, shape=()):
        return 10.0 ** rng.uniform(np.log10(lo), np.log10(hi), (n,) + shape)

    def sym(a):
        return 0.5 * (a + np.swapaxes(a, -1, -2))

    F = eye + spread(1e-6, 0.3)[:, None, None] * rng.standard_normal((n, dim, dim))
    DF = eye + spread(1e-7, 1e-2)[:, None, None] * rng.standard_normal((n, dim, dim))
    dFdt = spread(1e-3, 1e2)[:, None, None] * rng.standard_normal((n, dim, dim))
    e = spread(1e-7, 1e-2)[:, None, None] * sym(rng.standard_normal((n, dim, dim)))
    vol = np.zeros(n)
    eps = np.zeros(n)
    kappa = np.zeros(n)
    back = np.zeros((n, 3))
    if name == "Von-Mises":
        eps = rng.uniform(0.0, 0.01, n)
        back = 1e3 * rng.standard_normal((n, 3))
        back -= back.mean(axis=1, keepdims=True)
    elif name == "Drucker-Prager":
        vol = rng.uniform(-1e-3, 5e-4, n)  # compression and tension (apex)
        eps = rng.uniform(0.0, 0.01, n)
        # on the hardening law κ0·(1 + ε/ε0)^{1/m}
        kappa = row["kappa0"] * (1.0 + eps / row["plastic_strain_0"]) ** (
            1.0 / row["exponent_ortiz"])
    elif name in FRICTIONAL_KINDS:
        K = row["E"] / (3.0 * (1.0 - 2.0 * row["nu"]))
        vol = -CONFINEMENT / (3.0 * K) * rng.uniform(-0.5, 3.0, n)  # some in tension
        kappa = MODEL_KAPPA0[2][name] * rng.uniform(0.3, 3.0, n)  # on κ̂_φ = a1·Λ
        eps = kappa / row["a1_borja"]
    bemi = np.expm1(2.0 * (e + vol[:, None, None] * eye))
    bemi_zz = np.expm1(2.0 * (vol + e[:, 0, 0] * (dim == 2)))
    k = n // 16
    F[-k:], DF[-k:], dFdt[-k:], bemi[-k:], bemi_zz[-k:] = eye, eye, 0.0, 0.0, 0.0
    F[-2 * k:-k], DF[-2 * k:-k] = 0.0, 0.0
    if dim == 3:
        bemi_zz[:] = 0.0
    return dict(F_n1=F, DF=DF, dFdt_n1=dFdt, bemi=bemi, bemi_zz=bemi_zz, eps=eps,
                kappa=kappa, back_stress=back)


def _trial_yield(name, row, inp):
    """The trial yield value of a plastic kind and its row's principal trial
    stress scale, in float64 on the CPU (the models' own trial step)."""
    from nlpartsol_tpu_torch.models import borja, druckerprager as dp, vonmises as vm
    from nlpartsol_tpu_torch.models.materials import bulk_shear, lame_parameters
    from nlpartsol_tpu_torch.models.spectral import hencky_from_wm1, trial_bemi

    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in inp.items()}
    par = {k: torch.tensor(float(v), dtype=torch.float64) for k, v in row.items() if k != "kind"}
    Eh = hencky_from_wm1(trial_bemi(t["bemi"], t["bemi_zz"], t["DF"])[0])
    tr = Eh.sum(-1, keepdim=True)
    if name in FRICTIONAL_KINDS:
        lam, G = lame_parameters(par["E"], par["nu"])
        T = lam * tr + 2.0 * G * Eh
        F0 = borja._yield_fns(name.lower(), pa=par["atmospheric_pressure"],
                              m=par["m_frictional"])[0](borja._Principal(T), t["kappa"])
        return F0, T.abs().amax(-1)
    K, G = bulk_shear(par["E"], par["nu"])
    dev = 2.0 * G * (Eh - tr / 3.0)
    if name == "Von-Mises":
        dev = dev - t["back_stress"]
        k_iso, _ = vm._kappa(par["kappa0"], t["eps"], par["hardening_modulus"],
                             par["theta_voce"], par["K0_voce"], par["Kinf_voce"],
                             par["delta_voce"])
        J2 = dev.norm(dim=-1)
        return J2 - vm.SQ23 * k_iso, (K * tr + dev).abs().amax(-1)
    alpha_F, _, beta = dp.cone_parameters(par["friction_angle"], par["dilatancy_angle"],
                                          inp["DF"].shape[-1])
    J2 = dev.norm(dim=-1)
    p = -K * tr[..., 0]
    return J2 - 3.0 * alpha_F * p - beta * t["kappa"], (K * tr + dev).abs().amax(-1)


def model_fn_compare(dim, name, row, table, index, device, dtype, seed):
    """One kind's stress update on ``device`` in ``dtype`` over
    MODELS_FN_ROWS states against the CPU float32 one on every
    MODELS_FN_CPU_STRIDE-th of them.  Per output, each row's largest
    difference over the output's largest magnitude: its maximum, 99th
    percentile and median over the compared rows (neither in the yield band
    nor with F = 0, whose values are the reference's garbage).  Also the
    yield-band row count, the share of rows whose eps changed, and the count
    of F = 0 rows whose non-finite entries differ."""
    from nlpartsol_tpu_torch.models import dispatch

    full = _model_fn_inputs(name, row, dim, MODELS_FN_ROWS, seed)
    stride = MODELS_FN_CPU_STRIDE

    def call(dev, dt, inp):
        kw = {k: torch.as_tensor(v, dtype=dt, device=dev) for k, v in inp.items()}
        mats = table(dev, dt)
        mid = torch.full((len(inp["eps"]),), index, dtype=torch.int32, device=dev)
        out = dispatch.stress_integration(mat_id=mid, mats=mats, kinds=(row["kind"],), **kw)
        return {k: v.double().cpu() for k, v in out._asdict().items() if k != "failed"}

    got = {k: v[::stride] for k, v in call(device, dtype, full).items()}
    inp = {k: v[::stride] for k, v in full.items()}
    ref = call("cpu", torch.float32, inp)
    n = len(inp["eps"])
    zero_F = torch.zeros(MODELS_FN_ROWS, dtype=torch.bool)
    zero_F[-2 * (MODELS_FN_ROWS // 16):-(MODELS_FN_ROWS // 16)] = True
    zero_F = zero_F[::stride]
    keep = ~zero_F
    if name in PLASTIC_KINDS:
        phi, scale = _trial_yield(name, row, inp)
        keep &= ~(phi.abs() <= YIELD_BAND * scale)
    stats, garbage = {}, 0
    for key in got:
        g, r = got[key], ref[key]
        rows = (n,) + (1,) * (r.ndim - 1)
        fin_g, fin_r = torch.isfinite(g), torch.isfinite(r)
        differ = (fin_g != fin_r).reshape(n, -1).any(1)
        garbage += int((differ & zero_F).sum())
        # away from F = 0 the float32 non-finite entries agree on both sides
        if dtype == torch.float32 and bool((differ & ~zero_F).any()):
            raise PhaseError(f"models_fn: {name} {dim}D {key}: non-finite entries differ")
        both = fin_g & fin_r & keep.reshape(rows)
        scale = float(r[both].abs().max()) if bool(both.any()) else 0.0
        err = torch.where(both, (g - r).abs(), torch.zeros_like(r)).reshape(n, -1).amax(1)
        err = err[keep] / (scale if scale > 0 else 1.0)
        stats[key] = dict(max=float(err.max()), q99=float(torch.quantile(err, 0.99)),
                          median=float(err.median()))
    eps_in = torch.as_tensor(inp["eps"], dtype=torch.float32).double()
    plastic = float((ref["eps"][keep] != eps_in[keep]).double().mean())
    return stats, int((~keep).sum() - zero_F.sum()), plastic, garbage


def _fn_table(dim):
    from nlpartsol_tpu_torch.models import materials as M

    rows = [M.material(kind=name, **params) for name, params in MODEL_STRIPS[2]]

    def table(dev, dt):
        return M.MaterialTable(**{k: torch.as_tensor(
            np.asarray([r[k] for r in rows]), dtype=torch.int32 if k == "kind" else dt,
            device=dev) for k in rows[0]})

    return rows, table


def phase_models_fn(device):
    """Each model function on the card in float32 against the same function
    on the CPU in float32, on MODELS_FN_ROWS states a kind from a numpy seed,
    in 2D and 3D (the two torch builds)."""
    results, failed = {}, {}
    for dim in (2, 3):
        rows, table = _fn_table(dim)
        for i, ((name, _), row) in enumerate(zip(MODEL_STRIPS[2], rows)):
            stats, banded, plastic, garbage = model_fn_compare(
                dim, name, row, table, i, device, torch.float32, seed=100 * dim + i)
            tol = MODELS_FN_TOL[name]
            results[f"{name}/{dim}d"] = dict(rel_err=stats, yield_band_rows=banded,
                                             plastic_share=plastic,
                                             zero_F_rows_non_finite_differ=garbage, tol=tol)
            bad = {f"{key}.{q}": v[q] for key, v in stats.items() for q, lim in tol.items()
                   if v[q] > lim}
            if bad:
                failed[f"{name}/{dim}d"] = bad
    say(phase="models_fn", rows_per_kind=MODELS_FN_ROWS, yield_band=YIELD_BAND,
        results=results)
    if failed:
        raise PhaseError(f"models_fn: outside tolerance: {failed}")


# models_jv: the stress update's J·v (the implicit steps' tangent, forward
# mode with the spectral tangent of ops/tensor.py::isotropic_map) for every
# kind, JV_ROWS states a kind at tests/test_torch_tangent.py's three state
# families, 2D and 3D: the card's float32 J·v against a float64 central
# difference on the card (steps h and h/2 as in that test; rows where the
# two differ by more than JV_KINK straddle a return mapping's branch and are
# counted, not compared), and against the CPU's float32 J·v on the same
# inputs (every JV_CPU_STRIDE-th row; the two torch builds), on the rows of
# neither a kink nor a branch (one precision or build yielding where the
# other did not)
JV_ROWS = 4096
JV_CPU_STRIDE = 32
JV_KINK = 1e-4
# the one-sided differences' largest gap on a smooth row: h·f''/f' on strains
# of 1e-3 is about 1e-3, a kink's jump in slope of the order of 1
JV_ONE_SIDED = 5e-2
JV_KINDS = tuple(MODEL_STRIPS[2]) + (("Neo-Hookean-Wriggers", SOLID),
                                     ("Saint-Venant-Kirchhoff", SOLID),
                                     ("Solid-Rigid", dict(rho0=1000.0)))
# per row, the largest difference over each field's row scale (floored at
# 1e-3 of its largest over all rows), then its maximum, 99th percentile and
# median over the compared rows: float32 against the float64 difference, and
# card float32 against CPU float32.  Four times the CPU's own float32 spread
# against the float64 difference over these states at 2,048 rows (the
# rehearsal of this phase on the CPU, tests/torch_implicit_models_probe.py
# rehearse-models-jv), the largest over the kinds of
# a class and over 2D and 3D.  By percentiles: the frictional family, whose
# float32 Newton scatters on a few rows (as in MODELS_FN_TOL), and von
# Mises, whose principal back stress makes its update depend on the order
# of the eigenvalues: near coincident ones its tangent grows like
# Δback/gap, where float32 and float64 part (the worst row 0.74).  Card
# against CPU, the frictional family's q99 is 4.5× its worst reading, 1.1e-3
# (Lade-Duncan, 3D, general states, on an H100 80GB HBM3 at 700 W): its float32 Newton
# runs its 30 iterations on each build without meeting its tolerance, and
# the J·v follows each build's own iterates
JV_TOL = {"fd": dict(max=2e-2, q99=4e-3, median=4e-5),
          "fd_frictional": dict(q99=5e-4, median=4e-5),
          "fd_von_mises": dict(q99=4e-2, median=1e-4),
          "cpu": dict(max=2e-2, q99=4e-3, median=4e-5),
          "cpu_frictional": dict(q99=5e-3, median=4e-5),
          "cpu_von_mises": dict(q99=4e-2, median=1e-4)}
JV_STATES = ("general", "diagonal", "rest")


def _jv_inputs(name, row, dim, state, n, seed):
    """tests/test_torch_tangent.py's states for ``n`` rows of one kind:
    (history and fixed kinematics, X0, V); the update is a function of X:
    ΔF = I + X, F = ΔF·F_n, Ḟ = Ḟ_n + X."""
    rng = np.random.default_rng(seed)
    eye = np.eye(dim)
    fr = name in FRICTIONAL_KINDS
    vol = -2e-3 if fr else 0.0
    lam0 = rng.uniform(0.5, 1.5, n) if state == "general" else np.ones(n)
    eps = lam0 if fr else np.zeros(n)
    if name == "Drucker-Prager":
        kappa = row["kappa0"] * np.sqrt(1.0 + eps / row["plastic_strain_0"])
    else:
        kappa = row.get("a1_borja", 0.0) * lam0  # κ̂_φ = a1·Λ (a2 = a3 = 0)
    if state == "general":
        F_n = eye + 2e-3 * rng.standard_normal((n, dim, dim))
        e = 1e-3 * rng.standard_normal((n, dim, dim)) * (2.0 if fr else 1.0)
        bemi = np.expm1(2.0 * (0.5 * (e + np.swapaxes(e, -1, -2)) + vol * eye))
        X0 = 1e-3 * rng.standard_normal((n, dim, dim))
        if not fr:
            eps = rng.uniform(0.0, 0.01, n)
        back = 1e2 * rng.standard_normal((n, 3))
        dFdt = 0.3 * rng.standard_normal((n, dim, dim))
    else:
        F_n = np.broadcast_to(eye, (n, dim, dim))
        bemi = np.broadcast_to(np.expm1(2.0 * vol) * eye, (n, dim, dim))
        X0 = np.zeros((n, dim, dim))
        if state == "diagonal":
            X0[:] = np.diag([1.0, -1.0, 0.0][:dim]) * (1e-3 if fr else 1e-2)
        back, dFdt = np.zeros((n, 3)), np.zeros((n, dim, dim))
    arrays = dict(F_n=F_n, dFdt=dFdt, bemi=bemi, bemi_zz=np.full(n, np.expm1(2.0 * vol) *
                                                                 (dim == 2)),
                  eps=eps, kappa=kappa, back_stress=back)
    return arrays, X0, rng.standard_normal((n, dim, dim))


def _jv_fn(arrays, table, index, code, dev, dt):
    """The update as a function of X on ``dev`` in ``dt``, its outputs
    concatenated by field (in 3D without the zz channels, the third
    principal values) and the column slice of each field."""
    from nlpartsol_tpu_torch.models import dispatch

    t = {k: torch.as_tensor(np.ascontiguousarray(v), dtype=dt, device=dev)
         for k, v in arrays.items()}
    dim = t["F_n"].shape[-1]
    n = t["eps"].shape[0]
    mats = table(dev, dt)
    mid = torch.full((n,), index, dtype=torch.int32, device=dev)
    eye = torch.eye(dim, dtype=dt, device=dev)
    names = ("tau", "tau_zz", "bemi", "bemi_zz", "eps", "kappa", "back_stress")
    names = tuple(k for k in names if dim == 2 or not k.endswith("_zz"))
    widths = dict(tau=dim * dim, bemi=dim * dim, back_stress=3)
    cols, at = {}, 0
    for k in names:
        cols[k] = slice(at, at + widths.get(k, 1))
        at += widths.get(k, 1)

    def f(X):
        DF = eye + X
        cs = dispatch.stress_integration(
            F_n1=DF @ t["F_n"], DF=DF, dFdt_n1=t["dFdt"] + X, bemi=t["bemi"],
            bemi_zz=t["bemi_zz"], eps=t["eps"], kappa=t["kappa"],
            back_stress=t["back_stress"], mat_id=mid, mats=mats, kinds=(code,))
        return torch.cat([getattr(cs, k).reshape(n, -1) for k in names], dim=1)

    return f, cols


def _jv_row_errors(a, b, primal, cols, noise):
    """Per row, the largest over fields of |a − b| beyond ``noise`` over the
    field's row scale (its largest |b| in the row, floored at 1e-3 of the
    field's largest |b| and |primal| over all rows, a zz channel's with its
    tensor's: the two are rounded together)."""
    err = torch.zeros(a.shape[0], dtype=torch.float64, device=a.device)
    for name, sl in cols.items():
        ref = b[:, sl].abs()
        group = [sl] + ([cols[name[:-3]]] if name.endswith("_zz") else [])
        floor = 1e-3 * max(max(float(b[:, g].abs().max()), float(primal[:, g].abs().max()))
                           for g in group)
        floor = max(floor, 1e-300)
        excess = torch.clamp((a[:, sl] - b[:, sl]).abs() - noise[..., sl], min=0.0)
        err = torch.maximum(err, excess.amax(1) / torch.clamp(ref.amax(1), min=floor))
    return err


def _stats(err):
    if err.numel() == 0:
        return dict(max=0.0, q99=0.0, median=0.0)
    err = err.double().cpu()
    return dict(max=float(err.max()), q99=float(torch.quantile(err, 0.99)),
                median=float(err.median()))


def jv_compare(dim, name, row, table, index, state, device, seed):
    """One kind at one state family: the card's float32 J·v against the
    float64 central difference on the card and against the CPU's float32
    J·v.  Returns the two error statistics, the rows left out (kinks and
    float32 branches) and the non-finite rows of the card's J·v."""
    from nlpartsol_tpu_torch.ops import solvers

    code = row["kind"]
    # the inputs rounded to float32 once, so that both precisions see the
    # same values and differ only in their arithmetic
    arrays, X0, V = _jv_inputs(name, row, dim, state, JV_ROWS, seed)
    arrays = {k: np.asarray(v, np.float32).astype(np.float64) for k, v in arrays.items()}
    X0, V = (np.asarray(a, np.float32).astype(np.float64) for a in (X0, V))
    f32, cols = _jv_fn(arrays, table, index, code, device, torch.float32)
    X32, V32 = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (X0, V))
    primal32, jv = solvers.jvp(f32, X32, V32)
    primal32, jv = primal32.double(), jv.double()
    f64, _ = _jv_fn(arrays, table, index, code, device, torch.float64)
    X64, V64 = (torch.as_tensor(a, dtype=torch.float64, device=device) for a in (X0, V))
    primal = f64(X64)
    plastic = name in PLASTIC_KINDS
    fluid = "Fluid" in name
    h = ((1e-6 if state == "general" else 1e-5) if plastic
         else 1e-8 if state == "rest" and fluid else 1e-4)

    def fd(step):
        up, down = f64(X64 + step * V64), f64(X64 - step * V64)
        bound = 1e-15 * torch.maximum(up.abs(), down.abs()).amax(0) / step
        return (up - down) / (2.0 * step), bound

    (fd1, n1), (fd2, n2) = fd(h), fd(0.5 * h)
    none = torch.zeros(primal.shape[1], dtype=torch.float64, device=primal.device)
    # a kink: the two central differences disagree, or the one-sided ones
    # do (a kink nearer than h/2 leaves the central ones equal); a branch:
    # the float32 update yielded where the float64 one did not, or the
    # other way round
    smooth = _jv_row_errors(fd1, fd2, primal, cols, n1 + n2) <= JV_KINK
    if plastic:
        ahead = (f64(X64 + h * V64) - primal) / h
        behind = (primal - f64(X64 - h * V64)) / h
        smooth &= _jv_row_errors(ahead, behind, primal, cols, 2.0 * n1) <= JV_ONE_SIDED
    eps_in = torch.as_tensor(arrays["eps"], device=primal.device)
    e32, e64 = primal32[:, cols["eps"]][:, 0], primal[:, cols["eps"]][:, 0]
    smooth &= (e32 != eps_in.to(torch.float32).double()) == (e64 != eps_in)
    err_fd = _jv_row_errors(jv, fd2, primal, cols, n2 + 2.0 * (fd1 - fd2).abs() / 3.0)
    finite = torch.isfinite(jv).all(1)
    stride = JV_CPU_STRIDE
    sub = {k: v[::stride] for k, v in arrays.items()}
    fc, _ = _jv_fn(sub, table, index, code, "cpu", torch.float32)
    primal_cpu, jv_cpu = solvers.jvp(fc, torch.as_tensor(X0[::stride], dtype=torch.float32),
                                     torch.as_tensor(V[::stride], dtype=torch.float32))
    primal_cpu, jv_cpu = primal_cpu.double(), jv_cpu.double()
    card, p64 = jv[::stride].cpu(), primal[::stride].cpu()
    e_cpu, e_card = primal_cpu[:, cols["eps"]][:, 0], e32[::stride].cpu()
    same = smooth[::stride].cpu() & torch.isfinite(card).all(1) & (
        (e_cpu != eps_in[::stride].cpu()) == (e_card != eps_in[::stride].cpu()))
    err_cpu = _jv_row_errors(card, jv_cpu, p64, cols, none.cpu())
    return (_stats(err_fd[smooth & finite]), _stats(err_cpu[same]), int((~smooth).sum()),
            int((~finite).sum()))


def phase_models_jv(device):
    """The stress update's J·v for every kind of JV_KINDS at the three state
    families, 2D and 3D (JV_ROWS states each): finite on every row, within
    JV_TOL of the float64 central difference on the card on the rows away
    from a kink (kinks only in a plastic kind's rows away from rest, at
    most a quarter of them), and within JV_TOL of the CPU's float32 J·v."""
    from nlpartsol_tpu_torch.models import materials as M

    rows = [M.material(kind=name, **params) for name, params in JV_KINDS]

    def table(dev, dt):
        return M.MaterialTable(**{k: torch.as_tensor(
            np.asarray([r[k] for r in rows]), dtype=torch.int32 if k == "kind" else dt,
            device=dev) for k in rows[0]})

    t0 = time.perf_counter()
    results, failed = {}, {}
    for dim in (2, 3):
        for i, ((name, _), row) in enumerate(zip(JV_KINDS, rows)):
            fr = ("_frictional" if name in FRICTIONAL_KINDS
                  else "_von_mises" if name == "Von-Mises" else "")
            for j, state in enumerate(JV_STATES):
                st_fd, st_cpu, kinks, non_finite = jv_compare(
                    dim, name, row, table, i, state, device, seed=1000 * dim + 10 * i + j)
                key = f"{name}/{dim}d/{state}"
                results[key] = dict(fd=st_fd, cpu=st_cpu, kink_rows=kinks,
                                    non_finite_rows=non_finite)
                bad = {f"{which}.{q}": st[q] for which, st in (("fd", st_fd), ("cpu", st_cpu))
                       for q, lim in JV_TOL[which + fr].items() if st[q] > lim}
                plastic = name in PLASTIC_KINDS
                if non_finite or (kinks and (state == "rest" or not plastic)) or \
                        kinks > JV_ROWS // 4:
                    bad.update(kink_rows=kinks, non_finite_rows=non_finite)
                if bad:
                    failed[key] = bad
    say(phase="models_jv", rows_per_kind=JV_ROWS, states=list(JV_STATES), kink=JV_KINK,
        tol=JV_TOL, results=results, seconds=time.perf_counter() - t0)
    if failed:
        raise PhaseError(f"models_jv: outside tolerance: {failed}")


def phase_profile(grid, p1, mats, cfg, label="profile"):
    """Where a step's time goes.  With a re-bin period k > 1: one k-period
    of the main path (k−1 plain steps, one that re-bins).  With k = 1 (the
    3D path re-bins every step): 8 steps, each re-binning, after 4 steps
    timed without the re-bin (their result is discarded).  Host-clock step
    times, then a ``torch.profiler`` trace of one more such period for
    device time by kernel.  The busy share is the traced period's device
    time over the un-profiled period's host time."""
    from torch.profiler import ProfilerActivity, profile

    from nlpartsol_tpu_torch.formulations.explicit import explicit_step

    k = cfg.rebin_every
    n = k if k > 1 else 8
    body = torch.zeros(p1.dim, dtype=p1.x.dtype, device=p1.x.device)

    def step(p, i, timed=None, rebin=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, _ = explicit_step(p, grid, mats, cfg, body,
                             rebin=(i == k - 1) if rebin is None else rebin)
        torch.cuda.synchronize()
        if timed is not None:
            timed.append(1e3 * (time.perf_counter() - t0))
        return p

    def period(p, timed=None):
        for i in range(n):
            p = step(p, i % k, timed)
        return p

    plain = []
    if k == 1:
        q = p1
        for _ in range(4):
            q = step(q, 0, plain, rebin=False)
        del q
    times = []
    p = period(period(p1), times)
    if k > 1:
        plain, times = times[:-1], times[-1:]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            p, _ = explicit_step(p, grid, mats, cfg, body, rebin=i % k == k - 1)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: an operator's own row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    total_us = sum(dev_us(e) for e in kernels)
    if total_us <= 0:
        raise PhaseError(f"{label}: torch.profiler recorded no device time")
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    say(phase=label, steps=n,
        plain_step_ms=float(np.median(plain)), rebin_step_ms=float(np.median(times)),
        device_ms_per_step=1e-3 * total_us / n,
        device_busy_share=1e-3 * total_us / (sum(plain) + sum(times) if k > 1 else sum(times)),
        device_kernels_per_step=sum(e.count for e in kernels) / n,
        top=[dict(name=e.key[:60], count=e.count, device_ms_per_step=1e-3 * dev_us(e) / n)
             for e in top])


# phase ``tiles``: the scatter's candidate cell tiles per box axis, the
# first the default (``fused_transfer.TILE``)
TILE_CANDIDATES = {2: [(4, 8), (8, 8), (2, 16), (4, 16), (8, 16), (16, 16)],
                   3: [(8, 4, 4), (4, 4, 8), (4, 4, 4)]}


def phase_tiles(grid, p, cfg):
    """The main path's two scatter calls (λ solve + mass and momentum; Σ G·∇N
    beside the zero channel) at its shapes, timed with each candidate tile
    (median of 10, L2 flushed before each launch); each tile's nodes are
    checked against the first tile's."""
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    d = grid.dim
    box, params = cfg.active_box, cfg.lme_params
    margin = 0 if cfg.rebin_every == 1 else 1
    C, nc = box.capacity, box.n_cells
    x_t, lam_t, act_t = (ft.to_channel_leading(a, C, nc)
                         for a in (p.x, p.lme_lambda, p.active.float()))
    fN = ft.to_channel_leading(torch.cat([p.mass[:, None], p.mass[:, None] * cfg.dt * p.v], 1),
                               C, nc)
    G_t = ft.to_channel_leading((-p.vol0[:, None, None] * p.stress).reshape(-1, d * d), C, nc)
    dummy = ft.to_channel_leading(torch.zeros_like(p.mass), C, nc)
    base = (grid, box, params, x_t)
    _, lam_new, _ = ft.fused_scatter(*base, lam_t, act_t, fN, solve=True, margin=margin)
    calls = dict(
        solve=(lambda: ft.fused_scatter(*base, lam_t, act_t, fN, solve=True, margin=margin),
               TOL_N),
        G=(lambda: ft.fused_scatter(*base, lam_new, act_t, dummy, G_t=G_t, solve=False,
                                    margin=margin), TOL_GRAD))
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=p.x.device)
    default, rows, first = ft.TILE[d], [], {}
    try:
        for tile in TILE_CANDIDATES[d]:
            ft.TILE[d] = tile
            ft._tile_plan_of.cache_clear()
            plan = ft.tile_plan(tuple(box.cdims), ft._geom(grid, params, margin).offsets, d + 1)
            row = dict(tile=plan.tile, tiles=int(np.prod(plan.counts)))
            for key, (fn, tol) in calls.items():
                nodes = fn()[0]
                if key in first:
                    compare(f"tiles{_suffix(d)}:{tile}:{key}", nodes, first[key], **tol)
                else:
                    first[key] = nodes
                row[f"{key}_ms"] = cuda_ms(fn, 10, flush)
            rows.append(row)
    finally:
        ft.TILE[d] = default
        ft._tile_plan_of.cache_clear()
    say(phase="tiles" + _suffix(d), margin=margin, rows=rows)


def phase_probes(device, reps=20):
    """The lane-roll probes (scripts/probe_roll.py, probe_roll2.py): P1 ten
    rolls checked exactly against torch.roll summed in the same order; P2
    and P3 160 rolls against 160 multiply-adds at four shapes.  Each kernel
    is checked exactly against its plain version, then timed: the median of
    ``reps`` launches with L2 flushed before each (launches counted from 0
    over that run)."""
    from nlpartsol_tpu_torch.ops import roll_probe as rp

    rng = np.random.default_rng(0)
    rows = []
    # rewriting 1 GiB before each launch keeps the card busy while the host
    # queues the launch, so the events bracket device time, not host latency
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=device)

    def timed(fn):
        rp.reset_launch_counts()
        ms = cuda_ms(fn, reps, flush)
        return ms, sum(rp.launch_counts.values())

    def probe(name, replaces, x, fn, plain, n_ops):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if err != 0.0:
            raise PhaseError(f"probes:{name}: max error {err}, expected 0")
        ms, launches = timed(fn)
        plain_ms = cuda_ms(plain, 3, flush)
        n_bytes = 2 * 4 * x.numel()
        bound_ms, bound_by = _bound(n_bytes, n_ops * x.numel())
        rows.append(dict(
            name=name, route="cuda", source="nlpartsol_tpu_torch/csrc/roll_probe.cu",
            replaces=replaces, launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            bytes=n_bytes, operations=n_ops * x.numel(), path="probes (no MPM path)"))

    def arr(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=device)

    x = arr((8, 3456))
    probe("roll_sum:P1 8x3456 10 shifts", "scripts/probe_roll.py:31", x,
          lambda: rp.roll_sum(x, rp.P1_SHIFTS), lambda: rp.roll_sum_plain(x, rp.P1_SHIFTS),
          len(rp.P1_SHIFTS))
    for shape in [(8, 128), (8, 3456), (40, 3456), (16, 3456)]:
        x = arr(shape)
        tag = f"{shape[0]}x{shape[1]} 160"
        roll_src = "scripts/probe_roll.py:51" if shape == (8, 3456) else "scripts/probe_roll2.py:29"
        probe(f"roll_sum:{'P2/P3' if shape == (8, 3456) else 'P3'} {tag} shifts", roll_src, x,
              lambda: rp.roll_sum(x, rp.P2_SHIFTS), lambda: rp.roll_sum_plain(x, rp.P2_SHIFTS),
              160)
        probe(f"mul_sum:P3 {tag} ops", "scripts/probe_roll2.py:29", x,
              lambda: rp.mul_sum(x, 160), lambda: rp.mul_sum_plain(x, 160), 2 * 160)
    say(phase="probes", reps=reps,
        rows=[dict(name=r["name"], ms=r["ms"], plain_ms=r["plain_ms"]) for r in rows])
    return rows


def phase_large(device, dim):
    """The fused path alone at the problem's bigger size (2D 2048² nodes /
    4,194,304 particles; 3D 160³ / 512,000).  No parity leg at this size: the
    plain engine's edge tensors would take tens of GB."""
    from nlpartsol_tpu_torch.formulations.explicit import run

    spec = PROBLEMS[dim]["large"]
    label = "large" + _suffix(dim)
    grid, p0, mats, cfg, _ = build_problem(dim, spec["n_side"], device)
    p1, _ = run(p0, grid, mats, cfg, spec["warm"])
    torch.cuda.reset_peak_memory_stats()
    p2, diag, seconds, _ = _timed_run(p1, grid, mats, cfg, spec["steps"])
    lost = _check_state(label, p2, diag)
    total_nnz = int(diag["nnz"].long().sum())
    say(phase=label, grid="x".join(map(str, grid.dims)), particles=p0.count,
        slots=cfg.active_box.n_slots, warmup_steps=spec["warm"], steps=spec["steps"],
        ms_per_step=1e3 * seconds / spec["steps"], nnz_per_step=total_nnz / spec["steps"],
        nnz_per_s=total_nnz / seconds, lost=lost,
        peak_device_bytes=torch.cuda.max_memory_allocated())


# ---------------------------------------------------------------------------
# the deck-driven entry point: io/builder.py → driver.run_simulation / cli.py
# ---------------------------------------------------------------------------

# bench.py's problem as a deck: a 511² Q4 background on [0, 1]² (512² nodes),
# a 256² Q4 body over the central half, 4 Gauss-point particles an element
# (262,144), Neo-Hookean E 1e7, ν 0.3, ρ 1000, LME γ = 3, NPC-FS at CFL 0.25,
# Cel = √(E/ρ) (bench.py:88); VTK every 32 steps
DECK = dict(n_side=512, body_cells=256, steps=48, out_every=32, rebin_every=16)
DECK_PARITY = dict(dx=1e-3, dv=1e-2)  # bench.py:251, against explicit.run

_DECK_TEXT = """NLPS-Solver (Type={scheme}) {{
    CFL={cfl}
    Cel={cel!r}
    N={steps}
{solver_props}}}
GramsBox (Type=GID, File=bg.msh) {{
{boundaries}}}
GramsShapeFun (Type={shapefun}) {{
{shape_props}}}
{materials}{analysis} (File=body.msh, GPxElement={gpx}) {{
}}
{extra}GramsOutputs (i={out_every}) {{
    DIR=out
}}
"""


_CORNERS = {
    2: [(0, 0), (1, 0), (1, 1), (0, 1)],
    3: [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
        (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
}


def write_grid_mesh(path, cells, h, origin=None):
    """Write a uniform GiD ASCII mesh of ``cells`` (per axis) elements of
    side ``h`` from ``origin``: Q4 in 2D, H8 in 3D.  Node ids are 1-based in
    C order (last axis fastest); element corners go counter-clockwise (in
    3D the lower face, then the upper), the orders ``io.gid_mesh.seed_particles``
    and ``element_volumes`` read."""
    d = len(cells)
    origin = np.zeros(d) if origin is None else np.asarray(origin, np.float64)
    nodes = tuple(c + 1 for c in cells)
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in nodes], indexing="ij"), -1)
    xyz = origin + h * idx.reshape(-1, d)
    cell = np.stack(np.meshgrid(*[np.arange(c) for c in cells], indexing="ij"), -1)
    cell = cell.reshape(-1, d)
    strides = np.concatenate([np.cumprod(nodes[::-1])[-2::-1], [1]])
    conn = np.stack([(cell + np.asarray(c)) @ strides for c in _CORNERS[d]], -1) + 1
    name, nn = ("Quadrilateral", 4) if d == 2 else ("Hexahedra", 8)
    with open(path, "w") as fh:
        fh.write(f"MESH dimension {d} ElemType {name} Nnode {nn}\nCoordinates\n")
        np.savetxt(fh, np.column_stack([np.arange(1, len(xyz) + 1), xyz]),
                   fmt=["%d"] + ["%.17g"] * d)
        fh.write("End Coordinates\nElements\n")
        np.savetxt(fh, np.column_stack([np.arange(1, len(conn) + 1), conn]), fmt="%d")
        fh.write("End Elements\n")
    return path


def write_triangle_mesh(path, cells, h):
    """A 2D GiD background of T3 triangles (two a cell) over the nodes of
    :func:`write_grid_mesh`, in its node order, with the odd interior node
    columns moved by 0.2·h along x: a non-Cartesian mesh."""
    nodes = (cells[0] + 1, cells[1] + 1)
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in nodes], indexing="ij"), -1).reshape(-1, 2)
    xyz = h * idx.astype(np.float64)
    odd = (idx[:, 0] % 2 == 1) & (idx[:, 0] < cells[0])
    xyz[odd, 0] += 0.2 * h
    ids = np.arange(nodes[0] * nodes[1]).reshape(nodes) + 1
    i, j = np.meshgrid(np.arange(cells[0]), np.arange(cells[1]), indexing="ij")
    a, b, c, d = ids[i, j], ids[i + 1, j], ids[i + 1, j + 1], ids[i, j + 1]
    tris = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                           np.stack([a, c, d], -1).reshape(-1, 3)])
    with open(path, "w") as fh:
        fh.write("MESH dimension 2 ElemType Triangle Nnode 3\nCoordinates\n")
        np.savetxt(fh, np.column_stack([np.arange(1, len(xyz) + 1), xyz]),
                   fmt=["%d", "%.17g", "%.17g"])
        fh.write("End Coordinates\nElements\n")
        np.savetxt(fh, np.column_stack([np.arange(1, len(tris) + 1), tris]), fmt="%d")
        fh.write("End Elements\n")
    return path


def write_deck(directory, n_cells, h, body_cells, body_origin, scheme="NPC-FS", cfl=0.25,
               cel=100.0, steps=3, shapefun="LME", materials=None, analysis="One-Phase-Analysis",
               gravity=None, fix_bottom=False, out_every=100, extra="", solver_props="",
               background="grid"):
    """A deck on a uniform GiD background of ``n_cells`` elements of side
    ``h`` (``background='triangles'``: :func:`write_triangle_mesh`'s, 2D)
    and a body of ``body_cells`` elements from ``body_origin``, written by
    :func:`write_grid_mesh`; ``fix_bottom`` holds the nodes of the lowest
    plane (last axis 0) with a zero curve."""
    import os

    dim = len(n_cells)
    os.makedirs(directory, exist_ok=True)
    if background == "triangles":
        write_triangle_mesh(os.path.join(directory, "bg.msh"), n_cells, h)
    else:
        write_grid_mesh(os.path.join(directory, "bg.msh"), n_cells, h)
    write_grid_mesh(os.path.join(directory, "body.msh"), body_cells, h, origin=body_origin)
    boundaries = ""
    if fix_bottom:
        nodes = np.arange(int(np.prod([c + 1 for c in n_cells]))).reshape(
            [c + 1 for c in n_cells])
        bottom = nodes[..., 0].reshape(-1)  # the node ids are 0-based rows in C order
        with open(os.path.join(directory, "bottom.txt"), "w") as fh:
            fh.write("\n".join(map(str, bottom)) + "\n")
        with open(os.path.join(directory, "zero.txt"), "w") as fh:
            fh.write("CONSTANT_CURVE SCALE#0.0\n")
        comps = "".join(f"        BcDirichlet V.{c} zero.txt\n" for c in "xyz"[:dim])
        boundaries = f"    GramsBoundary (File=bottom.txt) {{\n{comps}    }}\n"
    if gravity is not None:
        extra += "GramsBodyForces {\n" + f"    g.{'xyz'[dim - 1]}={gravity}\n" + "}\n"
    materials = materials or ("Define-Material (idx=0, Model=Neo-Hookean-Wriggers) {\n"
                              "    E=1e7\n    nu=0.3\n    rho=1000\n}\n")
    text = _DECK_TEXT.format(
        scheme=scheme, cfl=cfl, cel=cel, steps=steps, solver_props=solver_props,
        boundaries=boundaries,
        shapefun=shapefun, shape_props="    gamma=3.0\n" if shapefun in ("LME", "aLME") else "",
        materials=materials, analysis=analysis, gpx=2 ** dim, extra=extra, out_every=out_every)
    path = os.path.join(directory, "sim.nlp")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def phase_deck(device):
    """bench.py's problem written as a deck and run through the user's entry
    point: ``build_simulation`` → ``run_simulation(transfer='auto')`` with
    VTK outputs, launches counted from 0 over the run; parity by pid against
    the same built particles stepped by ``explicit.run`` with the driver's
    config."""
    import os
    import tempfile

    from nlpartsol_tpu_torch.driver import make_step_config, run_simulation
    from nlpartsol_tpu_torch.formulations.explicit import run, to_slot_layout
    from nlpartsol_tpu_torch.io import gid_mesh, native
    from nlpartsol_tpu_torch.io.builder import build_simulation
    from nlpartsol_tpu_torch.ops import fused_transfer as ft, windowed

    n, nb, steps = DECK["n_side"], DECK["body_cells"], DECK["steps"]
    h = 1.0 / (n - 1)
    lo = n // 4
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = write_deck(tmp, (n - 1,) * 2, h, (nb,) * 2, (lo * h,) * 2, cel=float(np.sqrt(1e4)),
                          steps=steps, out_every=DECK["out_every"])
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        setup = build_simulation(path, device=device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        # the builder's GiD reader (C++ where g++ built it) beside the
        # Python one, on the deck's two meshes (warm file cache)
        gid_read_s = {}
        for name in ("bg.msh", "body.msh"):
            for reader, read in (("builder", gid_mesh.read_gid_mesh),
                                 ("python", gid_mesh._read_gid_mesh_py)):
                t0 = time.perf_counter()
                read(os.path.join(tmp, name))
                gid_read_s[f"{name}:{reader}"] = time.perf_counter() - t0
        n_p = setup.particles.count
        if n_p != (2 * nb) ** 2:
            raise PhaseError(f"deck: {n_p} particles seeded, expected {(2 * nb) ** 2}")
        # velocities 0.01·N(0,1) from numpy seed 0 in seeding order, as bench.py
        v = 0.01 * np.random.default_rng(0).standard_normal((n_p, 2)).astype(np.float32)
        setup.particles = setup.particles.replace(v=torch.as_tensor(v, device=device))
        p_init = setup.particles
        box = windowed.default_box(setup.grid, p_init.x.cpu().numpy(), p_init.active.cpu().numpy())
        cfg = make_step_config(setup, transfer="auto", active_box=box)
        if cfg.transfer != "fused" or cfg.rebin_every != DECK["rebin_every"]:
            raise PhaseError(f"deck: config {cfg.transfer} k={cfg.rebin_every}, expected fused "
                             f"k={DECK['rebin_every']}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_slot_layout(p_init, setup.grid, box)
        torch.cuda.synchronize()
        layout_s = time.perf_counter() - t0

        os.chdir(tmp)
        try:
            ft.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p_out, hist = run_simulation(setup, transfer="auto", n_steps=steps,
                                         write_outputs=True, progress=False)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = dict(ft.launch_counts)
            peak = torch.cuda.max_memory_allocated()
            written = sorted(os.listdir("out"))
        finally:
            os.chdir(cwd)
    want = {"lme_scatter2d:solve": steps, "lme_scatter2d:G": steps,
            "lme_gather2d:N+grad": steps, "lme_gather2d:N": steps}
    if counts != want:
        raise PhaseError(f"deck: launch counts {counts}, expected {want}")
    if hist["rebin_every"] != DECK["rebin_every"]:
        raise PhaseError(f"deck: the run ended at k={hist['rebin_every']}")
    files = ["nodes_000000.vtk", "nodes_000032.vtk", "particles_000000.vtk", "particles_000032.vtk"]
    if [f for f in written if f.endswith(".vtk")] != files:
        raise PhaseError(f"deck: wrote {written}, expected {files}")
    n_active = int(p_out.active.sum())
    if n_active != n_p or not all(bool(torch.isfinite(getattr(p_out, f)[p_out.active]).all())
                                  for f in ("x", "v", "F", "stress")):
        raise PhaseError(f"deck: {n_active} of {n_p} particles active, or non-finite fields")
    # the 32-step chunk (steps 1-32; step 0 and steps 33-47 are chunks of
    # their own at the output events' bounds)
    chunk_s, chunk_steps = hist["chunk_wall_s"][1]
    p_ref, diag = run(p_init, setup.grid, setup.materials, cfg, steps)
    rel_dx, rel_dv = _parity(p_out, p_ref, h, "deck")
    nnz_per_step = float(diag["nnz"].double().mean())
    ok = rel_dx < DECK_PARITY["dx"] and rel_dv < DECK_PARITY["dv"]
    st = hist["stage_timings"]
    say(phase="deck", grid=f"{n}x{n}", particles=n_p, slots=box.n_slots, capacity=box.capacity,
        transfer=cfg.transfer, rebin_every=hist["rebin_every"], steps=steps,
        write_deck_s=write_s, build_s=build_s, gid_native=native.available(),
        gid_read_s=gid_read_s, slot_layout_s=layout_s, run_s=run_s,
        chunk_steps=chunk_steps, ms_per_step=1e3 * chunk_s / chunk_steps,
        main_path_ms_per_step=REPORT.get("main_path"),
        step_chunks_s=st["step_chunks"]["total_s"], vtk_s=st["vtk_output"]["total_s"],
        vtk_files=len(files), nnz_per_step=nnz_per_step,
        nnz_per_s=nnz_per_step * chunk_steps / chunk_s, peak_device_bytes=peak,
        launches=counts, lost=0, rel_dx=rel_dx, rel_dv=rel_dv, limit_dx=DECK_PARITY["dx"],
        limit_dv=DECK_PARITY["dv"], ok=ok)
    if not ok:
        raise PhaseError(f"deck: rel_dx {rel_dx}, rel_dv {rel_dv} against explicit.run")


# One small deck per route of the driver, and the engine the JAX package's
# rule picks for it (nlpartsol_tpu/driver.py:49-87, with its 'pallas' as the
# port's 'fused'): LME NPC-FS, Newmark-β, Static, DEM and both u-pw schemes
# and -up Newmark-β on the kernels; FEM, FE and Generalized-α windowed.  The
# two mixed implicit decks loosen the deck's Newton tolerance
# (TOL-Newmark-beta): at the default 1e-5 every Newton iteration after the
# first runs GMRES(20) through all its cycles at the float32 floor (ROADMAP.md
# queue 3), some 600 J·v a step on a 192-particle deck.
_SOIL_WATER = ("Define-Material (idx=0, Model=Neo-Hookean-Wriggers) {\n"
               "    E=1e7\n    nu=0.3\n    rho=2700\n}\n"
               "Define-Material (idx=1, Model=Newtonian-Fluid-Compressible) {\n"
               "    rho=1000\n    Compressibility=2.2e7\n}\n"
               "Define-Mixture (idx=0) {\n    Soil-Idx=0\n    Fluid-Idx=1\n"
               "    Permeability-Skeleton=1e-5\n    Reference-Volume-Fraction-Soil=0.6\n"
               "    Reference-Volume-Fraction-Fluid=0.4\n}\n")
_FRACTURE_DECK_MATERIAL = ("Define-Material (idx=0, Model=Neo-Hookean-Wriggers) {\n"
                           "    E=1e7\n    nu=0.3\n    rho=1000\n    Ceps=1.5\n    Gf=1e-3\n}\n")
_DRUCKER_PRAGER_BODY = ("Model=Drucker-Prager) {\n    E=1e7\n    nu=0.3\n    rho={rho}\n"
                        "    Yield-stress=2e3\n    Friction-angle=30\n    Dilatancy-angle=10\n"
                        "    Hardening-exponent=2\n    Reference-plastic-strain=0.01\n}\n")
_DRUCKER_PRAGER_DECK = "Define-Material (idx=0, " + _DRUCKER_PRAGER_BODY.replace("{rho}", "1000")
_VON_MISES_DECK = ("Define-Material (idx=0, Model=Von-Mises) {\n    E=1e7\n    nu=0.3\n"
                   "    rho=1000\n    Yield-stress=1e3\n    Hardening-Modulus=1e5\n}\n")
_HENCKY_DECK = "Define-Material (idx=0, Model=Hencky) {\n    E=1e7\n    nu=0.3\n    rho=1000\n}\n"
_SOIL_WATER_DRUCKER_PRAGER = _SOIL_WATER.replace(
    "Model=Neo-Hookean-Wriggers) {\n    E=1e7\n    nu=0.3\n    rho=2700\n}\n",
    _DRUCKER_PRAGER_BODY.replace("{rho}", "2700"))
DECK_ROUTES = {
    # name: (deck options, CLI formulation flag, the engine of the JAX rule);
    # the option ``transfer`` goes to the CLI's --transfer (default auto)
    "npcfs_lme_2d": (dict(), "--FORMULATION-U", "fused"),
    "npcfs_lme_3d": (dict(dim=3), "--FORMULATION-U", "fused"),
    "npcfs_fem_2d": (dict(shapefun="FEM"), "--FORMULATION-U", "windowed"),
    "newmark_lme": (dict(scheme="Newmark-beta", cfl=1.0), "--FORMULATION-U", "fused"),
    "static_lme": (dict(scheme="Static", cfl=1.0), "--FORMULATION-U", "fused"),
    "forward_euler": (dict(scheme="FE", cfl=0.1), "--FORMULATION-U", "windowed"),
    "generalized_alpha": (dict(scheme="Generalized-alpha", cfl=0.1), "--FORMULATION-U",
                          "windowed"),
    "upw_explicit": (dict(materials=_SOIL_WATER, analysis="Soil-Water-Coupling-One-Layer",
                          cfl=0.1), "--FORMULATION-Upw", "fused"),
    "upw_implicit": (dict(materials=_SOIL_WATER, analysis="Soil-Water-Coupling-One-Layer",
                          scheme="Newmark-beta", cfl=0.5,
                          solver_props="    TOL-Newmark-beta=1e-2\n"),
                     "--FORMULATION-Upw", "fused"),
    "up_newmark": (dict(scheme="Newmark-beta", cfl=1.0,
                        solver_props="    TOL-Newmark-beta=1e-3\n"),
                   "--FORMULATION-Up", "fused"),
    "dem": (dict(scheme="Discrete-Energy-Momentum", cfl=1.0), "--FORMULATION-U", "fused"),
    # nonlocal fracture from the deck's Fracture-Modulus key: explicit on the
    # kernels (a re-bin every step) and on the windowed engine, Newmark-β
    # (staggered); a tiny Gf erodes what tension there is under gravity
    "fracture_fused": (dict(materials=_FRACTURE_DECK_MATERIAL,
                            solver_props="    Fracture-Modulus=Eigenerosion\n"),
                       "--FORMULATION-U", "fused"),
    "fracture_windowed": (dict(materials=_FRACTURE_DECK_MATERIAL,
                               solver_props="    Fracture-Modulus=Eigenerosion\n",
                               transfer="windowed"), "--FORMULATION-U", "windowed"),
    "fracture_newmark": (dict(scheme="Newmark-beta", cfl=1.0, materials=_FRACTURE_DECK_MATERIAL,
                              solver_props="    Fracture-Modulus=Eigenerosion\n"),
                         "--FORMULATION-U", "fused"),
    "ugimp": (dict(shapefun="uGIMP"), "--FORMULATION-U", "windowed"),
    # aLME: the deck's ALMEParams, β started from β₀ and pulled back
    "alme": (dict(shapefun="aLME"), "--FORMULATION-U", "windowed"),
    # an unstructured T3 background (a FEMesh): the scatter engine, FEM and
    # meshfree LME over the node cloud
    "unstructured_fem": (dict(background="triangles", shapefun="FEM"), "--FORMULATION-U",
                         "scatter"),
    "unstructured_lme": (dict(background="triangles"), "--FORMULATION-U", "scatter"),
    # the return mappings and Hencky on the implicit schemes (their J·v is
    # forward mode through the models)
    "newmark_drucker_prager": (dict(scheme="Newmark-beta-Finite-Strains", cfl=1.0,
                                    materials=_DRUCKER_PRAGER_DECK), "--FORMULATION-U", "fused"),
    "static_von_mises": (dict(scheme="Static", cfl=1.0, materials=_VON_MISES_DECK),
                         "--FORMULATION-U", "fused"),
    "upw_newmark_drucker_prager": (dict(materials=_SOIL_WATER_DRUCKER_PRAGER,
                                        analysis="Soil-Water-Coupling-One-Layer",
                                        scheme="Newmark-beta", cfl=0.5,
                                        solver_props="    TOL-Newmark-beta=1e-2\n"),
                                   "--FORMULATION-Upw", "fused"),
    "up_hencky": (dict(scheme="Newmark-beta", cfl=1.0, materials=_HENCKY_DECK,
                       solver_props="    TOL-Newmark-beta=1e-3\n"), "--FORMULATION-Up", "fused"),
    "dem_hencky": (dict(scheme="Discrete-Energy-Momentum", cfl=1.0, materials=_HENCKY_DECK),
                   "--FORMULATION-U", "fused"),
}
DECK_ROUTE_STEPS = 3
GOLDEN_DECKS = ("dem_bar", "dem_svk_bar", "dem_bar3d")


def _route_deck(directory, dim=2, cel=100.0, steps=DECK_ROUTE_STEPS, **kw):
    """A body on the floor of a 16² (3D 15³) background under gravity, its
    bottom nodes held, for ``steps`` steps."""
    cells = 16 if dim == 2 else 15
    h = 1.0 / cells
    body = (8,) * (dim - 1) + (6,)
    origin = (4 * h,) * (dim - 1) + (0.0,)
    if "materials" in kw:
        cel = float(np.sqrt((2.2e7 / 0.4) / (0.6 * 2700 + 0.4 * 1000)))
    return write_deck(directory, (cells,) * dim, h, body, origin, cel=cel,
                      steps=steps, gravity=-9.81, fix_bottom=True, **kw)


def phase_decks(device):
    """Every route of the driver through ``cli.main`` on the card (3 steps,
    ``--no-output``, a backup at the last step to read the state back); then
    the reference binary's DEM goldens through the port's builder in float64
    on the card, in one subprocess."""
    import os
    import subprocess
    import tempfile

    from nlpartsol_tpu_torch import cli
    from nlpartsol_tpu_torch.driver import make_step_config
    from nlpartsol_tpu_torch.io.builder import build_simulation
    from nlpartsol_tpu_torch.io.checkpoint import load_checkpoint
    from nlpartsol_tpu_torch.ops import fused_transfer as ft
    from nlpartsol_tpu_torch.shapefun import alme

    cwd = os.getcwd()
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (opts, flag, engine) in DECK_ROUTES.items():
            opts = dict(opts)
            transfer = opts.pop("transfer", "auto")
            path = _route_deck(os.path.join(tmp, name), **opts)
            setup = build_simulation(path, device=device)
            setup.formulation = {"--FORMULATION-U": "u", "--FORMULATION-Up": "up",
                                 "--FORMULATION-Upw": "upw"}[flag]
            cfg = make_step_config(setup, transfer=transfer)
            picked = cfg.transfer
            if name.startswith("unstructured") != (type(setup.grid).__name__ == "FEMesh"):
                raise PhaseError(f"decks {name}: background {type(setup.grid).__name__}")
            if picked != engine:
                raise PhaseError(f"decks {name}: engine {picked}, the JAX rule's {engine}")
            damage = getattr(cfg, "damage", None)
            if (damage is not None) != name.startswith("fracture") or (
                    damage is not None and getattr(cfg, "rebin_every", 1) != 1):
                raise PhaseError(f"decks {name}: fracture driver {damage}, {cfg}")
            os.chdir(os.path.dirname(path))
            try:
                ft.reset_launch_counts()
                t0 = time.perf_counter()
                rc = cli.main([flag, "-f", "sim.nlp", "--platform", device, "--no-output",
                               "--backup-every", str(DECK_ROUTE_STEPS), "--transfer", transfer])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = sum(ft.launch_counts.values())
                p, step, _ = load_checkpoint(os.path.join("out", "backup.npz"), device=device)
            finally:
                os.chdir(cwd)
            act = p.active
            finite = all(bool(torch.isfinite(getattr(p, f)[act]).all())
                         for f in ("x", "v", "a", "F", "stress", "J", "pw", "damage"))
            lost = setup.particles.count - int(act.sum())
            ok = rc == 0 and step == DECK_ROUTE_STEPS and finite and lost == 0 and \
                (launches > 0) == (engine == "fused")
            rows[name] = dict(engine=picked, launches=launches, seconds=seconds,
                              particles=setup.particles.count, finite=finite, lost=lost, ok=ok)
            if damage is not None:
                rows[name].update(damage=damage, eroded=int((p.damage[act] >= 1).sum()))
            if setup.shapefun == "alme":
                beta = p.lme_beta[act]
                b0 = torch.as_tensor(alme.beta0(cfg.alme_params, setup.grid.spacing, p.dim),
                                     device=beta.device)
                moved = float((beta - b0).abs().max() / b0.abs().max())
                rows[name].update(beta_finite=bool(torch.isfinite(beta).all()),
                                  beta_moved=moved)
                ok = ok and rows[name]["beta_finite"] and moved > 0
                rows[name]["ok"] = ok
            if not ok:
                raise PhaseError(f"decks {name}: exit code {rc}, step {step}, {rows[name]}")
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                          "_torch_e2e_worker.py")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, worker, "--device", device, *GOLDEN_DECKS],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "NLPS_DTYPE": "float64"})
    golden_s = time.perf_counter() - t0
    if r.returncode != 0 or "TORCH_E2E_PARITY_OK" not in r.stdout:
        raise PhaseError(f"decks: DEM goldens failed on the card:\n{r.stdout[-3000:]}"
                         f"{r.stderr[-3000:]}")
    say(phase="decks", routes=rows, steps=DECK_ROUTE_STEPS, golden_decks=list(GOLDEN_DECKS),
        golden_dtype="float64", golden_position_limit=1e-8, golden_s=golden_s, ok=True)


# ---------------------------------------------------------------------------
# nonlocal fracture, uGIMP and aLME, and the scatter engine on every step
# ---------------------------------------------------------------------------

# The fracture problem: the main path's (2D bench.py 512², 3D bench3d.py
# 96³) with a central band of FRACTURE_BAND["cells"] cells on either side of
# x = 0.5 pre-stretched to F_xx = 1.3 (tests/test_fracture.py:166) and the
# two halves pulled apart (x velocity ±pull by the side of x = 0.5), so the
# band's strain grows after the trigger; Neo-Hookean E 1e7, ν 0.3, ρ 1000,
# Ceps 1.5 (reach 2), a re-bin every step (the driver's rule under
# fracture).  Gf, ft, heps and wcrit from the CPU rehearsal
# (tests/torch_fracture_probe.py rehearse): the band erodes or triggers and
# softens, the far field stays intact.
FRACTURE = {2: dict(n_side=512, warm=4, steps=16, parity_steps=8),
            3: dict(n_side=96, warm=2, steps=4, parity_steps=4)}
FRACTURE_BAND = dict(cells=8, stretch=1.3, pull=5.0, margin=4)
FRACTURE_MATERIAL = dict(Ceps=1.5, Gf=600.0, ft=2e6, heps=1.0, wcrit=1e-3)
# the eroded (eigenerosion) or triggered (eigensoftening: strain_f > 0)
# share of the band's particles; and the far field: beyond 2·Ceps·h of the
# band, no particle damaged or triggered
FRACTURE_BAND_SHARE = (0.5, 1.0)
# fused against windowed on the card, by pid: x and v at bench.py's gate;
# the threshold decisions as counts of particles — eigenerosion's damage,
# eigensoftening's trigger (strain_f > 0) and its damage beyond
# SOFT_DAMAGE_TOL (the cohesive slope heps/wcrit = 1000 turns a float32
# difference of 1e-5 in the strain into 1e-2 of damage); strain_f over the
# particles both engines triggered, as a gap over its largest value.  Set
# from the readings: the JAX package's own windowed-vs-pallas spread on this
# problem at 128², 8 steps (tests/torch_fracture_probe.py jax-engines 2 128)
# is 0 differing decisions and a strain_f gap of 5.8e-7, the card's 0 and
# 7.3e-7 on every fracture phase; the limits are a few particles and about
# 14x the largest gap
FRACTURE_PARITY = dict(dx=1e-3, dv=1e-2, decisions=4, strain_f=1e-5)
SOFT_DAMAGE_TOL = 1e-2
BEPS_SAMPLE = 64  # the Beps check's float64 brute force on every 64th particle
BEPS_AMBIGUOUS = 1e-5  # pairs with |r² − R²| within this share of R² may go either way
# the 2D lattice puts neighbour pairs at exactly R = 1.5h, so the check runs
# on the state moved by a seeded jitter of up to BEPS_JITTER·h per axis, each
# particle kept in its cell; at most BEPS_AMBIGUOUS_SHARE of the sampled rows
# may then hold an ambiguous pair
BEPS_JITTER = 1e-2
BEPS_AMBIGUOUS_SHARE = 0.05
FRACTURE_IMPLICIT = dict(n_side=256, warm=1, steps=2, parity_steps=2, parity_n_side=128, cfl=0.25)


def build_fracture(dim, n_side, device, damage):
    """The main path's problem with the stretched band, the fracture
    material and the driver ``damage`` at a re-bin every step."""
    from nlpartsol_tpu_torch.models import fracture

    grid, p, _, cfg, h = build_problem(dim, n_side, device)
    # the box FRACTURE_BAND["margin"] cells wider than the particles: the
    # softening band recoils at up to ~0.15 cell a step
    m = FRACTURE_BAND["margin"] - 2
    box = cfg.active_box
    box = box.replace(offset=tuple(o - m for o in box.offset),
                      cdims=tuple(c + 2 * m for c in box.cdims))
    cfg = cfg.replace(rebin_every=1, damage=damage, active_box=box,
                      beps_reach=fracture.beps_reach(FRACTURE_MATERIAL["Ceps"]))
    return grid, _stretch_band(p, h, pull=True), _fracture_table(device), cfg, h


def _fracture_table(device):
    from nlpartsol_tpu_torch.models import materials as M

    return M.material_table([M.material(kind="Neo-Hookean-Wriggers", E=1e7, nu=0.3, rho0=1000.0,
                                        **FRACTURE_MATERIAL)], device=device)


def _stretch_band(p, h, pull):
    from nlpartsol_tpu_torch.ops import tensor as tn

    side = p.x[:, 0] - 0.5
    band = side.abs() < FRACTURE_BAND["cells"] * h
    F = p.F.clone()
    F[:, 0, 0] = torch.where(band, torch.full_like(side, FRACTURE_BAND["stretch"]),
                             torch.ones_like(side))
    v = p.v.clone()
    if pull:
        # the halves move apart at ±pull, the band between them stretches
        # at the uniform rate pull/(cells·h)
        w = FRACTURE_BAND["cells"] * h
        v[:, 0] = v[:, 0] + FRACTURE_BAND["pull"] * torch.clamp(side / w, -1.0, 1.0)
    return p.replace(F=F, J=tn.det(F), v=v)


def _fracture_shares(p, h, damage):
    """The band's eroded (eigenerosion) or triggered (eigensoftening) share,
    and the far field's count of particles touched, both by the particles'
    reference positions x − dis."""
    act = p.active
    side = (p.x[act, 0] - p.dis[act, 0] - 0.5).abs()  # in the reference configuration
    hit = (p.damage[act] > 0) if damage == "eigenerosion" else (p.strain_f[act] > 0)
    band = side < FRACTURE_BAND["cells"] * h
    far = side > (FRACTURE_BAND["cells"] + 2 * FRACTURE_MATERIAL["Ceps"]) * h
    return dict(band_particles=int(band.sum()), band_share=float(hit[band].float().mean()),
                far_particles=int(far.sum()),
                far_touched=int((hit | (p.damage[act] > 0))[far].sum()),
                damaged=int((p.damage[act] > 0).sum()), eroded=int((p.damage[act] >= 1).sum()),
                triggered=int((p.strain_f[act] > 0).sum()),
                damage_max=float(p.damage[act].max()))


def _beps_inputs(p, mats, grid):
    """The eigenerosion drivers' two neighbour sums on a state: V and V·W of
    the active intact particles, radius Ceps·h."""
    zero = torch.zeros((), dtype=p.x.dtype, device=p.x.device)
    act = p.active
    V = p.vol0 * p.J
    vals = {"V": torch.where(act, V, zero), "VW": torch.where(act & (p.damage < 1), V * p.W, zero)}
    radius = mats.Ceps[p.mat_id.long()] * grid.spacing
    return vals, radius


def _beps_costs(p, grid, mats, cfg, label):
    """ms of one call of the Beps sums at the step's shapes (CUDA events, 5
    calls) and its kernels (torch.profiler, one call)."""
    from torch.profiler import ProfilerActivity, profile

    from nlpartsol_tpu_torch.models import fracture

    vals, radius = _beps_inputs(p, mats, grid)

    def call():
        return fracture._neighbor_pair_sums(grid, cfg.active_box, p.x, p.active, vals, radius,
                                            reach=cfg.beps_reach)

    call()
    ms = cuda_ms(call, 5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    prof_out = _profiled_step(prof, ms, label)
    return dict(beps_ms_per_call=ms, beps_kernels_per_call=prof_out["device_kernels"],
                beps_device_ms_per_call=prof_out["device_ms"],
                offsets=(2 * cfg.beps_reach + 1) ** grid.dim)


def beps_bruteforce(x, vals, radius, h, sample, reach):
    """Σ_q val_q over |x_p − x_q| ≤ R_p for the rows ``sample`` of the
    active particles (float64 numpy, cell buckets of side h over the
    positions, independent of the slot layout): the sums counting only the
    pairs surely inside (r² ≤ R²(1 − BEPS_AMBIGUOUS)) and those counting the
    ambiguous pairs too (r² ≤ R²(1 + BEPS_AMBIGUOUS))."""
    import itertools

    n, d = x.shape
    cell = np.floor(x / h).astype(np.int64)
    cell -= cell.min(0)
    dims = cell.max(0) + 1
    key = np.ravel_multi_index(cell.T, dims)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    xs, r2 = x[sample], radius[sample] ** 2
    lo = np.zeros((len(sample), vals.shape[1]))
    hi = np.zeros_like(lo)
    for off in itertools.product(range(-reach - 1, reach + 2), repeat=d):
        c = cell[sample] + np.asarray(off)
        inside = np.all((c >= 0) & (c < dims), axis=1)
        kk = np.ravel_multi_index(np.clip(c, 0, dims - 1).T, dims)
        a, b = np.searchsorted(ks, kk, "left"), np.searchsorted(ks, kk, "right")
        for j in range(int((b - a).max(initial=0))):
            idx = a + j
            ok = inside & (idx < b)
            q = order[np.minimum(idx, n - 1)]
            d2 = np.sum((xs - x[q]) ** 2, axis=1)
            lo += np.where((ok & (d2 <= r2 * (1 - BEPS_AMBIGUOUS)))[:, None], vals[q], 0.0)
            hi += np.where((ok & (d2 <= r2 * (1 + BEPS_AMBIGUOUS)))[:, None], vals[q], 0.0)
    return lo, hi


def _beps_check(p, grid, mats, cfg, label):
    """The card's float32 Beps sums on the jittered state against the
    float64 brute force on the CPU, on every BEPS_SAMPLE-th active particle:
    each sum between the brute force without and with the ambiguous pairs,
    within 1e-5 relative (float32 sums of tens of terms), and few rows
    ambiguous."""
    from nlpartsol_tpu_torch.models import fracture

    h = grid.spacing
    origin = torch.as_tensor(grid.origin, dtype=p.x.dtype, device=p.x.device)
    cell = torch.floor((p.x - origin) / h)
    gen = torch.Generator(device=p.x.device).manual_seed(0)
    shake = (2 * torch.rand(p.x.shape, generator=gen, device=p.x.device, dtype=p.x.dtype) - 1)
    x = torch.minimum(torch.maximum(p.x + BEPS_JITTER * h * shake, origin + (cell + 1e-3) * h),
                      origin + (cell + 1 - 1e-3) * h)
    p = p.replace(x=torch.where(p.active[:, None], x, p.x))
    vals, radius = _beps_inputs(p, mats, grid)
    got = fracture._neighbor_pair_sums(grid, cfg.active_box, p.x, p.active, vals, radius,
                                       reach=cfg.beps_reach)
    act = p.active
    names = list(vals)
    card = torch.stack([got[k][act] for k in names], -1).double().cpu().numpy()
    x = p.x[act].double().cpu().numpy()
    v = torch.stack([vals[k][act] for k in names], -1).double().cpu().numpy()
    r = radius[act].double().cpu().numpy()
    sample = np.arange(0, len(x), BEPS_SAMPLE)
    t0 = time.perf_counter()
    lo, hi = beps_bruteforce(x, v, r, grid.spacing, sample, cfg.beps_reach)
    brute_s = time.perf_counter() - t0
    c = card[sample]
    scale = np.abs(hi).max(0)
    tol = 1e-5 * np.maximum(np.abs(hi), 1e-6 * scale)
    below, above = lo - tol - c, c - hi - tol
    worst = float(np.max(np.maximum(below, above) / np.maximum(np.abs(hi), 1e-30)))
    ambiguous = int(np.any(lo != hi, axis=1).sum())
    ok = bool(np.all(below <= 0) and np.all(above <= 0)
              and ambiguous <= BEPS_AMBIGUOUS_SHARE * len(sample))
    out = dict(sampled=len(sample), values=names, jitter=BEPS_JITTER, ambiguous_rows=ambiguous,
               worst_rel_outside=worst, mean_neighbors=float(np.mean(lo[:, 0] / np.maximum(
                   v[sample, 0], 1e-30))), brute_force_s=brute_s, ok=ok)
    if not ok:
        raise PhaseError(f"{label}: Beps sums outside the float64 brute force {out}")
    return out


def _fracture_parity(p0, grid, mats, cfg, h, steps, label):
    """``steps`` from the same state on the fused kernels and the windowed
    engine on the card, by pid: x, v, and the damage fields' gaps."""
    from nlpartsol_tpu_torch.formulations.explicit import run

    pf, df = run(p0, grid, mats, cfg, steps)
    _check_state(label + ":fused", pf, df)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pw, dw = run(p0, grid, mats, cfg.replace(transfer="windowed"), steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _check_state(label + ":windowed", pw, dw)
    return _damage_parity(pf, pw, h, label, cfg.damage, steps,
                          windowed_ms_per_step=1e3 * seconds / steps)


def _damage_parity(pf, pw, h, label, damage, steps, **extra):
    lim = FRACTURE_PARITY
    rel_dx, rel_dv, (df_, dw_), (sf, sw) = _parity(pf, pw, h, label,
                                                   ("x", "v", "damage", "strain_f"))
    both = (sf > 0) & (sw > 0)
    s_scale = max(float(sw.abs().max()), 1e-30)
    out = dict(steps=steps, rel_dx=rel_dx, rel_dv=rel_dv,
               damage_differs=int((df_ != dw_).sum()),
               damage_gap=float((df_ - dw_).abs().max()) / max(float(dw_.abs().max()), 1e-30),
               trigger_differs=int(((sf > 0) != (sw > 0)).sum()),
               soft_damage_differs=int(((df_ - dw_).abs() > SOFT_DAMAGE_TOL).sum()),
               strain_f_gap=float(torch.where(both, (sf - sw).abs(), 0 * sf).max()) / s_scale,
               damaged_fused=int((df_ > 0).sum()), damaged_windowed=int((dw_ > 0).sum()),
               triggered_fused=int((sf > 0).sum()), triggered_windowed=int((sw > 0).sum()),
               **extra)
    ok = rel_dx < lim["dx"] and rel_dv < lim["dv"]
    if damage == "eigenerosion":
        ok = ok and out["damage_differs"] <= lim["decisions"]
    else:
        ok = (ok and out["trigger_differs"] <= lim["decisions"]
              and out["soft_damage_differs"] <= lim["decisions"]
              and out["strain_f_gap"] <= lim["strain_f"])
    out["ok"] = ok
    if not ok:
        raise PhaseError(f"{label}: parity {out}, limits {lim}")
    return out


def _check_fracture_state(label, p, shares, damage):
    act = p.active
    for name in ("stress", "damage", "strain_f", "J"):
        if not bool(torch.isfinite(getattr(p, name)[act]).all()):
            raise PhaseError(f"{label}: non-finite {name}")
    lo, hi = FRACTURE_BAND_SHARE
    if not (lo <= shares["band_share"] <= hi and shares["band_share"] > 0):
        raise PhaseError(f"{label}: {damage} touched {shares['band_share']} of the band, "
                         f"outside {FRACTURE_BAND_SHARE}: {shares}")
    if shares["far_particles"] == 0 or shares["far_touched"] != 0:
        raise PhaseError(f"{label}: far field touched: {shares}")


def phase_fracture(device, dim, roofline=False):
    """Eigenerosion, then eigensoftening, on the main path's problem with the
    stretched band, fused at a re-bin every step: warm-up, timed steps with
    the launch counts from 0 (2 scatters + 2 gathers a step), the band's
    share and the far field, the Beps sums' cost and their float64 check,
    the re-bin's share, and parity against the windowed engine.  With
    ``roofline``, in 2D, the four calls at margin 0 on the eroding state
    (rows ``…@fracture``: the 2D main path runs margin 1; in 3D the main
    path's rows are these calls).  Returns the rows."""
    from nlpartsol_tpu_torch.formulations.explicit import run, to_slot_layout
    from nlpartsol_tpu_torch.ops import windowed

    spec = FRACTURE[dim]
    label = "fracture" + _suffix(dim)
    steps = spec["steps"]
    rows, kernel_rows = {}, []
    for damage in ("eigenerosion", "eigensoftening"):
        grid, p, mats, cfg, h = build_fracture(dim, spec["n_side"], device, damage)
        p0 = to_slot_layout(p, grid, cfg.active_box)
        p1, _ = run(p0, grid, mats, cfg, spec["warm"])
        p2, diag, seconds, counts = _timed_run(p1, grid, mats, cfg, steps)
        _check_state(f"{label}:{damage}", p2, diag)
        want = {f"lme_scatter{dim}d:solve": steps, f"lme_scatter{dim}d:G": steps,
                f"lme_gather{dim}d:N+grad": steps, f"lme_gather{dim}d:N": steps}
        if counts != want:
            raise PhaseError(f"{label}:{damage}: launch counts {counts}, expected {want}")
        shares = _fracture_shares(p2, h, damage)
        _check_fracture_state(f"{label}:{damage}", p2, shares, damage)
        if roofline and dim == 2 and damage == "eigenerosion":
            _roofline_rows(grid, p2, cfg, counts, 0, kernel_rows, path_tag="@fracture")
        ms = 1e3 * seconds / steps
        rebin_ms = cuda_ms(lambda: windowed.local_rebin(p2, grid, cfg.active_box), 5)
        rows[damage] = dict(
            ms_per_step=ms, lost=0, launches=counts, **shares,
            **_beps_costs(p2, grid, mats, cfg, label),
            rebin_ms=rebin_ms, rebin_share=rebin_ms / ms,
            beps_check=_beps_check(p2, grid, mats, cfg, f"{label}:{damage}"),
            parity=_fracture_parity(p0, grid, mats, cfg, h, spec["parity_steps"],
                                    f"{label}_parity:{damage}"))
        del p0, p1, p2
        torch.cuda.empty_cache()
    say(phase=label, grid="x".join(map(str, grid.dims)), particles=p.count,
        slots=cfg.active_box.n_slots, band=FRACTURE_BAND, material=FRACTURE_MATERIAL,
        beps_reach=cfg.beps_reach, warmup_steps=spec["warm"], steps=steps,
        band_share_range=FRACTURE_BAND_SHARE, parity_limits=FRACTURE_PARITY, drivers=rows,
        ok=True)
    return kernel_rows


def build_fracture_implicit(n_side, device):
    """The implicit problem with the stretched band (no pull) and
    eigenerosion, at dt = FRACTURE_IMPLICIT["cfl"]·h/c: the band holds its
    full stress through the first step (the update is staggered), and at
    the implicit problem's 2h/c its recoil would carry the band's edges
    past the one cell a local re-bin takes in a step."""
    from nlpartsol_tpu_torch.models import fracture

    grid, p, _, cfg, h = build_implicit(2, device, n_side)
    cfg = cfg.replace(dt=FRACTURE_IMPLICIT["cfl"] * h / np.sqrt(1e7 / 1000.0),
                      damage="eigenerosion",
                      beps_reach=fracture.beps_reach(FRACTURE_MATERIAL["Ceps"]))
    return grid, _stretch_band(p, h, pull=False), _fracture_table(device), cfg, h


def phase_fracture_implicit(device):
    """Eigenerosion on the implicit 256² problem with the stretched band (no
    pull), fused: the staggered update at each converged state; launches
    held to the implicit step's formula (fracture adds none); parity at
    128² against the windowed engine with equal Newton counts."""
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
    from nlpartsol_tpu_torch.models import fracture
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    spec = FRACTURE_IMPLICIT
    label = "fracture_implicit"

    def build(n_side):
        grid, p, mats, cfg, h = build_fracture_implicit(n_side, device)
        return grid, to_slot_layout(p, grid, cfg.active_box), mats, cfg, h

    grid, p0, mats, cfg, h = build(spec["n_side"])
    n_particles = int(p0.active.sum())
    p1, hist0 = _implicit_steps(label, p0, grid, mats, cfg, spec["warm"])
    fired = _fracture_shares(p1, h, "eigenerosion")
    if fired["eroded"] == 0:
        raise PhaseError(f"{label}: the staggered update did not fire: {fired}")
    ft.reset_launch_counts()
    times = []
    p2, hist = _implicit_steps(label, p1, grid, mats, cfg, spec["steps"], times)
    counts = dict(ft.launch_counts)
    steps = spec["steps"]
    n_tot, l_tot = sum(x[0] for x in hist), sum(x[1] for x in hist)
    want = {"lme_scatter2d:solve+gnorm": steps, "lme_gather2d:grad": 3 * steps + 7 * n_tot +
            2 * l_tot, "lme_scatter2d:G": steps + 7 * n_tot + 2 * l_tot, "lme_gather2d:N": steps}
    if counts != want:
        raise PhaseError(f"{label}: launch counts {counts}, expected {want}")
    shares = _fracture_shares(p2, h, "eigenerosion")
    _check_fracture_state(label, p2, shares, "eigenerosion")
    del p0, p1, p2
    torch.cuda.empty_cache()
    # parity at 128²: both engines from the same state, equal Newton counts
    gq, q0, mq, cq, hq = build(spec["parity_n_side"])
    qf, hf = _implicit_steps(label + ":fused", q0, gq, mq, cq, spec["parity_steps"])
    qw, hw = _implicit_steps(label + ":windowed", q0, gq, mq, cq.replace(transfer="windowed"),
                             spec["parity_steps"])
    parity = _damage_parity(qf, qw, hq, label + "_parity", "eigenerosion",
                            spec["parity_steps"], newton_fused=[x[0] for x in hf],
                            newton_windowed=[x[0] for x in hw])
    if parity["newton_fused"] != parity["newton_windowed"]:
        raise PhaseError(f"{label}: Newton counts differ {parity}")
    say(phase=label, grid="x".join(map(str, grid.dims)), particles=n_particles,
        slots=cfg.active_box.n_slots, dt=cfg.dt,
        warmup_steps=spec["warm"], steps=steps, ms_per_step=float(np.mean(times)),
        step_ms=times, newton_iters=[x[0] for x in hist], cg_iters=[x[1] for x in hist],
        warmup_newton=[x[0] for x in hist0], eroded_after_first_step=fired["eroded"],
        converged=True, lost=0, launches=counts, launches_expected=want, **shares,
        parity_n_side=spec["parity_n_side"], parity=parity, ok=True)


# uGIMP and aLME on the explicit step: the main path's problem on the
# windowed engine (their driver route: the kernels compute LME only), a
# re-bin every step; aLME at the JAX test's parameters
# (tests/test_gimp_alme.py:93), β from β₀; parity at 128² against the
# scatter engine on the card
SHAPEFUNS = dict(n_side=512, warm=2, steps=8, parity_n_side=128, parity_steps=4)
ALME_PARAMS = dict(gamma=3.0, max_stretch=1.2)


def build_shapefun(n_side, device, shapefun, transfer="windowed"):
    from nlpartsol_tpu_torch.shapefun import alme

    grid, p, mats, cfg, h = build_problem(2, n_side, device)
    kw = dict(transfer=transfer, shapefun=shapefun, rebin_every=1)
    if shapefun == "alme":
        kw["alme_params"] = alme.ALMEParams(**ALME_PARAMS)
        p = p.replace(lme_beta=alme.init_lme_beta(p.count, kw["alme_params"], h, 2,
                                                  device=device))
    return grid, p, mats, cfg.replace(**kw), h


def phase_shapefuns(device):
    """uGIMP and aLME at the main path's width on the windowed engine:
    warm-up, timed steps (no kernel launch), lost 0, finite fields, aLME's β
    pulled back; parity at 128² against the scatter engine, by pid."""
    from nlpartsol_tpu_torch.formulations.explicit import run, to_slot_layout
    from nlpartsol_tpu_torch.shapefun import alme, gimp

    spec = SHAPEFUNS
    rows = {}
    for shapefun in ("gimp", "alme"):
        label = f"shapefuns:{shapefun}"
        grid, p, mats, cfg, h = build_shapefun(spec["n_side"], device, shapefun)
        if shapefun == "gimp":
            gimp.check_halfwidth(gimp.voxel_halfwidth(p.vol0, 2), h)
        p0 = to_slot_layout(p, grid, cfg.active_box)
        p1, _ = run(p0, grid, mats, cfg, spec["warm"])
        torch.cuda.reset_peak_memory_stats()
        p2, diag, seconds, counts = _timed_run(p1, grid, mats, cfg, spec["steps"])
        _check_state(label, p2, diag)
        if any(counts.values()):
            raise PhaseError(f"{label}: the windowed engine launched kernels {counts}")
        total_nnz = int(diag["nnz"].long().sum())
        row = dict(ms_per_step=1e3 * seconds / spec["steps"],
                   nnz_per_step=total_nnz / spec["steps"], lost=0, finite=True,
                   offsets=int((gimp.offsets_for(2) if shapefun == "gimp" else
                                alme.offsets_for(2, cfg.alme_params)).shape[0]),
                   peak_device_bytes=torch.cuda.max_memory_allocated())
        if shapefun == "alme":
            beta = p2.lme_beta[p2.active]
            b0 = torch.as_tensor(alme.beta0(cfg.alme_params, h, 2), device=device)
            moved = float((beta - b0).abs().max() / b0.abs().max())
            if not (bool(torch.isfinite(beta).all()) and moved > 0):
                raise PhaseError(f"{label}: β not pulled back ({moved})")
            row["beta_pulled_back_max_rel"] = moved
        del p0, p1, p2
        torch.cuda.empty_cache()
        g, q, m, c, hq = build_shapefun(spec["parity_n_side"], device, shapefun)
        qw, dw = run(q, g, m, c, spec["parity_steps"])
        qs, ds = run(q, g, m, c.replace(transfer="scatter"), spec["parity_steps"])
        _check_state(label + ":windowed", qw, dw)
        _check_state(label + ":scatter", qs, ds)
        rel_dx, rel_dv, (bs, bw) = _parity(qs, qw, hq, label, ("x", "v", "lme_beta"))
        beta_gap = (float((bs - bw).abs().max() / bw.abs().max()) if shapefun == "alme"
                    else 0.0)
        ok = rel_dx < 1e-3 and rel_dv < 1e-2 and beta_gap < 1e-3
        row["parity"] = dict(n_side=spec["parity_n_side"], steps=spec["parity_steps"],
                             rel_dx=rel_dx, rel_dv=rel_dv, beta_gap=beta_gap,
                             nnz_windowed=int(dw["nnz"][-1]), nnz_scatter=int(ds["nnz"][-1]),
                             ok=ok)
        if not ok:
            raise PhaseError(f"{label}: parity against the scatter engine {row['parity']}")
        rows[shapefun] = row
    say(phase="shapefuns", grid=f"{spec['n_side']}x{spec['n_side']}", particles=p.count,
        warmup_steps=spec["warm"], steps=spec["steps"], alme_params=ALME_PARAMS,
        shapefuns=rows, ok=True)


# the scatter engine (ops/transfer.py::ScatterEngine, index_add over the
# particles' own order, no slot layout) on every step it now takes, at 128²
# against the windowed engine on the card, by pid
SCATTER = dict(n_side=128, steps=1, upw_implicit_steps=1, traction_steps=8)  # steps 2 → 1


def _engine_pair(label, h, fn, names=("x", "v"), newton=False):
    """``fn(transfer)`` → (particles, lost, Newton counts) on the windowed and
    the scatter engine; rel_dx, rel_dv (and equal Newton counts) by pid."""
    pw, lost_w, nw = fn("windowed")
    ps, lost_s, ns = fn("scatter")
    for eng, pp, lost in (("windowed", pw, lost_w), ("scatter", ps, lost_s)):
        _check_state(f"{label}:{eng}", pp, dict(lost=torch.as_tensor(lost)))
    rel_dx, rel_dv = _parity(ps, pw, h, label)[:2]
    ok = rel_dx < 1e-3 and rel_dv < 1e-2 and (not newton or nw == ns)
    row = dict(rel_dx=rel_dx, rel_dv=rel_dv, ok=ok)
    if newton:
        row.update(newton_windowed=nw, newton_scatter=ns)
    if not ok:
        raise PhaseError(f"scatter {label}: {row}")
    return row


def _traction_deck(directory, steps):
    """A free 8×6-cell body on a 16² background, pulled at its right column
    of particles by a constant traction (test_io.py's traction case)."""
    import os

    from nlpartsol_tpu_torch.io.builder import build_simulation

    cells, h = 16, 1.0 / 16
    neumann = ("Define-Neumann-Boundary (File=load_ids.txt) {\n"
               "    BcNeumann T.x pull.txt\n}\n")
    path = write_deck(directory, (cells, cells), h, (8, 6), (4 * h, 4 * h), steps=steps,
                      extra=neumann)
    with open(os.path.join(directory, "pull.txt"), "w") as fh:
        fh.write("CONSTANT_CURVE SCALE#1e5\n")
    with open(os.path.join(directory, "load_ids.txt"), "w") as fh:
        fh.write("0\n")
    x0 = build_simulation(path, device="cpu").particles.x.numpy()
    right = np.where(x0[:, 0] > x0[:, 0].max() - 0.25 * h)[0]
    with open(os.path.join(directory, "load_ids.txt"), "w") as fh:
        fh.write("\n".join(map(str, right)) + "\n")
    return path, x0, h


def phase_scatter(device):
    """Each route the scatter engine opened — the explicit, implicit, u-pw
    explicit and implicit, Forward-Euler and Generalized-α steps — at 128²
    against the windowed engine on the card, by pid; and the traction deck
    through ``run_simulation`` with the particles stored shuffled (the
    tables follow pid)."""
    import os
    import tempfile

    from nlpartsol_tpu_torch.driver import run_simulation
    from nlpartsol_tpu_torch.formulations import integrators, upw
    from nlpartsol_tpu_torch.formulations.explicit import run
    from nlpartsol_tpu_torch.io.builder import build_simulation
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    n, steps = SCATTER["n_side"], SCATTER["steps"]
    rows = {}
    t0 = time.perf_counter()
    ft.reset_launch_counts()

    grid, p, mats, cfg, h = build_problem(2, n, device)
    cfg = cfg.replace(transfer="windowed", rebin_every=1)

    def explicit(t):
        q, dg = run(p, grid, mats, cfg.replace(transfer=t), steps)
        return q, dg["lost"].sum(), None

    rows["explicit"] = _engine_pair("explicit", h, explicit)

    def integrator(scheme):
        def go(t):
            c = cfg.replace(transfer=t, scheme=scheme)
            body = torch.zeros(2, dtype=p.x.dtype, device=device)
            q, lost = p, 0
            for _ in range(steps):
                if scheme == "FE":
                    q, dg = integrators.forward_euler_step(q, grid, mats, c, body)
                else:
                    q, dg = integrators.generalized_alpha_step(q, grid, mats, c, body, c.ga_rb)
                lost += int(dg["lost"])
            return q, lost, None
        return go

    rows["forward_euler"] = _engine_pair("forward_euler", h, integrator("FE"))
    rows["generalized_alpha"] = _engine_pair("generalized_alpha", h,
                                             integrator("Generalized-alpha"))

    gi, pi, mi, ci, hi = build_implicit(2, device, n)

    def implicit(t):
        q, hist = _implicit_steps(f"scatter:implicit:{t}", pi, gi, mi, ci.replace(transfer=t),
                                  steps)
        return q, 0, [x[0] for x in hist]

    rows["implicit"] = _engine_pair("implicit", hi, implicit, newton=True)

    for implicit_upw in (False, True):
        gu, pu, mu, mix, cu, hu = build_upw(device, implicit_upw, n)
        body = _upw_body(pu)

        def mixture(t):
            c = cu.replace(transfer=t)
            if not implicit_upw:
                q, dg = upw.run(pu, gu, mu, mix, c, steps, body)
                return q, dg["lost"].sum(), None
            q, newton = pu, []
            for _ in range(SCATTER["upw_implicit_steps"]):
                q, dg = upw.upw_newmark_step(q, gu, mu, mix, c, body)
                newton.append(int(dg["newton_iters"]))
            return q, dg["lost"], newton

        name = "upw_implicit" if implicit_upw else "upw_explicit"
        rows[name] = _engine_pair(name, hu, mixture, newton=implicit_upw)
    if any(ft.launch_counts.values()):
        raise PhaseError(f"scatter: kernels launched on the plain engines {ft.launch_counts}")

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        path, x0, hd = _traction_deck(os.path.join(tmp, "traction"), SCATTER["traction_steps"])
        os.chdir(os.path.dirname(path))
        try:
            perm = torch.as_tensor(np.random.default_rng(3).permutation(len(x0)), device=device)

            def deck(t):
                setup = build_simulation("sim.nlp", device=device)
                if not setup.neumann:
                    raise PhaseError("scatter: the traction deck lost its Neumann block")
                setup.particles = setup.particles.map_tensors(lambda a: a[perm])
                q, _ = run_simulation(setup, transfer=t, write_outputs=False, progress=False)
                return q, 0, None

            rows["traction"] = _engine_pair("traction", hd, deck)
            qs = deck("scatter")[0]
            stretch = float(qs.x[:, 0].max()) - float(x0[:, 0].max())
        finally:
            os.chdir(cwd)
    if not stretch > 1e-6:
        raise PhaseError(f"scatter: the traction did not move the body ({stretch})")
    rows["traction"]["stretch"] = stretch
    say(phase="scatter", grid=f"{n}x{n}", steps=steps,
        upw_implicit_steps=SCATTER["upw_implicit_steps"],
        traction_steps=SCATTER["traction_steps"], routes=rows,
        seconds=time.perf_counter() - t0, ok=True)


# ---------------------------------------------------------------------------
# unstructured background meshes (shapefun/femesh.py) on the scatter engine
# ---------------------------------------------------------------------------

# scripts/bench_femesh.py's problem: a 192² perturbed T3 mesh (0.2·h, seed
# 0), 3 particles a triangle, Neo-Hookean E 1e7, ν 0.3, ρ 1000, v = 0.01·N(0,1),
# LME γ=3, dt = 0.25·(smallest edge)/c; then the same mesh with FEM
FEMESH = dict(nx=192, perturb=0.2, seed=0, warm=2, steps=10)
# the port's own 3D case (the JAX package has no 3D unstructured benchmark):
# a perturbed H8 mesh of 32³ elements (0.2·h, seed 0), 2×2×2 Gauss-point
# particles, FEM and LME; then its split into 6 tets a hex, one particle a
# tet, FEM
FEMESH3D = dict(n=32, perturb=0.2, seed=0, warm=1, steps=4)
# Q4 on the scatter phase's unperturbed 128² node grid against the
# structured grid on the windowed engine (same particles), and the T3 bar
FEMESH_PARITY = dict(n_side=128, steps=8, bar_error=0.12, implicit_steps=3)
FEMESH_SCATTER_STEPS = 1  # 2 before the time limit pressed
_KUHN = [[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]]


def femesh_mesh2d(nx, perturb, seed):
    """scripts/bench_femesh.py's mesh: the unit square's (nx+1)² nodes, the
    interior ones moved by up to perturb·h, two triangles a cell with
    alternating diagonals.  Returns (coords, triangles, the generator)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 1.0, nx + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], -1)
    interior = ((coords > 1e-9) & (coords < 1.0 - 1e-9)).all(-1)
    coords[interior] += rng.uniform(-perturb, perturb, coords[interior].shape) / nx
    ids = np.arange((nx + 1) ** 2).reshape(nx + 1, nx + 1)
    i, j = np.meshgrid(np.arange(nx), np.arange(nx), indexing="ij")
    a, b, c, d = ids[i, j], ids[i + 1, j], ids[i + 1, j + 1], ids[i, j + 1]
    even = ((i + j) % 2 == 0)[..., None]
    first = np.where(even, np.stack([a, b, c], -1), np.stack([a, b, d], -1))
    second = np.where(even, np.stack([a, c, d], -1), np.stack([b, c, d], -1))
    tris = np.stack([first, second], 2).reshape(-1, 3)  # bench_femesh.py's order
    return coords, tris, rng


def femesh_mesh3d(n, perturb, seed):
    """A perturbed H8 mesh of the unit cube, n³ elements (GiD corner order),
    and its generator."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 1.0, n + 1)
    coords = np.stack([g.ravel() for g in np.meshgrid(xs, xs, xs, indexing="ij")], -1)
    interior = ((coords > 1e-9) & (coords < 1.0 - 1e-9)).all(-1)
    coords[interior] += rng.uniform(-perturb, perturb, coords[interior].shape) / n
    ids = np.arange((n + 1) ** 3).reshape((n + 1,) * 3)
    i, j, k = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    hexes = np.stack([ids[i + a, j + b, k + c] for c in (0, 1)
                      for (a, b) in ((0, 0), (1, 0), (1, 1), (0, 1))], -1).reshape(-1, 8)
    return coords, hexes, rng


def _simplex_particles(coords, conn):
    """One particle a simplex at its centroid, V the simplex's volume."""
    xe = coords[conn]
    edges = xe[:, 1:] - xe[:, :1]
    vol = np.abs(np.linalg.det(edges)) / (2.0 if coords.shape[1] == 2 else 6.0)
    return xe.mean(axis=1), vol


def _gauss_particles_h8(coords, hexes):
    """2×2×2 Gauss points of each hexahedron and their volumes det J·1."""
    from nlpartsol_tpu_torch.shapefun import femesh

    g = 1.0 / np.sqrt(3.0)
    xi = torch.as_tensor(np.stack(np.meshgrid(*[[-g, g]] * 3, indexing="ij"), -1)
                         .reshape(-1, 3), dtype=torch.float64)
    N, dN = femesh.shape_ref("H8", xi)
    xe = torch.as_tensor(coords[hexes], dtype=torch.float64)
    x = torch.einsum("ga,eai->egi", N, xe).reshape(-1, 3)
    J = torch.einsum("eai,gaj->egij", xe, dN)
    return x.numpy(), torch.linalg.det(J).reshape(-1).numpy()


def _femesh_particles(x, vol, rng, device):
    from nlpartsol_tpu_torch.models import materials as M
    from nlpartsol_tpu_torch.types import make_particles

    rho = 1000.0
    p = make_particles(x.astype(np.float32), mass=(rho * vol).astype(np.float32),
                       vol0=vol.astype(np.float32), device=device,
                       v=(0.01 * rng.standard_normal(x.shape)).astype(np.float32))
    mats = M.material_table([M.material(kind="Neo-Hookean-Wriggers", E=1e7, nu=0.3, rho0=rho)],
                            device=device)
    return p, mats


def _femesh_config(mesh, shapefun):
    from nlpartsol_tpu_torch.formulations.courant import courant_dt
    from nlpartsol_tpu_torch.formulations.explicit import ExplicitConfig
    from nlpartsol_tpu_torch.models import materials as M
    from nlpartsol_tpu_torch.shapefun import lme

    return ExplicitConfig(dt=courant_dt(0.25, mesh.spacing, float(np.sqrt(1e7 / 1000.0))),
                          shapefun=shapefun, lme_params=lme.LMEParams(gamma=3.0),
                          kinds=(M.NEO_HOOKEAN,), transfer="scatter")


def _femesh_route(label, mesh, p, mats, cfg, warm, steps):
    """``warm`` + ``steps`` explicit steps on the mesh through ``run`` (the
    scatter engine): ms a step, nnz, lost 0, finite; the pattern's K, the
    peak device memory, and where a step's time goes (the shape functions
    — locate or the LME candidates and λ-Newton — and one P2G and G2P of a
    d-vector over the pattern, CUDA events)."""
    from nlpartsol_tpu_torch.formulations.common import make_engine, shapefun_eval
    from nlpartsol_tpu_torch.formulations.explicit import run
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft.reset_launch_counts()
    q, d0 = run(p, mesh, mats, cfg, warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q, dg = run(q, mesh, mats, cfg, steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated()
    if any(ft.launch_counts.values()):
        raise PhaseError(f"{label}: kernels launched on the scatter engine {ft.launch_counts}")
    lost = int(d0["lost"].sum()) + int(dg["lost"].sum())
    act = q.active
    finite = all(bool(torch.isfinite(getattr(q, f)[act]).all()) for f in ("x", "v", "F", "stress"))
    if lost or not finite:
        raise PhaseError(f"{label}: lost {lost}, finite {finite}")
    nnz = int(dg["nnz"].to(torch.int64).sum()) // steps
    sf, _ = shapefun_eval(cfg, mesh, q)
    K = int(sf["node_ids"].shape[1])
    mask = sf["mask"] & q.active[:, None]
    eng = make_engine(cfg, mesh, sf, None, mask)
    vec = sf["dN"]
    field = torch.zeros((mesh.n_nodes, p.dim), dtype=vec.dtype, device=vec.device)
    where = dict(shape_functions_ms=cuda_ms(lambda: shapefun_eval(cfg, mesh, q), 3),
                 p2g_vector_ms=cuda_ms(lambda: eng.p2g(vec), 3),
                 g2p_vector_ms=cuda_ms(lambda: eng.g2p(sf["N"], field), 3))
    del sf, mask, eng, vec
    return dict(ms_per_step=ms, nnz_per_step=nnz, nnz_per_s=nnz / (ms * 1e-3), K=K,
                particles=int(p.count), peak_device_gib=peak / 2**30, lost=lost, **where)


def _mesh_summary(mesh, build_s):
    return dict(kind=mesh.kind, nodes=mesh.n_nodes, elements=mesh.n_elems,
                Emax=int(mesh.bin_elems.shape[1]), bins=list(mesh.bin_dims),
                spacing=mesh.spacing, h_avg=mesh.h_avg, host_build_s=build_s)


def _with_node_bins(mesh, cfg):
    from nlpartsol_tpu_torch.shapefun import femesh, lme

    t0 = time.perf_counter()
    mesh = femesh.with_node_bins(mesh, lme.support_radius(cfg.lme_params, mesh.h_avg))
    return mesh, time.perf_counter() - t0


def phase_femesh(device):
    """scripts/bench_femesh.py's problem on the card: meshfree LME over the
    node cloud of the 192² perturbed T3 mesh, then FEM T3 on the same mesh."""
    from nlpartsol_tpu_torch.shapefun import femesh

    spec = FEMESH
    t0 = time.perf_counter()
    coords, tris, rng = femesh_mesh2d(spec["nx"], spec["perturb"], spec["seed"])
    tb = time.perf_counter()
    mesh = femesh.build_femesh(coords, tris, "T3", device=device)
    build_s = time.perf_counter() - tb
    xe = coords[tris]
    bary = np.array([[0.5, 0.25, 0.25], [0.25, 0.5, 0.25], [0.25, 0.25, 0.5]])
    x = np.einsum("ba,eai->ebi", bary, xe).reshape(-1, 2)
    vol = np.repeat(_simplex_particles(coords, tris)[1] / 3.0, 3)
    p, mats = _femesh_particles(x, vol, rng, device)
    routes = {}
    cfg = _femesh_config(mesh, "lme")
    lme_mesh, bins_s = _with_node_bins(mesh, cfg)
    routes["lme"] = _femesh_route("femesh:lme", lme_mesh, p, mats, cfg, spec["warm"],
                                  spec["steps"])
    routes["lme"].update(Bmax=int(lme_mesh.nbin_nodes.shape[1]), node_bins_s=bins_s,
                         K_candidates=9 * int(lme_mesh.nbin_nodes.shape[1]))
    del lme_mesh
    routes["fem"] = _femesh_route("femesh:fem", mesh, p, mats, _femesh_config(mesh, "fem"),
                                  spec["warm"], spec["steps"])
    say(phase="femesh", mesh=_mesh_summary(mesh, build_s), particles=int(p.count),
        warm=spec["warm"], steps=spec["steps"], routes=routes,
        seconds=time.perf_counter() - t0, ok=True)


def _lme_candidate_bytes(mesh, n_particles):
    """Edges and bytes of the (Np, K) LME candidate arrays: rel (d float32),
    the int32 ids and their int64 widening, the mask."""
    K = 3 ** mesh.dim * int(mesh.nbin_nodes.shape[1])
    edges = n_particles * K
    return dict(K=K, edges=edges, rel_bytes=edges * mesh.dim * 4, ids_bytes=edges * 4,
                ids_int64_bytes=edges * 8, mask_bytes=edges)


def phase_femesh3d(device):
    """The port's 3D unstructured case: FEM H8 and meshfree LME on the
    perturbed 32³ H8 mesh (262,144 Gauss-point particles), then FEM T4 on its
    6-tets-a-hex split (196,608 particles)."""
    from nlpartsol_tpu_torch.shapefun import femesh

    spec = FEMESH3D
    t0 = time.perf_counter()
    coords, hexes, rng = femesh_mesh3d(spec["n"], spec["perturb"], spec["seed"])
    tb = time.perf_counter()
    h8 = femesh.build_femesh(coords, hexes, "H8", device=device)
    h8_build_s = time.perf_counter() - tb
    x, vol = _gauss_particles_h8(coords, hexes)
    p, mats = _femesh_particles(x, vol, rng, device)
    routes = {}
    routes["fem_h8"] = _femesh_route("femesh3d:fem_h8", h8, p, mats, _femesh_config(h8, "fem"),
                                     spec["warm"], spec["steps"])
    cfg = _femesh_config(h8, "lme")
    lme_mesh, bins_s = _with_node_bins(h8, cfg)
    need = _lme_candidate_bytes(lme_mesh, p.count)
    say(phase="femesh3d:lme_candidates", **need,
        device_total_bytes=torch.cuda.get_device_properties(0).total_memory)
    routes["lme_h8"] = _femesh_route("femesh3d:lme_h8", lme_mesh, p, mats, cfg, spec["warm"],
                                     spec["steps"])
    routes["lme_h8"].update(Bmax=int(lme_mesh.nbin_nodes.shape[1]), node_bins_s=bins_s,
                            candidate_bytes=need)
    del lme_mesh, p
    torch.cuda.empty_cache()
    tets = np.concatenate([hexes[:, t] for t in _KUHN])
    tb = time.perf_counter()
    t4 = femesh.build_femesh(coords, tets, "T4", device=device)
    t4_build_s = time.perf_counter() - tb
    xt, volt = _simplex_particles(coords, tets)
    pt, mats = _femesh_particles(xt, volt, rng, device)
    routes["fem_t4"] = _femesh_route("femesh3d:fem_t4", t4, pt, mats, _femesh_config(t4, "fem"),
                                     spec["warm"], spec["steps"])
    say(phase="femesh3d", meshes=dict(h8=_mesh_summary(h8, h8_build_s),
                                      t4=_mesh_summary(t4, t4_build_s)),
        warm=spec["warm"], steps=spec["steps"], routes=routes,
        seconds=time.perf_counter() - t0, ok=True)


def tri_bar(nx=24, ny=3, L=1.0, H=0.15, perturb=0.2, seed=0):
    """tests/test_femesh.py's bar: a perturbed T3 mesh of nx×ny cells with
    alternating diagonals.  Returns (coords, triangles, node ids)."""
    rng = np.random.default_rng(seed)
    X, Y = np.meshgrid(np.linspace(0, L, nx + 1), np.linspace(0, H, ny + 1), indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], -1)
    interior = ((coords[:, 0] > 1e-9) & (coords[:, 0] < L - 1e-9) & (coords[:, 1] > 1e-9)
                & (coords[:, 1] < H - 1e-9))
    coords[interior] += rng.uniform(-perturb, perturb, coords[interior].shape) * [L / nx, H / ny]
    ids = np.arange((nx + 1) * (ny + 1)).reshape(nx + 1, ny + 1)
    tris = []
    for i in range(nx):
        for j in range(ny):
            a, b, c, d = ids[i, j], ids[i + 1, j], ids[i + 1, j + 1], ids[i, j + 1]
            tris += [[a, b, c], [a, c, d]] if (i + j) % 2 == 0 else [[a, b, d], [b, c, d]]
    return coords, np.asarray(tris), ids


BAR_C = float(np.sqrt(1e7 / 1000.0))


def build_tri_bar(device, shapefun="fem", V=0.01):
    """tests/test_femesh.py's unstructured bar problem (ends held in x, y
    held everywhere, 3 particles a triangle, Neo-Hookean E 1e7, ν 0, ρ 1000)
    at v = V·sin(πx): (mesh, particles, materials, positions)."""
    from nlpartsol_tpu_torch.models import materials as M
    from nlpartsol_tpu_torch.shapefun import femesh, lme
    from nlpartsol_tpu_torch.types import make_particles

    coords, tris, ids = tri_bar()
    dmask = np.zeros((len(coords), 2), bool)
    dmask[ids[0, :], 0] = True
    dmask[ids[-1, :], 0] = True
    dmask[:, 1] = True
    mesh = femesh.build_femesh(coords, tris, "T3", dirichlet_mask=dmask, device=device)
    if shapefun == "lme":
        mesh = femesh.with_node_bins(
            mesh, lme.support_radius(lme.LMEParams(gamma=3.0), mesh.h_avg))
    xe = coords[tris]
    bary = np.array([[0.5, 0.25, 0.25], [0.25, 0.5, 0.25], [0.25, 0.25, 0.5]])
    x = np.einsum("ba,eai->ebi", bary, xe).reshape(-1, 2)
    vol = np.repeat(_simplex_particles(coords, tris)[1] / 3.0, 3)
    v = np.stack([V * np.sin(np.pi * x[:, 0]), np.zeros(len(x))], -1)
    p = make_particles(x.astype(np.float32), mass=(1000.0 * vol).astype(np.float32),
                       vol0=vol.astype(np.float32), v=v.astype(np.float32), device=device)
    mats = M.material_table([M.material(kind="Neo-Hookean-Wriggers", E=1e7, nu=0.0,
                                        rho0=1000.0)], device=device)
    return mesh, p, mats, x


def _bar_quarter_period(device, shapefun):
    """test_femesh.py's oracle: the bar to a quarter period at courant 0.2,
    the displacement error over the amplitude."""
    from nlpartsol_tpu_torch.formulations.courant import courant_dt
    from nlpartsol_tpu_torch.formulations.explicit import run

    mesh, p, mats, x = build_tri_bar(device, shapefun)
    cfg = _femesh_config(mesh, shapefun).replace(dt=courant_dt(0.2, mesh.spacing, BAR_C),
                                                 kinds=(3,))
    omega = np.pi * BAR_C
    n = int(round((np.pi / 2 / omega) / cfg.dt))
    q, dg = run(p, mesh, mats, cfg, n)
    _check_state(f"femesh_parity:bar_{shapefun}", q, dg)
    u_ref = (0.01 / omega) * np.sin(np.pi * x[:, 0])
    err = float(np.abs(q.dis[:, 0].cpu().numpy() - u_ref).max() / (0.01 / omega))
    return dict(steps=n, error=err, ok=err < FEMESH_PARITY["bar_error"])


def _bar_implicit(device):
    """test_femesh.py:224: three Newmark-β steps of the bar at courant 1,
    FEM, every one converged, nothing lost."""
    from nlpartsol_tpu_torch.formulations.courant import courant_dt
    from nlpartsol_tpu_torch.formulations.implicit import ImplicitConfig, implicit_step

    mesh, p, mats, _ = build_tri_bar(device)
    cfg = ImplicitConfig(dt=courant_dt(1.0, mesh.spacing, BAR_C), shapefun="fem", kinds=(3,),
                         transfer="scatter", newton_tol=1e-6, newton_maxiter=20)
    body = torch.zeros(2, device=device)
    newton, ok = [], True
    for _ in range(FEMESH_PARITY["implicit_steps"]):
        p, dg = implicit_step(p, mesh, mats, cfg, body)
        newton.append(int(dg["newton_iters"]))
        ok = ok and bool(dg["converged"]) and int(dg["lost"]) == 0
    ok = ok and bool(torch.isfinite(p.x).all()) and float(p.dis.abs().max()) < 0.01
    return dict(newton=newton, ok=ok)


def phase_femesh_parity(device):
    """A Q4 FEMesh on the 128² node grid of ``scatter`` against the
    structured grid on the windowed engine, 8 steps from the same particles,
    by pid, FEM and LME (an axis-aligned Q4 is the structured bilinear basis;
    h_avg equals h there, so β and the support radius are the grid's); then
    the T3 bar's quarter-period oracle (FEM, LME) and its implicit steps."""
    from nlpartsol_tpu_torch.formulations.explicit import run
    from nlpartsol_tpu_torch.shapefun import femesh

    spec = FEMESH_PARITY
    t0 = time.perf_counter()
    n = spec["n_side"]
    grid, p, mats, cfg, h = build_problem(2, n, device)
    coords = np.stack([a.ravel() for a in np.meshgrid(*[np.arange(n) * h] * 2, indexing="ij")],
                      -1)
    ids = np.arange(n * n).reshape(n, n)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    quads = np.stack([ids[i, j], ids[i + 1, j], ids[i + 1, j + 1], ids[i, j + 1]],
                     -1).reshape(-1, 4)
    q4 = femesh.build_femesh(coords, quads, "Q4", device=device)
    rows = {}
    for shapefun in ("fem", "lme"):
        c = cfg.replace(shapefun=shapefun, rebin_every=1)
        mesh = _with_node_bins(q4, c)[0] if shapefun == "lme" else q4
        pw, dw = run(p, grid, mats, c.replace(transfer="windowed"), spec["steps"])
        ps, ds = run(p, mesh, mats, c.replace(transfer="scatter", active_box=None),
                     spec["steps"])
        _check_state(f"femesh_parity:{shapefun}:windowed", pw, dw)
        _check_state(f"femesh_parity:{shapefun}:femesh", ps, ds)
        rel_dx, rel_dv = _parity(ps, pw, h, f"femesh_parity:{shapefun}")[:2]
        rows[shapefun] = dict(rel_dx=rel_dx, rel_dv=rel_dv, h_avg_over_h=mesh.h_avg / h,
                              nnz_windowed=int(dw["nnz"][-1]), nnz_femesh=int(ds["nnz"][-1]),
                              ok=rel_dx < 1e-3 and rel_dv < 1e-2)
    for shapefun in ("fem", "lme"):
        rows[f"bar_{shapefun}"] = _bar_quarter_period(device, shapefun)
    rows["bar_implicit"] = _bar_implicit(device)
    ok = all(r["ok"] for r in rows.values())
    say(phase="femesh_parity", grid=f"{n}x{n}", steps=spec["steps"], routes=rows,
        seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise PhaseError(f"femesh_parity: {rows}")


def _bar_mixture(p, mats_device):
    """The bar's particles as a soil-water mixture (scripts/bench_upw.py's
    fluid, K_f 2.2e7): (particles, materials, mixtures)."""
    from nlpartsol_tpu_torch.formulations import upw
    from nlpartsol_tpu_torch.models import materials as M

    mats = M.material_table([M.material(kind="Neo-Hookean-Wriggers", E=1e7, nu=0.3, rho0=2700.0),
                             M.material(kind="Newtonian-Fluid-Compressible", rho0=1000.0,
                                        compressibility=2.2e7)], device=mats_device)
    mix = upw.make_mixture_table([dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4,
                                       permeability=1e-5)], device=mats_device)
    return upw.init_mixture_state(p, mats, mix), mats, mix


def phase_femesh_scatter(device):
    """Every step that takes a FEMesh, on the T3 bar (FEM) through the
    scatter engine on the card: Forward-Euler, Generalized-α, quasi-static,
    u-pw explicit and implicit, u-p and DEM; finite, nothing lost, every
    Newton loop converged (or, for u-pw, ended by its tolerance or stall
    rule)."""
    from nlpartsol_tpu_torch.formulations import dem, integrators, up, upw
    from nlpartsol_tpu_torch.formulations.courant import courant_dt
    from nlpartsol_tpu_torch.formulations.implicit import ImplicitConfig, implicit_step
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    t0 = time.perf_counter()
    ft.reset_launch_counts()
    # the bar at test_dem.py's finite amplitude: at 0.01 the DEM residual
    # sits at the float32 floor and its Newton loop stalls unconverged
    mesh, p0, mats, _ = build_tri_bar(device, V=0.05)
    cfg = _femesh_config(mesh, "fem").replace(dt=courant_dt(0.2, mesh.spacing, BAR_C),
                                              kinds=(3,))
    body = torch.zeros(2, device=device)
    c_mix = float(np.sqrt((2.2e7 / 0.4) / (0.6 * 2700.0 + 0.4 * 1000.0)))
    pm, mm, mix = _bar_mixture(p0, device)
    upw_implicit = upw.UpwImplicitConfig(dt=2.0 * mesh.spacing / c_mix, shapefun="fem",
                                         kinds=(3,), transfer="scatter")
    steps = {
        "forward_euler": lambda q: integrators.forward_euler_step(
            q, mesh, mats, cfg.replace(scheme="FE"), body),
        "generalized_alpha": lambda q: integrators.generalized_alpha_step(
            q, mesh, mats, cfg.replace(scheme="Generalized-alpha"), body, 0.8),
        "quasi_static": lambda q: implicit_step(
            q, mesh, mats, ImplicitConfig(dt=cfg.dt, shapefun="fem", kinds=(3,),
                                          transfer="scatter", quasi_static=True,
                                          newton_tol=1e-6, newton_maxiter=20),
            torch.tensor([-1e3, 0.0], device=device)),
        "upw_explicit": lambda q: upw.upw_step(
            q, mesh, mm, mix, upw.UpwConfig(dt=0.2 * mesh.spacing / c_mix, shapefun="fem",
                                            kinds=(3,), transfer="scatter"), body),
        "upw_implicit": lambda q: upw.upw_newmark_step(q, mesh, mm, mix, upw_implicit, body),
        "up": lambda q: up.up_step(
            q, mesh, mats, up.UpConfig(dt=courant_dt(2.0, mesh.spacing, BAR_C), shapefun="fem",
                                       kinds=(3,), transfer="scatter"), body),
        "dem": lambda q: dem.dem_step(
            q, mesh, mats, dem.DEMConfig(dt=courant_dt(1.0, mesh.spacing, BAR_C),
                                         shapefun="fem", kinds=(3,), transfer="scatter"), body),
    }
    rows = {}
    for name, step in steps.items():
        q = pm if name.startswith("upw") else p0
        ts = time.perf_counter()
        newton, converged, ended, lost = [], True, True, 0
        for _ in range(FEMESH_SCATTER_STEPS):
            q, dg = step(q)
            lost += int(dg["lost"])
            if "newton_iters" in dg:
                newton.append(int(dg["newton_iters"]))
                converged = converged and bool(dg["converged"])
                # u-pw: the loop ends by its tolerance or its stall rule, as
                # in the u-pw phases (``converged`` reported)
                ended = ended and newton[-1] < upw_implicit.newton_maxiter and np.isfinite(
                    float(dg["newton_residual"]))
        act = q.active
        finite = all(bool(torch.isfinite(getattr(q, f)[act]).all())
                     for f in ("x", "v", "F", "stress", "pw"))
        moved = float((q.x - p0.x).abs().max())
        settled = ended if name == "upw_implicit" else converged
        rows[name] = dict(lost=lost, finite=finite, newton=newton, converged=converged,
                          moved=moved, seconds=time.perf_counter() - ts,
                          ok=lost == 0 and finite and settled and moved > 0)
    if any(ft.launch_counts.values()):
        raise PhaseError(f"femesh_scatter: kernels launched {ft.launch_counts}")
    ok = all(r["ok"] for r in rows.values())
    say(phase="femesh_scatter", mesh="T3 bar 24x3", steps=FEMESH_SCATTER_STEPS, routes=rows,
        seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise PhaseError(f"femesh_scatter: {rows}")


# ---------------------------------------------------------------------------
# multi-device: the halo-sharded grid (parallel/domain.py) on torch.distributed
# ---------------------------------------------------------------------------
#
# The ranks are processes of this script (``--sharded-rank``), all on the one
# card: NCCL refuses two ranks on a device, so they join a gloo group and the
# halo planes, migration buffers and all-reduces go through pinned host
# memory (the transport, counted in ``bytes_staged``); all arithmetic stays on
# the card.  The parent computes the single-device references on the card
# and hands every rank its inputs as files; the ranks of the 1-D phases run
# in one launch, the 2×2 ranks of ``sharded2d`` in another.

# bench.py's problem (PROBLEMS[2]): S = 2, k = 16 at margin 1; the 16 parity
# steps are the warm-up of the timed ones
SHARDED = dict(shards=2, parity_steps=16, steps=32, s1_warm=16, s1_steps=32)
SHARDED3D = dict(shards=2, parity_steps=8, steps=16)  # main_path3d's, k = 1
SHARDED_IMPLICIT = dict(n_side=256, steps=1)
# bench_upw.py's explicit 512², 4 + 8 steps; the Newmark step at 64² and at
# twice the explicit step, GMRES at 2 cycles a solve (krylov_maxiter 40):
# this problem's Newton loop ends by the stall rule after 5 iterations at
# any step size, and at UpwImplicitConfig's 10 cycles a solve one step is
# 820 GMRES iterations of host-bound J·v (upw_implicit)
SHARDED_UPW = dict(warm=4, steps=8, newmark_n_side=64, newmark_dt_factor=2.0,
                   newmark_krylov_maxiter=40)
SHARDED_FRACTURE = dict(steps=4)
SHARDED2D = dict(shards=(2, 2), explicit_steps=8, implicit_steps=1)
SHARDED_PARITY = dict(dx=1e-3, dv=1e-2, pw_explicit=1e-4, pw_newmark=1e-2)
SHARDED_TIMEOUT_S = 420.0  # one launch of ranks, start to exit
SHARDED_GROUP_TIMEOUT_S = 60.0  # a collective that waits longer fails the run
SHARDED_PHASES = ("sharded", "sharded3d", "sharded_implicit", "sharded_upw", "sharded_fracture",
                  "multihost")
# the program each rank runs: this script, with ``--sharded-rank``
RANK_PROGRAM = os.path.abspath(__file__)
# the parent's single-device states the sharded phases compare against
SHARED = {}


def _cpu(obj):
    return obj.to("cpu") if hasattr(obj, "to") else obj


def _by_pid_numpy(p, names=("x", "v")):
    """Active rows of ``names`` and pid, on the host, ordered by pid."""
    act = p.active
    o = torch.argsort(p.pid[act])
    return {n: getattr(p, n)[act][o].detach().cpu().numpy() for n in ("pid",) + tuple(names)}


def _merge_ranks(parts):
    """The ranks' by-pid arrays merged into one set ordered by pid."""
    cat = {n: np.concatenate([q[n] for q in parts]) for n in parts[0]}
    o = np.argsort(cat["pid"])
    return {n: a[o] for n, a in cat.items()}


def _parity_np(got, ref, h, label, extra=()):
    """rel_dx over h and rel_dv over the largest speed between two by-pid
    sets; for each field of ``extra`` its largest gap over its largest
    magnitude."""
    if got["pid"].shape != ref["pid"].shape or not (got["pid"] == ref["pid"]).all():
        raise PhaseError(f"{label}: particle sets differ ({got['pid'].size} against "
                         f"{ref['pid'].size})")
    out = dict(rel_dx=float(np.abs(got["x"] - ref["x"]).max()) / h,
               rel_dv=float(np.abs(got["v"] - ref["v"]).max())
               / max(float(np.abs(ref["v"]).max()), 1e-12))
    for name in extra:
        out[f"rel_d{name}"] = float(np.abs(got[name] - ref[name]).max()) / max(
            float(np.abs(ref[name]).max()), 1e-12)
    return out


def _shard_stats(res, steps):
    """The transport of a rank's timed run, per step."""
    st = res["stats"]
    return dict(bytes_staged_per_step=st.get("bytes_staged", 0) / steps,
                host_syncs_per_step=st.get("host_syncs", 0) / steps,
                exchanges_per_step=st.get("exchanges", 0) / steps,
                all_reduces_per_step=st.get("all_reduces", 0) / steps)


def _transport(outs, world, shape=None):
    comm = outs[0]["comm"]
    return dict(backend=comm["backend"], ranks=world, ranks_per_device=world,
                shard_grid=list(shape or (world,)), device=comm["device"])


def _launch_ranks(job_dir, world, job):
    """Start ``world`` ranks of this script on the job, wait for all of them
    (each within SHARDED_TIMEOUT_S), and return their outputs; a rank that
    fails or outlives its time fails the phase, and no rank is left running."""
    import socket

    torch.save(job, os.path.join(job_dir, "job.pt"))
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, RANK_PROGRAM, "--sharded-rank",
                               str(r), "--world", str(world), "--port", str(port), "--job",
                               job_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    deadline = time.perf_counter() + SHARDED_TIMEOUT_S
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
    except subprocess.TimeoutExpired:
        raise PhaseError(f"sharded ranks outlived {SHARDED_TIMEOUT_S} s")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for r, (pr, log) in enumerate(zip(procs, logs)):
        with open(os.path.join(job_dir, f"rank{r}.log"), "w") as fh:
            fh.write(log)
        if pr.returncode != 0:
            raise PhaseError(f"sharded rank {r} failed ({pr.returncode}):\n{log[-3000:]}")
    return [torch.load(os.path.join(job_dir, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


def _job_dir(name):
    import shutil

    from nlpartsol_tpu_torch.ops import cuda_build

    d = os.path.join(cuda_build.BUILD_DIR, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def _explicit_reference(dim, device):
    """(grid, p0, mats, cfg, h, by-pid state after the parity steps, their
    per-step nnz) of the single-device fused run: the parity phase's when it
    ran, else run here."""
    from nlpartsol_tpu_torch.formulations.explicit import run

    key = "explicit" + _suffix(dim)
    if key not in SHARED:
        grid, p0, mats, cfg, h = build_problem(dim, PROBLEMS[dim]["n_side"], device)
        pf, diag = run(p0, grid, mats, cfg, PROBLEMS[dim]["parity_steps"])
        _check_state(key + ":reference", pf, diag)
        SHARED[key] = (grid, p0, mats, cfg, h, _by_pid_numpy(pf),
                       [int(n) for n in diag["nnz"].long()])
    return SHARED[key]


def _sharded_s1(device):
    """S = 1 in this process, no group: the sharded driver's overhead over
    the main path (bench.py's sharded leg), 16 + 32 steps."""
    from nlpartsol_tpu_torch.ops import fused_transfer as ft
    from nlpartsol_tpu_torch.parallel import domain

    grid, p0, mats, cfg, h, _, _ = _explicit_reference(2, device)
    offs = ft._geom(grid, cfg.lme_params, 0).offsets
    dec = domain.decompose(grid, cfg.active_box, 1, np.asarray(offs), margin=1)
    (p,) = domain.shard_particles(p0, dec)
    (g,) = domain.shard_grid(grid, dec)
    body = torch.zeros(2, device=device)
    p, _ = domain.sharded_explicit_run(dec, cfg, SHARDED["s1_warm"])(p, g, mats, body)
    ft.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, diag = domain.sharded_explicit_run(dec, cfg, SHARDED["s1_steps"])(p, g, mats, body)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / SHARDED["s1_steps"]
    return dict(ms_per_step=ms, main_path_ms_per_step=REPORT.get("main_path"),
                overhead=ms / REPORT["main_path"] - 1.0 if "main_path" in REPORT else None,
                launches=dict(ft.launch_counts), lost=int(diag["lost"]))


def _implicit_reference(device):
    """The implicit 256² problem and the single-device fused step from it."""
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
    from nlpartsol_tpu_torch.formulations.implicit import implicit_step

    if "implicit" not in SHARED:
        grid, p0, mats, cfg, h = build_implicit(2, device, SHARDED_IMPLICIT["n_side"])
        p = to_slot_layout(p0, grid, cfg.active_box)
        body = torch.zeros(2, device=device)
        newton = []
        for _ in range(SHARDED_IMPLICIT["steps"]):
            p, dg = implicit_step(p, grid, mats, cfg, body)
            if not bool(dg["converged"]) or int(dg["lost"]):
                raise PhaseError(f"sharded_implicit:reference: {dg['newton_iters']} Newton, "
                                 f"converged {bool(dg['converged'])}, lost {int(dg['lost'])}")
            newton.append(int(dg["newton_iters"]))
        SHARED["implicit"] = (grid, p0, mats, cfg, h, _by_pid_numpy(p), newton)
    return SHARED["implicit"]


def _prepare_sharded(device, phases):
    """The 1-D ranks' job and the references their results are held to."""
    from nlpartsol_tpu_torch.formulations import upw
    from nlpartsol_tpu_torch.formulations.explicit import run as erun, to_slot_layout

    job, refs = dict(phases=[]), {}
    if phases & {"sharded", "multihost"}:
        grid, p0, mats, cfg, h, ref, nnz = _explicit_reference(2, device)
        job["sharded"] = dict(grid=_cpu(grid), p0=_cpu(p0), mats=_cpu(mats), cfg=cfg, h=h,
                              **SHARDED)
        refs["sharded"] = (ref, nnz, h)
        job["phases"].append("sharded")
    if "sharded3d" in phases:
        grid, p0, mats, cfg, h, ref, nnz = _explicit_reference(3, device)
        job["sharded3d"] = dict(grid=_cpu(grid), p0=_cpu(p0), mats=_cpu(mats), cfg=cfg, h=h,
                                **SHARDED3D)
        refs["sharded3d"] = (ref, nnz, h)
        job["phases"].append("sharded3d")
    if "sharded_implicit" in phases:
        grid, p0, mats, cfg, h, ref, newton = _implicit_reference(device)
        job["sharded_implicit"] = dict(grid=_cpu(grid), p0=_cpu(p0), mats=_cpu(mats), cfg=cfg,
                                       steps=SHARDED_IMPLICIT["steps"])
        refs["sharded_implicit"] = (ref, newton, h)
        job["phases"].append("sharded_implicit")
    if "sharded_upw" in phases:
        spec = SHARDED_UPW
        grid, p0, mats, mix, cfg, h = build_upw(device, implicit=False)
        pr, dg = upw.run(p0, grid, mats, mix, cfg, spec["warm"] + spec["steps"], _upw_body(p0))
        _check_upw("sharded_upw:reference", pr, dg["lost"].sum())
        gn, pn0, mn, mixn, cfgn, hn = build_upw(device, implicit=True,
                                                 n_side=spec["newmark_n_side"])
        cfgn = cfgn.replace(dt=cfgn.dt / 20.0 * spec["newmark_dt_factor"],
                            krylov_maxiter=spec["newmark_krylov_maxiter"])
        pn = to_slot_layout(pn0, gn, cfgn.active_box)
        pn, dn = upw.upw_newmark_step(pn, gn, mn, mixn, cfgn, _upw_body(pn))
        _check_upw("sharded_upw:newmark_reference", pn, dn["lost"])
        job["sharded_upw"] = dict(
            explicit=dict(grid=_cpu(grid), p0=_cpu(p0), mats=_cpu(mats), mix=_cpu(mix), cfg=cfg,
                          warm=spec["warm"], steps=spec["steps"]),
            newmark=dict(grid=_cpu(gn), p0=_cpu(pn0), mats=_cpu(mn), mix=_cpu(mixn), cfg=cfgn))
        refs["sharded_upw"] = (_by_pid_numpy(pr, ("x", "v", "pw")), h,
                               _by_pid_numpy(pn, ("x", "v", "pw")), int(dn["newton_iters"]),
                               int(dn["cg_iters"]), hn)
        job["phases"].append("sharded_upw")
    if "sharded_fracture" in phases:
        grid, p0, mats, cfg, h = build_fracture(2, PROBLEMS[2]["n_side"], device, "eigenerosion")
        pr, dg = erun(p0, grid, mats, cfg, SHARDED_FRACTURE["steps"])
        _check_state("sharded_fracture:reference", pr, dg)
        job["sharded_fracture"] = dict(grid=_cpu(grid), p0=_cpu(p0), mats=_cpu(mats), cfg=cfg,
                                       steps=SHARDED_FRACTURE["steps"])
        refs["sharded_fracture"] = (_by_pid_numpy(pr, ("x", "v", "damage", "strain_f")), h,
                                    float(pr.damage[pr.active].mean()))
        job["phases"].append("sharded_fracture")
    job["multihost"] = "multihost" in phases
    return job, refs


def _want_launches(dim, steps):
    return {f"lme_scatter{dim}d:solve": steps, f"lme_scatter{dim}d:G": steps,
            f"lme_gather{dim}d:N+grad": steps, f"lme_gather{dim}d:N": steps}


def _report_explicit(label, outs, refs, world, spec, dim):
    ref, nnz_ref, h = refs[label]
    got = _merge_ranks([o[label]["parity"] for o in outs])
    par = _parity_np(got, ref, h, label)
    nnz = outs[0][label]["parity_nnz"]
    lost = [o[label]["lost"] for o in outs]
    want = _want_launches(dim, spec["steps"])
    launches = [o[label]["launches"] for o in outs]
    ms = max(o[label]["ms"] for o in outs)
    ok = (par["rel_dx"] < SHARDED_PARITY["dx"] and par["rel_dv"] < SHARDED_PARITY["dv"]
          and nnz == nnz_ref and not any(lost) and all(c == want for c in launches))
    PATH_LAUNCHES[label] = ("", {k: v / spec["steps"] for k, v in launches[0].items()})
    say(phase=label, **_transport(outs, world), parity_steps=spec["parity_steps"],
        steps=spec["steps"], ms_per_step=ms / spec["steps"], **par,
        limit_dx=SHARDED_PARITY["dx"], limit_dv=SHARDED_PARITY["dv"], nnz_equal=nnz == nnz_ref,
        nnz_per_step=nnz[-1], lost=lost, launches_per_rank=launches,
        **_shard_stats(outs[0][label], spec["steps"]),
        particles_per_rank=[o[label]["n_active"] for o in outs],
        moved_between_ranks=sum(o[label]["arrived"] for o in outs),
        s1=outs[0][label].get("s1"), ok=ok)
    if not ok:
        raise PhaseError(f"{label}: {par}, nnz equal {nnz == nnz_ref}, lost {lost}, "
                         f"launches {launches}")


def phase_sharded(device, phases):
    """The 1-D sharded phases on S = 2 ranks sharing the card (one launch),
    then ``sharded2d`` on 2×2 ranks (another)."""
    t0 = time.perf_counter()
    s1 = _sharded_s1(device) if "sharded" in phases else None
    job, refs = _prepare_sharded(device, phases)
    torch.cuda.empty_cache()
    prep_s = time.perf_counter() - t0
    if job["phases"]:
        world = SHARDED["shards"]
        t1 = time.perf_counter()
        outs = _launch_ranks(_job_dir("sharded_job"), world, job)
        launch_s = time.perf_counter() - t1
        if "sharded" in job["phases"]:
            outs[0]["sharded"]["s1"] = s1
            _report_explicit("sharded", outs, refs, world, SHARDED, 2)
        if "sharded3d" in job["phases"]:
            _report_explicit("sharded3d", outs, refs, world, SHARDED3D, 3)
        if "sharded_implicit" in job["phases"]:
            _report_sharded_implicit(outs, refs, world)
        if "sharded_upw" in job["phases"]:
            _report_sharded_upw(outs, refs, world)
        if "sharded_fracture" in job["phases"]:
            _report_sharded_fracture(outs, refs, world)
        if job["multihost"]:
            _report_multihost(outs, world, SHARDED["steps"])
        say(phase="sharded_launch", ranks=world, prepare_s=prep_s, launch_s=launch_s,
            rank_seconds={p: max(o[p]["seconds"] for o in outs) for p in job["phases"]})
    if "sharded2d" in phases:
        phase_sharded2d(device)


def _report_sharded_implicit(outs, refs, world):
    label = "sharded_implicit"
    ref, newton_ref, h = refs[label]
    res = [o[label] for o in outs]
    par = _parity_np(_merge_ranks([r["state"] for r in res]), ref, h, label)
    newton = [r["newton"] for r in res]
    cg = [r["cg"] for r in res]
    ok = (par["rel_dx"] < SHARDED_PARITY["dx"] and par["rel_dv"] < SHARDED_PARITY["dv"]
          and all(r["converged"] for r in res) and not any(r["lost"] for r in res)
          and all(n == newton_ref for n in newton) and all(c == cg[0] for c in cg))
    PATH_LAUNCHES[label] = ("implicit", {k: v / len(newton[0])
                                         for k, v in res[0]["launches"].items()})
    say(phase=label, **_transport(outs, world), steps=len(newton[0]),
        ms_per_step=max(r["ms"] for r in res) / len(newton[0]), **par,
        newton_per_rank=newton, newton_single_device=newton_ref, cg_per_rank=cg,
        converged=[r["converged"] for r in res], lost=[r["lost"] for r in res],
        launches_per_rank=[r["launches"] for r in res],
        **_shard_stats(res[0], len(newton[0])), ok=ok)
    if not ok:
        raise PhaseError(f"{label}: {par}, Newton {newton} against {newton_ref}, CG {cg}")


def _report_sharded_upw(outs, refs, world):
    label = "sharded_upw"
    ref_e, h, ref_n, newton_ref, gmres_ref, hn = refs[label]
    res = [o[label] for o in outs]
    pe = _parity_np(_merge_ranks([r["explicit"] for r in res]), ref_e, h, label, ("pw",))
    pn = _parity_np(_merge_ranks([r["newmark"] for r in res]), ref_n, hn, label, ("pw",))
    newton = [r["newton"] for r in res]
    ok = (pe["rel_dx"] < SHARDED_PARITY["dx"] and pe["rel_dv"] < SHARDED_PARITY["dv"]
          and pe["rel_dpw"] < SHARDED_PARITY["pw_explicit"]
          and pn["rel_dx"] < SHARDED_PARITY["dx"] and pn["rel_dv"] < SHARDED_PARITY["dv"]
          and pn["rel_dpw"] < SHARDED_PARITY["pw_newmark"]
          and all(n == newton_ref for n in newton) and not any(r["lost"] for r in res))
    PATH_LAUNCHES[label] = ("upw", {k: v / SHARDED_UPW["steps"]
                                    for k, v in res[0]["launches"].items()})
    say(phase=label, **_transport(outs, world), explicit=dict(
            grid=f"{UPW['n_side']}x{UPW['n_side']}", warm=SHARDED_UPW["warm"], steps=SHARDED_UPW["steps"],
            ms_per_step=max(r["ms"] for r in res) / SHARDED_UPW["steps"], **pe,
            limit_pw=SHARDED_PARITY["pw_explicit"],
            launches_per_rank=[r["launches"] for r in res]),
        **_shard_stats(res[0], SHARDED_UPW["steps"]),
        newmark=dict(grid=f"{SHARDED_UPW['newmark_n_side']}x{SHARDED_UPW['newmark_n_side']}",
                     dt_over_explicit=SHARDED_UPW["newmark_dt_factor"],
                     krylov_maxiter=SHARDED_UPW["newmark_krylov_maxiter"], **pn,
                     limit_pw=SHARDED_PARITY["pw_newmark"], newton_per_rank=newton,
                     newton_single_device=newton_ref, gmres_per_rank=[r["gmres"] for r in res],
                     gmres_single_device=gmres_ref, ms=max(r["newmark_ms"] for r in res)),
        lost=[r["lost"] for r in res], ok=ok)
    if not ok:
        raise PhaseError(f"{label}: explicit {pe}, Newmark {pn}, Newton {newton} "
                         f"against {newton_ref}")


def _report_sharded_fracture(outs, refs, world):
    label = "sharded_fracture"
    ref, h, eroded = refs[label]
    res = [o[label] for o in outs]
    got = _merge_ranks([r["state"] for r in res])
    par = _parity_np(got, ref, h, label)
    # the fracture phase's gates (_damage_parity): damage decisions as counts
    # of particles, the strain_f gap where both triggered
    decisions = int((got["damage"] != ref["damage"]).sum())
    both = (got["strain_f"] > 0) & (ref["strain_f"] > 0)
    sf_gap = float(np.where(both, np.abs(got["strain_f"] - ref["strain_f"]), 0.0).max()) / max(
        float(np.abs(ref["strain_f"]).max()), 1e-30)
    ok = (par["rel_dx"] < FRACTURE_PARITY["dx"] and par["rel_dv"] < FRACTURE_PARITY["dv"]
          and decisions <= FRACTURE_PARITY["decisions"] and sf_gap <= FRACTURE_PARITY["strain_f"]
          and not any(r["lost"] for r in res) and eroded > 0.0)
    say(phase=label, **_transport(outs, world), steps=SHARDED_FRACTURE["steps"],
        ms_per_step=max(r["ms"] for r in res) / SHARDED_FRACTURE["steps"], **par,
        other_decisions=decisions, limit_decisions=FRACTURE_PARITY["decisions"],
        strain_f_gap=sf_gap, eroded_share=eroded, lost=[r["lost"] for r in res],
        launches_per_rank=[r["launches"] for r in res],
        **_shard_stats(res[0], SHARDED_FRACTURE["steps"]), ok=ok)
    if not ok:
        raise PhaseError(f"{label}: {par}, {decisions} other decisions, strain_f {sf_gap}")


def _report_multihost(outs, world, steps):
    """gather_particles on every rank equals unshard_particles of the
    ranks' strips; the shards' VTK files together are the gathered cloud."""
    res = [o["multihost"] for o in outs]
    whole = _merge_ranks([r["mine"] for r in res])
    gathered_equal = all(
        r["gathered"]["pid"].shape == whole["pid"].shape
        and all(np.array_equal(r["gathered"][n], whole[n]) for n in whole) for r in res)
    # each shard's file holds its active particles in pid order
    pts = np.concatenate([_vtk_points(path) for r in res for path in r["paths"]])[:, :2]
    want = np.concatenate([r["mine"]["x"] for r in res]).astype(np.float64)
    vtk_gap = float(np.abs(pts - want).max()) if pts.shape == want.shape else float("inf")
    ok = gathered_equal and vtk_gap <= 1e-6 * max(1.0, float(np.abs(want).max()))
    say(phase="multihost", **_transport(outs, world), **_shard_stats(outs[0]["sharded"], steps),
        particles=int(whole["pid"].size),
        gather_equals_unshard=gathered_equal, vtk_files=[len(r["paths"]) for r in res],
        vtk_points=int(pts.shape[0]), vtk_max_gap=vtk_gap,
        gather_ms=max(r["gather_ms"] for r in res), vtk_s=max(r["vtk_s"] for r in res), ok=ok)
    if not ok:
        raise PhaseError(f"multihost: gather equal {gathered_equal}, VTK gap {vtk_gap}")


def _vtk_points(path):
    """The (n, 3) POINTS of a legacy ASCII VTK file."""
    with open(path) as fh:
        text = fh.read()
    head, _, rest = text.partition("POINTS ")
    n = int(rest.split(None, 1)[0])
    body = rest.split("\n", 1)[1]
    return np.array(body.split(None, 3 * n)[:3 * n], dtype=np.float64).reshape(n, 3)


def phase_sharded2d(device):
    """2×2 ranks on the card: bench.py's 512² explicit step (a re-bin every
    step, two-phase migration every step) and the implicit 256² step, each
    against its single-device fused run by pid."""
    from nlpartsol_tpu_torch.formulations.explicit import run

    spec = SHARDED2D
    grid, p0, mats, cfg, h = build_problem(2, PROBLEMS[2]["n_side"], device)
    cfg = cfg.replace(rebin_every=1)
    pr, dg = run(p0, grid, mats, cfg, spec["explicit_steps"])
    _check_state("sharded2d:reference", pr, dg)
    gi, pi0, mi, cfgi, hi, ref_i, newton_ref = _implicit_reference(device)
    job = dict(phases=["sharded2d"], sharded2d=dict(
        explicit=dict(grid=_cpu(grid), p0=_cpu(p0), mats=_cpu(mats), cfg=cfg,
                      steps=spec["explicit_steps"]),
        implicit=dict(grid=_cpu(gi), p0=_cpu(pi0), mats=_cpu(mi), cfg=cfgi,
                      steps=spec["implicit_steps"])), multihost=False)
    torch.cuda.empty_cache()
    world = spec["shards"][0] * spec["shards"][1]
    t0 = time.perf_counter()
    outs = _launch_ranks(_job_dir("sharded2d_job"), world, job)
    launch_s = time.perf_counter() - t0
    res = [o["sharded2d"] for o in outs]
    pe = _parity_np(_merge_ranks([r["explicit"] for r in res]), _by_pid_numpy(pr), h, "sharded2d")
    pi = _parity_np(_merge_ranks([r["implicit"] for r in res]), ref_i, hi, "sharded2d")
    newton = [r["newton"] for r in res]
    ok = (pe["rel_dx"] < SHARDED_PARITY["dx"] and pe["rel_dv"] < SHARDED_PARITY["dv"]
          and pi["rel_dx"] < SHARDED_PARITY["dx"] and pi["rel_dv"] < SHARDED_PARITY["dv"]
          and all(n == newton_ref for n in newton) and all(r["converged"] for r in res)
          and not any(r["lost"] for r in res)
          and all(r["launches"] == _want_launches(2, spec["explicit_steps"]) for r in res))
    say(phase="sharded2d", **_transport(outs, world, spec["shards"]), explicit=dict(
            steps=spec["explicit_steps"], ms_per_step=max(r["ms"] for r in res)
            / spec["explicit_steps"], **pe, launches_per_rank=[r["launches"] for r in res]),
        **_shard_stats(res[0], spec["explicit_steps"]),
        implicit=dict(steps=spec["implicit_steps"], **pi, newton_per_rank=newton,
                      newton_single_device=newton_ref, cg_per_rank=[r["cg"] for r in res]),
        lost=[r["lost"] for r in res], launch_s=launch_s, ok=ok)
    if not ok:
        raise PhaseError(f"sharded2d: explicit {pe}, implicit {pi}, Newton {newton}")


# ----- the ranks' side (``--sharded-rank``) --------------------------------


def _rank_state(p, dec, comm, names=("x", "v")):
    """This rank's active particles in world coordinates, by pid, on the
    host."""
    from nlpartsol_tpu_torch.parallel import multihost

    (_, arrays), = multihost.addressable_particles(p, dec, comm)
    act = arrays["active"]
    o = np.argsort(arrays["pid"][act])
    return {n: arrays[n][act][o] for n in ("pid",) + tuple(names)}


def _rank_timed(fn, comm):
    """``fn()`` timed on the host clock between synchronisations and a
    barrier, with the launch and transport counts set to 0 just before."""
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    torch.distributed.barrier(group=comm.group)
    comm.reset_stats()
    ft.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0), dict(ft.launch_counts), dict(comm.stats)


def _rank_problem(spec, dev):
    return (spec["grid"].to(dev), spec["p0"].to(dev), spec["mats"].to(dev),
            spec.get("cfg"))


def _offsets(grid, cfg):
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    return np.asarray(ft._geom(grid, cfg.lme_params, 0).offsets)


def _strip(p0, grid, dec, comm):
    from nlpartsol_tpu_torch.parallel import multihost

    return (multihost.shard_particles_global(p0, dec, comm),
            multihost.shard_grid_global(grid, dec, comm))


def _rank_explicit(spec, comm, dev, job_dir, multihost_check):
    from nlpartsol_tpu_torch.parallel import domain, multihost

    grid, p0, mats, cfg = _rank_problem(spec, dev)
    margin = 0 if cfg.rebin_every == 1 else 1
    dec = domain.decompose(grid, cfg.active_box, comm.size, _offsets(grid, cfg),
                           margin=margin).on(comm)
    p, g = _strip(p0, grid, dec, comm)
    start = set(p.pid[p.active].tolist())
    body = torch.zeros(grid.dim, device=dev)
    p, dg = domain.sharded_explicit_run(dec, cfg, spec["parity_steps"])(p, g, mats, body)
    out = dict(parity=_rank_state(p, dec, comm), parity_nnz=[int(n) for n in dg["nnz"].long()],
               lost=int(dg["lost"]))
    (p, dg), ms, launches, stats = _rank_timed(
        lambda: domain.sharded_explicit_run(dec, cfg, spec["steps"])(p, g, mats, body), comm)
    out.update(ms=ms, launches=launches, stats=stats, lost=out["lost"] + int(dg["lost"]),
               n_active=int(p.active.sum()),
               arrived=len(set(p.pid[p.active].tolist()) - start))
    if multihost_check:
        t0 = time.perf_counter()
        gathered = multihost.gather_particles(p, comm)
        whole = domain.unshard_particles(gathered, dec)
        gather_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        paths = multihost.write_shard_vtk(job_dir, spec["steps"], p, dec, comm, fields=())
        out["multihost"] = dict(gathered=_by_pid_numpy(whole), mine=_rank_state(p, dec, comm),
                                paths=paths, gather_ms=gather_ms,
                                vtk_s=time.perf_counter() - t0)
    return out


def _rank_implicit(spec, comm, dev, two=None):
    from nlpartsol_tpu_torch.parallel import domain

    grid, p0, mats, cfg = _rank_problem(spec, dev)
    if two:
        dec = domain.decompose2(grid, cfg.active_box, two, _offsets(grid, cfg)).on(comm)
        run = domain.sharded_implicit_run2(dec, cfg, spec["steps"])
    else:
        dec = domain.decompose(grid, cfg.active_box, comm.size, _offsets(grid, cfg)).on(comm)
        run = domain.sharded_implicit_run(dec, cfg, spec["steps"])
    p, g = _strip(p0, grid, dec, comm)
    (p, dg), ms, launches, stats = _rank_timed(
        lambda: run(p, g, mats, torch.zeros(2, device=dev)), comm)
    return dict(state=_rank_state(p, dec, comm), newton=dg["newton_iters"].tolist(),
                cg=dg["cg_iters"].tolist(), converged=bool(dg["converged"].all()),
                lost=int(dg["lost"]), ms=ms, launches=launches, stats=stats)


def _rank_upw(spec, comm, dev):
    from nlpartsol_tpu_torch.formulations import upw
    from nlpartsol_tpu_torch.parallel import collectives, domain

    e = spec["explicit"]
    grid, p0, mats, cfg = _rank_problem(e, dev)
    mix = e["mix"].to(dev)
    dec = domain.decompose(grid, cfg.active_box, comm.size, _offsets(grid, cfg)).on(comm)
    p, g = _strip(p0, grid, dec, comm)
    body = _upw_body(p)
    p, dw = domain.sharded_upw_run(dec, cfg, mix, e["warm"])(p, g, mats, body)
    (p, dg), ms, launches, stats = _rank_timed(
        lambda: domain.sharded_upw_run(dec, cfg, mix, e["steps"])(p, g, mats, body), comm)
    out = dict(explicit=_rank_state(p, dec, comm, ("x", "v", "pw")), ms=ms, launches=launches,
               stats=stats, lost=int(dw["lost"]) + int(dg["lost"]))
    # the Newmark step with the halo in this loop (its migration after it)
    n = spec["newmark"]
    grid, p0, mats, cfg = _rank_problem(n, dev)
    mix = n["mix"].to(dev)
    dec = domain.decompose(grid, cfg.active_box, comm.size, _offsets(grid, cfg)).on(comm)
    p, g = _strip(p0, grid, dec, comm)
    cfgl = domain._localize_cfg(cfg, dec)

    def newmark():
        q, dn = upw.upw_newmark_step(p, g, mats, mix, cfgl, _upw_body(p))
        q, lost = domain.migrate_local(q, dec.spec, g, dec.local_box)
        return q, dn, int(collectives.all_sum([lost], comm)[0])

    (p, dn, lost), ms_n, _, _ = _rank_timed(newmark, comm)
    out.update(newmark=_rank_state(p, dec, comm, ("x", "v", "pw")),
               newton=int(dn["newton_iters"]), gmres=int(dn["cg_iters"]), newmark_ms=ms_n)
    out["lost"] += lost
    return out


def _rank_fracture(spec, comm, dev):
    from nlpartsol_tpu_torch.parallel import domain

    grid, p0, mats, cfg = _rank_problem(spec, dev)
    dec = domain.decompose(grid, cfg.active_box, comm.size, _offsets(grid, cfg)).on(comm)
    p, g = _strip(p0, grid, dec, comm)
    (p, dg), ms, launches, stats = _rank_timed(
        lambda: domain.sharded_explicit_run(dec, cfg, spec["steps"])(
            p, g, mats, torch.zeros(2, device=dev)), comm)
    return dict(state=_rank_state(p, dec, comm, ("x", "v", "damage", "strain_f")), ms=ms,
                launches=launches, stats=stats, lost=int(dg["lost"]))


def _rank_sharded2d(spec, comm, dev):
    from nlpartsol_tpu_torch.parallel import domain

    e = spec["explicit"]
    grid, p0, mats, cfg = _rank_problem(e, dev)
    dec = domain.decompose2(grid, cfg.active_box, comm.shape, _offsets(grid, cfg)).on(comm)
    p, g = _strip(p0, grid, dec, comm)
    (p, dg), ms, launches, stats = _rank_timed(
        lambda: domain.sharded_explicit_run2(dec, cfg, e["steps"])(
            p, g, mats, torch.zeros(2, device=dev)), comm)
    out = dict(explicit=_rank_state(p, dec, comm), ms=ms, launches=launches, stats=stats,
               lost=int(dg["lost"]))
    imp = _rank_implicit(spec["implicit"], comm, dev, two=comm.shape)
    out.update(implicit=imp["state"], newton=imp["newton"], cg=imp["cg"],
               converged=imp["converged"])
    out["lost"] += imp["lost"]
    return out


def run_rank(args):
    """One rank of a sharded launch: join the gloo group, run the job's
    phases on this rank's strips on the card, write the results."""
    from nlpartsol_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{args.port}", args.world, args.sharded_rank,
                         timeout_s=SHARDED_GROUP_TIMEOUT_S)
    job = torch.load(os.path.join(args.job, "job.pt"), weights_only=False)
    shape = SHARDED2D["shards"] if "sharded2d" in job["phases"] else None
    comm = multihost.global_comm(shape)
    dev = multihost.local_device()
    torch.cuda.set_device(dev)
    out = dict(comm=dict(backend=comm.backend, device=torch.cuda.get_device_name(dev)))
    for phase in job["phases"]:
        t0 = time.perf_counter()
        if phase in ("sharded", "sharded3d"):
            out[phase] = _rank_explicit(job[phase], comm, dev, args.job,
                                        phase == "sharded" and job["multihost"])
            if "multihost" in out[phase]:
                out["multihost"] = out[phase].pop("multihost")
        elif phase == "sharded_implicit":
            out[phase] = _rank_implicit(job[phase], comm, dev)
        elif phase == "sharded_upw":
            out[phase] = _rank_upw(job[phase], comm, dev)
        elif phase == "sharded_fracture":
            out[phase] = _rank_fracture(job[phase], comm, dev)
        elif phase == "sharded2d":
            out[phase] = _rank_sharded2d(job[phase], comm, dev)
        out[phase]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(args.job, f"out_{args.sharded_rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,main_path,parity,roofline,implicit,"
                    "implicit_parity,kernels3d,main_path3d,parity3d,roofline3d,implicit3d,"
                    "implicit_parity3d,upw,upw_parity,upw_implicit,upw_implicit_parity,up,"
                    "up_parity,dem,dem_parity,models_fn,models,models_parity,models3d,"
                    "implicit_models,implicit_models_parity,implicit_models3d,upw_models,"
                    "models_jv,deck,decks,"
                    "fracture,fracture3d,fracture_implicit,shapefuns,scatter,femesh,femesh3d,"
                    "femesh_parity,femesh_scatter,probes,sharded,sharded3d,sharded_implicit,"
                    "sharded_upw,sharded_fracture,sharded2d,multihost,large3d,large",
                    help="comma-separated phases to run after device and build")
    # one rank of a sharded launch (started by the sharded phases themselves)
    ap.add_argument("--sharded-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--job", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import nlpartsol_tpu_torch  # noqa: F401  (fail before anything is printed)

    if args.sharded_rank is not None:
        return run_rank(args)

    device = "cuda"
    kind, smi = phase_device()
    phase_build()

    rows = []
    for dim in (2, 3):
        sfx = _suffix(dim)
        if "kernels" + sfx in phases:
            phase_kernels(device, dim)
        if phases & {name + sfx
                      for name in ("main_path", "profile", "parity", "roofline", "tiles")}:
            grid, p0, p1, mats, cfg, h, counts = phase_main_path(device, dim)
            if "profile" + sfx in phases:
                phase_profile(grid, p1, mats, cfg, label="profile" + sfx)
            if "tiles" + sfx in phases:
                phase_tiles(grid, p1, cfg)
            if "parity" + sfx in phases:
                phase_parity(grid, p0, mats, cfg, h)
            if "roofline" + sfx in phases:
                rows += phase_roofline(grid, p1, mats, cfg, counts)
            del p0, p1
            torch.cuda.empty_cache()
        if phases & {"implicit" + sfx, "implicit_parity" + sfx}:
            grid, p1, mats, cfg, h, counts, steps = phase_implicit(device, dim)
            if "implicit_parity" + sfx in phases:
                phase_implicit_parity(grid, p1, mats, cfg, h)
            if "roofline" + sfx in phases:
                rows += phase_implicit_roofline(grid, p1, mats, cfg, counts, steps)
            del p1
            torch.cuda.empty_cache()
    if phases & {"upw", "upw_parity"}:
        grid, p0, p2, mats, mix, cfg, h, counts = phase_upw(device)
        if "upw_parity" in phases:
            phase_upw_parity(grid, p0, mats, mix, cfg, h)
        if "roofline" in phases:
            rows += phase_upw_roofline(grid, p2, mats, mix, cfg, counts, UPW["steps"], False)
        del p0, p2
        torch.cuda.empty_cache()
    if phases & {"upw_implicit", "upw_implicit_parity"}:
        grid, p1, p2, mats, mix, cfg, h, counts, steps = phase_upw_implicit(device)
        if "roofline" in phases:
            rows += phase_upw_roofline(grid, p2, mats, mix, cfg, counts, steps, True)
        del p1, p2
        torch.cuda.empty_cache()
        if "upw_implicit_parity" in phases:
            phase_upw_implicit_parity(device)
    for path in ("up", "dem"):
        if path in phases:
            grid, p2, mats, cfg, counts, steps = phase_up_dem(device, path)
            if "roofline" in phases:
                rows += phase_up_dem_roofline(grid, p2, mats, cfg, counts, steps, path)
            del p2
            torch.cuda.empty_cache()
        if path + "_parity" in phases:
            phase_up_dem_parity(device, path)
            torch.cuda.empty_cache()
    if "models_fn" in phases:
        phase_models_fn(device)
    if phases & {"models", "models_parity"}:
        grid, p0, mats, cfg, h = phase_models(device, 2)
        if "models_parity" in phases:
            phase_models_parity(grid, p0, mats, cfg, h)
        del p0
        torch.cuda.empty_cache()
    if "models3d" in phases:
        grid, p0, mats, cfg, h = phase_models(device, 3)
        phase_models_parity(grid, p0, mats, cfg, h)
        del p0
        torch.cuda.empty_cache()
    for dim in (2, 3):
        if "implicit_models" + _suffix(dim) in phases:
            phase_implicit_models(device, dim)
            torch.cuda.empty_cache()
        if dim == 2 and "implicit_models_parity" in phases:
            phase_implicit_models_parity(device)
            torch.cuda.empty_cache()
    if "upw_models" in phases:
        phase_upw_models(device)
        torch.cuda.empty_cache()
    if "models_jv" in phases:
        phase_models_jv(device)
        torch.cuda.empty_cache()
    if "deck" in phases:
        phase_deck(device)
        torch.cuda.empty_cache()
    if "decks" in phases:
        phase_decks(device)
        torch.cuda.empty_cache()
    for dim in (2, 3):
        if "fracture" + _suffix(dim) in phases:
            rows += phase_fracture(device, dim, roofline="roofline" in phases)
            torch.cuda.empty_cache()
    if "fracture_implicit" in phases:
        phase_fracture_implicit(device)
        torch.cuda.empty_cache()
    if "shapefuns" in phases:
        phase_shapefuns(device)
        torch.cuda.empty_cache()
    if "scatter" in phases:
        phase_scatter(device)
        torch.cuda.empty_cache()
    for name in ("femesh", "femesh3d", "femesh_parity", "femesh_scatter"):
        if name in phases:
            globals()["phase_" + name](device)
            torch.cuda.empty_cache()
    if "probes" in phases:
        rows += phase_probes(device)
    if phases & (set(SHARDED_PHASES) | {"sharded2d"}):
        phase_sharded(device, phases)
        torch.cuda.empty_cache()
    # the large legs are optional: only with most of the time limit ahead
    for dim, before_s in ((3, 420.0), (2, 480.0)):
        if "large" + _suffix(dim) in phases and time.perf_counter() - T_START < before_s:
            phase_large(device, dim)
            torch.cuda.empty_cache()

    for r in rows:
        key, _, tag = r["name"].partition("@")
        r["launches_by_path"] = {path: n[key] for path, (path_tag, n) in PATH_LAUNCHES.items()
                                 if tag.split(" ")[0] == path_tag and key in n}
    say(phase="done", seconds=time.perf_counter() - T_START)
    print(smi, flush=True)
    say(kernels=rows)
    say(ok=True, device=dict(platform="gpu", kind=kind, count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
