#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``nlpartsol_tpu_torch/csrc`` (one ``nvcc`` per
source, all started together) and drives the port's eight paths — the 2D
and the 3D explicit LME step, the 2D and 3D implicit Newmark step, the 2D
explicit and implicit soil-water mixture (u-pw) step, and the 2D mixed u-p
and Discrete Energy-Momentum (DEM) steps, on the fused kernels — on the
card.  Each phase
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
             + 3 timed steps (the script times 8), every Newton loop ended by
             its tolerance or stall rule (``converged`` reported), nothing
             lost, launches held to the formula of
             formulations/upw.py, host syncs, 5 J·v under the profiler (a
             whole step is some 600,000 kernels: minutes of profiling)
  upw_implicit_parity
             2 implicit u-pw steps on both engines on the card at 128², by pid:
             rel_dx < 1e-3, rel_dv < 1e-2, pw within 1e-2 of its largest
             magnitude, equal Newton iterations; with ``roofline`` the u-pw
             steps' call variants at their shapes (rows ``…@upw``,
             ``…@upw_implicit``)
  up         the mixed u-p step on the fused kernels at the width of
             ``implicit`` (256² nodes, 65,536 particles, capacity-6 box of
             132² cells), Neo-Hookean E 1e7, ν 0.3, LME γ=3, dt = 2h/c,
             UpConfig's Newton-GMRES defaults, a local re-bin every step; 1
             warm-up + 2 timed steps, each Newton loop ended by its tolerance
             or stall rule (``converged`` reported), nothing lost, launches
             held to the formula of formulations/up.py, host syncs, host ms
             per residual and per J·v, 5 J·v under the profiler, and one
             J·v against a float64 central difference at 32² (float64 on CPU
             tensors: the plain versions and this torch build's forward mode),
             and the card's float32 J·v through the kernels against the plain
             versions' float32 J·v at the same x and v (``JV_F32_LIMIT``)
  up_parity  2 u-p steps on both engines on the card at 64², by pid:
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
  probes     the lane-roll probes: a roll sum checked exactly against
             torch.roll, and timed beside its multiply-add twin at 4 shapes
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
after), error against its plain version, times and bound; the line after it
is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

T_START = time.perf_counter()

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


def _roofline_rows(grid, p, cfg, counts, margin, rows):
    """The four calls of a step at ``margin``, appended to ``rows``;
    ``counts`` are the main path's launches, or None off the path."""
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
    tag = "" if counts is not None else f"@margin{margin}"
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
    2: dict(n_side=256, warm=1, steps=5, parity_steps=2),
    3: dict(n_side=96, warm=1, steps=3, parity_steps=2),
}


def build_implicit(dim, device):
    from nlpartsol_tpu_torch.formulations.implicit import ImplicitConfig

    spec = IMPLICIT[dim]
    grid, p, mats, cfg_e, h = build_problem(dim, spec["n_side"], device)
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
UPW_IMPLICIT = dict(n_side=256, warm=1, steps=3, parity_steps=2, parity_n_side=128)
# per explicit step: 3 scatters and 5 gathers, by launch key
UPW_LAUNCHES = {"lme_scatter2d:solve": 1, "lme_scatter2d:G": 2, "lme_gather2d:N+grad": 1,
                "lme_gather2d:grad": 2, "lme_gather2d:N": 2}
C_MIX = float(np.sqrt((2.2e7 / 0.4) / 1700.0))


def build_upw(device, implicit, n_side=None):
    from nlpartsol_tpu_torch.formulations import upw
    from nlpartsol_tpu_torch.models import materials as M

    spec = UPW_IMPLICIT if implicit else UPW
    grid, p, _, cfg_e, h = build_problem(2, n_side or spec["n_side"], device)
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=1e7, nu=0.3, rho0=2700.0),
         M.material(kind="Newtonian-Fluid-Compressible", rho0=1000.0, compressibility=2.2e7)],
        device=device)
    mix = upw.make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=1e-5)], device=device)
    p = upw.init_mixture_state(p, mats, mix)
    dt = 0.25 * h / C_MIX
    common = dict(lme_params=cfg_e.lme_params, kinds=cfg_e.kinds, transfer="fused",
                  active_box=cfg_e.active_box)
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
        depth_cut="1 warm-up + 3 timed steps (scripts/bench_upw.py --implicit times 8)",
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
UP = dict(n_side=256, warm=1, steps=2, parity_steps=2, parity_n_side=64)
DEM = dict(n_side=256, warm=1, steps=2, parity_steps=2, parity_n_side=128)
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
    ``column_problem`` (its soil and fluid table, mixture densities), 5 u-p
    steps on each engine from the same state, by pid."""
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
    from nlpartsol_tpu_torch.formulations.up import UpConfig, up_step

    grid, p, mats, _, ccfg, _ = column_problem(device)
    cfg = UpConfig(dt=2e-3, lme_params=ccfg.lme_params, kinds=ccfg.kinds, transfer="fused",
                   active_box=ccfg.active_box)
    body = _upw_body(p)
    res = {}
    for transfer in ("fused", "windowed"):
        q = to_slot_layout(p, grid, cfg.active_box)
        for i in range(5):
            q, dq = up_step(q, grid, mats, cfg.replace(transfer=transfer), body)
            _check_state(f"up_parity:column:{transfer}", q, dict(lost=dq["lost"]))
        res[transfer] = (_by_pid_fields(q, ("x", "pw")), bool(dq["converged"]))
    ((pid_f, (xf, lf)), conv_f), ((pid_w, (xw, lw)), conv_w) = res["fused"], res["windowed"]
    if not bool((pid_f == pid_w).all()):
        raise PhaseError("up_parity:column: particle sets differ")
    l_scale = max(1.0, float(lw.abs().max()))
    out = dict(steps=5, particles=p.count, dx=float((xf - xw).abs().max()),
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,main_path,parity,roofline,implicit,"
                    "implicit_parity,kernels3d,main_path3d,parity3d,roofline3d,implicit3d,"
                    "implicit_parity3d,upw,upw_parity,upw_implicit,upw_implicit_parity,up,"
                    "up_parity,dem,dem_parity,probes,"
                    "large3d,large",
                    help="comma-separated phases to run after device and build")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import nlpartsol_tpu_torch  # noqa: F401  (fail before anything is printed)

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
    if "probes" in phases:
        rows += phase_probes(device)
    # the large legs are optional: only with most of the time limit ahead
    for dim, before_s in ((3, 420.0), (2, 480.0)):
        if "large" + _suffix(dim) in phases and time.perf_counter() - T_START < before_s:
            phase_large(device, dim)
            torch.cuda.empty_cache()

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
