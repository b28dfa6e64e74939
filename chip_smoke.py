#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``nlpartsol_tpu_torch/csrc`` and drives the
port's main path — the 2D explicit LME step on the fused kernels — on the
card.  Each phase prints one JSON line; any failure ends the run with a
non-zero exit code.  Without a CUDA device the script fails at once.

Phases:
  device     card, nvidia-smi name and power limit, torch and CUDA versions
  build      nvcc build + load of the kernels
  kernels    every kernel variant against its plain PyTorch version on a
             128² grid (random positions and fields from a numpy seed)
  main_path  512² nodes, 262,144 particles, capacity-6 box of 260² cells,
             LME γ=3, Neo-Hookean, k=16 local rebin: 16 warm-up steps, 32
             timed steps through ``to_slot_layout`` + ``run``
  parity     the same 16 steps through the port's windowed engine on the
             card, matched by pid: rel_dx < 1e-3, rel_dv < 1e-2
  roofline   each kernel at the main path's shapes against its plain
             version: time, plain time, bound
  large      (if time allows) the fused path alone at 2048² nodes and
             4,194,304 particles
  profile    (only when asked: ``--phases main_path,profile``) where one
             16-step period of the main path spends its time: plain and
             re-bin step times, device-busy share, kernels per step

The line before the last is ``{"kernels": [...]}``; the last line is
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


def phase_build():
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    t0 = time.perf_counter()
    ft._library()
    say(phase="build", seconds=time.perf_counter() - t0, sources=["lme_transfer2d.cu"])


def _slot_problem(seed, n_side, lo_cell, n_cell, capacity, per_cell, drift, device):
    """Random particles in a box of ``n_cell``² cells starting at cell
    ``lo_cell``, binned to slots, then moved by up to ``drift`` cells."""
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
    from nlpartsol_tpu_torch.ops import windowed
    from nlpartsol_tpu_torch.types import Grid, make_particles

    rng = np.random.default_rng(seed)
    h = 1.0 / (n_side - 1)
    grid = Grid(dims=(n_side, n_side), spacing=h, origin=(0.0, 0.0))
    n = per_cell * n_cell * n_cell
    x = ((lo_cell + 1) + (n_cell - 2) * rng.random((n, 2))) * h
    p = make_particles(
        x.astype(np.float32),
        mass=rng.uniform(0.5, 2.0, n).astype(np.float32),
        vol0=np.full(n, h * h / per_cell, np.float32),
        device=device,
    )
    box = windowed.ActiveBox(offset=(lo_cell,) * 2, cdims=(n_cell,) * 2, capacity=capacity)
    p = to_slot_layout(p, grid, box, allow_lost=True)
    if drift:
        dx = torch.as_tensor(
            drift * h * (2.0 * rng.random((p.count, 2)) - 1.0), dtype=torch.float32,
            device=device)
        p = p.replace(x=p.x + dx)
    return rng, grid, box, p


def phase_kernels(device):
    from nlpartsol_tpu_torch.ops import fused_transfer as ft
    from nlpartsol_tpu_torch.shapefun import lme

    params = lme.LMEParams(gamma=3.0)
    cases = []

    def slot_inputs(p, box):
        C, nc = box.capacity, box.n_cells
        return (ft.to_channel_leading(p.x, C, nc),
                ft.to_channel_leading(p.lme_lambda, C, nc),
                ft.to_channel_leading(p.active.float(), C, nc))

    def rand(rng, *shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=device)

    def scatter_case(label, margin, has_G, gnorm, bounds=False, seed=0):
        rng, grid, box, p = _slot_problem(seed, 128, 14, 100, 6, 3, 0.9 * margin, device)
        if bounds:
            # valid node planes end where the particles end (they sit one
            # cell inside the box), cutting 2-3 planes out of every edge
            # particle's window; axis 1 is cut one plane further out
            lo, hi = box.offset[0] + 1, box.offset[0] + box.cdims[0] - 1
            grid = grid.replace(valid_lo=(lo, lo - 1), valid_hi=(hi, hi + 1))
        C, nc = box.capacity, box.n_cells
        x_t, lam_t, act_t = slot_inputs(p, box)
        vel = rand(rng, p.count, 2)
        fN = ft.to_channel_leading(
            torch.cat([p.mass[:, None], p.mass[:, None] * vel], dim=1), C, nc)
        G_t = ft.to_channel_leading(rand(rng, p.count, 4), C, nc) if has_G else None
        args = (grid, box, params, x_t, lam_t, act_t, fN)
        kw = dict(G_t=G_t, solve=True, margin=margin, gnorm=gnorm)
        nodes, lam, nnz = ft.fused_scatter(*args, **kw)
        torch.cuda.synchronize()
        r_nodes, r_lam, r_nnz = ft._scatter_plain(*args, G_t, True, margin, gnorm)
        out = dict(kernel="lme_scatter2d", case=label)
        out["N"] = compare(label + ":N", nodes[:, :3], r_nodes[:, :3], **TOL_N)
        if has_G or gnorm:
            out["grad"] = compare(label + ":grad", nodes[:, 3:], r_nodes[:, 3:], **TOL_GRAD)
        act = p.active
        out["lam"] = compare(
            label + ":lam", ft.from_channel_leading(lam)[act],
            ft.from_channel_leading(r_lam)[act], scale=1.0 / grid.spacing, **TOL_LAM)
        if int(nnz) != int(r_nnz):
            raise PhaseError(f"{label}: nnz {int(nnz)} != {int(r_nnz)}")
        out["nnz"] = int(nnz)
        out["ms"] = cuda_ms(lambda: ft.fused_scatter(*args, **kw), 5)
        out["plain_ms"] = cuda_ms(lambda: ft._scatter_plain(*args, G_t, True, margin, gnorm), 2)
        cases.append(out)

    def gather_case(label, with_grad, seed):
        margin = 1
        rng, grid, box, p = _slot_problem(seed, 128, 14, 100, 6, 3, 0.9 * margin, device)
        C, nc = box.capacity, box.n_cells
        x_t, lam_t, act_t = slot_inputs(p, box)
        dummy = ft.to_channel_leading(p.mass, C, nc)
        # gathers run at the λ the step's scatter solved
        _, lam_t, _ = ft._scatter_plain(grid, box, params, x_t, lam_t, act_t, dummy,
                                        None, True, margin, False)
        field = rand(rng, grid.n_nodes, 2)
        args = (grid, box, params, x_t, lam_t, act_t)
        kw = dict(gN=field, g_grad=field if with_grad else None, margin=margin)
        outN, grad = ft.fused_gather(*args, **kw)
        torch.cuda.synchronize()
        r_N, r_grad = ft._gather_plain(*args, field, kw["g_grad"], margin)
        out = dict(kernel="lme_gather2d", case=label)
        out["N"] = compare(label + ":N", outN, r_N, **TOL_N)
        if with_grad:
            out["grad"] = compare(label + ":grad", grad, r_grad, **TOL_GRAD)
        elif grad is not None:
            raise PhaseError(f"{label}: unexpected gradient output")
        inactive = ~p.active
        if float(outN[inactive].abs().max()) != 0.0:
            raise PhaseError(f"{label}: inactive slots not zero")
        out["ms"] = cuda_ms(lambda: ft.fused_gather(*args, **kw), 5)
        out["plain_ms"] = cuda_ms(lambda: ft._gather_plain(*args, field, kw["g_grad"], margin), 2)
        cases.append(out)

    scatter_case("solve,cN=3,margin=0", 0, False, False, seed=1)
    scatter_case("solve,cN=3,margin=1", 1, False, False, seed=2)
    scatter_case("solve,cN=3,G,margin=1", 1, True, False, seed=3)
    scatter_case("solve,cN=3,gnorm,margin=1", 1, False, True, seed=4)
    scatter_case("solve,cN=3,G,margin=0,valid_lo/hi", 0, True, False,
                 bounds=True, seed=5)
    gather_case("cN=2+grad,margin=1", True, seed=6)
    gather_case("cN=2,margin=1", False, seed=7)
    say(phase="kernels", grid="128x128", box="100x100 cells x capacity 6", cases=cases)


def build_problem(n_side, device, ppc=2, seed=0):
    """The benchmark problem of the JAX package's bench.py, rebuilt in numpy:
    particles 2×2 per cell over the central half, small random velocities."""
    from nlpartsol_tpu_torch.formulations.explicit import ExplicitConfig
    from nlpartsol_tpu_torch.models import materials as M
    from nlpartsol_tpu_torch.ops import windowed
    from nlpartsol_tpu_torch.shapefun import lme
    from nlpartsol_tpu_torch.types import Grid, make_particles

    h = 1.0 / (n_side - 1)
    grid = Grid(dims=(n_side, n_side), spacing=h, origin=(0.0, 0.0))
    lo_cell, hi_cell = n_side // 4, 3 * n_side // 4
    ncell = hi_cell - lo_cell
    i, j, a, b = np.meshgrid(
        np.arange(ncell), np.arange(ncell), np.arange(ppc), np.arange(ppc), indexing="ij"
    )
    x = np.stack(
        [(lo_cell + i + (a + 0.5) / ppc) * h, (lo_cell + j + (b + 0.5) / ppc) * h],
        axis=-1,
    ).reshape(-1, 2).astype(np.float32)
    vol = (h / ppc) ** 2
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
        offset=(n_side // 4 - 2,) * 2, cdims=(n_side // 2 + 4,) * 2, capacity=6
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
        rebin_every=16,
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


def phase_main_path(device, n_side=512, warm=16, steps=32):
    from nlpartsol_tpu_torch.formulations.explicit import run

    grid, p0, mats, cfg, h = build_problem(n_side, device)
    p1, _ = run(p0, grid, mats, cfg, warm)
    p2, diag, seconds, counts = _timed_run(p1, grid, mats, cfg, steps)
    lost = _check_state("main_path", p2, diag)
    n_active = int(p2.active.sum())
    if n_active != p0.count:
        raise PhaseError(f"main_path: {n_active} active particles of {p0.count}")
    total_nnz = int(diag["nnz"].long().sum())
    want = {"lme_scatter2d:solve": steps, "lme_scatter2d:G": steps,
            "lme_gather2d:N+grad": steps, "lme_gather2d:N": steps}
    if counts != want:
        raise PhaseError(f"main_path: launch counts {counts}, expected {want}")
    say(phase="main_path", grid=f"{n_side}x{n_side}", particles=p0.count, slots=cfg.active_box.n_slots,
        warmup_steps=warm, steps=steps, ms_per_step=1e3 * seconds / steps,
        total_nnz=total_nnz, nnz_per_step=total_nnz / steps, nnz_per_s=total_nnz / seconds,
        lost=lost, launches=counts, finite=True,
        kinetic_energy=float(diag["kinetic_energy"][-1]),
        strain_energy=float(diag["strain_energy"][-1]))
    return grid, p0, p1, mats, cfg, h, counts


def phase_parity(grid, p0, p1, mats, cfg, h, steps=16):
    from nlpartsol_tpu_torch.formulations.explicit import run

    cfg_w = cfg.replace(transfer="windowed", rebin_every=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pw, diag_w = run(p0, grid, mats, cfg_w, steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _check_state("parity", pw, diag_w)

    def by_pid(pp):
        act = pp.active
        pid = pp.pid[act]
        o = torch.argsort(pid)
        return pp.x[act][o], pp.v[act][o], pid[o]

    xf, vf, pid_f = by_pid(p1)
    xw, vw, pid_w = by_pid(pw)
    if pid_f.shape != pid_w.shape or not bool((pid_f == pid_w).all()):
        raise PhaseError("parity: particle sets differ")
    rel_dx = float((xf - xw).abs().max()) / h
    v_scale = max(float(vw.abs().max()), 1e-12)
    rel_dv = float((vf - vw).abs().max()) / v_scale
    ok = rel_dx < 1e-3 and rel_dv < 1e-2
    say(phase="parity", steps=steps, rel_dx=rel_dx, rel_dv=rel_dv,
        limit_dx=1e-3, limit_dv=1e-2, windowed_ms_per_step=1e3 * seconds / steps, ok=ok)
    if not ok:
        raise PhaseError(f"parity: rel_dx {rel_dx}, rel_dv {rel_dv}")


# Operations the function needs on this run's inputs, whatever the kernel
# computes again (it re-tests the window and re-evaluates f and exp in every
# sweep; none of that is charged twice).  An exp and a division count as one
# each.  Once per active slot and window offset: the edge test (node position,
# r, r², bounds) is 11.  Once per valid edge and evaluation of the basis at a
# new λ (each Newton iteration that ran, or the one evaluation at fixed λ): f
# is 5, exp 1, the six moments 14 (Z alone 1).  Once per valid edge: a shape
# value N 2, a gradient 10, one N-weighted channel 2 (multiply + add), the G
# product 8, a gradient-weighted gather 8.
OPS_TEST, OPS_F, OPS_MOM, OPS_N, OPS_DN, OPS_CH, OPS_G = 11, 5, 14, 2, 10, 2, 8


def _bound(n_bytes, n_ops):
    t_b, t_o = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOPS
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def phase_roofline(grid, p1, mats, cfg, counts):
    """Each kernel at the shapes (and on the state) the main path gives it,
    against its plain version: error, time, plain time, bound."""
    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    box, params, margin = cfg.active_box, cfg.lme_params, 1
    C, nc, ns = box.capacity, box.n_cells, box.n_slots
    n_nodes = grid.n_nodes
    p = p1
    dt = cfg.dt
    x_t = ft.to_channel_leading(p.x, C, nc)
    lam_t = ft.to_channel_leading(p.lme_lambda, C, nc)
    act_t = ft.to_channel_leading(p.active.float(), C, nc)
    d_dis = dt * p.v + 0.5 * dt * dt * p.a
    fN = ft.to_channel_leading(torch.cat([p.mass[:, None], p.mass[:, None] * d_dis], 1), C, nc)
    base = (grid, box, params, x_t)
    n_pairs = len(ft._geom(grid, params, margin).pairs)
    n_active = int(p.active.sum())
    n_idle = ns - n_active
    # bytes of one float32 channel over the active slots, the idle slots (the
    # function needs only ``active`` of an idle slot, and in the scatter its λ,
    # which passes through), all slots, and all nodes
    b_act, b_idle, b_all, b_nodes = 4 * n_active, 4 * n_idle, 4 * ns, 4 * n_nodes
    tests = n_active * n_pairs * OPS_TEST
    # 1 GiB: rewriting it keeps the card busy longer than the host needs to
    # queue the next launch, so the events bracket device time only
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=p.x.device)
    rows = []

    def row(name, replaces, fn_kernel, fn_plain, checks, n_bytes, n_ops):
        got, ref = fn_kernel(), fn_plain()
        torch.cuda.synchronize()
        err = 0.0
        for label, pick, tol in checks:
            err = max(err, compare(f"{name}:{label}", pick(got), pick(ref), **tol)["max_abs"])
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        rows.append(dict(
            name=name, route="cuda", source="nlpartsol_tpu_torch/csrc/lme_transfer2d.cu",
            replaces=replaces, launches=counts[name], max_abs_err=err,
            ms=cuda_ms(fn_kernel, 10, flush), plain_ms=cuda_ms(fn_plain, 2, flush),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            bytes=n_bytes, operations=n_ops))
        return got

    # scatter #1: λ solve + mass and momentum increment
    _, _, cnt = ft.scatter_cuda(grid, box, params, x_t, lam_t, act_t, fN, solve=True,
                                margin=margin)
    nnz, iters = (int(v) for v in cnt)
    # the last iteration's exponentials are those of the emitted basis
    ops = (tests
           + iters * (nnz / n_active) * (OPS_F + 1 + OPS_MOM)
           + nnz * (OPS_N + 3 * OPS_CH))
    nodes1, lam_new, _ = row(
        "lme_scatter2d:solve", "nlpartsol_tpu/ops/pallas_transfer.py:624",
        lambda: ft.fused_scatter(*base, lam_t, act_t, fN, solve=True, margin=margin),
        lambda: ft._scatter_plain(*base, lam_t, act_t, fN, None, True, margin, False),
        [("nodes", lambda o: o[0], TOL_N)],
        (8 + 2) * b_act + (3 + 2) * b_idle + 3 * b_nodes, ops)
    m_safe = torch.clamp(nodes1[:, 0], min=cfg.mass_tol)[:, None]
    d_dis_nodes = nodes1[:, 1:3] / m_safe

    # scatter #2: internal forces Σ G·∇N at fixed λ (G = −V0·τ of this state)
    G_t = ft.to_channel_leading((-p.vol0[:, None, None] * p.stress).reshape(-1, 4), C, nc)
    dummy = ft.to_channel_leading(torch.zeros_like(p.mass), C, nc)
    per_edge = OPS_F + 1 + OPS_MOM + OPS_N + OPS_DN + OPS_CH + OPS_G
    nodes2, _, _ = row(
        "lme_scatter2d:G", "nlpartsol_tpu/ops/pallas_transfer.py:624",
        lambda: ft.fused_scatter(*base, lam_new, act_t, dummy, G_t=G_t, solve=False,
                                 margin=margin),
        lambda: ft._scatter_plain(*base, lam_new, act_t, dummy, G_t, False, margin, False),
        [("forces", lambda o: o[0][:, 1:], TOL_GRAD)],
        (10 + 2) * b_act + (3 + 2) * b_idle + 3 * b_nodes, tests + nnz * per_edge)
    accel = (nodes2[:, 1:3] / m_safe).contiguous()

    # gather #1: smoothed Δu and its gradient
    per_edge = OPS_F + 1 + OPS_MOM + OPS_N + OPS_DN + 2 * OPS_CH + 8
    row("lme_gather2d:N+grad", "nlpartsol_tpu/ops/pallas_transfer.py:815",
        lambda: ft.fused_gather(*base, lam_new, act_t, gN=d_dis_nodes, g_grad=d_dis_nodes,
                                margin=margin),
        lambda: ft._gather_plain(*base, lam_new, act_t, d_dis_nodes, d_dis_nodes, margin),
        [("N", lambda o: o[0], TOL_N), ("grad", lambda o: o[1], TOL_GRAD)],
        5 * b_act + b_idle + 2 * b_nodes + 6 * b_all, tests + nnz * per_edge)

    # gather #2: accelerations
    per_edge = OPS_F + 1 + 1 + OPS_N + 2 * OPS_CH
    row("lme_gather2d:N", "nlpartsol_tpu/ops/pallas_transfer.py:815",
        lambda: ft.fused_gather(*base, lam_new, act_t, gN=accel, margin=margin),
        lambda: ft._gather_plain(*base, lam_new, act_t, accel, None, margin),
        [("N", lambda o: o[0], TOL_N)],
        5 * b_act + b_idle + 2 * b_nodes + 2 * b_all, tests + nnz * per_edge)

    say(phase="roofline", slots=ns, active=n_active, window_offsets=n_pairs, nnz=nnz,
        newton_iterations_per_active_slot=iters / n_active,
        peaks=dict(f32_flops=PEAK_F32_FLOPS, bytes_per_s=PEAK_BYTES_PER_S))
    return rows


def phase_profile(grid, p1, mats, cfg):
    """One k-period of the main path (k−1 plain steps, one that re-bins):
    host-clock step times, then a ``torch.profiler`` trace of one more such
    period for device time by kernel.  The busy share is the traced period's
    device time over the un-profiled period's host time."""
    from torch.profiler import ProfilerActivity, profile

    from nlpartsol_tpu_torch.formulations.explicit import explicit_step

    k = cfg.rebin_every
    body = torch.zeros(2, dtype=p1.x.dtype, device=p1.x.device)

    def period(p, timed=None):
        for i in range(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, _ = explicit_step(p, grid, mats, cfg, body, rebin=i == k - 1)
            torch.cuda.synchronize()
            if timed is not None:
                timed.append(1e3 * (time.perf_counter() - t0))
        return p

    times = []
    p = period(period(p1), times)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(k):
            p, _ = explicit_step(p, grid, mats, cfg, body, rebin=i == k - 1)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: an operator's own row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    total_us = sum(dev_us(e) for e in kernels)
    if total_us <= 0:
        raise PhaseError("profile: torch.profiler recorded no device time")
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    say(phase="profile", steps=k,
        plain_step_ms=float(np.median(times[:-1])), rebin_step_ms=times[-1],
        device_ms_per_step=1e-3 * total_us / k,
        device_busy_share=1e-3 * total_us / sum(times),
        device_kernels_per_step=sum(e.count for e in kernels) / k,
        top=[dict(name=e.key[:60], count=e.count, device_ms_per_step=1e-3 * dev_us(e) / k)
             for e in top])


def phase_large(device, steps=16):
    """The fused path alone at 2048² nodes / 4,194,304 particles.  No parity
    leg at this size: the plain engine's edge tensors would take tens of GB."""
    from nlpartsol_tpu_torch.formulations.explicit import run

    grid, p0, mats, cfg, _ = build_problem(2048, device)
    p1, _ = run(p0, grid, mats, cfg, steps)
    torch.cuda.reset_peak_memory_stats()
    p2, diag, seconds, _ = _timed_run(p1, grid, mats, cfg, steps)
    lost = _check_state("large", p2, diag)
    total_nnz = int(diag["nnz"].long().sum())
    say(phase="large", grid="2048x2048", particles=p0.count, slots=cfg.active_box.n_slots,
        steps=steps, ms_per_step=1e3 * seconds / steps, nnz_per_s=total_nnz / seconds,
        lost=lost, peak_device_bytes=torch.cuda.max_memory_allocated())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,main_path,parity,roofline,large",
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
    if "kernels" in phases:
        phase_kernels(device)
    if "main_path" in phases:
        grid, p0, p1, mats, cfg, h, counts = phase_main_path(device)
        if "profile" in phases:
            phase_profile(grid, p1, mats, cfg)
        if "parity" in phases:
            phase_parity(grid, p0, p1, mats, cfg, h)
        if "roofline" in phases:
            rows = phase_roofline(grid, p1, mats, cfg, counts)
        del p0, p1
        torch.cuda.empty_cache()
    # the 2048² leg is optional: only with most of the time limit still ahead
    if "large" in phases and time.perf_counter() - T_START < 300.0:
        phase_large(device)

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
