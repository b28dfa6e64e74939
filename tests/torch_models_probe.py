"""CPU probes behind the choices of chip_smoke.py's constitutive-model phases
(not a test: pytest does not collect it).  Each prints one JSON line.

    python tests/torch_models_probe.py fn-spread
    python tests/torch_models_probe.py rehearse 2 64
    python tests/torch_models_probe.py rehearse 3 24
    python tests/torch_models_probe.py calibrate 2 128
    python3 tests/torch_models_probe.py calibrate 2 512 cuda     (on a CUDA machine)
    JAX_PLATFORMS=cpu python tests/torch_models_probe.py jax-engines 64
    JAX_PLATFORMS=cpu python tests/torch_models_probe.py jax-engines 64 free
    JAX_PLATFORMS=cpu python tests/torch_models_probe.py borja-f32

fn-spread [ROWS]: ``models_fn``'s inputs (chip_smoke._model_fn_inputs) for
every kind in 2D and 3D through the port's stress update in float64 and in
float32 on the CPU: per output the largest float32 gap over the output's
largest magnitude (the rows in the yield band left out), the yield-band row
count and the seconds of each float32 call.  ``chip_smoke.MODELS_FN_TOL`` is
set from it.
rehearse DIM N [shares] [free]: ``models`` and ``models_parity`` (``models3d`` for DIM 3) on
the CPU at N^DIM nodes: chip_smoke.build_models, warm-up and timed steps on
the fused engine (the kernels' plain versions), each plastic kind's plastic
share, then the parity leg against the windowed engine: rel_dx, rel_dv and
the eps gap per kind; seconds per step (``shares``: without the parity
leg; ``free``: without the rigid frame, bench.py's free surfaces).
jax-engines N [free]: the 2D ``models_parity`` leg on the JAX package's windowed and
'pallas' engines from the same state (carried across as numpy), matched by
pid: rel_dx, rel_dv and the eps gap per kind.
card-shares [SCALE ...]: see ``card_shares`` (on a CUDA machine).
calibrate DIM N [DEVICE]: see ``calibrate``; on the card at the phases' own
sizes (512², 96³) it reads their shares directly.
borja-f32: the frictional kinds' return mapping of the JAX package in
float32 and float64 (jitted) and the port's in float32 and float64 on the
same 2,000 states at E 1e6 (confined, with deviatoric increments that yield
part of them): the stress gap of each to the JAX float64 result over its
largest magnitude (largest, 99th percentile).
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def fn_spread(rows=cs.MODELS_FN_ROWS):
    cs.MODELS_FN_ROWS = rows
    out = {}
    for dim in (2, 3):
        names, table = cs._fn_table(dim)
        for i, ((name, _), row) in enumerate(zip(cs.MODEL_STRIPS[2], names)):
            t0 = time.perf_counter()
            stats, banded, plastic, _ = cs.model_fn_compare(dim, name, row, table, i, "cpu",
                                                            torch.float64, seed=100 * dim + i)
            # the largest over the outputs, per statistic
            out[f"{name}/{dim}d"] = dict(
                {q: max(v[q] for v in stats.values()) for q in ("max", "q99", "median")},
                yield_band_rows=banded, plastic_share=plastic,
                seconds=time.perf_counter() - t0)
    print(json.dumps(dict(probe="fn-spread", rows=rows, results=out)))


def _shares(p, eps0, strips):
    return cs._plastic_shares(p, eps0, strips)


def rehearse(dim, n_side, parity=True, frame=True):
    from nlpartsol_tpu_torch.formulations.explicit import run

    torch.set_num_threads(4)
    spec = cs.MODELS[dim]
    grid, p0, mats, cfg, h, eps0 = cs.build_models(dim, n_side, "cpu", frame=frame)
    t0 = time.perf_counter()
    p1, diag = run(p0, grid, mats, cfg, spec["warm"] + spec["steps"])
    sec = (time.perf_counter() - t0) / (spec["warm"] + spec["steps"])
    cs._check_models_state("rehearse", p1, diag)
    shares = _shares(p1, eps0, cs.MODEL_STRIPS[dim])
    if not parity:
        print(json.dumps(dict(probe="rehearse", dim=dim, n_side=n_side, particles=p0.count,
                              dt=cfg.dt, s_per_step=sec, plastic_share=shares)))
        return
    steps = spec["parity_steps"]
    pf, df = run(p0, grid, mats, cfg, steps)
    pw, dw = run(p0, grid, mats, cfg.replace(transfer="windowed", rebin_every=1), steps)
    print(json.dumps(dict(probe="rehearse", dim=dim, n_side=n_side, particles=p0.count,
                          dt=cfg.dt, s_per_step=sec, plastic_share=shares,
                          **_engine_gaps(pf, pw, h, dim))))


def _engine_gaps(pf, pw, h, dim):
    """rel_dx, rel_dv, and per kind the eps gap over its largest value and
    the largest velocity gap over the largest speed, by pid."""
    rel_dx, rel_dv, (mf, mw), (ef, ew), (vf, vw) = cs._parity(
        pf, pw, h, "probe", names=("x", "v", "mat_id", "eps", "v"))
    v_scale = float(vw.abs().max())
    gaps, dv = {}, {}
    for i, (name, _) in enumerate(cs.MODEL_STRIPS[dim]):
        sel = mw == i
        gaps[name] = float((ef[sel] - ew[sel]).abs().max()) / max(float(ew[sel].abs().max()),
                                                                  1e-30)
        dv[name] = float((vf[sel] - vw[sel]).abs().max()) / v_scale
    return dict(rel_dx=rel_dx, rel_dv=rel_dv, eps_gap=gaps, rel_dv_by_kind=dv)


def jax_engines(n_side, frame=True):
    import jax
    import jax.numpy as jnp
    from nlpartsol_tpu.formulations import explicit as jex
    from nlpartsol_tpu.models import materials as jM
    from nlpartsol_tpu.ops import windowed as jwin
    from nlpartsol_tpu.shapefun import lme as jlme
    from nlpartsol_tpu.types import Grid as JGrid, Particles as JParticles

    from nlpartsol_tpu_torch import convert
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout

    jax.config.update("jax_disable_most_optimizations", True)
    grid, p0, mats, cfg, h, _ = cs.build_models(2, n_side, "cpu", frame=frame)
    p0 = to_slot_layout(p0, grid, cfg.active_box)
    pj = JParticles(**{k: jnp.asarray(v) for k, v in convert.particles_to_numpy(p0).items()})
    # the JAX step's Modified-Lade-Duncan fails at any particle count but 3
    # (its ddG_ddT broadcasts m on the wrong axis): that strip runs
    # Lade-Duncan here
    kind = mats.kind.numpy().copy()
    kind[kind == jM.MODIFIED_LADE_DUNCAN] = jM.LADE_DUNCAN
    mj = jM.MaterialTable(**{k: jnp.asarray(kind if k == "kind" else getattr(mats, k).numpy())
                             for k in vars(mats)})
    kinds = tuple(sorted(set(kind.tolist())))
    gj = JGrid(dims=grid.dims, spacing=grid.spacing, origin=grid.origin,
               **({} if not frame else dict(
                   dirichlet_mask=jnp.asarray(grid.dirichlet_mask.numpy()),
                   dirichlet_value=jnp.asarray(grid.dirichlet_value.numpy()))))
    box = cfg.active_box
    bj = jwin.ActiveBox(offset=box.offset, cdims=box.cdims, capacity=box.capacity)
    out = {}
    for transfer in ("windowed", "pallas"):
        c = jex.ExplicitConfig(dt=cfg.dt, lme_params=jlme.LMEParams(gamma=3.0), kinds=kinds,
                               transfer=transfer, active_box=bj,
                               rebin_every=1 if transfer == "windowed" else cfg.rebin_every)
        step = jax.jit(lambda q, c=c: jex.explicit_step(q, gj, mj, c, jnp.zeros(2)))
        q = pj
        for _ in range(cs.MODELS[2]["parity_steps"]):
            q, _ = step(q)
        out[transfer] = q
    to_t = {k: convert.particles_from_numpy(
        {f: np.asarray(getattr(v, f)) for f in convert._fields(type(p0))}, device="cpu")
        for k, v in out.items()}
    print(json.dumps(dict(probe="jax-engines", n_side=n_side,
                          **_engine_gaps(to_t["pallas"], to_t["windowed"], h, 2))))


def calibrate(dim, n_side, device="cpu"):
    """Elastic run of the models problem (every yield strength out of reach)
    recording, per particle, the extreme over the steps of the quantity each
    plastic kind compares with its strength; prints the strength that gives
    plastic shares 0.2, 0.5 and 0.8 over all particles of the strip and over
    its interior (the middle third of the strip in x, three cells off the
    frame), so that a share at a larger size, where the interior dominates,
    can be read off."""
    from nlpartsol_tpu_torch.formulations.explicit import explicit_step, to_slot_layout
    from nlpartsol_tpu_torch.models import druckerprager as dp
    from nlpartsol_tpu_torch.ops import tensor as tn

    torch.set_num_threads(4)
    strips = cs.MODEL_STRIPS[dim]
    grid, p, mats, cfg, h, eps0 = cs.build_models(dim, n_side, device)
    names = [name for name, _ in strips]
    big = {"Von-Mises": dict(kappa0=1e12), "Drucker-Prager": dict(kappa0=1e12)}
    fields = {}
    for i, name in enumerate(names):
        for k, v in big.get(name, {}).items():
            fields.setdefault(k, getattr(mats, k).clone())[i] = v
    for name in cs.FRICTIONAL_KINDS:
        if name in names:
            fields.setdefault("a1_borja", mats.a1_borja.clone())[names.index(name)] = 1e9
    mats = mats.replace(**fields)
    p = to_slot_layout(p, grid, cfg.active_box)
    big_kappa = torch.tensor(1e12, device=device)
    p = p.replace(kappa=torch.where(p.mat_id == names.index("Drucker-Prager"), big_kappa,
                                    p.kappa))
    for name in cs.FRICTIONAL_KINDS:
        if name in names:
            i = names.index(name)
            p = p.replace(kappa=torch.where(p.mat_id == i, torch.tensor(1e6, device=device),
                                            p.kappa))
    row_dp = dict(strips[names.index("Drucker-Prager")][1])
    aF, _, beta = dp.cone_parameters(torch.tensor(row_dp["friction_angle"], device=device),
                                     torch.tensor(row_dp["dilatancy_angle"], device=device), dim)
    ext = None
    steps = cs.MODELS[dim]["warm"] + cs.MODELS[dim]["steps"]
    t0 = time.perf_counter()
    for i in range(steps):
        rebin = (i % cfg.rebin_every == cfg.rebin_every - 1) if cfg.rebin_every > 1 else None
        p, _ = explicit_step(p, grid, mats, cfg, torch.zeros(dim, device=device), rebin=rebin)
        w = tn.sym_eig(p.stress.double())[0]
        if dim == 2:
            w = torch.cat([w, p.stress_zz.double()[:, None]], dim=1)
        mean = w.mean(1)
        j2 = (w - mean[:, None]).norm(dim=1)
        I1 = w.sum(1)
        I2 = w[:, 0] * w[:, 1] + w[:, 1] * w[:, 2] + w[:, 0] * w[:, 2]
        I3 = w.prod(1)
        # each kind yields where its strength lies below the measure: σy
        # (von Mises), κ0 (Drucker-Prager), κ_φ (the frictional family, on
        # compressive states: (9 + κ)·I3 > I1·I2 ⟺ κ < I1·I2/I3 − 9, …)
        meas = {"Von-Mises": j2 / np.sqrt(2.0 / 3.0),
                "Drucker-Prager": (j2 + 3.0 * aF * mean) / beta,
                "Matsuoka-Nakai": I1 * I2 / I3 - 9.0,
                "Lade-Duncan": I1 ** 3 / I3 - 27.0}
        if "Modified-Lade-Duncan" in names:
            row_mld = dict(strips[names.index("Modified-Lade-Duncan")][1])
            pw = (row_mld["atmospheric_pressure"] / I1).clamp(min=1e-12) ** row_mld["m_frictional"]
            meas["Modified-Lade-Duncan"] = (I1 ** 3 / I3 - 27.0) / pw
        meas = {k: v for k, v in meas.items() if k in names}
        order = torch.argsort(p.pid)
        cur = {k: v[order] for k, v in meas.items()}
        ext = cur if ext is None else {k: torch.fmax(ext[k], v) for k, v in cur.items()}
    seconds = time.perf_counter() - t0
    p = p.to("cpu")
    ext = {k: v.cpu() for k, v in ext.items()}
    act = p.active[torch.argsort(p.pid)]
    mid = p.mat_id[torch.argsort(p.pid)]
    x = p.x[torch.argsort(p.pid)]
    lo, hi = float(x[act, 0].min()), float(x[act, 0].max())
    width = (hi - lo) / len(names)
    frac = (x[:, 0] - lo) / width - mid.double()
    inner = (frac > 1 / 3) & (frac < 2 / 3)
    for a in range(1, dim):
        inner &= (x[:, a] > (n_side // 4 + 3) * h) & (x[:, a] < (3 * n_side // 4 - 3) * h)
    out = {}
    for name, m in ext.items():
        i = names.index(name)
        sel = act & (mid == i)
        res = {}
        for tag, s in (("all", sel), ("interior", sel & inner)):
            v = m[s]
            # the strength for share q: the (1 − q) quantile of the maximum
            res[tag] = {str(q): float(torch.quantile(v, 1.0 - q)) if v.numel() else None
                        for q in (0.2, 0.5, 0.8)}
            res[tag + "_n"] = int(s.sum())
        out[name] = res
    print(json.dumps(dict(probe="calibrate", dim=dim, n_side=n_side, device=str(device),
                          s_per_step=seconds / steps, strengths=out)))


def model_times(dim, n_side, variant="port", device="cuda"):
    """On the card: each kind's stress update alone on the whole slot state
    of the models problem after two steps (every model runs on every slot,
    as the dispatch runs it), timed with CUDA events (median of 3), and the
    top device operators of the slowest kind under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from nlpartsol_tpu_torch.formulations.explicit import run
    from nlpartsol_tpu_torch.models import dispatch, materials as M

    if variant == "solve_ex":
        # the 5x5 systems through the library's batched LU instead
        from nlpartsol_tpu_torch.models import borja
        borja.solve_small = lambda A, b: torch.linalg.solve_ex(A, b[..., None])[0][..., 0]
    grid, p0, mats, cfg, h, _ = cs.build_models(dim, n_side, device)
    p, _ = run(p0, grid, mats, cfg, 2)
    eye = torch.eye(dim, device=device)
    args = dict(F_n1=torch.where(p.active[:, None, None], p.F, eye), DF=eye.expand_as(p.F),
                dFdt_n1=p.dFdt, bemi=p.bemi, bemi_zz=p.bemi_zz, eps=p.eps, kappa=p.kappa,
                back_stress=p.back_stress, mat_id=p.mat_id, mats=mats)
    times = {}
    for name, _ in cs.MODEL_STRIPS[dim]:
        code = M.KIND_NAMES[name]
        fn = lambda: dispatch.stress_integration(kinds=(code,), **args)  # noqa: E731
        fn()
        times[name] = cs.cuda_ms(fn, 3)
    worst = max(times, key=times.get)
    code = M.KIND_NAMES[worst]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dispatch.stress_integration(kinds=(code,), **args)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    ev = [e for e in prof.key_averages() if dev_us(e) > 0]
    top = sorted(ev, key=dev_us, reverse=True)[:25]
    print(json.dumps(dict(probe="model-times", dim=dim, n_side=n_side, variant=variant,
                          slots=p.count,
                          ms=times, profiled=worst,
                          device_ms=1e-3 * sum(dev_us(e) for e in ev),
                          kernels=sum(e.count for e in ev),
                          top=[(e.key[:50], e.count, 1e-3 * dev_us(e)) for e in top])))


def borja_f32():
    """See the module docstring: 2,000 confined states at E 1e6 with a
    deviatoric part of 3e-3, Λ = 1 on the hardening law a1 = 10, a3 = 0.8."""
    import jax
    import jax.numpy as jnp
    from nlpartsol_tpu.models import borja as jb

    from nlpartsol_tpu_torch.models import borja as tb

    rng = np.random.default_rng(0)
    n, d = 2000, 2
    DF = np.eye(d) + 0.003 * rng.standard_normal((n, d, d))
    bemi = np.broadcast_to(np.expm1(-2e-3) * np.eye(d), (n, d, d)).copy()
    bemi_zz = np.full(n, np.expm1(-2e-3))
    lam, kap = np.ones(n), np.full(n, 10.0 * np.exp(-0.8))
    par = dict(E=1e6, nu=0.3, m=0.0, phi=0.0, a1=10.0, a2=0.0, a3=0.8, alpha=0.162)
    args = (bemi, bemi_zz, DF, lam, kap)
    out = {}
    for kind in ("matsuoka-nakai", "lade-duncan"):
        res = {}
        for dtype in ("float64", "float32"):
            with jax.enable_x64(dtype == "float64"):
                r = jax.jit(lambda *a, **k: jb.borja_frictional(
                    *a, yield_kind=kind, c0=0.0, psi=0.0, **k))(
                    *(jnp.asarray(a, dtype) for a in args),
                    **{k: jnp.asarray(v, dtype) for k, v in par.items()})
                res["jax_" + dtype] = np.asarray(r.tau, np.float64)
            t = tb.borja_frictional(*(torch.as_tensor(np.asarray(a, dtype)) for a in args),
                                    yield_kind=kind, **{k: torch.tensor(v, dtype=getattr(
                                        torch, dtype)) for k, v in par.items()})
            res["port_" + dtype] = t.tau.double().numpy()
        ref = res["jax_float64"]
        scale = float(np.abs(ref).max())
        out[kind] = {k: dict(max=float(np.abs(v - ref).max(axis=(1, 2)).max()) / scale,
                             q99=float(np.quantile(np.abs(v - ref).max(axis=(1, 2)), 0.99)) / scale)
                     for k, v in res.items() if k != "jax_float64"}
    print(json.dumps(dict(probe="borja-f32", gap_to_jax_float64_over_scale=out)))


def card_shares(*scales):
    """On the card: the 2D ``models`` problem (warm-up + timed steps) with
    the frictional κ0 of ``MODEL_KAPPA0`` scaled by each of ``scales``:
    each plastic kind's yielded share; then, at scale 1, the parity leg and
    for each frictional kind the particle with the largest eps gap: where it
    sits (x in strip widths from the strip's left edge, y in cells from the
    block's lower edge), its eps and principal stresses on both engines."""
    from nlpartsol_tpu_torch.formulations.explicit import run
    from nlpartsol_tpu_torch.ops import tensor as tn

    device, dim = "cuda", 2
    spec = cs.MODELS[dim]
    base = dict(cs.MODEL_KAPPA0[dim])
    out = {}
    for scale in map(float, scales or (1.0,)):
        cs.MODEL_KAPPA0[dim] = {k: v * scale for k, v in base.items()}
        grid, p0, mats, cfg, h, eps0 = cs.build_models(dim, cs.PROBLEMS[dim]["n_side"], device)
        p, _ = run(p0, grid, mats, cfg, spec["warm"] + spec["steps"])
        out[scale] = cs._plastic_shares(p, eps0, cs.MODEL_STRIPS[dim])
    cs.MODEL_KAPPA0[dim] = base
    grid, p0, mats, cfg, h, eps0 = cs.build_models(dim, cs.PROBLEMS[dim]["n_side"], device)
    steps = spec["parity_steps"]
    pf, _ = run(p0, grid, mats, cfg, steps)
    pw, _ = run(p0, grid, mats, cfg.replace(transfer="windowed", rebin_every=1), steps)
    names = ("x", "mat_id", "eps", "stress", "stress_zz")
    (_, ff), (_, fw) = cs._by_pid_fields(pf, names), cs._by_pid_fields(pw, names)
    n_strips = len(cs.MODEL_STRIPS[dim])
    x0 = fw[0][:, 0]
    lo, width = float(x0.min()), float(x0.max() - x0.min()) / n_strips
    worst = {}
    for i, (name, _) in enumerate(cs.MODEL_STRIPS[dim]):
        if name not in cs.FRICTIONAL_KINDS:
            continue
        sel = torch.nonzero(fw[1] == i)[:, 0]
        gap = (ff[2][sel] - fw[2][sel]).abs()
        k = sel[int(gap.argmax())]

        def principal(f):
            w = tn.sym_eig(f[3][k:k + 1].double())[0][0]
            return [float(v) for v in w] + [float(f[4][k])]

        worst[name] = dict(gap=float(gap.max()), eps_scale=float(fw[2][sel].abs().max()),
                           x_strips=(float(fw[0][k, 0]) - lo) / width - i,
                           y_cells=float(fw[0][k, 1]) / h - cs.PROBLEMS[dim]["n_side"] // 4,
                           eps=[float(ff[2][k]), float(fw[2][k])],
                           stress_fused=principal(ff), stress_windowed=principal(fw))
    print(json.dumps(dict(probe="card-shares", shares=out, worst_eps_gap=worst)))


if __name__ == "__main__":
    cmd, args = sys.argv[1], sys.argv[2:]
    if cmd == "fn-spread":
        fn_spread(*map(int, args))
    elif cmd == "rehearse":
        rehearse(int(args[0]), int(args[1]), parity="shares" not in args[2:],
                 frame="free" not in args[2:])
    elif cmd == "calibrate":
        calibrate(int(args[0]), int(args[1]), *args[2:])
    elif cmd == "borja-f32":
        borja_f32()
    elif cmd == "card-shares":
        card_shares(*args)
    elif cmd == "model-times":
        model_times(int(args[0]), int(args[1]), *args[2:])
    elif cmd == "jax-engines":
        jax_engines(int(args[0]), frame="free" not in args[1:])
    else:
        raise SystemExit(f"unknown probe {cmd}")
