"""CPU probes behind the float32 findings of the u-pw slice (not a test:
pytest does not collect it).  Each prints one JSON line.

    JAX_PLATFORMS=cpu python tests/torch_upw_probe.py bench-implicit 32
    JAX_PLATFORMS=cpu python tests/torch_upw_probe.py engine-parity 128
    JAX_PLATFORMS=cpu python tests/torch_upw_probe.py newton-counts
    JAX_PLATFORMS=cpu python tests/torch_upw_probe.py gmres-f64
    JAX_PLATFORMS=cpu python tests/torch_upw_probe.py forward-mode-cost

bench-implicit N: one implicit u-pw step of scripts/bench_upw.py --implicit
at N² on the JAX package's windowed engine and on the port's fused engine
(plain versions): Newton and GMRES iterations, ‖R‖, converged.
engine-parity N: 8 explicit u-pw steps of bench_upw.py's problem at N² on
the port's two engines, pore-pressure gap over its largest value, in
float32 and (a child process) float64.
newton-counts: two implicit steps of
tests/test_upw.py::test_upw_implicit_pallas_parity's problem (water, dt
2e-3) on the JAX package's windowed and 'pallas' engines and on the port's
windowed and fused ones: Newton iterations a step.
gmres-f64: the port's and the JAX package's GMRES on one random system,
largest difference of the solutions over their largest value, float64 and
float32.
forward-mode-cost: µs per op of a product with a tensor without tangent,
under forward mode with dual tensors and without, and with the same tensor
made dual with a zero tangent.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(4)


def bench_fluid(n_side):
    """bench_upw.py's mixture on bench.build_problem(n_side): JAX records."""
    import jax.numpy as jnp
    from bench import build_problem
    from nlpartsol_tpu.formulations import upw as jupw
    from nlpartsol_tpu.models import materials as M
    from nlpartsol_tpu.ops import windowed

    grid, p, _, h = build_problem(n_side=n_side, ppc=2)
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=1e7, nu=0.3, rho0=2700.0),
         M.material(kind="Newtonian-Fluid-Compressible", rho0=1000.0, compressibility=2.2e7)])
    mix = jupw.make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=1e-5)])
    box = windowed.ActiveBox(offset=(n_side // 4 - 2,) * 2, cdims=(n_side // 2 + 4,) * 2,
                             capacity=6)
    c_mix = float(np.sqrt((2.2e7 / 0.4) / 1700.0))
    return (grid, jupw.init_mixture_state(p, mats, mix), mats, mix, box, h, c_mix,
            jnp.asarray([0.0, -9.81], jnp.float32))


def port_records(grid, p, mats, mix):
    from _torch_port import fields_to_numpy, to_torch_grid, to_torch_materials, to_torch_particles
    from nlpartsol_tpu_torch import convert

    return (to_torch_grid(grid), to_torch_particles(p), to_torch_materials(mats),
            convert.mixture_from_numpy(fields_to_numpy(mix), device="cpu"))


def bench_implicit(n_side):
    import dataclasses
    import jax

    from nlpartsol_tpu.formulations import upw as jupw
    from nlpartsol_tpu.formulations.explicit import to_slot_layout
    from nlpartsol_tpu.models import materials as M
    from nlpartsol_tpu.shapefun import lme
    from nlpartsol_tpu_torch import convert
    from nlpartsol_tpu_torch.formulations import upw as tupw

    grid, p, mats, mix, box, h, c_mix, body = bench_fluid(n_side)
    cfg = jupw.UpwImplicitConfig(dt=20 * 0.25 * h / c_mix, shapefun="lme",
                                 lme_params=lme.LMEParams(gamma=3.0), kinds=(M.NEO_HOOKEAN,),
                                 transfer="windowed", active_box=box)
    pj = to_slot_layout(p, grid, box)
    pj1, dj = jax.jit(jupw.upw_newmark_step, static_argnums=(4,))(pj, grid, mats, mix, cfg, body)
    cfg_t = convert.upw_implicit_config_from_fields(
        {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}).replace(transfer="fused")
    tg, tp, tm, tmix = port_records(grid, pj, mats, mix)
    _, dt_ = tupw.upw_newmark_step(tp, tg, tm, tmix, cfg_t, torch.as_tensor(np.asarray(body)))

    def row(d):
        return dict(newton=int(d["newton_iters"]), gmres=int(d["cg_iters"]),
                    residual=float(d["newton_residual"]), converged=bool(d["converged"]))

    return dict(n_side=n_side, jax_windowed=row(dj), port_fused_plain=row(dt_))


def engine_parity(n_side, steps=8):
    if os.environ.get("NLPS_DTYPE") != "float64":
        child = subprocess.run(
            [sys.executable, __file__, "engine-parity", str(n_side)], capture_output=True,
            text=True, env={**os.environ, "NLPS_DTYPE": "float64"}, check=True)
        f64 = json.loads(child.stdout.strip().splitlines()[-1])
    import chip_smoke as cs
    from nlpartsol_tpu_torch.formulations import upw

    grid, p0, mats, mix, cfg, h = cs.build_upw("cpu", implicit=False, n_side=n_side)
    body = cs._upw_body(p0)
    pf, _ = upw.run(p0, grid, mats, mix, cfg, steps, body)
    pw, _ = upw.run(p0, grid, mats, mix, cfg.replace(transfer="windowed"), steps, body)
    out, _ = cs._upw_parity(pf, pw, h, "engine-parity", 1.0)
    res = dict(n_side=n_side, steps=steps, dtype=str(p0.x.dtype), rel_dpw=out["rel_dpw"],
               rel_dv=out["rel_dv"])
    if os.environ.get("NLPS_DTYPE") != "float64":
        res = dict(float32=res, float64=f64)
    return res


def newton_counts(steps=2):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from nlpartsol_tpu.formulations import upw as jupw
    from nlpartsol_tpu.formulations.explicit import to_slot_layout
    from nlpartsol_tpu.models import materials as M
    from nlpartsol_tpu.ops import windowed
    from nlpartsol_tpu.shapefun import lme
    from nlpartsol_tpu_torch import convert
    from nlpartsol_tpu_torch.formulations import upw as tupw
    from test_upw import column_setup

    grid, p, mats, mix, h, H = column_setup()
    box = windowed.full_box(grid, capacity=8)
    pj0 = to_slot_layout(p, grid, box)
    body = jnp.asarray([0.0, -9.81], jnp.float32)
    out = {}
    for transfer in ("windowed", "pallas"):
        cfg = jupw.UpwImplicitConfig(dt=2e-3, shapefun="lme", lme_params=lme.LMEParams(gamma=3.0),
                                     kinds=(M.NEO_HOOKEAN,), transfer=transfer, active_box=box)
        cfg_t = convert.upw_implicit_config_from_fields(
            {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
        step = jax.jit(jupw.upw_newmark_step, static_argnums=(4,))
        pj, (tg, tp, tm, tmix) = pj0, port_records(grid, pj0, mats, mix)
        counts = {"jax": [], "port": []}
        for _ in range(steps):
            pj, dj = step(pj, grid, mats, mix, cfg, body)
            tp, dt_ = tupw.upw_newmark_step(tp, tg, tm, tmix, cfg_t,
                                            torch.as_tensor(np.asarray(body)))
            counts["jax"].append(int(dj["newton_iters"]))
            counts["port"].append(dt_["newton_iters"])
        out[transfer] = counts
    return out


def gmres_f64():
    import jax

    jax.config.update("jax_enable_x64", True)
    from nlpartsol_tpu.ops import solvers as jsol
    from nlpartsol_tpu_torch.ops import solvers as tsol

    rng = np.random.default_rng(0)
    n = 300
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.logspace(0, 3, n)) @ Q.T + 0.3 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    out = {}
    for dt in (np.float64, np.float32):
        Aj, bj = jax.numpy.asarray(A.astype(dt)), jax.numpy.asarray(b.astype(dt))
        At, bt = torch.as_tensor(A.astype(dt)), torch.as_tensor(b.astype(dt))
        xj = np.asarray(jsol.gmres(lambda v: Aj @ v, bj, tol=0.1, max_cycles=10).x)
        xt = tsol.gmres(lambda v: At @ v, bt, tol=0.1, max_cycles=10).x.numpy()
        out[dt.__name__] = float(np.abs(xj - xt).max() / np.abs(xj).max())
    return out


def forward_mode_cost(reps=200):
    import torch.autograd.forward_ad as fwAD

    x, t, w = (torch.randn(160, 2, 2) for _ in range(3))

    def us(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e6 * (time.perf_counter() - t0) / reps

    plain = us(lambda: x * w)
    with fwAD.dual_level():
        d = fwAD.make_dual(x, t)
        dual_plain = us(lambda: d * w)
        dual_dual = us(lambda: d * d)
        w_zero = fwAD.make_dual(w, torch.zeros_like(w))  # the same w, a zero tangent
        dual_zero = us(lambda: d * w_zero)
    return dict(torch=torch.__version__, plain_us=plain, dual_times_plain_us=dual_plain,
                dual_times_dual_us=dual_dual, dual_times_zero_tangent_dual_us=dual_zero)


if __name__ == "__main__":
    what = sys.argv[1]
    arg = int(sys.argv[2]) if len(sys.argv) > 2 else None
    if what in ("bench-implicit", "newton-counts", "gmres-f64"):
        import jax

        jax.config.update("jax_platforms", "cpu")
    result = {"bench-implicit": lambda: bench_implicit(arg or 32),
              "engine-parity": lambda: engine_parity(arg or 128),
              "newton-counts": newton_counts,
              "gmres-f64": gmres_f64,
              "forward-mode-cost": forward_mode_cost}[what]()
    print(json.dumps(dict(probe=what, **result)), flush=True)
