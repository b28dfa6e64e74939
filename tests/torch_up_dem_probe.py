"""CPU probes behind the float32 findings of the u-p and DEM slice (not a
test: pytest does not collect it).  Each prints one JSON line.

    JAX_PLATFORMS=cpu python tests/torch_up_dem_probe.py jax-engines up 64
    JAX_PLATFORMS=cpu python tests/torch_up_dem_probe.py jax-engines dem 128
    JAX_PLATFORMS=cpu python tests/torch_up_dem_probe.py port-engines up 16 float64
    JAX_PLATFORMS=cpu python tests/torch_up_dem_probe.py port-engines up 32 float32 2000
    JAX_PLATFORMS=cpu python tests/torch_up_dem_probe.py jax-golden-windowed dem_bar
    python3 tests/torch_up_dem_probe.py card-spread 14        (on a CUDA machine)

jax-engines KIND N: two u-p or DEM steps of chip_smoke.py's bench problem
(bench.build_problem(N, ppc=2), its box, the u-p / DEM configurations of
chip_smoke.build_up_dem) on the JAX package's windowed and 'pallas' engines:
Newton and Krylov counts, and by pid the position gap over h, the λ gap over
its largest value (u-p: largest and root mean square) or the grid-energy
identity of each step (DEM).
port-engines KIND N DTYPE [KRYLOV_MAXITER]: the same two steps on the port's
fused (plain versions) and windowed engines, in float32 or float64 (u-p:
optionally with another GMRES budget than UpConfig's 200 a Newton step).
card-spread RUNS: see ``card_spread``.
jax-golden-windowed DECK: the reference binary's golden deck through the JAX
package's DEM step as tests/_e2e_worker.py runs it, but on the windowed
engine with a box over the whole grid at capacity 8, matched by pid: the
largest position gap to the golden trajectory after step 0 (the worker's
limit is 1e-8) and how many entries exceed it.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def jax_engines(kind, n_side):
    import jax
    import jax.numpy as jnp
    from bench import build_problem
    from nlpartsol_tpu.formulations import dem as jdem, up as jup
    from nlpartsol_tpu.formulations.explicit import to_slot_layout
    from nlpartsol_tpu.models import materials as M
    from nlpartsol_tpu.ops import windowed
    from nlpartsol_tpu.shapefun import lme

    jax.config.update("jax_disable_most_optimizations", True)
    grid, p, mats, h = build_problem(n_side=n_side, ppc=2)
    box = windowed.ActiveBox(offset=(n_side // 4 - 2,) * 2, cdims=(n_side // 2 + 4,) * 2,
                             capacity=6)
    c = float(np.sqrt(1e7 / 1000.0))
    out, hist = {}, {}
    for transfer in ("windowed", "pallas"):
        common = dict(lme_params=lme.LMEParams(gamma=3.0), kinds=(M.NEO_HOOKEAN,),
                      transfer=transfer, active_box=box)
        if kind == "up":
            cfg, step = jup.UpConfig(dt=2.0 * h / c, **common), jup.up_step
        else:
            cfg, step = jdem.DEMConfig(dt=h / c, **common), jdem.dem_step
        step = jax.jit(step, static_argnums=(3,))
        pp, rows = to_slot_layout(p, grid, box), []
        for _ in range(2):
            pp, d = step(pp, grid, mats, cfg, jnp.zeros((2,), jnp.float32))
            row = dict(newton=int(d["newton_iters"]), converged=bool(d["converged"]),
                       krylov=int(d["cg_iters"]) if "cg_iters" in d else None)
            if kind == "dem":
                row["identity"] = (abs(float(d["grid_energy_increment"]))
                                   / float(d["grid_kinetic_energy"]))
            rows.append(row)
        act = np.asarray(pp.active)
        order = np.argsort(np.asarray(pp.pid)[act])
        out[transfer] = (np.asarray(pp.x)[act][order], np.asarray(pp.pw)[act][order])
        hist[transfer] = rows
    (xw, lw), (xp, lp) = out["windowed"], out["pallas"]
    res = dict(probe="jax-engines", kind=kind, n_side=n_side, steps=hist,
               rel_dx=float(np.abs(xp - xw).max() / h))
    if kind == "up":
        gap = np.abs(lp - lw) / np.abs(lw).max()
        res.update(lambda_max=float(np.abs(lw).max()), rel_dlambda=float(gap.max()),
                   rms_dlambda=float(np.sqrt(np.mean(gap ** 2))))
    return res


def port_engines(kind, n_side, dtype, krylov_maxiter=None):
    import torch

    import chip_smoke
    from nlpartsol_tpu_torch import config

    torch.set_num_threads(4)
    config.set_dtype(dtype)
    grid, p, mats, cfg, h = chip_smoke.build_up_dem("cpu", kind, n_side=n_side)
    if krylov_maxiter is not None:
        cfg = cfg.replace(krylov_maxiter=krylov_maxiter)
    if dtype == "float64":
        p, mats = (r.map_tensors(lambda a: a.double() if a.is_floating_point() else a)
                   for r in (p, mats))
    torch.cuda.synchronize = lambda *a, **k: None  # the phases' helpers sync the card
    runs, hist = {}, {}
    for transfer in ("fused", "windowed"):
        q, rows = chip_smoke._up_dem_steps(transfer, kind, p, grid, mats,
                                           cfg.replace(transfer=transfer), 2)
        runs[transfer] = q
        hist[transfer] = [dict(newton=r[0], krylov=r[1], converged=r[5], identity=r[6])
                          for r in rows]
    names = ("x", "v", "pw") if kind == "up" else ("x", "v")
    rel_dx, rel_dv, *more = chip_smoke._parity(runs["fused"], runs["windowed"], h, "probe",
                                               names)
    res = dict(probe="port-engines", kind=kind, n_side=n_side, dtype=dtype,
               krylov_maxiter=cfg.krylov_maxiter if kind == "up" else None, steps=hist,
               rel_dx=rel_dx, rel_dv=rel_dv)
    if kind == "up":
        (lf, lw), = more
        gap = (lf - lw).abs() / lw.abs().max()
        res.update(lambda_max=float(lw.abs().max()), rel_dlambda=float(gap.max()),
                   rms_dlambda=float((gap ** 2).mean().sqrt()))
    return res


def card_spread(runs):
    """On the card: the fused J·v check of chip_smoke.py three times per
    kind, then the u-p parity leg's two steps at 64² on the windowed engine
    three times and on the fused engine ``runs`` times, each against the
    first windowed run by pid; one JSON line per run."""
    import chip_smoke

    chip_smoke.phase_device()
    chip_smoke.phase_build()
    for rep in range(3):
        for kind in ("up", "dem"):
            print(json.dumps(dict(probe="card-jv", rep=rep, kind=kind,
                                  **chip_smoke._jv_check(kind, kind, "cuda"))), flush=True)
    grid, p, mats, cfg, h = chip_smoke.build_up_dem("cuda", "up", n_side=64)
    ref = None
    for rep, transfer in enumerate(["windowed"] * 3 + ["fused"] * runs):
        q, hist = chip_smoke._up_dem_steps(transfer, "up", p, grid, mats,
                                           cfg.replace(transfer=transfer), 2)
        if ref is None:
            ref = q
            continue
        rel_dx, rel_dv, (lf, lw) = chip_smoke._parity(q, ref, h, "probe", ("x", "v", "pw"))
        gap = (lf - lw).abs() / lw.abs().max()
        print(json.dumps(dict(probe="card-lambda", rep=rep, transfer=transfer, rel_dx=rel_dx,
                              rel_dv=rel_dv, rel_dlambda=float(gap.max()),
                              rms_dlambda=float((gap ** 2).mean().sqrt()),
                              newton=[x[0] for x in hist], krylov=[x[1] for x in hist],
                              converged=[x[5] for x in hist])), flush=True)


def jax_golden_windowed(deck_name):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from nlpartsol_tpu import config

    config.set_dtype("float64")
    import jax.numpy as jnp
    from nlpartsol_tpu.driver import make_step_config
    from nlpartsol_tpu.formulations.dem import dem_step
    from nlpartsol_tpu.formulations.explicit import to_slot_layout
    from nlpartsol_tpu.io.builder import build_simulation
    from nlpartsol_tpu.ops.windowed import full_box

    deck = os.path.join(ROOT, "tests", "golden", deck_name)
    setup = build_simulation(os.path.join(deck, "sim.nlp"))
    gold = np.genfromtxt(os.path.join(deck, "trajectory.csv"), delimiter=",", names=True)
    d = setup.grid.dim
    box = full_box(setup.grid, 8)
    cfg = make_step_config(setup, transfer="windowed", active_box=box).replace(
        stress_mode="average-strain")
    p = to_slot_layout(setup.particles, setup.grid, box)
    p, _ = jax.jit(dem_step, static_argnums=(3,))(p, setup.grid, setup.materials, cfg,
                                                   jnp.zeros((d,), jnp.float64))
    act = np.asarray(p.active)
    x = np.asarray(p.x)[act][np.argsort(np.asarray(p.pid)[act])]
    g0 = gold[gold["step"] == 0]
    gx = np.stack([g0[c] for c in ["x", "y", "z"][:d]], -1)
    perm = np.linalg.norm(gx[:, None, :] - x[None, :, :], axis=-1).argmin(axis=1)
    gap = np.abs(x[perm] - gx)
    return dict(probe="jax-golden-windowed", deck=deck_name, max_position_gap=float(gap.max()),
                entries_over_limit=int((gap > 1e-8).sum()), entries=int(gap.size))


if __name__ == "__main__":
    what = sys.argv[1]
    if what == "jax-engines":
        print(json.dumps(jax_engines(sys.argv[2], int(sys.argv[3]))))
    elif what == "port-engines":
        print(json.dumps(port_engines(sys.argv[2], int(sys.argv[3]), sys.argv[4],
                                      *[int(a) for a in sys.argv[5:6]])))
    elif what == "card-spread":
        card_spread(int(sys.argv[2]))
    elif what == "jax-golden-windowed":
        print(json.dumps(jax_golden_windowed(sys.argv[2])))
    else:
        raise SystemExit(f"unknown probe {what}")
