"""CPU probes behind the choices of chip_smoke.py's fracture, shape-function
and scatter phases (not a test: pytest does not collect it).  Each prints
one JSON line.

    JAX_PLATFORMS=cpu python tests/torch_fracture_probe.py jax-engines 2 128
    JAX_PLATFORMS=cpu python tests/torch_fracture_probe.py jax-engines 3 32
    JAX_PLATFORMS=cpu python tests/torch_fracture_probe.py jax-implicit 64
    python tests/torch_fracture_probe.py rehearse fracture 2 96
    python tests/torch_fracture_probe.py rehearse fracture 3 32
    python tests/torch_fracture_probe.py rehearse fracture_implicit 64
    python tests/torch_fracture_probe.py rehearse shapefuns 64
    python tests/torch_fracture_probe.py rehearse scatter 32

jax-engines DIM N: chip_smoke's fracture problem (``build_fracture``) at
N^DIM nodes carried across as numpy to the JAX package, both drivers, the
parity steps of the phase on the JAX windowed and 'pallas' engines from the
same state, matched by pid: rel_dx, rel_dv, the share of particles whose
damage differs, the damage and strain_f gaps over their largest values,
and the band's share and far field as the phase gates them.
``chip_smoke.FRACTURE_PARITY`` is set from these spreads.
jax-implicit N: the same for the implicit eigenerosion problem
(``phase_fracture_implicit``'s), 2 steps, with the Newton counts.
rehearse PHASE ARGS: the chip_smoke phase on the CPU at a small size (the
fused kernels' plain versions; CUDA events, memory counters and
torch.profiler's device table stubbed): ``fracture DIM N``,
``fracture_implicit N`` (its parity leg at N/2), ``shapefuns N`` (its parity
leg at N/2), ``scatter N``.
"""

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _jax_state(p, grid, box, mats):
    """The port's records as the JAX package's, through numpy."""
    import jax.numpy as jnp

    from nlpartsol_tpu.models import materials as jM
    from nlpartsol_tpu.ops import windowed as jwin
    from nlpartsol_tpu.types import Grid as JGrid, Particles as JParticles
    from nlpartsol_tpu_torch import convert

    pj = JParticles(**{k: jnp.asarray(v) for k, v in convert.particles_to_numpy(p).items()})
    gj = JGrid(dims=grid.dims, spacing=grid.spacing, origin=grid.origin)
    bj = jwin.ActiveBox(offset=box.offset, cdims=box.cdims, capacity=box.capacity)
    mj = jM.MaterialTable(**{f.name: jnp.asarray(getattr(mats, f.name).cpu().numpy())
                             for f in dataclasses.fields(mats)})
    return pj, gj, bj, mj


def _by_pid(p, names):
    act = np.asarray(p.active)
    order = np.argsort(np.asarray(p.pid)[act])
    return [np.asarray(getattr(p, n))[act][order] for n in names]


def _spread(pf, pw, h):
    xf, vf, df, sf = _by_pid(pf, ("x", "v", "damage", "strain_f"))
    xw, vw, dw, sw = _by_pid(pw, ("x", "v", "damage", "strain_f"))
    return dict(rel_dx=float(np.abs(xf - xw).max() / h),
                rel_dv=float(np.abs(vf - vw).max() / np.abs(vw).max()),
                damage_differs=int(np.sum(df != dw)),
                trigger_differs=int(np.sum((sf > 0) != (sw > 0))),
                damage_gap=float(np.abs(df - dw).max() / max(np.abs(dw).max(), 1e-30)),
                strain_f_gap=float(np.abs(sf - sw).max() / max(np.abs(sw).max(), 1e-30)),
                damaged=[int((df > 0).sum()), int((dw > 0).sum())],
                triggered=[int((sf > 0).sum()), int((sw > 0).sum())])


def _shares(p, h, damage):
    """chip_smoke._fracture_shares on a JAX state."""
    from nlpartsol_tpu_torch import convert
    from nlpartsol_tpu_torch.types import Particles

    q = convert.particles_from_numpy(
        {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(Particles)},
        device="cpu")
    return cs._fracture_shares(q, h, damage)


def jax_engines(dim, n_side):
    import jax

    from nlpartsol_tpu.formulations import explicit as jex
    from nlpartsol_tpu.shapefun import lme as jlme
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout

    jax.config.update("jax_platforms", "cpu")
    spec = cs.FRACTURE[dim]
    out = {}
    for damage in ("eigenerosion", "eigensoftening"):
        grid, p, mats, cfg, h = cs.build_fracture(dim, n_side, "cpu", damage)
        p = to_slot_layout(p, grid, cfg.active_box)
        pj, gj, bj, mj = _jax_state(p, grid, cfg.active_box, mats)
        res = {}
        for transfer in ("windowed", "pallas"):
            cj = jex.ExplicitConfig(dt=cfg.dt, lme_params=jlme.LMEParams(gamma=3.0),
                                    kinds=cfg.kinds, transfer=transfer, active_box=bj,
                                    rebin_every=1, damage=damage, beps_reach=cfg.beps_reach)
            t0 = time.perf_counter()
            n_steps = spec["parity_steps"]
            res[transfer] = jax.jit(lambda q, c=cj: jex.run(q, gj, mj, c, n_steps)[0])(pj)
            res[transfer + "_s"] = time.perf_counter() - t0
        out[damage] = dict(_spread(res["pallas"], res["windowed"], h),
                           shares=_shares(res["pallas"], h, damage),
                           seconds=[res["windowed_s"], res["pallas_s"]])
    print(json.dumps(dict(probe="jax-engines", dim=dim, n_side=n_side,
                          steps=spec["parity_steps"], results=out)))


def jax_implicit(n_side):
    import jax
    import jax.numpy as jnp

    from nlpartsol_tpu.formulations import implicit as jim
    from nlpartsol_tpu.shapefun import lme as jlme
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout

    jax.config.update("jax_platforms", "cpu")
    grid, p, mats, cfg, h = cs.build_fracture_implicit(n_side, "cpu")
    p = to_slot_layout(p, grid, cfg.active_box)
    pj, gj, bj, mj = _jax_state(p, grid, cfg.active_box, mats)
    res, newton = {}, {}
    for transfer in ("windowed", "pallas"):
        cj = jim.ImplicitConfig(dt=cfg.dt, lme_params=jlme.LMEParams(gamma=3.0),
                                kinds=cfg.kinds, transfer=transfer, active_box=bj,
                                cg_maxiter=cfg.cg_maxiter, newton_maxiter=cfg.newton_maxiter,
                                forcing=cfg.forcing, damage="eigenerosion",
                                beps_reach=cfg.beps_reach)
        step = jax.jit(lambda q, c=cj: jim.implicit_step(q, gj, mj, c, jnp.zeros(2)))
        q, its = pj, []
        for _ in range(cs.FRACTURE_IMPLICIT["parity_steps"]):
            q, dg = step(q)
            its.append((int(dg["newton_iters"]), bool(dg["converged"])))
        res[transfer], newton[transfer] = q, its
    print(json.dumps(dict(probe="jax-implicit", n_side=n_side,
                          results=dict(_spread(res["pallas"], res["windowed"], h),
                                       newton=newton,
                                       shares=_shares(res["pallas"], h, "eigenerosion")))))


class _Event:
    def __init__(self, **kw):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def _stub_cuda():
    """The card's timing and memory calls as host no-ops, the profiler's
    device table as the host's, and the kernels' plain versions counted as
    the kernels count their launches (the rehearsal checks the phases'
    logic)."""
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.Event = _Event
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.empty_cache = lambda *a, **k: None

    from nlpartsol_tpu_torch.ops import fused_transfer as ft

    scatter, gather = ft._scatter_plain, ft._gather_plain

    def counted_scatter(grid, box, params, x_t, lam_t, act_t, fN_t, G_t, solve, margin, gnorm):
        ft._count_launch(f"lme_scatter{grid.dim}d", solve=solve, G=G_t is not None, gnorm=gnorm)
        return scatter(grid, box, params, x_t, lam_t, act_t, fN_t, G_t, solve, margin, gnorm)

    def counted_gather(grid, box, params, x_t, lam_t, act_t, gN, g_grad, margin):
        ft._count_launch(f"lme_gather{grid.dim}d", N=gN is not None, grad=g_grad is not None)
        return gather(grid, box, params, x_t, lam_t, act_t, gN, g_grad, margin)

    ft._scatter_plain, ft._gather_plain = counted_scatter, counted_gather

    def profiled(prof, host_ms, label):
        events = prof.key_averages()
        return dict(device_ms=0.0, device_kernels=sum(e.count for e in events),
                    device_busy_share=0.0)

    cs._profiled_step = profiled


def rehearse(phase, *args):
    torch.set_num_threads(4)
    _stub_cuda()
    t0 = time.perf_counter()
    if phase == "fracture":
        dim, n = int(args[0]), int(args[1])
        cs.FRACTURE[dim]["n_side"] = n
        cs.phase_fracture("cpu", dim)
    elif phase == "fracture_implicit":
        n = int(args[0])
        cs.FRACTURE_IMPLICIT.update(n_side=n, parity_n_side=n // 2)
        cs.phase_fracture_implicit("cpu")
    elif phase == "shapefuns":
        n = int(args[0])
        cs.SHAPEFUNS.update(n_side=n, parity_n_side=n // 2)
        cs.phase_shapefuns("cpu")
    elif phase == "scatter":
        cs.SCATTER["n_side"] = int(args[0])
        cs.phase_scatter("cpu")
    else:
        raise SystemExit(f"unknown phase {phase}")
    print(json.dumps(dict(probe="rehearse", phase=phase, args=args,
                          seconds=time.perf_counter() - t0)))


if __name__ == "__main__":
    cmd, rest = sys.argv[1], sys.argv[2:]
    if cmd == "jax-engines":
        jax_engines(int(rest[0]), int(rest[1]))
    elif cmd == "jax-implicit":
        jax_implicit(int(rest[0]))
    elif cmd == "rehearse":
        rehearse(*rest)
    else:
        raise SystemExit(__doc__)
