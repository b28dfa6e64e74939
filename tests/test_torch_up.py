"""The mixed u-p slice: the port's ``up_step`` on the scatter, windowed and
fused engines against the JAX package's scatter, windowed and 'pallas'
steps from the same numpy state, by pid, at the JAX package's limits
between its engines (test_upw.py::test_up_pallas_parity: x atol 1e-6, λ
atol 1e-2 of its largest magnitude), with equal Newton iterations; the
fused step's launches by variant against the formula of
formulations/up.py's docstring; two of test_up.py's oracles through the
port; the fused residual's J·v against a float64 central difference; and
what the new steps do not hold yet raising with its ROADMAP.md item."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import up as jup
from nlpartsol_tpu.formulations.explicit import to_slot_layout as jslot
from nlpartsol_tpu.models import materials as jM
from nlpartsol_tpu.ops import windowed as jwin
from nlpartsol_tpu.shapefun import lme as jlme

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import dem as tdem
from nlpartsol_tpu_torch.formulations import implicit as tim
from nlpartsol_tpu_torch.formulations import up as tup
from nlpartsol_tpu_torch.formulations.courant import courant_dt
from nlpartsol_tpu_torch.models import materials as tM
from nlpartsol_tpu_torch.ops import fused_transfer as ft
from nlpartsol_tpu_torch.ops import solvers
from nlpartsol_tpu_torch.ops import windowed as twin

from _torch_port import (by_pid, cheap_jax_compiles, to_torch_box, to_torch_grid,  # noqa: F401
                         to_torch_materials, to_torch_particles)
from test_explicit import C, E_, RHO, bar_setup
from test_upw import column_setup

torch.set_num_threads(1)

BODY = np.asarray([0.0, -9.81], np.float32)


def _configs(transfer, box, shapefun="lme", **kw):
    cfg_j = jup.UpConfig(dt=2e-3, shapefun=shapefun, lme_params=jlme.LMEParams(gamma=3.0),
                         kinds=(jM.NEO_HOOKEAN,), transfer=transfer, active_box=box, **kw)
    cfg_t = convert.up_config_from_fields(
        {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})
    return cfg_j, cfg_t


def count_calls(monkeypatch):
    """Count the fused wrappers' calls by the launch key the kernel would
    count them under (the plain versions launch nothing on the CPU)."""
    calls = {}
    real_s, real_g = ft.fused_scatter, ft.fused_gather

    def scatter(*a, solve=True, gnorm=False, G_t=None, **kw):
        key = "+".join(k for k, on in (("solve", solve), ("G", G_t is not None),
                                       ("gnorm", gnorm)) if on)
        calls[f"scatter:{key}"] = calls.get(f"scatter:{key}", 0) + 1
        return real_s(*a, solve=solve, gnorm=gnorm, G_t=G_t, **kw)

    def gather(*a, gN=None, g_grad=None, **kw):
        key = "+".join(k for k, on in (("N", gN is not None), ("grad", g_grad is not None)) if on)
        calls[f"gather:{key}"] = calls.get(f"gather:{key}", 0) + 1
        return real_g(*a, gN=gN, g_grad=g_grad, **kw)

    monkeypatch.setattr(ft, "fused_scatter", scatter)
    monkeypatch.setattr(ft, "fused_gather", gather)
    return calls


@pytest.mark.parametrize("transfer", ["scatter", "windowed", "pallas"])
def test_up_steps_match_jax(transfer, monkeypatch):
    """test_upw.py::test_up_pallas_parity's column (capacity-8 box over the
    grid, dt 2e-3, gravity; LME γ=3 on the fused engine, FEM on the others)
    from the same state, 2 steps on the fused engine and 1 on the others (a
    step takes seconds of forward mode on the CPU): x within 1e-6 and λ
    within 1e-2 of its largest magnitude, by pid, equal Newton iterations,
    converged, nothing lost; on the fused engine the launches of the
    docstring's formula."""
    grid, p, mats, _, _, _ = column_setup()
    box = jwin.full_box(grid, capacity=8)
    # the plain engines with FEM (the oracles' shape functions; its JAX
    # program compiles in a third of LME's time), the fused one with LME
    cfg_j, cfg_t = _configs(transfer, box if transfer != "scatter" else None,
                            shapefun="lme" if transfer == "pallas" else "fem")
    assert cfg_t.transfer == {"pallas": "fused"}.get(transfer, transfer)
    pj = p if transfer == "scatter" else jslot(p, grid, box)
    tp, tg, tm = to_torch_particles(pj), to_torch_grid(grid), to_torch_materials(mats)
    step = jax.jit(jup.up_step, static_argnums=(3,))
    calls = count_calls(monkeypatch)
    solvers.reset_host_syncs()
    n = L = 0
    steps = 2 if transfer == "pallas" else 1
    for _ in range(steps):
        pj, dj = step(pj, grid, mats, cfg_j, jnp.asarray(BODY))
        tp, dt_ = tup.up_step(tp, tg, tm, cfg_t, torch.as_tensor(BODY))
        assert bool(dt_["converged"]) and bool(dj["converged"])
        assert int(dt_["lost"]) == int(dj["lost"]) == 0
        assert int(dt_["nnz"]) == int(dj["nnz"])
        assert dt_["newton_iters"] == int(dj["newton_iters"])
        n, L = n + dt_["newton_iters"], L + dt_["cg_iters"]
    got, ref = by_pid(tp, ("x", "pw")), by_pid(pj, ("x", "pw"))
    l_scale = max(1.0, float(np.abs(ref["pw"]).max()))
    assert l_scale > 10.0, "no pressure built up"
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["pw"], ref["pw"], rtol=0, atol=1e-2 * l_scale)
    if transfer == "pallas":
        R = steps + 5 * n
        V = n + solvers.host_syncs["krylov"] + 21 * L // 20
        assert calls == {"scatter:solve+gnorm": steps, "gather:grad": steps,
                         "gather:N+grad": steps + R + 2 * V, "scatter:G": R + 2 * V,
                         "gather:N": steps}, (calls, n, L)


def _bar(V, nu=0.0):
    """test_explicit.py's FEM bar for the port: a sine velocity of amplitude
    V along x, Neo-Hookean E 1e7, ν ``nu``."""
    grid, p, _, L, h = bar_setup("fem")
    vx = V * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
    tp = to_torch_particles(p).replace(
        v=torch.as_tensor(np.stack([vx, np.zeros_like(vx)], -1), dtype=torch.float32))
    tm = tM.material_table([tM.material(kind="Neo-Hookean-Wriggers", E=E_, nu=nu, rho0=RHO)],
                           device="cpu")
    return to_torch_grid(grid), tp, tm, L, h


def test_up_matches_displacement_formulation_compressible():
    """test_up.py:17 through the port: for a compressible material the u-p
    step (scatter engine) reproduces the pure-displacement Newmark step
    (windowed engine over the bar) within 0.05 of the largest displacement,
    each step within 20 Newton iterations."""
    tg, tp, tm, L, h = _bar(0.01)
    dt = courant_dt(1.0, h, C)
    n_steps = max(4, int(round((np.pi / 4 / (np.pi * C / L)) / dt)))
    cfg_u = tim.ImplicitConfig(dt=dt, shapefun="fem", kinds=(tM.NEO_HOOKEAN,),
                               transfer="windowed", active_box=twin.full_box(tg, capacity=8))
    p_u, _ = tim.run(tp, tg, tm, cfg_u, n_steps)
    p_up, d_up = tup.run(tp, tg, tm, tup.UpConfig(dt=dt, shapefun="fem",
                                                  kinds=(tM.NEO_HOOKEAN,)), n_steps)
    du, dup = by_pid(p_u, ("dis",))["dis"], by_pid(p_up, ("dis",))["dis"]
    scale = np.abs(du).max()
    assert scale > 0
    err = np.abs(dup - du).max() / scale
    assert err < 0.05, f"u-p vs u displacement mismatch {err:.4f}"
    assert int(d_up["newton_iters"].max()) <= 20


def test_up_near_incompressible_converges():
    """test_up.py:75 through the port: ν = 0.499, 5 steps at dt = 2h/c_vol
    on the scatter engine: J stays finite and within 5e-3 of 1."""
    tg, tp, tm, L, h = _bar(0.005, nu=0.499)
    c_vol = np.sqrt(E_ / (3 * (1 - 2 * 0.499)) / RHO)
    cfg = tup.UpConfig(dt=courant_dt(2.0, h, c_vol), shapefun="fem", kinds=(tM.NEO_HOOKEAN,),
                       newton_maxiter=30)
    p1, _ = tup.run(tp, tg, tm, cfg, 5)
    J = p1.J.numpy()
    assert np.isfinite(J).all()
    assert np.abs(J - 1.0).max() < 5e-3, f"max |J-1| = {np.abs(J - 1).max():.2e}"


def test_fused_jv_matches_central_difference_float64(monkeypatch):
    """The J·v of the fused step's Newton-GMRES (forward mode through the
    stress, the deviator and the pressure field, GatherNGrad and ScatterNG)
    against (R(x + sv) − R(x − sv))/2s of the port's own scaled residual, in
    float64, at a nonzero iterate."""
    grid, p, mats, _, _, _ = column_setup()
    box = jwin.full_box(grid, capacity=8)
    _, cfg = _configs("pallas", box, newton_maxiter=0)
    tg, tb = to_torch_grid(grid), to_torch_box(box)
    tp = to_torch_particles(jslot(p, grid, box))

    def f64(r):
        return r.map_tensors(lambda a: a.double() if a.is_floating_point() else a)

    tp, tm = f64(tp), f64(to_torch_materials(mats))
    tg = tg.replace(dirichlet_value=tg.dirichlet_value.double())
    seen, real = {}, solvers.newton_krylov

    def spy(residual, x0, **kw):
        seen.update(residual=residual, M_inv=kw["M_inv"])
        return real(residual, x0, **kw)

    monkeypatch.setattr(solvers, "newton_krylov", spy)
    tup.up_step(tp, tg, tm, cfg.replace(active_box=tb), torch.as_tensor(BODY).double())
    R, M_inv = seen["residual"], seen["M_inv"]
    rng = np.random.default_rng(7)
    x = M_inv(torch.as_tensor(1e-3 * rng.standard_normal((tg.n_nodes, 3))))
    v = M_inv(torch.as_tensor(rng.standard_normal((tg.n_nodes, 3))))
    Jv = solvers.jvp(R, x, v)[1]
    s = 1e-5
    fd = (R(x + s * v) - R(x - s * v)) / (2 * s)
    assert float(Jv[:, 2].abs().max()) > 0.0 and float(Jv[:, :2].abs().max()) > 0.0
    torch.testing.assert_close(Jv, fd, rtol=1e-6, atol=1e-6 * float(fd.abs().max()))


def test_new_steps_refuse_what_waits():
    """What the u-p and DEM steps do not hold raises NotImplementedError
    naming its ROADMAP.md queue (the converters carry `prebinned` across);
    the fused engine's refusals stay ValueError."""
    _, (tg, tb, tp, lt) = _small_problem()
    mt = tM.material_table([tM.material(kind="Neo-Hookean-Wriggers", E=1e6, nu=0.3)],
                           device="cpu")
    for cls, step in ((tup.UpConfig, tup.up_step), (tdem.DEMConfig, tdem.dem_step)):
        cfg = cls(dt=1e-4, lme_params=lt, active_box=tb, transfer="fused")
        # axis_name and rebin_mode='none' run now (tests/test_torch_not_ported.py::
        # test_sharding_options_run[up,dem])
        for change, match in [(dict(transfer="binned"), "queue 2")]:
            with pytest.raises(NotImplementedError, match=match):
                step(tp, tg, mt, cfg.replace(**change), torch.zeros(2))
        for shapefun in ("fem", "gimp", "alme"):
            with pytest.raises(ValueError):
                step(tp, tg, mt, cfg.replace(shapefun=shapefun), torch.zeros(2))
    # the JAX configs' `prebinned` converts (the sharded drivers' pre-binned slots)
    for conv in (convert.up_config_from_fields, convert.dem_config_from_fields):
        assert conv({"dt": 1e-4, "prebinned": False}).transfer == "scatter"
        assert conv({"dt": 1e-4, "prebinned": True}).prebinned
    with pytest.raises(ValueError, match="discrete-gradient"):
        tdem.dem_step(tp, tg, mt, tdem.DEMConfig(dt=1e-4, lme_params=lt, active_box=tb,
                                                 transfer="fused",
                                                 stress_mode="average-strain"), torch.zeros(2))


def test_fused_3d_step_with_traction_fills_the_channel_cap(monkeypatch):
    """In 3D with tractions the fused step's λ-solve scatter carries 2 + 2d
    + d + 1 = 12 channels — the kernels' cap, ``fused_transfer.MAX_CN``
    (chip_smoke.py's kernels3d phase holds that case on the card) — whose
    traction columns sum to the total applied force (partition of unity),
    and the step's state stays finite with nothing lost."""
    from _torch_port import problem3

    _, (tg, tb, tp, lt) = problem3(seed=4)
    mt = tM.material_table([tM.material(kind="Neo-Hookean-Wriggers", E=1e6, nu=0.3)],
                           device="cpu")
    seen, real = [], ft.fused_scatter

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append((a[6].shape[0], out[0]))
        return out

    monkeypatch.setattr(ft, "fused_scatter", spy)
    traction = torch.zeros_like(tp.x)
    traction[:, 2] = -1e3
    area = torch.full((tp.count,), 1e-3)
    cfg = tup.UpConfig(dt=1e-4, lme_params=lt, active_box=tb, transfer="fused",
                       newton_maxiter=0)
    p1, diag = tup.up_step(tp, tg, mt, cfg, torch.zeros(3), traction, area)
    cN, nodes = seen[0]
    assert cN == ft.MAX_CN == 12
    force = float((area * traction[:, 2])[tp.active].sum())
    np.testing.assert_allclose(float(nodes[:, 2 + 2 * 3 + 2].sum()), force, rtol=1e-5)
    assert int(diag["lost"]) == 0
    act = p1.active
    assert bool(torch.isfinite(p1.x[act]).all()) and bool(torch.isfinite(p1.pw[act]).all())


def _small_problem():
    from _torch_port import problem

    return problem(seed=3, n_side=8, n_particles=40)
