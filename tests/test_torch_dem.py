"""The Discrete Energy-Momentum slice: the port's ``dem_step`` against the
JAX package's from the same numpy state, by pid — on the windowed and
scatter engines in both stress modes, and on the fused engine against JAX's
'pallas' with the discrete gradient's grid-energy identity and the launch
formula of formulations/dem.py's docstring; two of test_dem.py's oracles
through the port (SVK energy conservation, momentum in free flight); and the
fused residual's J·v, forward mode over the reverse-mode ∂W/∂F, against a
float64 central difference."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import dem as jdem
from nlpartsol_tpu.formulations.explicit import to_slot_layout as jslot
from nlpartsol_tpu.models import materials as jM
from nlpartsol_tpu.ops import windowed as jwin
from nlpartsol_tpu.shapefun import lme as jlme

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import dem as tdem
from nlpartsol_tpu_torch.formulations.courant import courant_dt
from nlpartsol_tpu_torch.models import materials as tM
from nlpartsol_tpu_torch.ops import solvers

from _torch_port import (by_pid, cheap_jax_compiles, to_torch_grid,  # noqa: F401
                         to_torch_materials, to_torch_particles)
from test_explicit import C, E_, RHO, bar_setup
from test_torch_up import count_calls

torch.set_num_threads(1)

V_BAR = 0.05  # test_dem.py's finite amplitude: the nonlinearity matters


def _bar(shapefun, V=V_BAR, kind="Neo-Hookean-Wriggers"):
    """test_explicit.py's bar (20×2 cells, 160 particles, ends fixed in x,
    every node fixed in y) with a sine velocity of amplitude V, as the JAX
    package's arrays (the port's come through convert.py)."""
    grid, p, _, L, h = bar_setup(shapefun)
    mats = jM.material_table([jM.material(kind=kind, E=E_, nu=0.3, rho0=RHO)])
    vx = V * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1), jnp.float32))
    return grid, p, mats, L, h


def _configs(transfer, grid, h, shapefun, **kw):
    box = None if transfer == "scatter" else jwin.full_box(grid, capacity=8)
    cfg_j = jdem.DEMConfig(dt=1.0 * h / C, shapefun=shapefun,
                           lme_params=jlme.LMEParams(gamma=3.0), kinds=(jM.NEO_HOOKEAN,),
                           transfer=transfer, active_box=box, **kw)
    cfg_t = convert.dem_config_from_fields(
        {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})
    return cfg_j, cfg_t, box


def _steps(pj, tp, grid, mats, cfg_j, cfg_t, n):
    """n steps on both sides: equal Newton counts, converged, nothing lost;
    returns both states and the port's largest |grid energy increment| over
    the grid kinetic energy."""
    tg, tm = to_torch_grid(grid), to_torch_materials(mats)
    step = jax.jit(jdem.dem_step, static_argnums=(3,))
    ident = 0.0
    for _ in range(n):
        pj, dj = step(pj, grid, mats, cfg_j, jnp.zeros((2,), jnp.float32))
        tp, dt_ = tdem.dem_step(tp, tg, tm, cfg_t, torch.zeros(2))
        assert bool(dt_["converged"]) and bool(dj["converged"])
        assert int(dt_["lost"]) == int(dj["lost"]) == 0
        assert int(dt_["nnz"]) == int(dj["nnz"])
        assert dt_["newton_iters"] == int(dj["newton_iters"])
        ident = max(ident, abs(float(dt_["grid_energy_increment"]))
                    / float(dt_["grid_kinetic_energy"]))
    return pj, tp, ident


@pytest.mark.parametrize("transfer", ["windowed", "scatter"])
@pytest.mark.parametrize("mode", ["discrete-gradient", "average-strain"])
def test_dem_steps_match_jax(transfer, mode):
    """2 steps of the FEM bar (the goldens' shape functions; the fused test
    holds LME) at dt = h/c from the same state: x within 1e-6, v within 1e-5
    (test_dem.py::test_dem_pallas_parity_and_energy's limits between
    engines), F within 1e-6, by pid; equal Newton iterations."""
    grid, p, mats, _, h = _bar("fem")
    cfg_j, cfg_t, box = _configs(transfer, grid, h, "fem", stress_mode=mode)
    pj = p if box is None else jslot(p, grid, box)
    pj, tp, _ = _steps(pj, to_torch_particles(pj), grid, mats, cfg_j, cfg_t, 2)
    got, ref = by_pid(tp, ("x", "v", "F")), by_pid(pj, ("x", "v", "F"))
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["v"], ref["v"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["F"], ref["F"], rtol=0, atol=1e-6)


def test_dem_fused_matches_jax_pallas_and_energy(monkeypatch):
    """test_dem.py::test_dem_pallas_parity_and_energy's bar and engines
    (LME γ=3, capacity-8 box, dt = h/c), with the sine velocity of its SVK
    test (the JAX test starts at rest), 3 steps: x within 1e-6 and v within
    1e-5 of JAX's 'pallas' step by pid, equal Newton iterations, the
    discrete-gradient identity |ΔKE_grid + ΔW| < 5e-4 of the grid kinetic
    energy, and the launches of the docstring's formula."""
    grid, p, mats, _, h = _bar("lme")
    cfg_j, cfg_t, box = _configs("pallas", grid, h, "lme")
    assert cfg_t.transfer == "fused"
    pj = jslot(p, grid, box)
    calls = count_calls(monkeypatch)
    solvers.reset_host_syncs()
    pj, tp, ident = _steps(pj, to_torch_particles(pj), grid, mats, cfg_j, cfg_t, 3)
    got, ref = by_pid(tp, ("x", "v")), by_pid(pj, ("x", "v"))
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["v"], ref["v"], rtol=0, atol=1e-5)
    assert ident < 5e-4, ident
    n = solvers.host_syncs["newton"] - 3  # each step's last check ends its loop
    L = solvers.host_syncs["krylov"] - n  # each CG solve's last check ends it
    assert calls == {"scatter:solve+gnorm": 3, "gather:grad": 9 + 7 * n + 2 * L,
                     "scatter:G": 3 + 7 * n + 2 * L, "gather:N": 3}, (calls, n, L)


def test_dem_conserves_energy_svk():
    """test_dem.py:28 through the port (FEM, scatter engine): the SVK bar
    at a step 4× the explicit CFL; per step |ΔKE_grid + ΔW| < 5e-3 of the
    initial energy over the first 6 steps, and the particles' total energy
    within 5e-2 of it over 20 steps, each within 30 Newton iterations (one
    run of 20 steps: the JAX test steps the first 6 twice)."""
    grid, p, mats, _, h = _bar("fem", kind="Saint-Venant-Kirchhoff")
    tg, tp, tm = to_torch_grid(grid), to_torch_particles(p), to_torch_materials(mats)
    kinds = (tM.SAINT_VENANT_KIRCHHOFF,)
    cfg = tdem.DEMConfig(dt=courant_dt(1.0, h, C), shapefun="fem", kinds=kinds, newton_tol=1e-7)
    E0 = float(0.5 * torch.sum(tp.mass * torch.sum(tp.v ** 2, -1))
               + torch.sum(tdem._strain_energy(tp.F, tp, tm, kinds) * tp.vol0))
    assert E0 > 0
    pp, Etot = tp, []
    for i in range(20):
        pp, diag = tdem.dem_step(pp, tg, tm, cfg, torch.zeros(2))
        if i < 6:
            rel = abs(float(diag["grid_energy_increment"])) / E0
            assert rel < 5e-3, f"grid energy increment {rel:.2e} of E0"
        assert diag["newton_iters"] <= 30
        Etot.append(float(diag["kinetic_energy"] + diag["strain_energy"]))
    drift = np.abs(np.asarray(Etot) - E0).max() / E0
    assert drift < 5e-2, f"energy drift {drift:.2e}"


def test_dem_conserves_momentum_free_flight():
    """test_dem.py:69 through the port (FEM, scatter engine): the bar with
    no Dirichlet mask and no gravity keeps its linear momentum over 5 steps
    (rtol 1e-4, atol 1e-6), positions finite."""
    grid, p, mats, L, h = bar_setup("fem")
    tg = to_torch_grid(grid).replace(dirichlet_mask=None, dirichlet_value=None)
    v0 = np.zeros((p.count, 2), np.float32)
    v0[:, 0] = 0.02
    v0[:, 1] = 0.01 * np.sin(2 * np.pi * np.asarray(p.x)[:, 0] / L)
    tp = to_torch_particles(p).replace(v=torch.as_tensor(v0))
    tm = to_torch_materials(mats)
    mom0 = torch.sum(tp.mass[:, None] * tp.v, dim=0).numpy()
    cfg = tdem.DEMConfig(dt=courant_dt(1.0, h, C), shapefun="fem", kinds=(tM.NEO_HOOKEAN,))
    for _ in range(5):
        tp, _ = tdem.dem_step(tp, tg, tm, cfg, torch.zeros(2))
    mom = torch.sum(tp.mass[:, None] * tp.v, dim=0).numpy()
    np.testing.assert_allclose(mom, mom0, rtol=1e-4, atol=1e-6)
    assert np.isfinite(tp.x.numpy()).all()


def test_fused_jv_matches_central_difference_float64(monkeypatch):
    """The J·v of the fused step's Newton-CG — forward mode through the
    discrete gradient, whose ∂W/∂F is reverse mode, and through GatherGrad
    and ScatterG — against (R(x + sv) − R(x − sv))/2s of the port's own
    residual, in float64, at a nonzero iterate."""
    grid, p, mats, _, h = _bar("lme")
    _, cfg, box = _configs("pallas", grid, h, "lme", newton_maxiter=0)
    tg = to_torch_grid(grid)
    tg = tg.replace(dirichlet_value=tg.dirichlet_value.double())

    def f64(r):
        return r.map_tensors(lambda a: a.double() if a.is_floating_point() else a)

    tp, tm = f64(to_torch_particles(jslot(p, grid, box))), f64(to_torch_materials(mats))
    seen, real = {}, solvers.newton_krylov

    def spy(residual, x0, **kw):
        seen.update(residual=residual, x0=x0)
        return real(residual, x0, **kw)

    monkeypatch.setattr(solvers, "newton_krylov", spy)
    tdem.dem_step(tp, tg, tm, cfg, torch.zeros(2, dtype=torch.float64))
    R, x0 = seen["residual"], seen["x0"]
    rng = np.random.default_rng(5)
    x = x0 + torch.as_tensor(0.05 * rng.standard_normal(tuple(x0.shape)))
    v = torch.as_tensor(rng.standard_normal(tuple(x0.shape)))
    Jv = solvers.jvp(R, x, v)[1]
    s = 1e-6
    fd = (R(x + s * v) - R(x - s * v)) / (2 * s)
    assert float(Jv.abs().max()) > 0.0
    torch.testing.assert_close(Jv, fd, rtol=1e-6, atol=1e-6 * float(fd.abs().max()))
