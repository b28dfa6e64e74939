"""``transfer='scatter'`` (the ScatterEngine: segment sums over the (Np, K)
pattern in particle order, no slot layout, no re-bin) on the explicit,
implicit, u-pw explicit and implicit, Forward-Euler and Generalized-α
steps, each against the JAX package's step on the same transfer from the
same numpy state, by pid (x rtol 1e-5, v 1e-4, F 1e-4 — the JAX package's
limits between its engines — or, for the mixture steps, test_upw.py's x
1e-6 and pw limits); and the traction-alignment case of
tests/test_io.py::test_traction_alignment_windowed_vs_scatter through the
port's driver."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu import driver as jdriver
from nlpartsol_tpu.formulations import explicit as jex, implicit as jim
from nlpartsol_tpu.formulations import integrators as jint, upw as jupw
from nlpartsol_tpu.io.builder import build_simulation as jax_build
from nlpartsol_tpu.models import materials as jM
from nlpartsol_tpu.shapefun import lme as jlme

from nlpartsol_tpu_torch import convert, driver
from nlpartsol_tpu_torch.formulations import explicit as tex, implicit as tim
from nlpartsol_tpu_torch.formulations import integrators as tint, upw as tupw
from nlpartsol_tpu_torch.io.builder import build_simulation

import _torch_decks as decks
from _torch_port import (assert_tracks, by_pid, cheap_jax_compiles,  # noqa: F401
                         explicit_configs, implicit_configs, neo_hookean_tables, problem,
                         to_torch_grid, to_torch_materials, to_torch_particles)
from test_io import bar_case  # noqa: F401
from test_torch_upw import BODY, to_torch_mixture
from test_torch_upw_implicit import _bench_fluid_column
from test_upw import KF, column_setup

torch.set_num_threads(1)


def test_explicit_scatter_matches_jax():
    """Three steps with gravity, a Dirichlet strip and tractions from the
    particles' own (unbinned) order; nnz equal."""
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem(seed=7, n_side=14, n_particles=200,
                                                 speed=0.05, slots=False)
    mj, mt = neo_hookean_tables()
    fixed = np.zeros((gj.n_nodes, 2), bool)
    fixed.reshape(14, 14, 2)[:, :3, :] = True
    gj = gj.replace(dirichlet_mask=jnp.asarray(fixed),
                    dirichlet_value=jnp.zeros((gj.n_nodes, 2), jnp.float32))
    tg = tg.replace(dirichlet_mask=torch.as_tensor(fixed),
                    dirichlet_value=torch.zeros((tg.n_nodes, 2)))
    rng = np.random.default_rng(10)
    trac = (1e3 * rng.standard_normal((pj.count, 2))).astype(np.float32)
    area = np.full(pj.count, gj.spacing / 2, np.float32)
    cfg_j, cfg_t = explicit_configs(gj, bj, lj, 0.1, transfer="scatter")
    assert cfg_t.transfer == "scatter"
    body = np.asarray([0.0, -9.81], np.float32)
    step_j = jax.jit(lambda q: jex.explicit_step(q, gj, mj, cfg_j, jnp.asarray(body),
                                                 jnp.asarray(trac), jnp.asarray(area)))
    for _ in range(3):
        pj, dj = step_j(pj)
        tp, dt_ = tex.explicit_step(tp, tg, mt, cfg_t, torch.as_tensor(body),
                                    torch.as_tensor(trac), torch.as_tensor(area))
    assert tp.count == 200 and int(dt_["nnz"]) == int(dj["nnz"])
    assert int(dt_["lost"]) == int(dj["lost"]) == 0
    np.testing.assert_allclose(dt_["reactions"].numpy(), np.asarray(dj["reactions"]),
                               rtol=1e-3, atol=1e-4 * float(np.abs(dj["reactions"]).max()))
    assert_tracks(tp, pj)
    # run() takes the particles as they are: no slot layout
    tq, hist = tex.run(tp, tg, mt, cfg_t, 2)
    assert tq.count == 200 and hist["nnz"].shape == (2,)


def test_implicit_scatter_matches_jax():
    """Two implicit Newmark steps: equal Newton counts, converged."""
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem(seed=5, n_side=12, n_particles=150,
                                                 speed=0.05, slots=False)
    mj, mt = neo_hookean_tables()
    cfg_j, cfg_t = implicit_configs(gj, bj, lj, transfer="scatter")
    assert cfg_t.transfer == "scatter"
    body = np.asarray([0.0, -9.81], np.float32)
    step_j = jax.jit(lambda q: jim.implicit_step(q, gj, mj, cfg_j, jnp.asarray(body)))
    for _ in range(2):
        pj, dj = step_j(pj)
        tp, dt_ = tim.implicit_step(tp, tg, mt, cfg_t, torch.as_tensor(body))
        assert bool(dt_["converged"]) and bool(dj["converged"])
        assert int(dt_["newton_iters"]) == int(dj["newton_iters"])
    assert_tracks(tp, pj)


def test_upw_explicit_scatter_matches_jax():
    """10 explicit u-pw steps of test_upw.py's column under gravity (LME
    γ=3): x within 1e-6 and pw within 1e-5 of its largest magnitude."""
    grid, p, mats, mix, h, H = column_setup()
    c_mix = np.sqrt((KF / 0.4) / 1700.0)
    cfg_j = jupw.UpwConfig(dt=0.2 * h / c_mix, shapefun="lme",
                           lme_params=jlme.LMEParams(gamma=3.0), kinds=(jM.NEO_HOOKEAN,),
                           transfer="scatter")
    cfg_t = convert.upw_config_from_fields(
        {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})
    assert cfg_t.transfer == "scatter" and cfg_t.active_box is None
    step = jax.jit(jupw.upw_step, static_argnums=(4,))
    pj = p
    for _ in range(10):
        pj, dj = step(pj, grid, mats, mix, cfg_j, jnp.asarray(BODY))
    tp, hist = tupw.run(to_torch_particles(p), to_torch_grid(grid), to_torch_materials(mats),
                        to_torch_mixture(mix), cfg_t, 10, torch.as_tensor(BODY))
    assert int(hist["lost"].sum()) == 0 and int(hist["nnz"][-1]) == int(dj["nnz"])
    got, ref = by_pid(tp, ("x", "pw")), by_pid(pj, ("x", "pw"))
    pw_scale = float(np.abs(ref["pw"]).max())
    assert pw_scale > 1.0, "no pore pressure built up"
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["pw"], ref["pw"], rtol=0, atol=1e-5 * pw_scale)


def test_upw_implicit_scatter_matches_jax():
    """One implicit u-pw step (bench_upw.py's fluid, dt 2e-4): equal Newton
    counts, x within 1e-6, pw within 1e-2 of its largest magnitude."""
    grid, p, mats, mix = _bench_fluid_column()
    cfg_j = jupw.UpwImplicitConfig(dt=2e-4, shapefun="lme", lme_params=jlme.LMEParams(gamma=3.0),
                                   kinds=(jM.NEO_HOOKEAN,), transfer="scatter")
    cfg_t = convert.upw_implicit_config_from_fields(
        {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})
    pj, dj = jax.jit(jupw.upw_newmark_step, static_argnums=(4,))(
        p, grid, mats, mix, cfg_j, jnp.asarray(BODY))
    tp, dt_ = tupw.upw_newmark_step(to_torch_particles(p), to_torch_grid(grid),
                                    to_torch_materials(mats), to_torch_mixture(mix), cfg_t,
                                    torch.as_tensor(BODY))
    assert bool(dt_["converged"]) and bool(dj["converged"])
    assert int(dt_["newton_iters"]) == int(dj["newton_iters"])
    got, ref = by_pid(tp, ("x", "pw")), by_pid(pj, ("x", "pw"))
    pw_scale = float(np.abs(ref["pw"]).max())
    assert pw_scale > 1.0, "no pore pressure built up"
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["pw"], ref["pw"], rtol=0, atol=1e-2 * pw_scale)


@pytest.mark.parametrize("scheme,rb", [("FE", None), ("Generalized-alpha", 0.8)])
def test_integrators_scatter_track_jax(scheme, rb, bar_case):  # noqa: F811
    """Three steps of the bar's deck through each integrator on the scatter
    engine, configs from both drivers' ``make_step_config``."""
    path = str(decks.set_scheme(bar_case, scheme, rb))
    sj, st = jax_build(path), build_simulation(path, device="cpu")
    x = np.asarray(sj.particles.x)
    v = (0.01 * np.stack([np.sin(np.pi * x[:, 0]), np.zeros(len(x))], -1)).astype(np.float32)
    sj.particles = sj.particles.replace(v=jnp.asarray(v))
    st.particles = st.particles.replace(v=torch.as_tensor(v))
    cfg_j = jdriver.make_step_config(sj, transfer="scatter")
    cfg_t = driver.make_step_config(st, transfer="scatter")
    assert cfg_t == convert.config_from_fields(
        {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})
    assert cfg_t.transfer == "scatter" and cfg_t.scheme == scheme
    gj = sj.grid.replace(dirichlet_value=jnp.zeros_like(sj.grid.dirichlet_value))
    gt = st.grid.replace(dirichlet_value=torch.zeros_like(st.grid.dirichlet_value))
    pj, p = sj.particles, st.particles
    for _ in range(3):
        if scheme == "FE":
            pj, _ = jint.forward_euler_step(pj, gj, sj.materials, cfg_j, jnp.zeros(2))
            p, diag = tint.forward_euler_step(p, gt, st.materials, cfg_t, torch.zeros(2))
        else:
            pj, _ = jint.generalized_alpha_step(pj, gj, sj.materials, cfg_j, jnp.zeros(2), rb)
            p, diag = tint.generalized_alpha_step(p, gt, st.materials, cfg_t, torch.zeros(2), rb)
        assert int(diag["lost"]) == 0
    assert_tracks(p, pj)
    assert float(np.abs(np.asarray(pj.v)).max()) > 1e-3  # the bar moved


def test_traction_alignment_windowed_vs_scatter(bar_case, tmp_path, monkeypatch):  # noqa: F811
    """Tractions defined on the seeding ids, particles stored in a shuffled
    order: the port's driver on the windowed and the scatter engine stretch
    the bar alike (rtol 1e-5, atol 1e-8 by pid) and as the JAX driver's
    scatter run does."""
    x0 = build_simulation(str(bar_case / "sim.nlp"), device="cpu").particles.x.numpy()
    path = str(decks.add_neumann(bar_case, x0))
    monkeypatch.chdir(tmp_path)
    perm = np.random.default_rng(3).permutation(len(x0))
    kw = dict(write_outputs=False, progress=False, n_steps=8)
    outs = {}
    for transfer in ("windowed", "scatter"):
        setup = build_simulation(path, device="cpu")
        assert setup.neumann
        setup.particles = setup.particles.map_tensors(lambda a: a[torch.as_tensor(perm)])
        p, _ = driver.run_simulation(setup, transfer=transfer, **kw)
        outs[transfer] = by_pid(p, names=("x",))["x"]
    sj = jax_build(path)
    sj.particles = jax.tree_util.tree_map(lambda a: a[perm], sj.particles)
    pj, _ = jdriver.run_simulation(sj, transfer="scatter", **kw)
    assert outs["scatter"][:, 0].max() > x0[:, 0].max() + 1e-6
    np.testing.assert_allclose(outs["windowed"], outs["scatter"], rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(outs["scatter"], by_pid(pj, names=("x",))["x"], rtol=1e-5,
                               atol=1e-8)
