"""The u-pw explicit, u-p and DEM steps on an unstructured T3 mesh (the
scatter engine) against the JAX package's, by pid, and the deck route: the
bar of tests/test_io.py over a background of T3 triangles whose node
columns are unevenly spaced (``_torch_decks.set_triangle_background``),
through both drivers' ``run_simulation`` with FEM and with LME shape
functions (rel_dx < 1e-3, rel_dv < 1e-2); a particle outside the mesh
stops the run loudly; nodal initial values over a T3 background."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu import driver as jdriver
from nlpartsol_tpu.formulations import dem as jdem, up as jup, upw as jupw
from nlpartsol_tpu.formulations.courant import courant_dt
from nlpartsol_tpu.io.builder import build_simulation as jax_build
from nlpartsol_tpu.models import materials as jM

from nlpartsol_tpu_torch import convert, driver
from nlpartsol_tpu_torch.formulations import dem as tdem, up as tup, upw as tupw
from nlpartsol_tpu_torch.io.builder import build_simulation
from nlpartsol_tpu_torch.shapefun.femesh import FEMesh

import _torch_decks as decks
from _torch_femesh import rel_dx_dv, static_fields, t3_of_grid, to_torch_mesh
from _torch_port import (cheap_jax_compiles, to_torch_materials,  # noqa: F401
                         to_torch_particles)
from test_explicit import C, bar_setup
from test_io import bar_case  # noqa: F401
from test_torch_upw import BODY, to_torch_mixture
from test_upw import KF, column_setup

torch.set_num_threads(1)


def _close(tp, pj, h):
    rel_dx, rel_dv = rel_dx_dv(tp, pj, h)
    assert rel_dx < 1e-3 and rel_dv < 1e-2, (rel_dx, rel_dv)


def test_upw_explicit_on_a_t3_mesh_matches_jax():
    """Five explicit u-pw steps of test_upw.py's column under gravity over
    its nodes split into triangles, FEM: x within 1e-6, pw within 1e-5 of
    its largest magnitude (test_upw.py's limits)."""
    grid, pj, mats, mix, h, _ = column_setup()
    mj = t3_of_grid(grid)
    c_mix = np.sqrt((KF / 0.4) / 1700.0)
    cfg_j = jupw.UpwConfig(dt=0.2 * mj.spacing / c_mix, shapefun="fem",
                           kinds=(jM.NEO_HOOKEAN,), transfer="scatter")
    cfg_t = convert.upw_config_from_fields(static_fields(cfg_j))
    tp = to_torch_particles(pj)
    step = jax.jit(jupw.upw_step, static_argnums=(4,))
    for _ in range(5):
        pj, dj = step(pj, mj, mats, mix, cfg_j, jnp.asarray(BODY))
    tp, hist = tupw.run(tp, to_torch_mesh(mj), to_torch_materials(mats), to_torch_mixture(mix),
                        cfg_t, 5, torch.as_tensor(BODY))
    assert int(hist["lost"].sum()) == 0 and int(hist["nnz"][-1]) == int(dj["nnz"])
    got_pw, ref_pw = tp.pw.numpy(), np.asarray(pj.pw)
    assert np.abs(ref_pw).max() > 1.0, "no pore pressure built up"
    np.testing.assert_allclose(tp.x.numpy(), np.asarray(pj.x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_pw, ref_pw, rtol=0, atol=1e-5 * np.abs(ref_pw).max())


@pytest.mark.parametrize("step", ["up", "dem"])
def test_up_and_dem_on_a_t3_mesh_match_jax(step):
    """One u-p step (dt = 2h/c) or DEM step (dt = h/c) of test_explicit.py's
    bar over its nodes split into triangles, FEM, the bar swinging at
    0.05·sin(πx): converged with equal Newton counts, by pid."""
    grid, pj, mats, _, _ = bar_setup("fem")
    mj = t3_of_grid(grid)
    x = np.asarray(pj.x)
    v = np.stack([0.05 * np.sin(np.pi * x[:, 0]), np.zeros(len(x))], -1).astype(np.float32)
    pj = pj.replace(v=jnp.asarray(v))
    if step == "up":
        cfg_j = jup.UpConfig(dt=courant_dt(2.0, mj.spacing, C), shapefun="fem",
                             kinds=(jM.NEO_HOOKEAN,), transfer="scatter")
        cfg_t = convert.up_config_from_fields(static_fields(cfg_j))
        fj, ft = jup.up_step, tup.up_step
    else:
        cfg_j = jdem.DEMConfig(dt=courant_dt(1.0, mj.spacing, C), shapefun="fem",
                               kinds=(jM.NEO_HOOKEAN,), transfer="scatter")
        cfg_t = convert.dem_config_from_fields(static_fields(cfg_j))
        fj, ft = jdem.dem_step, tdem.dem_step
    qj, dj = jax.jit(fj, static_argnums=(3,))(pj, mj, mats, cfg_j, jnp.zeros(2, jnp.float32))
    qt, dt_ = ft(to_torch_particles(pj), to_torch_mesh(mj), to_torch_materials(mats), cfg_t,
                 torch.zeros(2))
    assert bool(dt_["converged"]) and bool(dj["converged"])
    assert int(dt_["newton_iters"]) == int(dj["newton_iters"]) and int(dt_["lost"]) == 0
    _close(qt, qj, mj.spacing)


@pytest.mark.parametrize("shapefun", ["FEM", "LME"])
def test_triangle_deck_runs_like_jax(shapefun, bar_case, tmp_path, monkeypatch):  # noqa: F811
    """The triangle-background bar deck through both drivers'
    ``run_simulation`` (20 steps, the scatter engine forced on a FEMesh, dt
    from the smallest edge), the bar swinging at 0.01·sin(πx)."""
    path = decks.set_triangle_background(bar_case)
    if shapefun == "LME":
        path = decks.set_shapefun(bar_case, "LME")
    sj, st = jax_build(str(path)), build_simulation(str(path), device="cpu")
    assert isinstance(st.grid, FEMesh) and st.grid.kind == "T3"
    x = np.asarray(sj.particles.x)
    v = np.stack([0.01 * np.sin(np.pi * x[:, 0]), np.zeros(len(x))], -1).astype(np.float32)
    sj.particles = sj.particles.replace(v=jnp.asarray(v))
    st.particles = st.particles.replace(v=torch.as_tensor(v))
    cfg = driver.make_step_config(st, transfer="auto")
    assert cfg.transfer == "scatter" and cfg.active_box is None
    assert cfg.dt == jdriver.make_step_config(sj, transfer="auto").dt
    monkeypatch.chdir(tmp_path)
    kw = dict(write_outputs=False, progress=False)
    pj, hj = jdriver.run_simulation(sj, transfer="auto", **kw)
    pt, ht = driver.run_simulation(st, transfer="auto", **kw)
    assert len(ht["t"]) == len(hj["t"]) == 20
    _close(pt, pj, st.grid.spacing)
    assert float(np.abs(np.asarray(pj.dis)).max()) > 1e-6  # the bar moved


def test_a_particle_outside_the_mesh_is_lost_loudly(bar_case, tmp_path, monkeypatch):  # noqa: F811
    """A particle that no element holds (``found`` false) is counted as
    lost, and ``run_simulation`` raises, as the JAX driver does."""
    path = decks.set_triangle_background(bar_case)
    st = build_simulation(str(path), device="cpu")
    x = st.particles.x.clone()
    x[0] = torch.tensor([5.0, 5.0])
    st.particles = st.particles.replace(x=x)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="1 active particles left every element"):
        driver.run_simulation(st, write_outputs=False, progress=False, n_steps=2)


def test_nodal_initial_values_on_a_triangle_background(tmp_path):
    """test_io.py's hydrostatic and nodal initial conditions deck over a T3
    background: the port interpolates the nodal velocity with the mesh's
    isoparametric basis (every node at 2.5 m/s gives every particle 2.5);
    the JAX builder calls the structured basis on the FEMesh and fails
    (ROADMAP.md queue 3)."""
    path = decks.write_initial_conditions_case(tmp_path)
    decks.write_triangle_mesh(tmp_path / "bg.msh", 4, 4, 0.25, 0.05)
    with pytest.raises(AttributeError, match="cell_of"):
        jax_build(str(path))
    st = build_simulation(str(path), device="cpu")
    assert isinstance(st.grid, FEMesh)
    np.testing.assert_allclose(st.particles.v.numpy(), [[2.5, 0.0]] * st.particles.count,
                               rtol=0, atol=1e-6)
