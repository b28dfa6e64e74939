"""Structured FEM checks owed by earlier slices, against the JAX package:
tests/test_3d.py::test_bar_vibration_3d[fem] (the 3D bar to a quarter
period, the port on the windowed engine against the JAX step, by pid, and
the oracle at the JAX test's limit) and
tests/test_fracture.py::test_step_with_eigenerosion_runs (an explicit step
with eigenerosion and FEM shape functions on the windowed engine)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from nlpartsol_tpu.formulations import explicit as jex
from nlpartsol_tpu.formulations.courant import courant_dt
from nlpartsol_tpu.models import materials as jM
from nlpartsol_tpu.ops import windowed as jwin
from nlpartsol_tpu.types import Grid as JGrid, make_particles as jmake

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import explicit as tex

from _torch_femesh import rel_dx_dv
from _torch_port import (by_pid, cheap_jax_compiles, to_torch_box,  # noqa: F401
                         to_torch_grid, to_torch_materials, to_torch_particles)
from test_3d import C, bar_setup_3d

torch.set_num_threads(1)


def _port_config(cfg_j, **changes):
    static = {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)}
    return convert.config_from_fields(static).replace(**changes)


def test_bar_vibration_3d_fem_on_the_windowed_engine():
    """n_quarter steps (dt = 0.25·h/c): the port's windowed step tracks the
    JAX step by pid (rel_dx < 1e-3, rel_dv < 1e-2) and meets test_3d.py's
    FEM oracle, err < 0.05."""
    grid, pj, mats, L, h = bar_setup_3d()
    V, omega = 0.01, np.pi * C / L
    x = np.asarray(pj.x)
    v = np.zeros_like(x)
    v[:, 0] = V * np.sin(np.pi * x[:, 0] / L)
    pj = pj.replace(v=jnp.asarray(v))
    dt = courant_dt(0.25, h, C)
    cfg_j = jex.ExplicitConfig(dt=dt, shapefun="fem", kinds=(jM.NEO_HOOKEAN,))
    box = jwin.full_box(grid, capacity=8)
    cfg_t = _port_config(cfg_j, transfer="windowed", active_box=to_torch_box(box))
    n_quarter = int(round((np.pi / 2 / omega) / dt))
    step = jax.jit(jex.explicit_step, static_argnums=(3,))
    body = jnp.zeros((3,), jnp.float32)
    pt = to_torch_particles(pj)
    for _ in range(n_quarter):
        pj, _ = step(pj, grid, mats, cfg_j, body)
    pt, hist = tex.run(pt, to_torch_grid(grid), to_torch_materials(mats), cfg_t, n_quarter)
    assert int(hist["lost"].sum()) == 0
    rel_dx, rel_dv = rel_dx_dv(pt, pj, h)
    assert rel_dx < 1e-3 and rel_dv < 1e-2, (rel_dx, rel_dv)
    got = by_pid(pt, ("x", "dis"))
    u_ref = (V / omega) * np.sin(np.pi * (got["x"][:, 0] - got["dis"][:, 0]) / L)
    assert np.abs(got["dis"][:, 0] - u_ref).max() / (V / omega) < 0.05


def test_step_with_eigenerosion_and_fem_matches_jax():
    """test_fracture.py's step: 8×8 particles in a 9² grid (h 0.1), Ceps
    1.5, Gf 10, reach 2, FEM, windowed, one step: finite, by pid within
    the STEP limits of the port's tests, damage equal."""
    from test_fracture import E_, RHO

    grid = JGrid(dims=(9, 9), spacing=0.1, origin=(0.0, 0.0))
    box = jwin.full_box(grid, capacity=6)
    xs = np.stack(np.meshgrid(np.linspace(0.25, 0.55, 8), np.linspace(0.25, 0.55, 8)),
                  -1).reshape(-1, 2).astype(np.float32)
    vol = 0.05**2
    pj = jmake(xs, mass=np.full(len(xs), RHO * vol), vol0=np.full(len(xs), vol))
    mats = jM.material_table(
        [jM.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.2, rho0=RHO, Ceps=1.5, Gf=10.0)])
    cfg_j = jex.ExplicitConfig(dt=courant_dt(0.25, 0.1, C), shapefun="fem",
                               kinds=(jM.NEO_HOOKEAN,), transfer="windowed", active_box=box,
                               damage="eigenerosion", beps_reach=2)
    cfg_t = _port_config(cfg_j)
    assert cfg_t.damage == "eigenerosion" and cfg_t.shapefun == "fem"
    tg, tb = to_torch_grid(grid), to_torch_box(box)
    pt = tex.to_slot_layout(to_torch_particles(pj), tg, tb)
    pj = jex.to_slot_layout(pj, grid, box)
    qj, _ = jax.jit(jex.explicit_step, static_argnums=(3,))(pj, grid, mats, cfg_j,
                                                            jnp.zeros((2,), jnp.float32))
    qt, diag = tex.explicit_step(pt, tg, to_torch_materials(mats), cfg_t, torch.zeros(2))
    assert int(diag["lost"]) == 0 and bool(torch.isfinite(qt.x).all())
    got, ref = by_pid(qt, ("x", "v", "damage")), by_pid(qj, ("x", "v", "damage"))
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["v"], ref["v"], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got["damage"], ref["damage"])
