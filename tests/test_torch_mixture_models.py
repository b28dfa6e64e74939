"""The u-pw (explicit and implicit), mixed u-p and DEM steps with plastic and
Hencky materials, against the JAX package's steps from the same general
state on the scatter engine (FEM; its JAX programs compile fastest), by pid,
at the limits of PERF.md §2 for each step; then each from rest on the port
alone, where the JAX package's J·v is not finite (ROADMAP.md queue 3):
finite, and each Newton loop ended by its tolerance or stall rule.

* u-pw on tests/test_upw.py's column with a Drucker-Prager soil and
  scripts/bench_upw.py's fluid: explicit, 4 steps (x within 1e-6, pw within
  1e-5 of its largest magnitude); implicit, 1 step (x within 1e-6, pw within
  1e-2, equal Newton iterations).
* u-p on the same column with Hencky and with von Mises: 1 step, x within
  1e-6, λ within 1e-2 of its largest magnitude, equal Newton iterations.
* DEM (discrete gradient) on tests/test_dem.py's bar with Hencky and with
  von Mises: 1 step, x within 1e-6, v within 1e-5, equal Newton iterations,
  the grid-energy identity within 5e-4 (the JAX test's limits).  Hencky's
  P = ∂W/∂F is τ·F⁻ᵀ in the port (formulations/dem.py); von Mises' W reads
  ΔF = I and the history, so its P is 0 in both packages.
* Plastic strips: the eps gap within EPS_GAP of its largest magnitude."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import dem as jdem, up as jup, upw as jupw
from nlpartsol_tpu.models import materials as jM

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import dem as tdem, up as tup, upw as tupw

from _torch_port import (by_pid, cheap_jax_compiles, to_torch_grid,  # noqa: F401
                         to_torch_materials, to_torch_particles)
from test_explicit import C, E_, RHO, bar_setup
from test_torch_upw import BODY, to_torch_mixture
from test_upw import E_SOIL, RHO_F, RHO_S, column_setup

torch.set_num_threads(1)

EPS_GAP = 1e-3
FLUID = dict(kind="Newtonian-Fluid-Compressible", rho0=RHO_F, compressibility=2.2e7)
DRUCKER_PRAGER = dict(kind="Drucker-Prager", kappa0=50.0, friction_angle=30.0,
                      dilatancy_angle=10.0, exponent_ortiz=2.0, plastic_strain_0=0.01)
KINDS = {"Hencky": dict(kind="Hencky"),
         "Von-Mises": dict(kind="Von-Mises", kappa0=3e3, hardening_modulus=1e5,
                           theta_voce=1.0)}


def _general(p, seed, vol=0.0, kappa0=0.0, lateral=True):
    """A general prestrained state on the JAX particles: F, b_e − I (with an
    isotropic part ``vol``), eps, kappa on Drucker-Prager's law, and small
    random velocities (vertical only unless ``lateral``)."""
    rng = np.random.default_rng(seed)
    n = p.count
    e = 5e-4 * rng.standard_normal((n, 2, 2))
    e = 0.5 * (e + e.transpose(0, 2, 1))
    eps = rng.uniform(0.0, 0.005, n)
    v = 1e-3 * rng.standard_normal((n, 2))
    if not lateral:
        v[:, 0] = 0.0
    fields = dict(F=np.eye(2) + 1e-3 * rng.standard_normal((n, 2, 2)),
                  bemi=np.expm1(2.0 * (e + vol * np.eye(2))),
                  bemi_zz=np.full(n, np.expm1(2.0 * vol)),
                  eps=eps, kappa=kappa0 * np.sqrt(1.0 + eps / 0.01), v=v)
    return p.replace(**{k: jnp.asarray(np.asarray(a, np.float32)) for k, a in fields.items()})


def _soil_column(soil, general, seed=3):
    """test_upw.py's column with ``soil`` (E 1e7, ν 0.3, ρ 2700) and
    bench_upw.py's fluid, at rest or in a general state."""
    grid, p, _, mix, h, _ = column_setup()
    mats = jM.material_table([jM.material(E=E_SOIL, nu=0.3, rho0=RHO_S, **soil),
                              jM.material(**FLUID)])
    if general:
        p = _general(p, seed, vol=-1e-4, kappa0=soil.get("kappa0", 0.0), lateral=False)
    elif soil["kind"] == "Drucker-Prager":
        p = p.replace(kappa=jnp.full((p.count,), soil["kappa0"], jnp.float32))
    return grid, p, mats, mix, h


def _kinds(mats):
    return tuple(sorted({int(k) for k in np.asarray(mats.kind)}))


def _convert(cfg_j, fn):
    return fn({f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})


def _compare(tp, pj, names, limits, eps0):
    """By pid: x, and the named fields within their limits (absolute for x
    and v, over the largest magnitude for pw), the eps gap within EPS_GAP."""
    got, ref = by_pid(tp, names + ("eps",)), by_pid(pj, names + ("eps",))
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=1e-6)
    for name, lim in limits.items():
        scale = max(float(np.abs(ref[name]).max()), 1.0) if name == "pw" else 1.0
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=lim * scale,
                                   err_msg=name)
    gap = np.abs(got["eps"] - ref["eps"]).max() / max(float(np.abs(ref["eps"]).max()), 1e-30)
    assert gap < EPS_GAP, gap
    return float((got["eps"] != eps0).mean())


def _ended(dg, maxiter):
    """The Newton loop ended by its tolerance or its stall rule, finite."""
    assert dg["newton_iters"] < maxiter and np.isfinite(float(dg["newton_residual"])), dg
    assert int(dg["lost"]) == 0


def _finite(p, names):
    for name in names:
        assert bool(torch.isfinite(getattr(p, name)[p.active]).all()), name


def test_upw_explicit_with_drucker_prager_soil():
    for general in (True, False):
        grid, p, mats, mix, h = _soil_column(DRUCKER_PRAGER, general)
        p = jupw.init_mixture_state(p, mats, mix)
        cfg_j = jupw.UpwConfig(dt=1e-4, shapefun="fem", kinds=_kinds(mats), transfer="scatter")
        cfg_t = _convert(cfg_j, convert.upw_config_from_fields)
        tp, tg, tm, tmix = (to_torch_particles(p), to_torch_grid(grid), to_torch_materials(mats),
                            to_torch_mixture(mix))
        pj = p
        for _ in range(4):
            tp, dt_ = tupw.upw_step(tp, tg, tm, tmix, cfg_t, torch.as_tensor(BODY))
            assert int(dt_["lost"]) == 0
            if general:
                pj, _ = jupw.upw_step(pj, grid, mats, mix, cfg_j, jnp.asarray(BODY))
        _finite(tp, ("x", "v", "pw", "stress", "eps"))
        if general:
            yielded = _compare(tp, pj, ("x", "pw"), dict(pw=1e-5),
                               by_pid(to_torch_particles(p), ("eps",))["eps"])
            assert yielded > 0.1, yielded


def test_upw_implicit_with_drucker_prager_soil():
    for general in (True, False):
        grid, p, mats, mix, h = _soil_column(DRUCKER_PRAGER, general)
        p = jupw.init_mixture_state(p, mats, mix)
        cfg_j = jupw.UpwImplicitConfig(dt=2e-4, shapefun="fem", kinds=_kinds(mats),
                                       transfer="scatter")
        cfg_t = _convert(cfg_j, convert.upw_implicit_config_from_fields)
        tp, dt_ = tupw.upw_newmark_step(to_torch_particles(p), to_torch_grid(grid),
                                        to_torch_materials(mats), to_torch_mixture(mix), cfg_t,
                                        torch.as_tensor(BODY))
        _ended(dt_, cfg_t.newton_maxiter)
        _finite(tp, ("x", "v", "pw", "stress", "eps"))
        if general:
            pj, dj = jax.jit(jupw.upw_newmark_step, static_argnums=(4,))(
                p, grid, mats, mix, cfg_j, jnp.asarray(BODY))
            assert dt_["newton_iters"] == int(dj["newton_iters"])
            yielded = _compare(tp, pj, ("x", "pw"), dict(pw=1e-2),
                               by_pid(to_torch_particles(p), ("eps",))["eps"])
            assert yielded > 0.1, yielded


@pytest.mark.parametrize("name", list(KINDS))
def test_up_step(name):
    for general in (True, False):
        grid, p, mats, _, h = _soil_column(KINDS[name], general)
        cfg_j = jup.UpConfig(dt=2e-3, shapefun="fem", kinds=_kinds(mats), transfer="scatter")
        cfg_t = _convert(cfg_j, convert.up_config_from_fields)
        tp, dt_ = tup.up_step(to_torch_particles(p), to_torch_grid(grid),
                              to_torch_materials(mats), cfg_t, torch.as_tensor(BODY))
        _ended(dt_, cfg_t.newton_maxiter)
        _finite(tp, ("x", "v", "pw", "stress", "eps"))
        if general:
            pj, dj = jax.jit(jup.up_step, static_argnums=(3,))(p, grid, mats, cfg_j,
                                                                jnp.asarray(BODY))
            assert bool(dt_["converged"]) and bool(dj["converged"])
            assert dt_["newton_iters"] == int(dj["newton_iters"])
            yielded = _compare(tp, pj, ("x", "pw"), dict(pw=1e-2),
                               by_pid(to_torch_particles(p), ("eps",))["eps"])
            assert yielded > 0.1 or name == "Hencky", yielded


@pytest.mark.parametrize("name", list(KINDS))
def test_dem_step(name):
    """tests/test_dem.py's bar (V 0.05, no gravity): from a general state
    against the JAX step, and from rest (the bar's sine velocity on F = I)
    on the port alone."""
    for general in (True, False):
        grid, p, _, L, h = bar_setup("fem")
        mats = jM.material_table([jM.material(E=E_, nu=0.3, rho0=RHO, **KINDS[name])])
        if general:
            p = _general(p, seed=5, lateral=False)
        vx = 0.05 * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
        p = p.replace(v=p.v.at[:, 0].add(jnp.asarray(vx, jnp.float32)))
        cfg_j = jdem.DEMConfig(dt=h / C, shapefun="fem", kinds=_kinds(mats), transfer="scatter")
        cfg_t = _convert(cfg_j, convert.dem_config_from_fields)
        tp, dt_ = tdem.dem_step(to_torch_particles(p), to_torch_grid(grid),
                                to_torch_materials(mats), cfg_t, torch.zeros(2))
        assert bool(dt_["converged"]) and int(dt_["lost"]) == 0
        _finite(tp, ("x", "v", "stress", "eps", "W"))
        ident = abs(float(dt_["grid_energy_increment"])) / float(dt_["grid_kinetic_energy"])
        assert ident < 5e-4, ident
        if general:
            pj, dj = jax.jit(jdem.dem_step, static_argnums=(3,))(p, grid, mats, cfg_j,
                                                                  jnp.zeros((2,), jnp.float32))
            assert dt_["newton_iters"] == int(dj["newton_iters"])
            _compare(tp, pj, ("x", "v"), dict(v=1e-5),
                     by_pid(to_torch_particles(p), ("eps",))["eps"])
