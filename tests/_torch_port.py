"""Shared fixtures of the tests/test_torch_*.py files: one problem built in
numpy, handed to the JAX package and — through ``convert.py`` — to the
PyTorch port, both on the CPU."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import explicit as jex
from nlpartsol_tpu.models import materials as jM
from nlpartsol_tpu.ops import windowed as jwin
from nlpartsol_tpu.shapefun import lme as jlme
from nlpartsol_tpu.types import Grid as JGrid, Particles as JParticles, make_particles as jmake

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import explicit as tex
from nlpartsol_tpu_torch.ops import windowed as twin
from nlpartsol_tpu_torch.shapefun import lme as tlme


@pytest.fixture(autouse=True, scope="module")
def cheap_jax_compiles():
    """The JAX side of these tests is compile-bound (each reference program
    runs once, on a few hundred particles): have XLA skip its expensive
    optimisation passes while a module of them runs.  Imported into each
    tests/test_torch_*.py module; compiled programs do not outlive the module
    (conftest clears the jit caches after each one)."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


# λ ~ 1/h: a Newton stop at ‖r‖ ≤ 1e-6·R leaves it uncertain by J⁻¹r ≈ 2e-5/h,
# so λ is compared with an absolute floor of LAM_ATOL/h beside rtol 1e-3
LAM_ATOL = 1e-4

# A step of the port against a step of the JAX package, by pid over active
# particles: the tolerances the JAX package holds between its own engines
# (tests/test_pallas_transfer.py)
STEP_TOL = dict(x=dict(rtol=1e-5, atol=1e-7), v=dict(rtol=1e-4, atol=1e-6),
                F=dict(rtol=1e-4, atol=1e-6), stress=dict(rtol=2e-3, atol=1.0))


def fields_to_numpy(obj) -> dict:
    """Every dataclass field of a JAX-package record as a numpy array."""
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def to_torch_particles(pj):
    return convert.particles_from_numpy(fields_to_numpy(pj), device="cpu")


def to_torch_grid(gj):
    def opt(a):
        return None if a is None else np.asarray(a)

    return convert.grid_from_numpy(
        gj.dims, gj.spacing, gj.origin, active=opt(gj.active),
        dirichlet_mask=opt(gj.dirichlet_mask), dirichlet_value=opt(gj.dirichlet_value),
        valid_lo=opt(gj.valid_lo), valid_hi=opt(gj.valid_hi), device="cpu",
    )


def to_torch_box(bj):
    return twin.ActiveBox(offset=tuple(bj.offset), cdims=tuple(bj.cdims), capacity=bj.capacity)


def to_torch_materials(mj):
    return convert.materials_from_numpy(fields_to_numpy(mj), device="cpu")


def problem(seed=0, n_side=12, n_particles=150, speed=0.0, slots=True, origin=(0.0, 0.0)):
    """Random particles in the middle of an ``n_side``² grid (the problem of
    tests/test_pallas_transfer.py).  Returns (JAX grid, box, particles, LME
    params) and the same four for the port."""
    rng = np.random.default_rng(seed)
    h = 1.0 / (n_side - 1)
    org = np.asarray(origin)
    gj = JGrid(dims=(n_side, n_side), spacing=h, origin=tuple(origin))
    x = (rng.uniform(0.15, 0.85, size=(n_particles, 2)) + org).astype(np.float32)
    pj = jmake(
        x,
        mass=rng.uniform(0.5, 2.0, n_particles).astype(np.float32),
        vol0=np.full(n_particles, h * h / 4, np.float32),
    )
    if speed:
        pj = pj.replace(
            v=jnp.asarray(speed * rng.standard_normal((n_particles, 2)), jnp.float32)
        )
    probe = jwin.box_for_extent(gj, org + 0.1, org + 0.9, capacity=1, margin=1)
    bj = probe.replace(capacity=max(8, jwin.required_capacity(gj, probe, x)))
    tg, tb, tp = to_torch_grid(gj), to_torch_box(bj), to_torch_particles(pj)
    if slots:
        # the slot layout comes from the port's binning (no compile); that it
        # equals the JAX package's is what tests/test_torch_windowed.py checks
        tp = tex.to_slot_layout(tp, tg, tb)
        pj = JParticles(**{k: jnp.asarray(v) for k, v in convert.particles_to_numpy(tp).items()})
    return (gj, bj, pj, jlme.LMEParams(gamma=3.0)), (tg, tb, tp, tlme.LMEParams(gamma=3.0))


def problem3(seed=0, n_side=8, n_particles=60, gamma=5.0, tol_zero=1e-6, speed=0.0):
    """Random particles in the middle of an ``n_side``³ grid (the problem of
    tests/test_pallas_transfer3d.py; γ=5 at tol_zero 1e-6 keeps the window
    at 5³ nodes).  Returns (JAX grid, box, particles, LME params) and the
    same four for the port, in slot layout."""
    rng = np.random.default_rng(seed)
    h = 1.0 / (n_side - 1)
    gj = JGrid(dims=(n_side,) * 3, spacing=h, origin=(0.0, 0.0, 0.0))
    x = rng.uniform(0.2, 0.8, size=(n_particles, 3)).astype(np.float32)
    pj = jmake(
        x,
        mass=rng.uniform(0.5, 2.0, n_particles).astype(np.float32),
        vol0=np.full(n_particles, h**3 / 8, np.float32),
    )
    if speed:
        pj = pj.replace(
            v=jnp.asarray(speed * rng.standard_normal((n_particles, 3)), jnp.float32)
        )
    probe = jwin.box_for_extent(gj, [0.15] * 3, [0.85] * 3, capacity=1, margin=1)
    bj = probe.replace(capacity=max(4, jwin.required_capacity(gj, probe, x)))
    tg, tb, tp = to_torch_grid(gj), to_torch_box(bj), to_torch_particles(pj)
    tp = tex.to_slot_layout(tp, tg, tb)
    pj = JParticles(**{k: jnp.asarray(v) for k, v in convert.particles_to_numpy(tp).items()})
    lj = jlme.LMEParams(gamma=gamma, tol_zero=tol_zero)
    lt = tlme.LMEParams(gamma=gamma, tol_zero=tol_zero)
    return (gj, bj, pj, lj), (tg, tb, tp, lt)


def neo_hookean_tables(E=1e6):
    mj = jM.material_table(
        [jM.material(kind="Neo-Hookean-Wriggers", E=E, nu=0.3, rho0=1000.0)]
    )
    return mj, to_torch_materials(mj)


def explicit_configs(gj, bj, lj, cfl, **kw):
    """The JAX package's ExplicitConfig for a Neo-Hookean E=1e6, ρ=1e3 problem
    and the port's, made from its static fields by ``convert.py``."""
    dt = cfl * gj.spacing / np.sqrt(1e6 / 1e3)
    cfg_j = jex.ExplicitConfig(dt=dt, shapefun="lme", lme_params=lj,
                               kinds=(jM.NEO_HOOKEAN,), active_box=bj, **kw)
    static = {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)}
    return cfg_j, convert.config_from_fields(static)


def assert_tracks(tp, pj):
    """The port's particles follow the JAX package's within STEP_TOL."""
    got, ref = by_pid(tp), by_pid(pj)
    for name, tol in STEP_TOL.items():
        np.testing.assert_allclose(got[name], ref[name], err_msg=name, **tol)


def by_pid(p, names=("x", "v", "F", "stress")):
    """Active rows of the named fields ordered by particle id (slot orders
    may differ between binning flavours; padding rows hold duplicates)."""
    act = np.asarray(p.active)
    order = np.argsort(np.asarray(p.pid)[act])
    return {n: np.asarray(getattr(p, n))[act][order] for n in names}


def implicit_configs(gj, bj, lj, **kw):
    """The JAX package's ImplicitConfig for a Neo-Hookean E=1e6, ρ=1e3 LME
    problem at dt = h/(2c) and the port's, made from its static fields by
    ``convert.py`` (the JAX transfer 'pallas' becomes 'fused')."""
    from nlpartsol_tpu.formulations import implicit as jim

    dt = 0.5 * gj.spacing / np.sqrt(1e6 / 1e3)
    cfg_j = jim.ImplicitConfig(dt=dt, shapefun="lme", lme_params=lj, kinds=(jM.NEO_HOOKEAN,),
                               active_box=bj, **kw)
    static = {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)}
    return cfg_j, convert.implicit_config_from_fields(static)


def with_fields(pj, tp, **arrays):
    """The same numpy arrays set as particle fields on both sides."""
    pj = pj.replace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tp = tp.replace(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    return pj, tp
