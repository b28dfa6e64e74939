"""The port's Forward-Euler and Generalized-α steps
(formulations/integrators.py) against the JAX package's, by pid over three
steps of tests/test_io.py's bar; the spectral-radius parameters; and the
driver dispatching a deck's ``Type=FE`` / ``Type=Generalized-alpha`` to them
(tests/test_io.py::test_driver_dispatches_fe_and_generalized_alpha through
the port)."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nlpartsol_tpu import driver as jdriver
from nlpartsol_tpu.formulations import explicit as jex, integrators as jint
from nlpartsol_tpu.io.builder import build_simulation as jax_build
from nlpartsol_tpu.ops import windowed as jwin
from nlpartsol_tpu_torch import convert, driver
from nlpartsol_tpu_torch.formulations import explicit as tex, integrators as tint
from nlpartsol_tpu_torch.io.builder import build_simulation
from nlpartsol_tpu_torch.ops import windowed as twin

import _torch_decks as decks
from _torch_port import (assert_tracks, cheap_jax_compiles, to_torch_box,  # noqa: F401
                         to_torch_particles)
from test_io import bar_case  # noqa: F401

torch.set_num_threads(1)


def _mode(x):
    """test_io.py's initial velocity mode v = 0.01·sin(πx)."""
    x = np.asarray(x)
    return (0.01 * np.stack([np.sin(np.pi * x[:, 0]), np.zeros(len(x))], -1)).astype(np.float32)


def _steps(scheme, pj, p, sj, st, cfg_j, cfg_t, n=3):
    """n steps of the scheme's step in both packages, with the deck's
    (zero) Dirichlet values."""
    gj = sj.grid.replace(dirichlet_value=jnp.zeros_like(sj.grid.dirichlet_value))
    gt = st.grid.replace(dirichlet_value=torch.zeros_like(st.grid.dirichlet_value))
    body_j, body_t = jnp.zeros((2,), jnp.float32), torch.zeros(2)
    for _ in range(n):
        if scheme == "FE":
            pj, _ = jint.forward_euler_step(pj, gj, sj.materials, cfg_j, body_j)
            p, diag = tint.forward_euler_step(p, gt, st.materials, cfg_t, body_t)
        else:
            pj, _ = jint.generalized_alpha_step(pj, gj, sj.materials, cfg_j, body_j, cfg_j.ga_rb)
            p, diag = tint.generalized_alpha_step(p, gt, st.materials, cfg_t, body_t,
                                                  cfg_t.ga_rb)
        assert int(diag["lost"]) == 0
    return pj, p


@pytest.mark.parametrize("scheme,rb", [("FE", None), ("Generalized-alpha", 0.8)])
def test_integrator_steps_track_jax(scheme, rb, bar_case):  # noqa: F811
    path = str(decks.set_scheme(bar_case, scheme, rb))
    sj, st = jax_build(path), build_simulation(path, device="cpu")
    v = _mode(sj.particles.x)
    sj.particles = sj.particles.replace(v=jnp.asarray(v))
    box_j = jwin.default_box(sj.grid, sj.particles.x, sj.particles.active)
    cfg_j = jdriver.make_step_config(sj, transfer="windowed", active_box=box_j)
    cfg_t = driver.make_step_config(st, transfer="windowed", active_box=to_torch_box(box_j))
    static = {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)}
    assert cfg_t == convert.config_from_fields(static)
    assert cfg_t.scheme == scheme and cfg_t.transfer == "windowed"
    pj = jex.to_slot_layout(sj.particles, sj.grid, box_j)
    pj, p = _steps(scheme, pj, to_torch_particles(pj), sj, st, cfg_j, cfg_t)
    assert_tracks(p, pj)
    assert float(np.abs(np.asarray(pj.v)).max()) > 1e-3  # the bar moved


def test_generalized_alpha_parameters_match_jax():
    for rb in (0.0, 0.3, 0.6, 0.8, 1.0):
        assert tint.generalized_alpha_parameters(rb) == jint.generalized_alpha_parameters(rb)
    # r_b = 1: no dissipation (α = 1/2, γ = 1); r_b = 0: the strongest
    assert tint.generalized_alpha_parameters(1.0) == (0.5, 0.5, 1.0)
    assert tint.generalized_alpha_parameters(0.0) == (-1.0, 2.5, 2.5)


@pytest.mark.parametrize("scheme", ["FE", "Generalized-alpha"])
def test_driver_dispatches_fe_and_generalized_alpha(scheme, bar_case, tmp_path,  # noqa: F811
                                                    monkeypatch):
    """A deck requesting Type=FE / Type=Generalized-alpha runs the matching
    integrator on the windowed engine, not the NPC-FS step."""
    path = str(decks.set_scheme(bar_case, scheme, 0.8 if scheme != "FE" else None))
    setup = build_simulation(path, device="cpu")
    box = twin.default_box(setup.grid, setup.particles.x.numpy(), setup.particles.active.numpy())
    cfg = driver.make_step_config(setup, transfer="fused", active_box=box)
    assert isinstance(cfg, tex.ExplicitConfig)
    assert cfg.scheme == scheme and cfg.transfer == "windowed"
    if scheme == "Generalized-alpha":
        assert cfg.ga_rb == pytest.approx(0.8)

    monkeypatch.chdir(tmp_path)
    setup.particles = setup.particles.replace(v=torch.as_tensor(_mode(setup.particles.x)))
    p_drv, hist = driver.run_simulation(setup, transfer="windowed", write_outputs=False,
                                        progress=False, n_steps=3)
    assert len(hist["kinetic_energy"]) == 3

    cfg = driver.make_step_config(setup, transfer="windowed", active_box=box)
    p_man = tex.to_slot_layout(setup.particles, setup.grid, box)
    g = setup.grid.replace(dirichlet_value=torch.zeros_like(setup.grid.dirichlet_value))
    for _ in range(3):
        if scheme == "FE":
            p_man, _ = tint.forward_euler_step(p_man, g, setup.materials, cfg, torch.zeros(2))
        else:
            p_man, _ = tint.generalized_alpha_step(p_man, g, setup.materials, cfg,
                                                   torch.zeros(2), cfg.ga_rb)
    np.testing.assert_allclose(p_drv.x.numpy(), p_man.x.numpy(), rtol=1e-6, atol=1e-9)


def test_scheme_routing_and_refusals(bar_case):  # noqa: F811
    """The NPC-FS step points FE/GA at the integrators; the integrators take
    the windowed and scatter engines ('binned' is on the do-not-port list,
    the kernels have no path for them)."""
    setup = build_simulation(str(decks.set_scheme(bar_case, "FE")), device="cpu")
    box = twin.default_box(setup.grid, setup.particles.x.numpy(), setup.particles.active.numpy())
    cfg = driver.make_step_config(setup, transfer="windowed", active_box=box)
    p = tex.to_slot_layout(setup.particles, setup.grid, box)
    with pytest.raises(ValueError, match="integrators.forward_euler_step"):
        tex.explicit_step(p, setup.grid, setup.materials, cfg, torch.zeros(2))
    with pytest.raises(NotImplementedError, match="do-not-port list, ROADMAP.md queue 2"):
        tint.forward_euler_step(p, setup.grid, setup.materials, cfg.replace(transfer="binned"),
                                torch.zeros(2))
    with pytest.raises(ValueError, match="no fused transfer path"):
        tint.generalized_alpha_step(p, setup.grid, setup.materials,
                                    cfg.replace(transfer="fused", shapefun="lme"), torch.zeros(2))
