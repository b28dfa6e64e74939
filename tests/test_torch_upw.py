"""The explicit soil-water mixture (u-pw) slice: the port's
``init_mixture_state`` and ``upw_step`` on the windowed and on the fused
engine against the JAX package's windowed and 'pallas' steps, from the same
numpy state on tests/test_upw.py's column, compared by pid (x atol 1e-6, pw
atol 1e-5 of its largest magnitude, φ_f atol 1e-6: the JAX package's own
limits between its engines, test_upw.py::test_upw_pallas_parity); the
column's FEM oracles through the port's windowed engine with a box over the
whole grid; and the options that wait."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import upw as jupw
from nlpartsol_tpu.formulations.explicit import to_slot_layout as jslot
from nlpartsol_tpu.models import materials as jM
from nlpartsol_tpu.ops import windowed as jwin
from nlpartsol_tpu.shapefun import lme as jlme

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import upw as tupw
from nlpartsol_tpu_torch.ops import windowed as twin

from _torch_port import (by_pid, cheap_jax_compiles, fields_to_numpy,  # noqa: F401
                         to_torch_grid, to_torch_materials, to_torch_particles)
from test_upw import KF, column_setup, mixture_celerity

torch.set_num_threads(1)

BODY = np.asarray([0.0, -9.81], np.float32)


def to_torch_mixture(mix):
    return convert.mixture_from_numpy(fields_to_numpy(mix), device="cpu")


def port_column(**kw):
    """test_upw.py's column (2×10 cells, 2×2 particles a cell, bottom fixed
    in y, no x motion, Neo-Hookean soil and compressible water) as port
    records, with a box over the whole grid."""
    grid, p, mats, mix, h, H = column_setup(**kw)
    tg = to_torch_grid(grid)
    return (tg, to_torch_particles(p), to_torch_materials(mats), to_torch_mixture(mix), h, H,
            twin.full_box(tg, capacity=4))


def test_init_mixture_state_matches_jax():
    grid, p, mats, mix, h, H = column_setup()
    mix2 = jupw.make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=1e-5),
         dict(soil_id=0, water_id=1, phi_s0=0.7, phi_f0=0.3, permeability=1e-6)])
    rng = np.random.default_rng(3)
    mid = rng.integers(0, 2, p.count).astype(np.int32)
    pj = jupw.init_mixture_state(p.replace(mat_id=jnp.asarray(mid)), mats, mix2)
    tm = tupw.make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=1e-5),
         dict(soil_id=0, water_id=1, phi_s0=0.7, phi_f0=0.3, permeability=1e-6)], device="cpu")
    for name in ("soil_id", "water_id", "phi_s0", "phi_f0", "permeability"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(mix2, name)))
    tp = tupw.init_mixture_state(
        to_torch_particles(p).replace(mat_id=torch.as_tensor(mid)), to_torch_materials(mats), tm)
    for name in ("rho_s", "rho_f", "phi_s", "phi_f", "rho", "mass"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(pj, name)),
                                   rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("transfer", ["windowed", "pallas"])
def test_explicit_steps_match_jax(transfer):
    """25 steps of test_upw.py::test_upw_pallas_parity's gravity loading
    (LME γ=3, dt = 0.2·h/c_mix, capacity-8 box over the grid): the port's
    ``run`` against the JAX package's step on the engine of the same name
    ('pallas' is the port's 'fused'), by pid."""
    grid, p, mats, mix, h, H = column_setup()
    box = jwin.full_box(grid, capacity=8)
    c_mix = np.sqrt((KF / 0.4) / 1700.0)
    cfg_j = jupw.UpwConfig(dt=0.2 * h / c_mix, shapefun="lme", lme_params=jlme.LMEParams(gamma=3.0),
                           kinds=(jM.NEO_HOOKEAN,), transfer=transfer, active_box=box)
    cfg_t = convert.upw_config_from_fields(
        {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})
    assert cfg_t.transfer == {"pallas": "fused", "windowed": "windowed"}[transfer]
    n_steps = 25
    pj = jslot(p, grid, box)
    step = jax.jit(jupw.upw_step, static_argnums=(4,))
    for _ in range(n_steps):
        pj, dj = step(pj, grid, mats, mix, cfg_j, jnp.asarray(BODY))
    tp, hist = tupw.run(to_torch_particles(p), to_torch_grid(grid), to_torch_materials(mats),
                        to_torch_mixture(mix), cfg_t, n_steps, torch.as_tensor(BODY))
    assert hist["lost"].shape == (n_steps,) and int(hist["lost"].sum()) == 0
    assert int(hist["nnz"][-1]) == int(dj["nnz"])
    names = ("x", "pw", "phi_f", "v")
    got, ref = by_pid(tp, names), by_pid(pj, names)
    pw_scale = float(np.abs(ref["pw"]).max())
    assert pw_scale > 1.0, "no pore pressure built up"
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["pw"], ref["pw"], rtol=0, atol=1e-5 * pw_scale)
    np.testing.assert_allclose(got["phi_f"], ref["phi_f"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["v"], ref["v"], rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref["v"]).max()))


def test_upw_gravity_loading_builds_pore_pressure():
    """test_upw.py's oracle through the port (FEM, windowed): after 60 steps
    of sudden gravity the pore pressure is positive, larger at depth, and
    the run is stable."""
    tg, tp, tm, tmix, h, H, box = port_column()
    dt = 0.3 * h / mixture_celerity(tp, 0.4)
    cfg = tupw.UpwConfig(dt=dt, shapefun="fem", kinds=(jM.NEO_HOOKEAN,), transfer="windowed",
                         active_box=box)
    p, hist = tupw.run(tp, tg, tm, tmix, cfg, 60, torch.as_tensor(BODY))
    assert int(hist["lost"].sum()) == 0
    got = by_pid(p, ("x", "pw", "phi_f", "J"))
    assert np.isfinite(got["x"]).all()
    pw, y = got["pw"], got["x"][:, 1]
    deep, shallow = pw[y < 0.3 * H].mean(), pw[y > 0.7 * H].mean()
    assert deep > 0, f"expected compressive (positive) pore pressure at depth, got {deep}"
    assert deep > shallow, "pore pressure must increase with depth"
    assert got["phi_f"].min() > 0.0
    assert abs(got["J"].max() - 1.0) < 0.1


def test_upw_incompressible_limit_total_stress():
    """test_upw.py's undrained oracle through the port (FEM, windowed, k =
    0): the time-averaged total vertical stress over 200 steps after 200
    settling steps is the lithostatic ρ_mix·g·(H − y) within 0.30."""
    tg, tp, tm, _, h, H, box = port_column()
    tmix = tupw.make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=0.0)], device="cpu")
    rho_mix = float(tp.rho[0])
    cfg = tupw.UpwConfig(dt=0.25 * h / mixture_celerity(tp, 0.4), shapefun="fem",
                         kinds=(jM.NEO_HOOKEAN,), transfer="windowed", active_box=box)
    body = torch.as_tensor(BODY)
    p = tupw.to_slot_layout(tp, tg, box)
    acc = np.zeros(tp.count)
    for i in range(400):
        p, diag = tupw.upw_step(p, tg, tm, tmix, cfg, body)
        if i >= 200:  # by pid: the windowed step re-bins every step
            act = p.active.numpy()
            acc[p.pid.numpy()[act]] += (p.stress[:, 1, 1] - p.pw).numpy()[act]
    assert int(diag["lost"]) == 0
    s_total = acc / 200
    y = by_pid(p, ("x",))["x"][:, 1]
    s_ref = -rho_mix * 9.81 * (H - y)
    bulk = (y > 0.15 * H) & (y < 0.85 * H)
    assert bulk.sum() > 0
    err = np.abs(s_total[bulk] - s_ref[bulk]).max() / (rho_mix * 9.81 * H)
    assert err < 0.30, f"time-averaged total stress error {err:.2f}"


def test_options_that_wait_raise():
    tg, tp, tm, tmix, h, H, box = port_column()
    body = torch.as_tensor(BODY)
    base = tupw.UpwConfig(dt=1e-6, active_box=box)
    # sharding (item 15) runs now: tests/test_torch_not_ported.py::
    # test_sharding_options_run[upw]
    waiting = [("queue 2", dict(transfer="binned"))]
    for item, kw in waiting:
        with pytest.raises(NotImplementedError, match=item):
            tupw.upw_step(tp, tg, tm, tmix, base.replace(**kw), body)
        with pytest.raises(NotImplementedError, match=item):
            tupw.upw_newmark_step(tp, tg, tm, tmix, tupw.UpwImplicitConfig(
                dt=1e-6, active_box=box).replace(**kw), body)
    for shapefun in ("fem", "gimp"):
        with pytest.raises(ValueError, match="LME only"):
            tupw.upw_step(tp, tg, tm, tmix, base.replace(shapefun=shapefun, transfer="fused"),
                          body)
    with pytest.raises(ValueError, match="active_box"):
        tupw.upw_step(tp, tg, tm, tmix, base.replace(active_box=None), body)
    assert convert.upw_config_from_fields(dict(dt=1e-6, prebinned=True)).prebinned
