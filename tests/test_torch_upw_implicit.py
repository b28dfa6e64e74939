"""The implicit soil-water mixture (u-pw) slice: the port's
``upw_newmark_step`` on the windowed and on the fused engine against the
JAX package's windowed and 'pallas' steps from the same numpy state, by pid
(x atol 1e-6, pw atol 1e-2 of its largest magnitude: the JAX package's own
limits between its engines, test_upw.py::test_upw_implicit_pallas_parity),
with equal Newton iterations; the column's implicit FEM oracles through the
port's windowed engine; and the fused residual's J·v against a float64
central difference of the port's own residual.

The steps are compared on tests/test_upw.py's column with the fluid of
scripts/bench_upw.py (K_f = 2.2e7) at dt = 2e-4.  On test_upw.py's own
parity problem (K_f = 2.2e9, dt = 2e-3) the Newton counts sit at the
float32 floor: over two steps the JAX package's windowed engine takes 3
and 4 Newton iterations, its 'pallas' engine 3 and 3, the port's windowed
engine 4 and 4, though the port's GMRES matches the JAX package's to 7e-14
in float64 (5e-5 in float32) on one random system
(tests/torch_upw_probe.py, ``newton-counts`` and ``gmres-f64``)."""

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
from nlpartsol_tpu_torch.ops import solvers
from nlpartsol_tpu_torch.ops import windowed as twin

from _torch_port import (by_pid, cheap_jax_compiles, to_torch_grid,  # noqa: F401
                         to_torch_materials, to_torch_particles)
from test_torch_upw import BODY, port_column, to_torch_mixture
from test_upw import E_SOIL, RHO_F, RHO_S, column_setup, mixture_celerity

torch.set_num_threads(1)


def _bench_fluid_column():
    """test_upw.py's column with scripts/bench_upw.py's fluid, K_f = 2.2e7."""
    grid, p, _, mix, h, H = column_setup()
    mats = jM.material_table(
        [jM.material(kind="Neo-Hookean-Wriggers", E=E_SOIL, nu=0.3, rho0=RHO_S),
         jM.material(kind="Newtonian-Fluid-Compressible", rho0=RHO_F, compressibility=2.2e7)])
    return grid, jupw.init_mixture_state(p, mats, mix), mats, mix


@pytest.mark.parametrize("transfer", ["windowed", "pallas"])
def test_implicit_steps_match_jax(transfer):
    """Two implicit steps (LME γ=3, capacity-8 box over the grid, dt = 2e-4,
    Newton-GMRES): equal Newton iterations, converged, nothing lost; GMRES
    totals reported beside them."""
    grid, p, mats, mix = _bench_fluid_column()
    box = jwin.full_box(grid, capacity=8)
    cfg_j = jupw.UpwImplicitConfig(dt=2e-4, shapefun="lme", lme_params=jlme.LMEParams(gamma=3.0),
                                   kinds=(jM.NEO_HOOKEAN,), transfer=transfer, active_box=box)
    cfg_t = convert.upw_implicit_config_from_fields(
        {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})
    assert cfg_t.transfer == {"pallas": "fused", "windowed": "windowed"}[transfer]
    pj = jslot(p, grid, box)
    tp, tg = to_torch_particles(pj), to_torch_grid(grid)
    tm, tmix = to_torch_materials(mats), to_torch_mixture(mix)
    step = jax.jit(jupw.upw_newmark_step, static_argnums=(4,))
    iters = []
    for _ in range(2):
        pj, dj = step(pj, grid, mats, mix, cfg_j, jnp.asarray(BODY))
        tp, dt_ = tupw.upw_newmark_step(tp, tg, tm, tmix, cfg_t, torch.as_tensor(BODY))
        assert bool(dt_["converged"]) and bool(dj["converged"])
        assert int(dt_["lost"]) == int(dj["lost"]) == 0
        assert int(dt_["nnz"]) == int(dj["nnz"])
        iters.append(((dt_["newton_iters"], dt_["cg_iters"]),
                      (int(dj["newton_iters"]), int(dj["cg_iters"]))))
    assert all(t[0] == j[0] for t, j in iters), iters
    got, ref = by_pid(tp, ("x", "pw")), by_pid(pj, ("x", "pw"))
    pw_scale = float(np.abs(ref["pw"]).max())
    assert pw_scale > 100.0, "no pore pressure built up"
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["pw"], ref["pw"], rtol=0, atol=1e-2 * pw_scale)


def test_upw_implicit_drained_pressure_decays():
    """test_upw.py's oracle through the port (FEM, windowed): the 6-cell
    column with its top row drained (θ = 0) and k = 1e-3 consolidates over
    40 steps of 0.01 s: the mean pore pressure falls below 0.8 of its value
    after the first step."""
    tg, tp, tm, _, h, H, box = port_column(ny=6)
    tmix = tupw.make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=1e-3)], device="cpu")
    ids = np.arange(tg.n_nodes).reshape(tg.dims)
    pw_mask = np.zeros(tg.n_nodes, bool)
    pw_mask[ids[:, -1]] = True  # top row drained
    cfg = tupw.UpwImplicitConfig(dt=0.01, shapefun="fem", kinds=(jM.NEO_HOOKEAN,),
                                 transfer="windowed", active_box=box)
    body = torch.as_tensor(BODY)
    p, means = tp, []
    for _ in range(40):
        p, diag = tupw.upw_newmark_step(p, tg, tm, tmix, cfg, body, torch.as_tensor(pw_mask),
                                        torch.zeros(tg.n_nodes))
        assert int(diag["lost"]) == 0
        means.append(float(p.pw[p.active].mean()))
    assert np.isfinite(means[-1])
    assert means[0] > 0
    assert means[-1] < 0.8 * means[0], f"pore pressure did not consolidate: {means[0]} -> {means[-1]}"


def test_upw_implicit_matches_explicit():
    """test_upw.py's cross-integrator oracle through the port (FEM,
    windowed): 20 implicit steps against 80 explicit ones over the same
    time; displacements within 0.35 of the largest, and both build pore
    pressure that grows with depth."""
    tg, tp, tm, tmix, h, H, box = port_column()
    dt_exp = 0.25 * h / mixture_celerity(tp, 0.4)
    n_exp, n_imp = 80, 20
    body = torch.as_tensor(BODY)
    cfg_e = tupw.UpwConfig(dt=dt_exp, shapefun="fem", kinds=(jM.NEO_HOOKEAN,),
                           transfer="windowed", active_box=box)
    pe, _ = tupw.run(tp, tg, tm, tmix, cfg_e, n_exp, body)
    cfg_i = tupw.UpwImplicitConfig(dt=n_exp * dt_exp / n_imp, shapefun="fem",
                                   kinds=(jM.NEO_HOOKEAN,), transfer="windowed", active_box=box)
    pi, iters = tupw.to_slot_layout(tp, tg, box), []
    for _ in range(n_imp):
        pi, diag = tupw.upw_newmark_step(pi, tg, tm, tmix, cfg_i, body)
        iters.append(diag["newton_iters"])
    assert max(iters) <= 20
    ue, ui = by_pid(pe, ("dis",))["dis"][:, 1], by_pid(pi, ("dis",))["dis"][:, 1]
    err_u = np.abs(ui - ue).max() / max(np.abs(ue).max(), 1e-12)
    assert err_u < 0.35, f"implicit vs explicit displacement mismatch {err_u:.3f}"
    got = by_pid(pi, ("pw", "x"))
    pwi, y = got["pw"], got["x"][:, 1]
    assert pwi[y < 0.3 * H].mean() > 0
    assert pwi[y < 0.3 * H].mean() > pwi[y > 0.7 * H].mean()


@pytest.mark.parametrize("transfer", ["windowed", "fused"])
def test_jv_matches_central_difference_float64(transfer, monkeypatch):
    """The J·v the Newton-GMRES solve uses (forward mode through the stress,
    the kinematics, the fluid state and the transfers; on the fused engine
    through GatherNGrad, GatherGrad, ScatterNG and ScatterG) against
    (R(x + sv) − R(x − sv))/2s of the port's own scaled residual, in float64,
    at a nonzero iterate."""
    tg, tp, tm, tmix, h, H, _ = port_column()
    box = twin.full_box(tg, capacity=8)
    tp = tupw.to_slot_layout(tp, tg, box)

    def f64(r):
        return r.map_tensors(lambda a: a.double() if a.is_floating_point() else a)

    tp, tm, tmix = f64(tp), f64(tm), f64(tmix)
    cfg = tupw.UpwImplicitConfig(dt=2e-3, kinds=(jM.NEO_HOOKEAN,), transfer=transfer,
                                 active_box=box, newton_maxiter=0)
    seen, real = {}, solvers.newton_krylov

    def spy(residual, x0, **kw):
        seen.update(residual=residual, M_inv=kw["M_inv"])
        return real(residual, x0, **kw)

    monkeypatch.setattr(solvers, "newton_krylov", spy)
    tupw.upw_newmark_step(tp, tg, tm, tmix, cfg, torch.as_tensor(BODY, dtype=torch.float64))
    R, M_inv = seen["residual"], seen["M_inv"]
    rng = np.random.default_rng(21)
    # unknowns at the scale of the column scaling (h for dU, λ + 2G for dθ)
    x = M_inv(torch.as_tensor(1e-3 * rng.standard_normal((tg.n_nodes, 3))))
    v = M_inv(torch.as_tensor(rng.standard_normal((tg.n_nodes, 3))))
    Jv = solvers.jvp(R, x, v)[1]
    s = 1e-5
    fd = (R(x + s * v) - R(x - s * v)) / (2 * s)
    assert float(Jv[:, 2].abs().max()) > 0.0 and float(Jv[:, :2].abs().max()) > 0.0
    torch.testing.assert_close(Jv, fd, rtol=1e-6, atol=1e-6 * float(fd.abs().max()))

