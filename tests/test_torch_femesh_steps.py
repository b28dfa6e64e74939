"""The port's steps on an unstructured mesh (the scatter engine) against the
JAX package's, on tests/test_femesh.py's 24×3 T3 bar, by pid at bench.py's
limits (rel_dx < 1e-3 over the mesh's smallest edge, rel_dv < 1e-2): the
explicit step with FEM and with LME over the node cloud (and the
quarter-period oracle of test_femesh.py on the port alone, err < 0.12),
implicit Newmark-β (test_femesh.py:224, equal Newton counts), Forward-Euler,
Generalized-α and the quasi-static step."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import explicit as jex, implicit as jim
from nlpartsol_tpu.formulations import integrators as jint
from nlpartsol_tpu.formulations.courant import courant_dt
from nlpartsol_tpu.models import materials as jM

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import explicit as tex, implicit as tim
from nlpartsol_tpu_torch.formulations import integrators as tint

from _torch_femesh import C, bar_problem, quarter_period_error, rel_dx_dv, static_fields
from _torch_port import cheap_jax_compiles  # noqa: F401

torch.set_num_threads(1)

COMPARED_STEPS = 5


def _close(tp, pj, h):
    rel_dx, rel_dv = rel_dx_dv(tp, pj, h)
    assert rel_dx < 1e-3 and rel_dv < 1e-2, (rel_dx, rel_dv)


@pytest.mark.parametrize("shapefun", ["fem", "lme"])
def test_explicit_on_the_t3_bar_matches_jax(shapefun):
    """COMPARED_STEPS steps against the JAX step by pid (nnz and lost
    equal), then the port alone to a quarter period: err < 0.12."""
    (mj, pj, matj), (mt, pt, matt), pts, (lj, _) = bar_problem(shapefun)
    dt = courant_dt(0.2, mj.spacing, C)
    cfg_j = jex.ExplicitConfig(dt=dt, shapefun=shapefun, lme_params=lj,
                               kinds=(jM.NEO_HOOKEAN,), transfer="scatter")
    cfg_t = convert.config_from_fields(static_fields(cfg_j))
    qj, dj = jax.jit(jex.run, static_argnums=(3, 4))(pj, mj, matj, cfg_j, COMPARED_STEPS)
    qt, dt_ = tex.run(pt, mt, matt, cfg_t, COMPARED_STEPS)
    np.testing.assert_array_equal(dt_["nnz"].numpy(), np.asarray(dj["nnz"]))
    assert int(dt_["lost"].sum()) == 0
    _close(qt, qj, mj.spacing)
    n_quarter = int(round((np.pi / 2 / (np.pi * C)) / dt))
    q, hist = tex.run(qt, mt, matt, cfg_t, n_quarter - COMPARED_STEPS)
    assert int(hist["lost"].sum()) == 0
    assert quarter_period_error(q.dis[:, 0].numpy(), pts) < 0.12


def test_implicit_on_the_t3_bar_matches_jax():
    """test_femesh.py::test_implicit_unstructured_t3: 3 Newmark-β steps at
    courant 1, FEM; converged with equal Newton counts, tracks by pid."""
    (mj, pj, matj), (mt, pt, matt), _, _ = bar_problem("fem")
    cfg_j = jim.ImplicitConfig(dt=courant_dt(1.0, mj.spacing, C), shapefun="fem",
                               kinds=(jM.NEO_HOOKEAN,), transfer="scatter", newton_tol=1e-6,
                               newton_maxiter=20)
    cfg_t = convert.implicit_config_from_fields(static_fields(cfg_j))
    step_j = jax.jit(jim.implicit_step, static_argnums=(3,))
    for _ in range(3):
        pj, dj = step_j(pj, mj, matj, cfg_j, jnp.zeros(2, jnp.float32))
        pt, dt_ = tim.implicit_step(pt, mt, matt, cfg_t, torch.zeros(2))
        assert bool(dt_["converged"]) and bool(dj["converged"])
        assert int(dt_["newton_iters"]) == int(dj["newton_iters"])
        assert int(dt_["lost"]) == 0
    _close(pt, pj, mj.spacing)
    assert float(pt.dis.abs().max()) < 0.01


@pytest.mark.parametrize("scheme,rb", [("FE", None), ("Generalized-alpha", 0.8)])
def test_integrators_on_the_t3_bar_match_jax(scheme, rb):
    """Three Forward-Euler or Generalized-α steps, FEM, by pid."""
    (mj, pj, matj), (mt, pt, matt), _, _ = bar_problem("fem")
    cfg_j = jex.ExplicitConfig(dt=courant_dt(0.2, mj.spacing, C), shapefun="fem",
                               kinds=(jM.NEO_HOOKEAN,), transfer="scatter", scheme=scheme,
                               ga_rb=rb or 0.6)
    cfg_t = convert.config_from_fields(static_fields(cfg_j))
    body_j, body_t = jnp.zeros(2, jnp.float32), torch.zeros(2)
    if scheme == "FE":
        step_j = jax.jit(lambda q: jint.forward_euler_step(q, mj, matj, cfg_j, body_j))
    else:
        step_j = jax.jit(lambda q: jint.generalized_alpha_step(q, mj, matj, cfg_j, body_j, rb))
    for _ in range(3):
        pj, _ = step_j(pj)
        if scheme == "FE":
            pt, diag = tint.forward_euler_step(pt, mt, matt, cfg_t, body_t)
        else:
            pt, diag = tint.generalized_alpha_step(pt, mt, matt, cfg_t, body_t, rb)
        assert int(diag["lost"]) == 0
    _close(pt, pj, mj.spacing)


def test_quasi_static_on_the_t3_bar_matches_jax():
    """One quasi-static step under a body force along the bar (ends held):
    converged with equal Newton counts, displacements by pid."""
    (mj, pj, matj), (mt, pt, matt), _, _ = bar_problem("fem", V=0.0)
    cfg_j = jim.ImplicitConfig(dt=courant_dt(1.0, mj.spacing, C), shapefun="fem",
                               kinds=(jM.NEO_HOOKEAN,), transfer="scatter", quasi_static=True,
                               newton_tol=1e-6, newton_maxiter=20)
    cfg_t = convert.implicit_config_from_fields(static_fields(cfg_j))
    body = np.asarray([-1e3, 0.0], np.float32)
    pj, dj = jim.implicit_step(pj, mj, matj, cfg_j, jnp.asarray(body))
    pt, dt_ = tim.implicit_step(pt, mt, matt, cfg_t, torch.as_tensor(body))
    assert bool(dt_["converged"]) and bool(dj["converged"])
    assert int(dt_["newton_iters"]) == int(dj["newton_iters"])
    ref = np.asarray(pj.dis)
    assert np.abs(ref).max() > 1e-6  # the bar sagged
    np.testing.assert_allclose(pt.dis.numpy(), ref, rtol=0, atol=1e-3 * np.abs(ref).max())
