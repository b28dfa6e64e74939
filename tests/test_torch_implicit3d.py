"""The implicit Newmark-β slice in 3D: one step of the port's fused engine
against the JAX package's 'pallas' step from the same numpy state (by pid,
at the 2D slice's tolerances: x rtol 1e-4 atol 1e-6; v, F rtol 1e-3 atol
1e-5; equal nnz and Newton iterations), and the port's fused engine against
its own windowed engine — through ``run`` from particles in any order, and
one step with tractions (the first scatter's 11 channels: mass, 3 velocity
and 3 acceleration momenta, 3 tractions, the stiffness scale) and a
Dirichlet floor.  The JAX program compiles once (about 40 s)."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from nlpartsol_tpu.formulations import implicit as jim

from nlpartsol_tpu_torch.formulations import implicit as tim

from _torch_port import (by_pid, cheap_jax_compiles, implicit_configs,  # noqa: F401
                         neo_hookean_tables, problem3)

torch.set_num_threads(1)

TOL = dict(x=dict(rtol=1e-4, atol=1e-6), v=dict(rtol=1e-3, atol=1e-5),
           F=dict(rtol=1e-3, atol=1e-5))
BODY = np.asarray([0.0, 0.0, -9.81], np.float32)


def _assert_tracks(got_p, ref_p):
    got, ref = by_pid(got_p), by_pid(ref_p)
    for name, tol in TOL.items():
        np.testing.assert_allclose(got[name], ref[name], err_msg=name, **tol)


def test_fused_3d_step_matches_jax_pallas():
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem3(seed=7, n_side=9, n_particles=80, speed=0.02)
    mj, mt = neo_hookean_tables()
    cfg_j, cfg_t = implicit_configs(gj, bj, lj, transfer="pallas", cg_maxiter=100)
    assert cfg_t.transfer == "fused"
    pj, dj = jax.jit(jim.implicit_step, static_argnums=(3,))(pj, gj, mj, cfg_j,
                                                             jnp.asarray(BODY))
    tp, dt_ = tim.implicit_step(tp, tg, mt, cfg_t, torch.as_tensor(BODY))
    assert int(dt_["nnz"]) == int(dj["nnz"])
    assert dt_["newton_iters"] == int(dj["newton_iters"]) >= 2
    assert bool(dt_["converged"]) and bool(dj["converged"])
    assert int(dt_["lost"]) == int(dj["lost"]) == 0
    _assert_tracks(tp, pj)


def test_fused_3d_run_matches_windowed_run():
    """Two steps through ``run`` (binned once from particle order; the fused
    engine re-bins locally after each step, the windowed one sorts)."""
    (_, _, _, _), (tg, tb, tp, lt) = problem3(seed=8, n_side=9, n_particles=80, speed=0.05)
    _, mt = neo_hookean_tables()
    perm = torch.as_tensor(np.random.default_rng(8).permutation(tp.count))
    tp = tp.map_tensors(lambda a: a[perm])
    cfg = tim.ImplicitConfig(dt=0.5 * tg.spacing / np.sqrt(1e3), lme_params=lt, active_box=tb,
                             cg_maxiter=100)
    body = torch.as_tensor(BODY)
    pf, df = tim.run(tp, tg, mt, cfg, 2, body)
    pw, dw = tim.run(tp, tg, mt, cfg.replace(transfer="windowed"), 2, body)
    assert df["newton_iters"].tolist() == dw["newton_iters"].tolist()
    assert min(df["newton_iters"].tolist()) >= 2
    assert bool(torch.all(torch.isfinite(df["newton_residual"])))
    _assert_tracks(pf, pw)


def test_fused_3d_traction_dirichlet_step_matches_windowed():
    (_, _, _, _), (tg, tb, tp, lt) = problem3(seed=9, n_side=9, n_particles=80, speed=0.02)
    _, mt = neo_hookean_tables()
    fixed = np.zeros((tg.n_nodes, 3), bool)
    fixed.reshape(9, 9, 9, 3)[:, :, :3, :] = True
    tg = tg.replace(dirichlet_mask=torch.as_tensor(fixed),
                    dirichlet_value=torch.zeros((tg.n_nodes, 3)))
    rng = np.random.default_rng(9)
    trac = torch.as_tensor((1e3 * rng.standard_normal((tp.count, 3))).astype(np.float32))
    area = torch.full((tp.count,), tg.spacing ** 2 / 4)
    cfg = tim.ImplicitConfig(dt=0.5 * tg.spacing / np.sqrt(1e3), lme_params=lt, active_box=tb,
                             cg_maxiter=100)
    body = torch.as_tensor(BODY)
    out = {}
    for transfer in ("fused", "windowed"):
        out[transfer] = tim.implicit_step(tp, tg, mt, cfg.replace(transfer=transfer), body,
                                          traction=trac, traction_area=area)
    (pf, df), (pw, dw) = out["fused"], out["windowed"]
    assert df["newton_iters"] == dw["newton_iters"] and int(df["nnz"]) == int(dw["nnz"])
    assert bool(df["converged"]) and int(df["lost"]) == 0
    _assert_tracks(pf, pw)
    ref = dw["reactions"]
    assert float(ref.abs().max()) > 1.0 and not bool(ref[~torch.as_tensor(fixed)].any())
    torch.testing.assert_close(df["reactions"], ref, rtol=1e-3,
                               atol=1e-4 * float(ref.abs().max()))
