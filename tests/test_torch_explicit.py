"""The slice as a whole, step by step: the port's explicit step on the
windowed and on the fused engine against the JAX package's, from state
carried across by convert.py.  Steps are compared by pid over active
particles at the tolerances the JAX package holds between its own engines
(tests/test_pallas_transfer.py): x rtol 1e-5, v 1e-4, F 1e-4, stress rtol
2e-3 atol 1.0, nnz equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import explicit as jex

from nlpartsol_tpu_torch.formulations import explicit as tex
from nlpartsol_tpu_torch.ops import fused_transfer as ft

from _torch_port import (assert_tracks, cheap_jax_compiles, explicit_configs,  # noqa: F401
                         neo_hookean_tables, problem)

torch.set_num_threads(1)


@pytest.mark.parametrize("transfer", ["windowed", "pallas"])
def test_three_explicit_steps_match_jax(transfer):
    """Gravity, a Dirichlet strip, F-bar and tractions at once (tractions make
    the fused step bin by sorting each step; the local re-bin is held against
    the JAX package in tests/test_torch_run.py and test_torch_windowed.py)."""
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem(seed=7, n_side=14, n_particles=200, speed=0.05)
    mj, mt = neo_hookean_tables()
    mj = mj.replace(alpha_fbar=jnp.asarray([0.5], jnp.float32))
    mt = mt.replace(alpha_fbar=torch.tensor([0.5]))
    # fix the three lowest node columns along axis 1; pull on every particle
    fixed = np.zeros((gj.n_nodes, 2), bool)
    fixed.reshape(14, 14, 2)[:, :3, :] = True
    gj = gj.replace(dirichlet_mask=jnp.asarray(fixed),
                    dirichlet_value=jnp.zeros((gj.n_nodes, 2), jnp.float32))
    tg = tg.replace(dirichlet_mask=torch.as_tensor(fixed),
                    dirichlet_value=torch.zeros((tg.n_nodes, 2)))
    rng = np.random.default_rng(10)
    trac = (1e3 * rng.standard_normal((pj.count, 2))).astype(np.float32)
    area = np.full(pj.count, gj.spacing / 2, np.float32)
    body = np.asarray([0.0, -9.81], np.float32)

    cfg_j, cfg_t = explicit_configs(gj, bj, lj, 0.1, transfer=transfer, fbar=True)
    assert cfg_t.transfer == {"pallas": "fused", "windowed": "windowed"}[transfer]
    assert cfg_t.active_box == tb and cfg_t.lme_params == lt and cfg_t.fbar
    step_j = jax.jit(lambda q, t, a: jex.explicit_step(
        q, gj, mj, cfg_j, jnp.asarray(body), traction=t, traction_area=a))
    ft.reset_launch_counts()
    for _ in range(3):
        # both packages re-bin at step start, so the slot order of the
        # traction rows (particle order of the step's input) stays in step
        pj, dj = step_j(pj, jnp.asarray(trac), jnp.asarray(area))
        tp, dt_ = tex.explicit_step(tp, tg, mt, cfg_t, torch.as_tensor(body),
                                    traction=torch.as_tensor(trac),
                                    traction_area=torch.as_tensor(area))
    assert int(dt_["nnz"]) == int(dj["nnz"])
    assert int(dt_["lost"]) == int(dj["lost"]) == 0
    assert_tracks(tp, pj)
    for key in ("kinetic_energy", "strain_energy"):
        np.testing.assert_allclose(float(dt_[key]), float(dj[key]), rtol=1e-4)
    r_j = np.asarray(dj["reactions"])
    np.testing.assert_allclose(dt_["reactions"].numpy(), r_j, rtol=2e-3,
                               atol=2e-3 * np.abs(r_j).max())
    assert np.abs(r_j).max() > 0 and not dt_["reactions"].numpy()[~fixed].any()
    # on CPU tensors the fused step runs the kernels' plain versions
    assert sum(ft.launch_counts.values()) == 0
